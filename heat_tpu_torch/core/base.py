"""sklearn-style estimator base classes (counterpart of
``heat_tpu/core/base.py``, the subset the clusterers need)."""

from __future__ import annotations

import inspect
from typing import Any, Dict, List

from .dndarray import DNDarray

__all__ = ["BaseEstimator", "ClusteringMixin"]


class BaseEstimator:
    """Base for all estimators: parameter introspection get/set."""

    @classmethod
    def _parameter_names(cls) -> List[str]:
        init = cls.__init__
        if init is object.__init__:
            return []
        sig = inspect.signature(init)
        return [
            p.name
            for p in sig.parameters.values()
            if p.name != "self" and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
        ]

    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        params = {}
        for key in self._parameter_names():
            value = getattr(self, key, None)
            if deep and hasattr(value, "get_params"):
                for sub_key, sub_value in value.get_params().items():
                    params[f"{key}__{sub_key}"] = sub_value
            params[key] = value
        return params

    def set_params(self, **params) -> "BaseEstimator":
        if not params:
            return self
        valid = self.get_params(deep=True)
        for key, value in params.items():
            key, _, sub_key = key.partition("__")
            if key not in valid:
                raise ValueError(f"Invalid parameter {key} for estimator {self}")
            if sub_key:
                getattr(self, key).set_params(**{sub_key: value})
            else:
                setattr(self, key, value)
        return self

    def __repr__(self) -> str:
        params = ", ".join(f"{k}={v!r}" for k, v in self.get_params(deep=False).items())
        return f"{self.__class__.__name__}({params})"


class ClusteringMixin:
    """fit/fit_predict contract for clusterers."""

    def fit(self, x: DNDarray):
        raise NotImplementedError()

    def fit_predict(self, x: DNDarray) -> DNDarray:
        self.fit(x)
        return self.predict(x)

