"""sklearn-style estimator base classes (counterpart of
``heat_tpu/core/base.py``)."""

from __future__ import annotations

import inspect
from typing import Any, Dict, List

from .dndarray import DNDarray

__all__ = [
    "BaseEstimator",
    "ClassificationMixin",
    "ClusteringMixin",
    "RegressionMixin",
    "TransformMixin",
    "is_classifier",
    "is_estimator",
    "is_regressor",
    "is_transformer",
]


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



class ClassificationMixin:
    """fit/predict contract for classifiers."""

    def fit(self, x: DNDarray, y: DNDarray):
        raise NotImplementedError()

    def fit_predict(self, x: DNDarray, y: DNDarray) -> DNDarray:
        self.fit(x, y)
        return self.predict(x)

    def predict(self, x: DNDarray) -> DNDarray:
        raise NotImplementedError()


class TransformMixin:
    """fit/transform contract for transformers."""

    def fit(self, x: DNDarray):
        raise NotImplementedError()

    def fit_transform(self, x: DNDarray) -> DNDarray:
        self.fit(x)
        return self.transform(x)

    def transform(self, x: DNDarray) -> DNDarray:
        raise NotImplementedError()


class RegressionMixin:
    """fit/predict contract for regressors."""

    def fit(self, x: DNDarray, y: DNDarray):
        raise NotImplementedError()

    def fit_predict(self, x: DNDarray, y: DNDarray) -> DNDarray:
        self.fit(x, y)
        return self.predict(x)

    def predict(self, x: DNDarray) -> DNDarray:
        raise NotImplementedError()


def is_classifier(estimator: Any) -> bool:
    return isinstance(estimator, ClassificationMixin)


def is_estimator(estimator: Any) -> bool:
    return isinstance(estimator, BaseEstimator)


def is_regressor(estimator: Any) -> bool:
    return isinstance(estimator, RegressionMixin)


def is_transformer(estimator: Any) -> bool:
    return isinstance(estimator, TransformMixin)
