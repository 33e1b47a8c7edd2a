"""Spatial functions (counterpart of ``heat_tpu/spatial``)."""

from .distance import cdist, rbf

__all__ = ["cdist", "rbf"]
