"""Classification algorithms (counterpart of ``heat_tpu/classification``)."""

from .kneighborsclassifier import KNeighborsClassifier

__all__ = ["KNeighborsClassifier"]
