"""Clustering (counterpart of ``heat_tpu/cluster``)."""

from .kmeans import KMeans
from .spectral import Spectral

__all__ = ["KMeans", "Spectral"]
