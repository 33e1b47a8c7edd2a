"""Clustering (counterpart of ``heat_tpu/cluster``)."""

from .kmeans import KMeans
from .kmedians import KMedians
from .kmedoids import KMedoids
from .spectral import Spectral

__all__ = ["KMeans", "KMedians", "KMedoids", "Spectral"]
