"""Clustering (counterpart of ``heat_tpu/cluster``)."""

from .kmeans import KMeans

__all__ = ["KMeans"]
