"""Graph algorithms (counterpart of ``heat_tpu/graph``): the Laplacian and
connected components."""

from .components import connected_components
from .laplacian import Laplacian

__all__ = ["Laplacian", "connected_components"]
