"""Graph algorithms (counterpart of ``heat_tpu/graph``): the Laplacian."""

from .laplacian import Laplacian

__all__ = ["Laplacian"]
