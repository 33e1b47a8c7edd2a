"""heat_tpu_torch: the PyTorch/CUDA port of the heat_tpu package.

SPMD over ``torch.distributed`` (one process per GPU, as the original
Heat), with split-axis DNDarrays whose ``larray`` is the rank-local
``torch.Tensor``. Entry points run on the card (``cuda:0`` unless the
process chose another device) unless the caller asks for the CPU with
``device="cpu"`` or ``use_device("cpu")``.

This slice covers the main path: ``array(x, split=0)`` → elementwise
arithmetic → ``mean``/``var``/``std`` → ``spatial.cdist`` →
``cluster.KMeans.fit``, with hand-written CUDA kernels for the column
moments, the fused cdist and the Lloyd step (``csrc/``).
"""

from .core import *
from . import core
from . import cluster
from . import spatial
from . import interop
from ._build import launch_counts, reset_launch_counts

__version__ = "0.1.0"
