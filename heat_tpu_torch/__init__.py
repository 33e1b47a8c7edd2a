"""heat_tpu_torch: the PyTorch/CUDA port of the heat_tpu package.

SPMD over ``torch.distributed`` (one process per GPU, as the original
Heat), with split-axis DNDarrays whose ``larray`` is the rank-local
``torch.Tensor``. Entry points run on the card (``cuda:0`` unless the
process chose another device) unless the caller asks for the CPU with
``device="cpu"`` or ``use_device("cpu")``.

Two paths are ported, each with hand-written CUDA kernels (``csrc/``):
  - the array path: ``array(x, split=0)`` → elementwise arithmetic →
    ``mean``/``var``/``std`` → ``spatial.cdist`` → ``cluster.KMeans.fit``
    (kernels for the column moments, the fused cdist and the Lloyd step);
  - inference: ``nn.TransformerLM`` with ``attn_impl="flash"`` (the
    flash-attention forward kernel) and the W8A8 path
    ``core.linalg.int8_matmul``/``matmul_int8``/``nn.QuantDense`` (the int8
    GEMM kernel).
"""

from .core import *
from . import core
from . import cluster
from . import spatial
from . import parallel
from . import nn
from . import interop
from ._build import launch_counts, reset_launch_counts

__version__ = "0.1.0"
