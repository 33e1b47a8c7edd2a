"""heat_tpu_torch: the PyTorch/CUDA port of the heat_tpu package.

SPMD over ``torch.distributed`` (one process per GPU, as the original
Heat), with split-axis DNDarrays whose ``larray`` is the rank-local
``torch.Tensor``. Entry points run on the card (``cuda:0`` unless the
process chose another device) unless the caller asks for the CPU with
``device="cpu"`` or ``use_device("cpu")``.

Ported paths, with hand-written CUDA kernels (``csrc/``) where the JAX
package has a Pallas kernel:
  - the array path: ``array(x, split=0)`` → elementwise arithmetic →
    ``mean``/``var``/``std`` → ``spatial.cdist`` → ``cluster.KMeans.fit``
    (kernels for the column moments, the fused cdist and the Lloyd step);
  - inference and training: ``nn.TransformerLM`` with ``attn_impl="flash"``
    (the flash-attention forward and backward kernels) and the W8A8 path
    ``core.linalg.int8_matmul``/``matmul_int8``/``nn.QuantDense`` (the int8
    GEMM kernel);
  - distributed linear algebra: ``matmul`` (``a @ b``) and the rest of
    ``linalg``'s basics, ``linalg.qr`` (TSQR, CholeskyQR2) and
    ``linalg.svd``, over ``reduce_scatter``, ``all_to_all`` and
    ``ring_permute``; ``DNDarray.resplit`` between split axes is one
    ``all_to_all``. Their products and factorizations are cuBLAS and
    cuSOLVER through ``torch``, as the JAX package's are XLA's; the
    rounding, relational and logical operations come with them;
  - ``random``: the JAX package's ``jax.random`` stream reproduced (counter-
    mode threefry2x32 and its transforms), each rank drawing only its own
    chunk, on a kernel that computes the draw on the card; KMeans seeds
    from it as the JAX package does (``'random'`` and
    ``'probability_based'``);
  - the rest of the elementwise API (cumulative operations, the bitwise
    and remaining arithmetic, exponential, trigonometric and complex
    functions, printing) and the statistics (``argmax``/``argmin``,
    ``average``, ``bincount``, ``cov``, ``histogram``, ``skew``,
    ``kurtosis``, the nan-reductions, ``chunk_moments`` on the moments
    kernel, ``percentile`` and ``median``);
  - indexing and manipulations: ``x[key]`` and ``x[key] = v`` for every key
    numpy takes, ``nonzero``, ``where``, and the manipulations (``sort``,
    ``topk`` and ``unique`` distributed along the split axis by the odd-even
    merge-split network, ``concatenate``, ``reshape``, ``flip``, ``roll``,
    the stacks and splits, ``pad``, ``tile``, ``repeat``, ...);
  - the ``lasso`` and ``spectral`` paths: ``regression.Lasso`` (coordinate
    descent, one epoch a CUDA graph on one card), ``linalg.cg`` and
    ``linalg.lanczos``, ``graph.Laplacian`` and ``cluster.Spectral`` (on
    the cdist kernel's ``rbf`` epilogue and the Lloyd kernel), with the
    factories ``eye``/``linspace``/``logspace``/``meshgrid``,
    ``spatial.manhattan``, the type functions and names, the estimator
    mixins and the validation helpers. Exact products (bool and the
    integers) and the wide unsigned types compute on the card as in the JAX
    package;
  - the sparse arrays: ``sparse.SparseDNDarray`` with ``spmv``/``spmm``
    (torch's CSR product, cuSPARSE on the card, for float sums),
    ``transpose`` (``alltoallv``), ``csr_from_dense`` and ``csr_from_coo``;
    ``SplitTiles``, ``SquareDiagTiles``, ``Ragged``; the sparse eNeighbour
    ``graph.Laplacian``, ``cg``/``lanczos`` on a sparse operator, the
    sparse ``cluster.Spectral`` (the cdist and Lloyd kernels) and
    ``graph.connected_components``; and ``cluster.KMedians``,
    ``cluster.KMedoids``, ``naive_bayes.GaussianNB`` and
    ``classification.KNeighborsClassifier``;
  - sequence and data parallelism: ``parallel.ring_attention`` and
    ``parallel.ulysses_attention`` (the flash kernels under the latter with
    ``use_pallas=True``), ``TransformerLM(attn_impl="ring"|"ulysses",
    comm=...)``, the ring ``cdist``/``rbf``/``manhattan``,
    ``parallel.ring_pipeline``, ``parallel.halo_exchange``/``halo_stencil``,
    ``nn.functional``, ``nn.DataParallel`` (one flat all-reduce a step,
    blocking or double-buffered), ``nn.DataParallelMultiGPU``, ``nn.MoEMLP``
    (experts split over the ranks), and ``optim`` (``DataParallelOptimizer``,
    ``DASO``, ``DetectMetricPlateau``, the ``lr_scheduler`` factories);
  - out-of-core streaming: ``io`` (npy, CSV through the native parser,
    HDF5, NetCDF; ``load``/``save`` and the rest at the root, each rank
    reading its own slab), ``streaming.ChunkStream`` (row blocks sized from
    ``HEAT_TPU_HBM_BUDGET``), ``streaming.StreamingMoments`` (the moments
    kernel a chunk), ``streaming.MiniBatchKMeans`` (the Lloyd window on the
    Lloyd kernel), ``KMeans(checkpoint_every=...)``, and the substrate they
    stand on: ``resilience`` (checkpoints in the JAX package's format, the
    memory budget), ``telemetry`` and the knob registry ``_knobs``;
  - serving: ``serve.Server`` (the micro-batcher, the bucket ladder,
    admission, ``publish``, ``save``/``restore``) over the eight endpoint
    kinds, dispatched through ``core.program_cache``, a registry of CUDA
    graphs (one captured per bucket at the warm-up, replayed after; an
    endpoint's buckets share one set of parameter buffers), with
    the fault injector and the guarded retries of ``resilience``
    (``faults``, ``guard``, ``wrap_program``, ``memory_guard.preflight``)
    and ``telemetry.CompileWatcher``; and the replica tier ``serve.net``
    (the wire, ``HttpFront``, the replica process, ``ReplicaPool``,
    ``Router``), which ``streaming.rolling_update`` rolls.
"""

from . import telemetry
from . import resilience
from .core import *
from . import core
from .core import io
from .core import random
from .core.ragged import Ragged, ragged
from . import sparse
from . import cluster
from . import classification
from . import graph
from . import naive_bayes
from . import regression
from . import spatial
from . import parallel
from . import nn
from . import optim
from . import interop
from . import streaming
from . import serve
from ._build import launch_counts, reset_launch_counts
from .core.version import version as __version__

