"""Neural-network modules (counterpart of ``heat_tpu/nn``): the transformer
LM, the W8A8 dense layer and the mixture-of-experts layer as
``torch.nn.Module``s, the data-parallel wrappers, fully sharded data
parallelism (``FSDP``), pipeline training (``Pipeline``), and
``functional``.

As the reference Heat's ``heat.nn`` (:19-31), every other name falls through
to ``torch.nn`` (``heat_tpu_torch.nn.Linear`` is ``torch.nn.Linear``); the JAX
package falls through to flax.linen.
"""

from . import functional
from .data_parallel import DataParallel, DataParallelMultiGPU
from .fsdp import FSDP
from .moe import MoEMLP
from .pipeline import Pipeline
from .quant_dense import QuantDense
from .transformer import LayerNorm, MultiHeadAttention, TransformerBlock, TransformerLM

__all__ = ["DataParallel", "DataParallelMultiGPU", "FSDP", "LayerNorm", "MoEMLP",
           "MultiHeadAttention", "Pipeline", "QuantDense", "TransformerBlock", "TransformerLM",
           "functional"]


def __getattr__(name):
    """Fall through to torch.nn (reference heat/nn/__init__.py:19-31)."""
    import torch.nn

    try:
        return getattr(torch.nn, name)
    except AttributeError:
        raise AttributeError(
            f"module {name} not implemented in torch.nn or heat_tpu_torch.nn") from None
