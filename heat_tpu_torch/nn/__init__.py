"""Neural-network modules (counterpart of ``heat_tpu/nn``): the transformer
LM and the W8A8 dense layer, as ``torch.nn.Module``s."""

from .quant_dense import QuantDense
from .transformer import LayerNorm, MultiHeadAttention, TransformerBlock, TransformerLM

__all__ = ["LayerNorm", "MultiHeadAttention", "QuantDense", "TransformerBlock", "TransformerLM"]
