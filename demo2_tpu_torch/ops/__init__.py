from .activations import quick_gelu
from .attention import MultiHeadAttention, attention_core
from .fused_block import fused_attention_block, fused_mlp_block
from .norm import BNNeck, LayerNorm, TorchBatchNorm
