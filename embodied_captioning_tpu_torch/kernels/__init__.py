"""Hand-written CUDA kernels for Hopper (sm_90a) with their plain PyTorch
versions. A wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors; `launches` counts kernel launches per wrapper."""

from ._lib import build, launches, reset_launches
from .decode_attention import (
    decode_cross_attention, decode_cross_attention_plain, decode_cross_block,
    decode_cross_block_plain, decode_mlp, decode_mlp_plain,
    decode_self_attention, decode_self_attention_plain, decode_self_block,
    decode_self_block_plain,
)
from .flash_attention import flash_attention, flash_attention_plain
from .layernorm import (
    layernorm, layernorm_bwd, layernorm_bwd_plain, layernorm_plain,
)
from .preprocess import fused_preprocess, fused_preprocess_plain
from .raycast import raycast_minargmin, raycast_minargmin_plain

__all__ = [
    "build", "launches", "reset_launches",
    "flash_attention", "flash_attention_plain",
    "decode_self_attention", "decode_self_attention_plain",
    "decode_cross_attention", "decode_cross_attention_plain",
    "decode_mlp", "decode_mlp_plain",
    "decode_self_block", "decode_self_block_plain",
    "decode_cross_block", "decode_cross_block_plain",
    "fused_preprocess", "fused_preprocess_plain",
    "layernorm", "layernorm_plain", "layernorm_bwd", "layernorm_bwd_plain",
    "raycast_minargmin", "raycast_minargmin_plain",
]
