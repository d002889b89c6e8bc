"""Per-channel symmetric int8 weights and int8 cross-attention K/V.

Dequantization happens in bfloat16 (`q.bf16 * scale.bf16`), exactly as the
JAX package does it; dequantizing in float32 shifts logits enough to flip
greedy tokens.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

MIN_QUANT_SIZE = 1 << 14  # smaller tensors (biases, norms) stay float


class QuantizedArray(NamedTuple):
    """w ~= q * scale; q int8 [..., out], scale f32 [out]."""

    q: torch.Tensor
    scale: torch.Tensor

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        return self.q.to(dtype) * self.scale.to(dtype)


class QuantizedKV(NamedTuple):
    """int8 cross-attention K/V with scales constant along each contraction:
    kt int8 [B,H,Dh,K] with kt_scale f32 [B,H,K]; v int8 (head-major after
    `precompute_kv`) with v_scale f32 [B,H,Dh]."""

    kt: torch.Tensor
    kt_scale: torch.Tensor
    v: torch.Tensor
    v_scale: torch.Tensor


def quantize_array(w: torch.Tensor, axis: int = -1) -> QuantizedArray:
    """Per-channel symmetric int8 quantization along `axis`."""
    axis = axis % w.dim()
    red = tuple(i for i in range(w.dim()) if i != axis)
    amax = torch.amax(w.abs(), dim=red, keepdim=True)
    # divided by a tensor on w's device: a CUDA division by a host scalar
    # multiplies by its rounded reciprocal, and the scales would differ
    # from the CPU's (and the JAX package's) in the last bit
    scale = torch.clamp(amax, min=1e-8) / amax.new_tensor(127.0)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return QuantizedArray(q, scale.reshape(-1).to(torch.float32))


def maybe_dequant(w: Any, dtype=torch.bfloat16) -> torch.Tensor:
    if isinstance(w, QuantizedArray):
        return w.dequantize(dtype)
    return w.to(dtype)


def quantize_params(params: Any, min_size: int = MIN_QUANT_SIZE) -> Any:
    """Quantize every leaf named "w" with ndim >= 2 and >= `min_size`
    elements per output channel (last axis of a dense kernel, axis 0 of an
    OIHW conv kernel); embeddings and small tensors stay as they are."""

    def walk(node: Any, name: str) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, QuantizedArray):
            return node
        if hasattr(node, "_fields"):  # NamedTuple containers
            return type(node)(*(walk(getattr(node, f), "")
                                for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, "") for v in node)
        if (name == "w" and isinstance(node, torch.Tensor)
                and node.dim() >= 2 and node.numel() >= min_size):
            return quantize_array(node, axis=0 if node.dim() == 4 else -1)
        return node

    return walk(params, "")


def quantize_kv(kt: torch.Tensor, v: torch.Tensor) -> QuantizedKV:
    """kt [B,H,Dh,K], v [B,K,H,Dh] (bf16) -> QuantizedKV."""
    kt_f = kt.float()
    kt_scale = torch.clamp(kt_f.abs().amax(dim=2), min=1e-8) / 127.0
    kt_q = torch.clamp(torch.round(kt_f / kt_scale[:, :, None, :]),
                       -127, 127).to(torch.int8)
    v_f = v.float()
    v_scale = torch.clamp(v_f.abs().amax(dim=1), min=1e-8) / 127.0
    v_q = torch.clamp(torch.round(v_f / v_scale[:, None, :, :]),
                      -127, 127).to(torch.int8)
    return QuantizedKV(kt_q, kt_scale, v_q, v_scale)
