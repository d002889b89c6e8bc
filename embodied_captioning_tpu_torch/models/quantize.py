"""Per-channel symmetric int8 weights, int8 activations (W8A8) and int8
cross-attention K/V.

Dequantization happens in bfloat16 (`q.bf16 * scale.bf16`), exactly as the
JAX package does it; dequantizing in float32 shifts logits enough to flip
greedy tokens.

The serving opt-ins are arguments, threaded from `perception.perceive`
down to `common.dense` and `common.precompute_kv`: `w8a8` (default off)
runs every product with an int8 weight as int8 x int8 -> int32
(`dense_w8a8`); `int8_kv` (default on) quantizes the precomputed
cross-attention K/V where the projections are int8.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

MIN_QUANT_SIZE = 1 << 14  # smaller tensors (biases, norms) stay float


_RECIP_127 = float(np.float32(1.0) / np.float32(127.0))


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


def _int_mm_padded(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 a [M, K] @ int8 b [K, N] -> int32 [M, N] through `torch._int_mm`.
    On the card it takes more than 16 rows and K, N multiples of 8: a shape
    outside that is padded with zero rows and columns and the result
    sliced, which leaves every integer sum as it was."""
    m, k = a.shape
    n = b.shape[1]
    pm = max(17 - m, 0) if a.is_cuda else 0
    pk, pn = -k % 8, -n % 8
    if pm or pk:
        a = torch.nn.functional.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = torch.nn.functional.pad(b, (0, pn, 0, pk))
    y = torch._int_mm(a.contiguous(), b.contiguous())
    return y[:m, :n] if (pm or pn) else y


def dense_w8a8(x: torch.Tensor, w: QuantizedArray) -> torch.Tensor:
    """[..., in] x QuantizedArray[in, out] -> float32 [..., out]: x
    quantized per token (symmetric, its own scale a row), the product
    int8 x int8 -> int32, then `y * sx * w.scale` in that order. The
    scale is `max(amax, 1e-8) * (1/127)` with the reciprocal rounded to
    float32: the product XLA's CPU compiler makes of the JAX package's
    jitted `/ 127.0` (ROADMAP C.10). The reciprocal is a host scalar, so
    no copy to the card (and no wait for it) precedes each product: a
    float32 tensor times a scalar that float32 holds exactly is the same
    product on the card and on the CPU."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    sx = torch.clamp(amax, min=1e-8) * _RECIP_127
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    lead = x.shape[:-1]
    y = _int_mm_padded(xq.reshape(-1, x.shape[-1]), w.q)
    return y.reshape(*lead, -1).float() * sx * w.scale


def quantization_ratio(params: Any) -> float:
    """Fraction of parameter bytes stored as int8, counted as the JAX
    package counts it: an int8 leaf its `q.size` bytes (its scales not
    counted), every other leaf `size * 4`, whatever its dtype."""
    total = q8 = 0

    def walk(node: Any) -> None:
        nonlocal total, q8
        if node is None:
            return
        if isinstance(node, QuantizedArray):
            total += node.q.numel()
            q8 += node.q.numel()
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):  # NamedTuples too
            for v in node:
                walk(v)
        else:
            total += (node.numel() if isinstance(node, torch.Tensor)
                      else int(np.size(node))) * 4

    walk(params)
    return q8 / max(total, 1)


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
    """kt [B,H,Dh,K], v [B,K,H,Dh] (bf16) -> QuantizedKV. The scales are
    `max(amax, 1e-8) * (1/127)`, as in `dense_w8a8`: the JAX package's
    `quantize_kv` runs inside the jitted `perceive`."""
    kt_f = kt.float()
    kt_scale = torch.clamp(kt_f.abs().amax(dim=2), min=1e-8) * _RECIP_127
    kt_q = torch.clamp(torch.round(kt_f / kt_scale[:, :, None, :]),
                       -127, 127).to(torch.int8)
    v_f = v.float()
    v_scale = torch.clamp(v_f.abs().amax(dim=1), min=1e-8) * _RECIP_127
    v_q = torch.clamp(torch.round(v_f / v_scale[:, None, :, :]),
                      -127, 127).to(torch.int8)
    return QuantizedKV(kt_q, kt_scale, v_q, v_scale)
