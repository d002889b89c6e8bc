"""Flash attention: the CUDA kernel (csrc/flash_attention.cu) and its plain
PyTorch version.

Replaces the TPU kernel embodied_captioning_tpu/ops/pallas/
flash_attention.py:flash_attention. On a CUDA tensor the wrapper launches
the kernel; on a CPU tensor it runs `flash_attention_plain`.

The kernel has no backward, as the TPU kernel has none: where autograd
records and q, k or v needs a gradient the wrapper raises, on either
device, rather than return an output that gradients cannot cross.
`models/common.mha` sends such calls to its plain attention.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _lib

NEG_INF = -1e30
# head dims with a kernel instance (8 and 16: the query detector's decoder,
# computed 16 wide on the tensor cores)
HEAD_DIMS = (8, 16, 32, 64, 128)
# head dims of the warpgroup kernel (flash_wg); the smaller ones take the
# mma.sync kernels (flash_head / flash_stream)
WG_HEAD_DIMS = (64, 128)
KEY_TILE = 64          # keys a flash_wg K/V tile
MMA_SYNC = -1          # `flash_plan`: the mma.sync kernels
TWO_PASS = 0           # `flash_plan`: flash_wg, S recomputed in a second pass


def flash_plan(d: int, t: int, valid_len: Optional[int] = None) -> int:
    """The kernel a [.., t, d] call takes (csrc/flash_attention.cu):
    MMA_SYNC for head dims 8-32, whose 64-row warpgroup products would be
    mostly padding; for 64 and 128 flash_wg, with the whole row of scores
    in registers over n key tiles (returns n) where the live keys fit them
    at D = 64 (at most 4 tiles, or 4 tiles and 16 keys: T = 257 is 272
    scores, 136 registers a thread), else in two passes (TWO_PASS)."""
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention supports head dims {HEAD_DIMS}, "
                         f"got {d}")
    if d not in WG_HEAD_DIMS:
        return MMA_SYNC
    kend = min(t, valid_len or t)
    n = -(-kend // KEY_TILE)
    if d == 64 and (n <= 4 or (n == 5 and kend - KEY_TILE * 4 <= 16)):
        return n
    return TWO_PASS


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False,
                          valid_len: Optional[int] = None) -> torch.Tensor:
    """q, k, v [B, H, T, D] -> [B, H, T, D] in q's dtype. The TPU
    single-block kernel's numerics: f32 scores from the input-precision
    operands, f32 softmax, probabilities normalised and then rounded to
    bf16 before the PV product with f32 accumulation. Keys at index >=
    `valid_len` are masked."""
    t, d = q.shape[-2], q.shape[-1]
    vl = valid_len or t
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (
        1.0 / math.sqrt(d))
    cols = torch.arange(t, device=q.device)
    if vl < t:
        s = torch.where(cols < vl, s, NEG_INF)
    if causal:
        s = torch.where(cols[:, None] >= cols[None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    p = (p / torch.clamp(l, min=1e-30)).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    valid_len: Optional[int] = None) -> torch.Tensor:
    """q, k, v contiguous bf16 [B, H, T, D] (D in `HEAD_DIMS`) -> bf16
    [B, H, T, D]. Any T; keys at index >= `valid_len` are masked. Raises
    where autograd records and an input needs a gradient."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("flash_attention has no backward: call it under "
                           "torch.no_grad() or on inputs that need no "
                           "gradient")
    if _lib.dispatch_device(q) == "cpu":
        return flash_attention_plain(q, k, v, causal, valid_len)
    b, h, t, d = q.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        _lib.check(x, name, (torch.bfloat16,), (b, h, t, d))
    vl = t if valid_len is None else int(valid_len)
    if not 1 <= vl <= t:
        raise ValueError(f"valid_len {vl} outside [1, {t}]")
    kernel = flash_plan(d, t, vl)
    o = torch.empty_like(q)
    _lib.call("ecap_flash_attention", q.data_ptr(), k.data_ptr(),
              v.data_ptr(), o.data_ptr(), b * h, t, d, int(causal), vl,
              1.0 / math.sqrt(d), kernel)
    _lib.launches["flash_attention"] += 1
    return o
