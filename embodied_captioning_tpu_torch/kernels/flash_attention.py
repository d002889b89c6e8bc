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
    """q, k, v contiguous bf16 [B, H, T, D] (D in 32, 64, 128) -> bf16
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
    if d not in (32, 64, 128):
        raise ValueError(f"flash_attention supports head dims 32/64/128, "
                         f"got {d}")
    vl = t if valid_len is None else int(valid_len)
    if not 1 <= vl <= t:
        raise ValueError(f"valid_len {vl} outside [1, {t}]")
    o = torch.empty_like(q)
    _lib.call("ecap_flash_attention", q.data_ptr(), k.data_ptr(),
              v.data_ptr(), o.data_ptr(), b * h, t, d, int(causal), vl,
              1.0 / math.sqrt(d))
    _lib.launches["flash_attention"] += 1
    return o
