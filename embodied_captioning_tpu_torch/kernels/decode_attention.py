"""Decode-step kernels: single-query self- and cross-attention and the
fused decode MLP (csrc/decode_attention.cu, csrc/decode_mlp.cu), each with
its plain PyTorch version.

They replace the TPU kernels decode_self_attention, decode_cross_attention
and decode_mlp of embodied_captioning_tpu/ops/pallas/decode_attention.py,
and follow those kernels' numerics (f32 probabilities; GELU in f32 after
the weight scale), which differ from the JAX package's XLA path. On a CUDA
tensor a wrapper launches its kernel; on a CPU tensor it runs the plain
version.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import _lib

NEG_INF = -1e30


def decode_self_attention_plain(q: torch.Tensor, kt: torch.Tensor,
                                v: torch.Tensor, pos: int) -> torch.Tensor:
    """q [B,H,Dh]; kt [B,H,Dh,T]; v [B,T,H,Dh] -> f32 [B,H,Dh]; keys at
    positions > pos are masked."""
    dh, t = q.shape[-1], kt.shape[-1]
    s = torch.einsum("bhd,bhdt->bht", q.float(), kt.float()) / math.sqrt(dh)
    live = torch.arange(t, device=q.device) <= pos
    s = torch.where(live, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.einsum("bht,bthd->bhd", p, v.float())
    return out / p.sum(dim=-1)[..., None]


def decode_self_attention(q: torch.Tensor, kt: torch.Tensor,
                          v: torch.Tensor, pos: int) -> torch.Tensor:
    """q bf16 [B,H,Dh]; cache kt bf16 [B,H,Dh,T], v bf16 [B,T,H,Dh]; pos
    the current position -> f32 [B,H,Dh]."""
    if _lib.dispatch_device(q) == "cpu":
        return decode_self_attention_plain(q, kt, v, pos)
    b, h, dh = q.shape
    t = kt.shape[-1]
    _lib.check(q, "q", (torch.bfloat16,))
    _lib.check(kt, "kt", (torch.bfloat16,), (b, h, dh, t))
    _lib.check(v, "v", (torch.bfloat16,), (b, t, h, dh))
    if not 0 <= pos < t:
        raise ValueError(f"pos {pos} outside the cache [0, {t})")
    out = torch.empty(b, h, dh, dtype=torch.float32, device=q.device)
    _lib.call("ecap_decode_self_attention", q.data_ptr(), kt.data_ptr(),
              v.data_ptr(), out.data_ptr(), b, h, dh, t, int(pos))
    _lib.launches["decode_self_attention"] += 1
    return out


def decode_cross_attention_plain(q: torch.Tensor, kt: torch.Tensor,
                                 v: torch.Tensor,
                                 kt_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """q [B,H,Dh]; kt [B,H,Dh,K]; v head-major [B,H,K,Dh] (int8 or bf16);
    kt_scale [B,H,K] multiplies the scores after 1/sqrt(Dh), v_scale
    [B,H,Dh] the output -> f32 [B,H,Dh]."""
    dh = q.shape[-1]
    s = torch.einsum("bhd,bhdk->bhk", q.float(), kt.float()) / math.sqrt(dh)
    if kt_scale is not None:
        s = s * kt_scale.float()
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.einsum("bhk,bhkd->bhd", p, v.float())
    if v_scale is not None:
        out = out * v_scale.float()
    return out / p.sum(dim=-1)[..., None]


def decode_cross_attention(q: torch.Tensor, kt: torch.Tensor,
                           v: torch.Tensor,
                           kt_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """q bf16 [B,H,Dh]; kt [B,H,Dh,K], v [B,H,K,Dh] both int8 (with f32
    scales) or both bf16 -> f32 [B,H,Dh]."""
    if _lib.dispatch_device(q) == "cpu":
        return decode_cross_attention_plain(q, kt, v, kt_scale, v_scale)
    b, h, dh = q.shape
    nk = kt.shape[-1]
    _lib.check(q, "q", (torch.bfloat16,))
    _lib.check(kt, "kt", (torch.int8, torch.bfloat16), (b, h, dh, nk))
    _lib.check(v, "v", (kt.dtype,), (b, h, nk, dh))
    ks_ptr = vs_ptr = None
    if kt_scale is not None:
        _lib.check(kt_scale, "kt_scale", (torch.float32,), (b, h, nk))
        ks_ptr = kt_scale.data_ptr()
    if v_scale is not None:
        _lib.check(v_scale, "v_scale", (torch.float32,), (b, h, dh))
        vs_ptr = v_scale.data_ptr()
    out = torch.empty(b, h, dh, dtype=torch.float32, device=q.device)
    _lib.call("ecap_decode_cross_attention", q.data_ptr(), kt.data_ptr(),
              v.data_ptr(), ks_ptr, vs_ptr, out.data_ptr(), b, h, dh, nk,
              int(kt.dtype == torch.int8))
    _lib.launches["decode_cross_attention"] += 1
    return out


def decode_mlp_plain(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                     wfc: torch.Tensor, sfc: torch.Tensor, bfc: torch.Tensor,
                     wpj: torch.Tensor, spj: torch.Tensor, bpj: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """x [B,D] bf16 -> x + proj(gelu(fc(ln(x)))) in x's dtype. wfc [D,F],
    wpj [F,D] int8 or float with per-output-channel scales sfc [F], spj [D]
    applied after the dot; GELU (tanh) in f32."""
    xf = x.float()
    m1 = xf.mean(dim=1, keepdim=True)
    var = torch.maximum((xf * xf).mean(dim=1, keepdim=True) - m1 * m1,
                        m1 * m1 * 3e-7)
    xn = (xf - m1) * torch.rsqrt(var + eps) * g.float() + b.float()
    h = torch.matmul(xn.to(torch.bfloat16).float(),
                     wfc.to(torch.bfloat16).float())
    h = F.gelu(h * sfc.float() + bfc.float(), approximate="tanh")
    y = torch.matmul(h.to(torch.bfloat16).float(),
                     wpj.to(torch.bfloat16).float())
    y = y * spj.float() + bpj.float()
    return (xf + y).to(x.dtype)


def decode_mlp(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               wfc: torch.Tensor, sfc: torch.Tensor, bfc: torch.Tensor,
               wpj: torch.Tensor, spj: torch.Tensor, bpj: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """x bf16 [B,D]; LN g, b f32 [D]; wfc [D,F] and wpj [F,D] both int8 or
    both bf16; scales and biases f32 -> bf16 [B,D]. Two launches (see
    csrc/decode_mlp.cu), counted as one call."""
    if _lib.dispatch_device(x) == "cpu":
        return decode_mlp_plain(x, g, b, wfc, sfc, bfc, wpj, spj, bpj, eps)
    bsz, d = x.shape
    f = wfc.shape[-1]
    f32 = (torch.float32,)
    _lib.check(x, "x", (torch.bfloat16,))
    _lib.check(g, "g", f32, (d,))
    _lib.check(b, "b", f32, (d,))
    _lib.check(wfc, "wfc", (torch.int8, torch.bfloat16), (d, f))
    _lib.check(wpj, "wpj", (wfc.dtype,), (f, d))
    _lib.check(sfc, "sfc", f32, (f,))
    _lib.check(bfc, "bfc", f32, (f,))
    _lib.check(spj, "spj", f32, (d,))
    _lib.check(bpj, "bpj", f32, (d,))
    h = torch.empty(bsz, f, dtype=torch.bfloat16, device=x.device)
    out = torch.empty_like(x)
    _lib.call("ecap_decode_mlp", x.data_ptr(), g.data_ptr(), b.data_ptr(),
              wfc.data_ptr(), sfc.data_ptr(), bfc.data_ptr(), wpj.data_ptr(),
              spj.data_ptr(), bpj.data_ptr(), h.data_ptr(), out.data_ptr(),
              bsz, d, f, float(eps), int(wfc.dtype == torch.int8))
    _lib.launches["decode_mlp"] += 1
    return out
