"""Row LayerNorm kernel (csrc/layernorm.cu) and its plain PyTorch version.

Replaces the TPU kernels layernorm_2d and layernorm_3d of
embodied_captioning_tpu/ops/pallas/layernorm.py: a contiguous [B, T, D]
tensor is [B*T, D] without a copy, so one kernel takes any leading shape.
Two statistics modes: two-pass (the TPU kernel; the JAX package's default
for float32 input) and one-pass with a relative floor (the JAX package's
default for bf16 input). On a CUDA tensor the wrapper launches the kernel;
on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _lib

_KINDS = (torch.bfloat16, torch.float32)
_F32 = (torch.float32,)


def layernorm_plain(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                    eps: float = 1e-5, out_dtype=None,
                    two_pass: Optional[bool] = None) -> torch.Tensor:
    """LayerNorm over the last axis with float32 statistics. Two-pass:
    var = mean((x - m)^2). One-pass: var = max(E[x^2] - m^2, m^2 * 3e-7)
    (a near-constant row cannot cancel to 0 and be amplified by
    1/sqrt(eps)). `two_pass=None` takes one-pass for bf16 input and
    two-pass otherwise."""
    out_dtype = out_dtype or x.dtype
    if two_pass is None:
        two_pass = x.dtype != torch.bfloat16
    xf = x.float()
    m1 = xf.mean(dim=-1, keepdim=True)
    if two_pass:
        var = torch.square(xf - m1).mean(dim=-1, keepdim=True)
    else:
        var = torch.maximum((xf * xf).mean(dim=-1, keepdim=True) - m1 * m1,
                            m1 * m1 * 3e-7)
    y = (xf - m1) * torch.rsqrt(var + eps) * g + b
    return y.to(out_dtype)


def layernorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5, out_dtype=None,
              two_pass: Optional[bool] = None) -> torch.Tensor:
    """x [..., D] bf16 or f32; g, b [D] f32 -> [..., D] in `out_dtype`
    (bf16 or f32; defaults to x's). See `layernorm_plain` for the modes."""
    if _lib.dispatch_device(x) == "cpu":
        return layernorm_plain(x, g, b, eps, out_dtype, two_pass)
    out_dtype = out_dtype or x.dtype
    if two_pass is None:
        two_pass = x.dtype != torch.bfloat16
    if out_dtype not in _KINDS:
        raise TypeError(f"out_dtype {out_dtype}, expected one of {_KINDS}")
    d = x.shape[-1]
    x = x.contiguous()
    # the kernel loads 16-byte vectors where x, g, b and out are 16-byte
    # aligned and a row is a multiple of 16 bytes, elements otherwise:
    # natural alignment is enough
    _lib.check(x, "x", _KINDS, align=x.element_size())
    # g and b are a model's parameters, the same tensors on every call
    _lib.check_param(g, "g", _F32, (d,), align=4)
    _lib.check_param(b, "b", _F32, (d,), align=4)
    out = (torch.empty_like(x) if out_dtype == x.dtype
           else torch.empty(x.shape, dtype=out_dtype, device=x.device))
    rows = x.numel() // d if d else 0
    _lib.call("ecap_layernorm", x.data_ptr(), g.data_ptr(), b.data_ptr(),
              out.data_ptr(), rows, d, float(eps), int(bool(two_pass)),
              int(x.dtype == torch.bfloat16),
              int(out_dtype == torch.bfloat16))
    _lib.launches["layernorm"] += 1
    return out
