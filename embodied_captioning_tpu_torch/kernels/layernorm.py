"""Row LayerNorm kernel (csrc/layernorm.cu) and its plain PyTorch version.

Replaces the TPU kernels layernorm_2d and layernorm_3d of
embodied_captioning_tpu/ops/pallas/layernorm.py: a contiguous [B, T, D]
tensor is [B*T, D] without a copy, so one kernel takes any leading shape.
Two statistics modes: two-pass (the TPU kernel; the JAX package's default
for float32 input) and one-pass with a relative floor (the JAX package's
default for bf16 input). On a CUDA tensor the wrapper launches the kernel;
on a CPU tensor it runs the plain version.

The backward (`layernorm_bwd`, the kernel `ecap_layernorm_bwd` in the same
source) is the counterpart of the JAX package's custom VJP of its Pallas
LayerNorm, `_ln_pallas_bwd` (embodied_captioning_tpu/models/common.py).
Where autograd records and an input needs a gradient, `layernorm` runs
through `_LayerNormFn`, whose forward is the forward above and whose
backward is `layernorm_bwd`: the kernel on the card, `layernorm_bwd_plain`
on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _lib

_KINDS = (torch.bfloat16, torch.float32)
_F32 = (torch.float32,)


def _row_stats(xf: torch.Tensor, eps: float, two_pass: bool):
    """(mean, 1/sqrt(var + eps)) of float32 rows, in the given mode."""
    m1 = xf.mean(dim=-1, keepdim=True)
    if two_pass:
        var = torch.square(xf - m1).mean(dim=-1, keepdim=True)
    else:
        var = torch.maximum((xf * xf).mean(dim=-1, keepdim=True) - m1 * m1,
                            m1 * m1 * 3e-7)
    return m1, torch.rsqrt(var + eps)


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
    m1, inv = _row_stats(xf, eps, two_pass)
    y = (xf - m1) * inv * g + b
    return y.to(out_dtype)


def layernorm_bwd_plain(x: torch.Tensor, g: torch.Tensor, dy: torch.Tensor,
                        eps: float = 1e-5, two_pass: Optional[bool] = None):
    """(dx in x's dtype, dg, db in g's dtype) of `layernorm_plain` for the
    output cotangent dy: `_ln_pallas_bwd`'s formula, dx = inv * (dxhat -
    mean(dxhat) - xhat * mean(dxhat * xhat)) with dxhat = dy * g, and dg,
    db summed over the rows, in float32; the row statistics in the
    forward's mode."""
    if two_pass is None:
        two_pass = x.dtype != torch.bfloat16
    xf, dyf = x.float(), dy.float()
    m1, inv = _row_stats(xf, eps, two_pass)
    xhat = (xf - m1) * inv
    dxhat = dyf * g.float()
    dx = inv * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    d = x.shape[-1]
    dg = (dyf * xhat).reshape(-1, d).sum(dim=0)
    db = dyf.reshape(-1, d).sum(dim=0)
    return dx.to(x.dtype), dg.to(g.dtype), db.to(g.dtype)


def layernorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5, out_dtype=None,
              two_pass: Optional[bool] = None) -> torch.Tensor:
    """x [..., D] bf16 or f32; g, b [D] f32 -> [..., D] in `out_dtype`
    (bf16 or f32; defaults to x's). See `layernorm_plain` for the modes.
    Differentiable (`_LayerNormFn`) where autograd records and an input
    needs a gradient."""
    if torch.is_grad_enabled() and (x.requires_grad or g.requires_grad
                                    or b.requires_grad):
        return _LayerNormFn.apply(x, g, b, eps, out_dtype, two_pass)
    return _layernorm(x, g, b, eps, out_dtype, two_pass)


def _layernorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               eps: float, out_dtype, two_pass: Optional[bool]
               ) -> torch.Tensor:
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


class _LayerNormFn(torch.autograd.Function):
    """`layernorm` with `layernorm_bwd` as its backward, on either
    device."""

    @staticmethod
    def forward(ctx, x, g, b, eps, out_dtype, two_pass):
        x = x.contiguous()
        ctx.save_for_backward(x, g)
        ctx.eps, ctx.two_pass = eps, two_pass
        return _layernorm(x, g, b, eps, out_dtype, two_pass)

    @staticmethod
    def backward(ctx, dy):
        x, g = ctx.saved_tensors
        dx, dg, db = layernorm_bwd(x, g, dy.contiguous(), ctx.eps,
                                   ctx.two_pass)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dg if need[1] else None,
                db if need[2] else None, None, None, None)


# the backward kernel's row groups, each with its float32 partials of dg
# and db (2 x BWD_PARTS x d floats of scratch at most)
BWD_PARTS = 256


def layernorm_bwd(x: torch.Tensor, g: torch.Tensor, dy: torch.Tensor,
                  eps: float = 1e-5, two_pass: Optional[bool] = None):
    """x [..., D] bf16 or f32, g [D] f32, dy [..., D] bf16 or f32 (the
    output's cotangent) -> (dx like x, dg [D] f32, db [D] f32); see
    `layernorm_bwd_plain`. On a CUDA tensor: the backward kernel, two
    launches (rows, then the column sums of the partials), counted once."""
    if _lib.dispatch_device(x) == "cpu":
        return layernorm_bwd_plain(x, g, dy, eps, two_pass)
    if two_pass is None:
        two_pass = x.dtype != torch.bfloat16
    d = x.shape[-1]
    _lib.check(x, "x", _KINDS, align=x.element_size())
    _lib.check(dy, "dy", _KINDS, tuple(x.shape), align=dy.element_size())
    _lib.check_param(g, "g", _F32, (d,), align=4)
    dx = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        raise ValueError(f"layernorm_bwd needs at least one row of x "
                         f"{tuple(x.shape)}")
    per = -(-rows // min(rows, BWD_PARTS))
    parts = -(-rows // per)  # every group holds at least one row
    dg = torch.empty(d, dtype=torch.float32, device=x.device)
    db = torch.empty_like(dg)
    part = torch.empty(2, parts, d, dtype=torch.float32, device=x.device)
    _lib.call("ecap_layernorm_bwd", x.data_ptr(), g.data_ptr(), dy.data_ptr(),
              dx.data_ptr(), dg.data_ptr(), db.data_ptr(), part.data_ptr(),
              rows, d, parts, float(eps), int(bool(two_pass)),
              int(x.dtype == torch.bfloat16), int(dy.dtype == torch.bfloat16))
    _lib.launches["layernorm_bwd"] += 1
    return dx, dg, db
