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

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

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


# the generic backward's row groups, each with its float32 partials of dg
# and db (2 x BWD_PARTS x d floats of scratch at most)
BWD_PARTS = 256
# the register path: warps a block holds (BWD_FEW_WARPS for a few rows),
# blocks a cluster holds where there is more than one cluster, bytes of x
# and dy a lane may hold for one row
BWD_WARPS = 8
BWD_FEW_WARPS = 4
BWD_CLUSTER = 4
BWD_ROW_BYTES = 192


class BwdPlan(NamedTuple):
    """The backward's launch geometry (`bwd_plan`)."""
    route: str          # "registers" or "generic"
    vectors: int        # chunks of 8 columns a lane holds (0: generic)
    blocks: int
    warps: int          # warps a block holds
    cluster: int        # blocks a cluster holds (1 on the generic path)
    rows_per: int       # the most rows a warp (registers) or block takes
    partials: int       # rows of float32 dg and db partials in scratch
    scratch_floats: int
    launches: int       # kernel launches a call


def bwd_vectors(d: int, x_bytes: int, dy_bytes: int) -> int:
    """Chunks of 8 columns a lane holds on the backward's register path for
    rows of d elements of x_bytes and dy_bytes each; 0 where the rows take
    the generic path (d not a multiple of 8, wider than 1024, or more than
    BWD_ROW_BYTES of x and dy a lane: float32 x and dy past 768)."""
    if d % 8 or d > 1024:
        return 0
    v = -(-d // 256)
    return v if v * 8 * (x_bytes + dy_bytes) <= BWD_ROW_BYTES else 0


def bwd_plan(rows: int, d: int, x_bytes: int, dy_bytes: int, slots: int,
             widest: int, aligned: bool = True) -> BwdPlan:
    """The backward's launch geometry for `rows` rows of `d` (x and dy of
    x_bytes and dy_bytes an element), on a card that holds `slots`
    clusters of BWD_CLUSTER register-path blocks at once and launches
    clusters of at most `widest` few-row blocks (`bwd_room`); `aligned`:
    x, dy, dx and g all 16-byte aligned.

    Register path: rows that fit one cluster of `widest` blocks of
    BWD_FEW_WARPS warps (at most 64 rows, a row a warp) take that one
    cluster, one block an SM, which writes dg and db itself (one launch):
    the rows' arithmetic spreads over twice the SMs that blocks of
    BWD_WARPS would take. Other rows take a row a warp in full blocks of
    BWD_WARPS warps, up to the blocks the card holds at once; past that
    every such block, its warps splitting the rows evenly into contiguous
    runs. These form clusters of BWD_CLUSTER; one cluster writes dg and db
    itself, more each write a partial row of dg and db (2 d floats), which
    a second launch sums. Generic path: up to BWD_PARTS row groups, one
    block each, each writing a partial row, which a second launch sums."""
    if rows < 1 or d < 1:
        raise ValueError(f"layernorm_bwd needs rows of at least one "
                         f"element, got {rows} x {d}")
    v = bwd_vectors(d, x_bytes, dy_bytes) if aligned else 0
    if v == 0:
        per = -(-rows // min(rows, BWD_PARTS))
        parts = -(-rows // per)  # every group holds at least one row
        # as many warps as fit 48 KB of accumulators, 1 to 8
        warps = min(8, max(1, 48 * 1024 // (8 * d)))
        return BwdPlan("generic", 0, parts, warps, 1, per, parts,
                       2 * parts * d, 2)
    blocks = -(-rows // BWD_FEW_WARPS)
    if rows <= 8 * BWD_WARPS and blocks <= widest:
        return BwdPlan("registers", v, blocks, BWD_FEW_WARPS, blocks, 1, 0,
                       0, 1)
    blocks = min(max(1, slots) * BWD_CLUSTER, -(-rows // BWD_WARPS))
    cluster = BWD_CLUSTER
    blocks = -(-blocks // cluster) * cluster
    clusters = blocks // cluster
    partials = clusters if clusters > 1 else 0
    return BwdPlan("registers", v, blocks, BWD_WARPS, cluster,
                   -(-rows // (blocks * BWD_WARPS)), partials,
                   2 * partials * d, 2 if partials else 1)


# per device index: (the clusters of BWD_CLUSTER its SMs hold at once, the
# widest few-row cluster it launches); per (device index, stream): the
# backward's scratch
_room: Dict[int, Tuple[int, int]] = {}
_scratch: Dict[Tuple[Optional[int], int], torch.Tensor] = {}


def bwd_room(device: torch.device) -> Tuple[int, int]:
    """(clusters of BWD_CLUSTER register-path blocks `device` holds at
    once, the most blocks of BWD_FEW_WARPS warps, one an SM, that it
    launches as one cluster: 16 at most), asked of the CUDA runtime once
    per device."""
    room = _room.get(device.index)
    if room is None:
        slots, widest = ctypes.c_int(0), ctypes.c_int(0)
        _lib.call("ecap_layernorm_bwd_slots", BWD_CLUSTER,
                  ctypes.addressof(slots), ctypes.addressof(widest))
        if slots.value < 1:
            raise RuntimeError(f"no cluster of {BWD_CLUSTER} backward "
                               f"blocks fits on {device}")
        room = _room[device.index] = (slots.value, widest.value)
    return room


def bwd_scratch(device: torch.device, floats: int) -> torch.Tensor:
    """The backward's scratch on `device` for the current stream, at least
    `floats` long (at least one), kept across calls so that a call
    allocates no partials. Each stream has its own, so that backwards in
    flight on two streams at once do not share one."""
    key = (device.index, _lib.current_stream())
    buf = _scratch.get(key)
    if buf is None or buf.numel() < floats:
        buf = _scratch[key] = torch.empty(
            max(1, floats), dtype=torch.float32, device=device)
    return buf


def layernorm_bwd(x: torch.Tensor, g: torch.Tensor, dy: torch.Tensor,
                  eps: float = 1e-5, two_pass: Optional[bool] = None):
    """x [..., D] bf16 or f32, g [D] f32, dy [..., D] bf16 or f32 (the
    output's cotangent) -> (dx like x, dg [D] f32, db [D] f32); see
    `layernorm_bwd_plain`. On a CUDA tensor: the backward kernel with the
    geometry of `bwd_plan` (one or two launches), counted once."""
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
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, dy, dx, g))
    plan = bwd_plan(rows, d, x.element_size(), dy.element_size(),
                    *bwd_room(x.device), aligned)
    scratch = bwd_scratch(x.device, plan.scratch_floats)
    dg = torch.empty(d, dtype=torch.float32, device=x.device)
    db = torch.empty_like(dg)
    _lib.call("ecap_layernorm_bwd", x.data_ptr(), g.data_ptr(), dy.data_ptr(),
              dx.data_ptr(), dg.data_ptr(), db.data_ptr(), scratch.data_ptr(),
              rows, d, float(eps), int(bool(two_pass)),
              int(x.dtype == torch.bfloat16), int(dy.dtype == torch.bfloat16),
              plan.vectors, plan.blocks, plan.cluster, plan.warps)
    _lib.launches["layernorm_bwd"] += 1
    return dx, dg, db
