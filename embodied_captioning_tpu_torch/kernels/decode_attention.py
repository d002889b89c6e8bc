"""Decode-step kernels: single-query self- and cross-attention, the fused
decode MLP, and the whole self-attention and cross-attention sublayers of a
decoder block (csrc/decode_attention.cu, csrc/decode_mlp.cu,
csrc/decode_block.cu), each with its plain PyTorch version.

They replace the TPU kernels decode_self_attention, decode_cross_attention,
decode_mlp, decode_self_block and decode_cross_block of
embodied_captioning_tpu/ops/pallas/decode_attention.py, and follow those
kernels' numerics (f32 probabilities; GELU in f32 after the weight scale;
an f32 query in the block kernels), which differ from the JAX package's XLA
path. On a CUDA tensor a wrapper launches its kernel; on a CPU tensor it
runs the plain version.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

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


MAX_SMEM = 232448        # a block's shared memory on sm_90 (common.cuh)
# the self-attention kernels (csrc/attention.cuh): a block of four warps
# per (row, head), q.k split over Dh between the warps; the tiled kernel's
# K or V tiles of SELF_TILE_BYTES in a ring of SELF_STAGES buffers, its PV
# sums of up to four chunks of 128 dims a thread
SELF_ATTN_THREADS = 128
SELF_KEY_PARTS = SELF_ATTN_THREADS // 32
SELF_TILE_BYTES = 12288
SELF_STAGES = 2
SELF_TILED_MAX_DH = 4 * SELF_ATTN_THREADS


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def self_attn_smem(dh: int, t: int) -> int:
    """Shared memory of the whole-head self-attention kernel (the self
    block's attention launch, and `decode_self_attention` at caches it
    holds) at heads dh wide and a cache of t positions: q, the head's K and
    V cache blocks, the partial and final scores, a reduction scratch.
    Mirrors `self_attn_smem` in csrc/attention.cuh."""
    return (4 * (dh + (SELF_KEY_PARTS + 1) * t + SELF_ATTN_THREADS)
            + 2 * 2 * dh * t)


def self_attn_tile_keys(dh: int) -> int:
    """Keys per tile of the tiled self-attention kernel: SELF_TILE_BYTES of
    K or V, a multiple of 8 from 8 to 128. Mirrors `self_tile_keys`."""
    return min(max(SELF_TILE_BYTES // (2 * dh) // 8 * 8, 8), 128)


def self_attn_tiled_smem(dh: int, n: int) -> int:
    """Shared memory of the tiled self-attention kernel over n live keys:
    SELF_STAGES tile buffers (a K tile holds Dh rows of tk + 8 keys), q, a
    tile's partial scores, a reduction scratch and the scores of all n
    keys.
    Mirrors `self_tiled_smem` in csrc/attention.cuh."""
    tk = self_attn_tile_keys(dh)
    return (SELF_STAGES * _align16(2 * dh * (tk + 8)) + _align16(4 * dh)
            + 4 * SELF_KEY_PARTS * tk + 4 * SELF_ATTN_THREADS + 4 * n)


def self_attention_fits(dh: int, t: int) -> bool:
    """Whether `decode_self_attention` takes heads dh wide over a cache of
    t positions: a multiple of 8 wide, as the JAX package's dispatcher
    asks, with the head's cache in one block's shared memory (the
    whole-head kernel) or, up to SELF_TILED_MAX_DH wide, the scores of t
    keys (the tiled kernel: some 50,000 positions at Dh 64). Mirrors
    `self_attn_fits` in csrc/attention.cuh."""
    return (dh >= 8 and dh % 8 == 0 and t >= 1
            and (self_attn_smem(dh, t) <= MAX_SMEM
                 or (dh <= SELF_TILED_MAX_DH
                     and self_attn_tiled_smem(dh, t) <= MAX_SMEM)))


def decode_self_attention(q: torch.Tensor, kt: torch.Tensor,
                          v: torch.Tensor, pos: int) -> torch.Tensor:
    """q bf16 [B,H,Dh]; cache kt bf16 [B,H,Dh,T], v bf16 [B,T,H,Dh]; pos
    the current position -> f32 [B,H,Dh]; Dh and T as
    `self_attention_fits` takes them. The kernel reads positions 0..pos
    only."""
    if _lib.dispatch_device(q) == "cpu":
        return decode_self_attention_plain(q, kt, v, pos)
    b, h, dh = q.shape
    t = kt.shape[-1]
    if not self_attention_fits(dh, t):
        raise ValueError(f"decode_self_attention takes heads a multiple of "
                         f"8 wide over caches whose head or scores fit a "
                         f"block's shared memory; got Dh={dh}, {t} "
                         f"positions")
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


# the widest heads the cross-attention launch takes (csrc/attention.cuh:
# kCrossMaxDh); it takes any number of keys, in tiles past what one
# block's shared memory holds
CROSS_MAX_DH = 4096


def cross_attention_fits(dh: int) -> bool:
    """Whether the cross-attention kernel takes heads `dh` wide: a
    multiple of 8, as the JAX package's dispatcher asks, up to
    CROSS_MAX_DH."""
    return 8 <= dh <= CROSS_MAX_DH and dh % 8 == 0


def decode_cross_attention(q: torch.Tensor, kt: torch.Tensor,
                           v: torch.Tensor,
                           kt_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """q bf16 [B,H,Dh]; kt [B,H,Dh,K], v [B,H,K,Dh] both int8 (with f32
    scales) or both bf16 -> f32 [B,H,Dh]; Dh as `cross_attention_fits`
    takes it, K >= 1."""
    if _lib.dispatch_device(q) == "cpu":
        return decode_cross_attention_plain(q, kt, v, kt_scale, v_scale)
    b, h, dh = q.shape
    nk = kt.shape[-1]
    if not cross_attention_fits(dh) or nk < 1:
        raise ValueError(f"decode_cross_attention takes heads a multiple of "
                         f"8 wide up to {CROSS_MAX_DH} and at least one "
                         f"key; got Dh={dh}, {nk} keys")
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


def _ln_rows_bf16(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                  eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x as f32, one-pass LayerNorm of the bf16 rows with the relative
    variance floor, rounded to bf16)."""
    xf = x.float()
    m1 = xf.mean(dim=1, keepdim=True)
    var = torch.maximum((xf * xf).mean(dim=1, keepdim=True) - m1 * m1,
                        m1 * m1 * 3e-7)
    xn = (xf - m1) * torch.rsqrt(var + eps) * g.float() + b.float()
    return xf, xn.to(torch.bfloat16)


def _project(a: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
             bias: torch.Tensor) -> torch.Tensor:
    """bf16 a @ (int8 or float w as bf16) accumulated in f32, then
    `* scale + bias` in f32."""
    y = torch.matmul(a.float(), w.to(torch.bfloat16).float())
    return y * scale.float() + bias.float()


def decode_mlp_plain(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                     wfc: torch.Tensor, sfc: torch.Tensor, bfc: torch.Tensor,
                     wpj: torch.Tensor, spj: torch.Tensor, bpj: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """x [B,D] bf16 -> x + proj(gelu(fc(ln(x)))) in x's dtype. wfc [D,F],
    wpj [F,D] int8 or float with per-output-channel scales sfc [F], spj [D]
    applied after the dot; GELU (tanh) in f32."""
    xf, xn = _ln_rows_bf16(x, g, b, eps)
    h = F.gelu(_project(xn, wfc, sfc, bfc), approximate="tanh")
    y = _project(h.to(torch.bfloat16), wpj, spj, bpj)
    return (xf + y).to(x.dtype)


# the split-K products of the decode MLP and the self block
# (csrc/splitk.cuh)
MLP_COLS = 32          # output columns per block
MLP_MAX_SPLITS = 8     # blocks of one column tile: a portable cluster
MLP_MAX_SLICE = 512    # contraction per block
MLP_MAX_WIDTH = 1024   # the MLP's LayerNorm launch holds a row in registers
QKV_COLS = 64          # output columns per block of the self block's q/k/v
SM_COUNT = 132         # H100 SXM


def _splits(k: int, n: int, cols: int = MLP_COLS) -> int:
    """Splits of a K-long contraction for N output columns in blocks of
    `cols`: the fewest (a power of two, slices a multiple of 16 and at most
    MLP_MAX_SLICE long) that give at least one block per SM."""
    splits = 1
    while (2 * splits <= MLP_MAX_SPLITS and k % (32 * splits) == 0
           and (n // cols * splits < SM_COUNT
                or k // splits > MLP_MAX_SLICE)):
        splits *= 2
    if k // splits > MLP_MAX_SLICE:
        raise ValueError(f"a contraction of {k} does not split into "
                         f"slices of at most {MLP_MAX_SLICE}")
    return splits


def mlp_plan(rows: int, d: int, f: int) -> Tuple[int, int]:
    """(splits of the fc product's D-long contraction, splits of the proj
    product's F-long contraction) for `decode_mlp` at [rows, d] -> f -> d:
    each product's blocks are (columns / 32) x splits x ceil(rows / 64)."""
    if rows < 1:
        raise ValueError(f"decode_mlp needs at least one row, got {rows}")
    if d % MLP_COLS or f % MLP_COLS or not 0 < d <= MLP_MAX_WIDTH or f <= 0:
        raise ValueError(f"decode_mlp takes widths D and F that are "
                         f"multiples of {MLP_COLS}, D up to "
                         f"{MLP_MAX_WIDTH}; got D={d}, F={f}")
    return _splits(d, f), _splits(f, d)


def _takes(plan, *shape) -> bool:
    """Whether `plan` takes the shape (does not raise)."""
    try:
        plan(*shape)
    except ValueError:
        return False
    return True


def mlp_fits(rows: int, d: int, f: int) -> bool:
    """Whether `decode_mlp` takes [rows, d] -> f -> d."""
    return _takes(mlp_plan, rows, d, f)


def decode_mlp(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               wfc: torch.Tensor, sfc: torch.Tensor, bfc: torch.Tensor,
               wpj: torch.Tensor, spj: torch.Tensor, bpj: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """x bf16 [B,D]; LN g, b f32 [D]; wfc [D,F] and wpj [F,D] both int8 or
    both bf16; scales and biases f32 -> bf16 [B,D]. Three launches (see
    csrc/decode_mlp.cu), counted as one call; D and F as `mlp_plan`
    takes them."""
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
    s_fc, s_pj = mlp_plan(bsz, d, f)
    # h [B, F], then the LayerNorm output [B, D]
    scratch = torch.empty(bsz, f + d, dtype=torch.bfloat16, device=x.device)
    out = torch.empty_like(x)
    _lib.call("ecap_decode_mlp", x.data_ptr(), g.data_ptr(), b.data_ptr(),
              wfc.data_ptr(), sfc.data_ptr(), bfc.data_ptr(), wpj.data_ptr(),
              spj.data_ptr(), bpj.data_ptr(), scratch.data_ptr(),
              scratch.data_ptr() + 2 * bsz * f, out.data_ptr(), bsz, d, f,
              float(eps), int(wfc.dtype == torch.int8), s_fc, s_pj)
    _lib.launches["decode_mlp"] += 1
    return out


def self_block_plan(rows: int, d: int, heads: int, t: int
                    ) -> Tuple[int, int]:
    """(splits of the q/k/v product's D-long contraction, splits of the out
    product's) for `decode_self_block` at [rows, d] with `heads` heads and
    a cache of t positions: the q/k/v product's blocks are (3 d / 64) x
    splits x ceil(rows / 64), the out product's (d / 32) x splits x
    ceil(rows / 64). A q/k/v cluster spans the whole contraction, so it
    also holds the LayerNorm's rows. The attention launch holds a head's
    whole cache in shared memory, so a cache longer than that refuses."""
    if rows < 1:
        raise ValueError(f"decode_self_block needs at least one row, got "
                         f"{rows}")
    if d <= 0 or d % QKV_COLS or heads < 1 or d % heads or d // heads % 8:
        raise ValueError(f"decode_self_block takes a width that is a "
                         f"multiple of {QKV_COLS} and of the head count, "
                         f"with heads a multiple of 8 wide; got D={d}, "
                         f"{heads} heads")
    if self_attn_smem(d // heads, t) > MAX_SMEM:
        raise ValueError(f"decode_self_block holds a head's cache in shared "
                         f"memory: {t} positions of heads {d // heads} wide "
                         f"need {self_attn_smem(d // heads, t)} bytes, more "
                         f"than {MAX_SMEM}")
    return _splits(d, 3 * d, QKV_COLS), _splits(d, d)


def self_block_fits(rows: int, d: int, heads: int, t: int) -> bool:
    """Whether `decode_self_block` takes [rows, d] with `heads` heads and a
    cache of t positions."""
    return _takes(self_block_plan, rows, d, heads, t)


def decode_self_block_plain(x, g, b, wq, sq, bq, wk, sk, bk, wv, sv, bv,
                            wo, so, bo, kc: torch.Tensor, vc: torch.Tensor,
                            pos: int, heads: int, eps: float = 1e-5
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The cached self-attention sublayer for one token per row:
    x + o(attn(q(ln(x)))) over cache positions < pos and the current
    token, whose k and v (rounded to the cache dtype, the values attention
    uses) are written into kc [B,H,Dh,T] and vc [B,T,H,Dh] at `pos` in
    place. q stays f32. Returns (out [B,D] in x's dtype, kc, vc)."""
    bsz, d = x.shape
    dh, t = d // heads, kc.shape[-1]
    xf, xn = _ln_rows_bf16(x, g, b, eps)
    q = _project(xn, wq, sq, bq).reshape(bsz, heads, dh)
    k_cur = _project(xn, wk, sk, bk).to(kc.dtype).reshape(bsz, heads, dh)
    v_cur = _project(xn, wv, sv, bv).to(vc.dtype).reshape(bsz, heads, dh)
    k3, v3 = k_cur.float(), v_cur.float()
    s = torch.einsum("bhd,bhdt->bht", q, kc.float()) / math.sqrt(dh)
    live = torch.arange(t, device=x.device) < pos
    s = torch.where(live, s, NEG_INF)
    s_cur = (q * k3).sum(dim=-1) / math.sqrt(dh)
    m = torch.maximum(s.amax(dim=-1), s_cur)
    p = torch.exp(s - m[..., None])
    p_cur = torch.exp(s_cur - m)
    denom = p.sum(dim=-1) + p_cur
    out = (torch.einsum("bht,bthd->bhd", p, vc.float())
           + p_cur[..., None] * v3) / denom[..., None]
    y = _project(out.reshape(bsz, d).to(torch.bfloat16), wo, so, bo)
    kc[:, :, :, pos] = k_cur
    vc[:, pos] = v_cur
    return (xf + y).to(x.dtype), kc, vc


def _check_block_weights(x, g, b, weights, d) -> None:
    """x, the LayerNorm parameters and the (weight, scale, bias) triples of
    a block kernel: [D,D] weights of one dtype, f32 [D] vectors."""
    f32 = (torch.float32,)
    _lib.check(x, "x", (torch.bfloat16,))
    _lib.check(g, "g", f32, (d,))
    _lib.check(b, "b", f32, (d,))
    if d % 32:
        raise ValueError(f"the block kernels take widths that are multiples "
                         f"of 32, got {d}")
    wdtypes = (torch.int8, torch.bfloat16)
    for i, (w, s, bias) in enumerate(weights):
        _lib.check(w, f"weight {i}", wdtypes, (d, d))
        wdtypes = (w.dtype,)
        _lib.check(s, f"scale {i}", f32, (d,))
        _lib.check(bias, f"bias {i}", f32, (d,))


def decode_self_block(x, g, b, wq, sq, bq, wk, sk, bk, wv, sv, bv, wo, so,
                      bo, kc: torch.Tensor, vc: torch.Tensor, pos: int,
                      heads: int, eps: float = 1e-5
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x bf16 [B,D]; LN g, b f32 [D]; wq, wk, wv, wo [D,D] all int8 or all
    bf16, with f32 [D] per-output-channel scales and biases; caches kc bf16
    [B,H,Dh,T] and vc bf16 [B,T,H,Dh], read at positions < pos and written
    at `pos` in place -> (out bf16 [B,D], kc, vc). Three launches (see
    csrc/decode_block.cu), counted as one call; D, H and T as
    `self_block_plan` takes them."""
    if _lib.dispatch_device(x) == "cpu":
        return decode_self_block_plain(x, g, b, wq, sq, bq, wk, sk, bk, wv,
                                       sv, bv, wo, so, bo, kc, vc, pos,
                                       heads, eps)
    bsz, d = x.shape
    dh, t = d // heads, kc.shape[-1]
    _check_block_weights(x, g, b, ((wq, sq, bq), (wk, sk, bk), (wv, sv, bv),
                                   (wo, so, bo)), d)
    _lib.check(kc, "kc", (torch.bfloat16,), (bsz, heads, dh, t))
    _lib.check(vc, "vc", (torch.bfloat16,), (bsz, t, heads, dh))
    if not 0 <= pos < t:
        raise ValueError(f"pos {pos} outside the cache [0, {t})")
    s_qkv, s_out = self_block_plan(bsz, d, heads, t)
    q = torch.empty(bsz, d, dtype=torch.float32, device=x.device)
    attn = torch.empty_like(x)
    out = torch.empty_like(x)
    _lib.call("ecap_decode_self_block", x.data_ptr(), g.data_ptr(),
              b.data_ptr(), wq.data_ptr(), sq.data_ptr(), bq.data_ptr(),
              wk.data_ptr(), sk.data_ptr(), bk.data_ptr(), wv.data_ptr(),
              sv.data_ptr(), bv.data_ptr(), wo.data_ptr(), so.data_ptr(),
              bo.data_ptr(), kc.data_ptr(), vc.data_ptr(), q.data_ptr(),
              attn.data_ptr(), out.data_ptr(), bsz, d, heads, t, int(pos),
              float(eps), int(wq.dtype == torch.int8), s_qkv, s_out)
    _lib.launches["decode_self_block"] += 1
    return out, kc, vc


def decode_cross_block_plain(x, g, b, wq, sq, bq, wo, so, bo,
                             kt: torch.Tensor, v: torch.Tensor,
                             kt_scale: Optional[torch.Tensor] = None,
                             v_scale: Optional[torch.Tensor] = None,
                             heads: int = 8, eps: float = 1e-5
                             ) -> torch.Tensor:
    """The cross-attention sublayer for one token per row:
    x + o(attn(q(ln(x)))) over precomputed kt [B,H,Dh,K] and head-major v
    [B,H,K,Dh] (int8 with scales, or float). q stays f32; kt_scale
    multiplies the scores after 1/sqrt(Dh), v_scale the output before the
    division by the denominator."""
    bsz, d = x.shape
    dh = d // heads
    xf, xn = _ln_rows_bf16(x, g, b, eps)
    q = _project(xn, wq, sq, bq).reshape(bsz, heads, dh)
    s = torch.einsum("bhd,bhdk->bhk", q, kt.float()) / math.sqrt(dh)
    if kt_scale is not None:
        s = s * kt_scale.float()
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.einsum("bhk,bhkd->bhd", p, v.float())
    if v_scale is not None:
        out = out * v_scale.float()
    out = out / p.sum(dim=-1)[..., None]
    y = _project(out.reshape(bsz, d).to(torch.bfloat16), wo, so, bo)
    return (xf + y).to(x.dtype)


def cross_block_plan(rows: int, d: int, heads: int) -> Tuple[int, int]:
    """(splits of the q product's D-long contraction, splits of the out
    product's) for `decode_cross_block` at [rows, d] with `heads` heads:
    each product's blocks are (d / 32) x splits x ceil(rows / 64); a q
    cluster spans the whole contraction, so it also holds the LayerNorm's
    rows. The attention launch takes heads as `cross_attention_fits`
    does, over any number of keys."""
    if rows < 1:
        raise ValueError(f"decode_cross_block needs at least one row, got "
                         f"{rows}")
    if (d <= 0 or d % MLP_COLS or heads < 1 or d % heads
            or not cross_attention_fits(d // heads)):
        raise ValueError(f"decode_cross_block takes a width that is a "
                         f"multiple of {MLP_COLS} and of the head count, "
                         f"with heads a multiple of 8 wide; got D={d}, "
                         f"{heads} heads")
    return _splits(d, d), _splits(d, d)


def cross_block_fits(rows: int, d: int, heads: int) -> bool:
    """Whether `decode_cross_block` takes [rows, d] with `heads` heads."""
    return _takes(cross_block_plan, rows, d, heads)


def decode_cross_block(x, g, b, wq, sq, bq, wo, so, bo, kt: torch.Tensor,
                       v: torch.Tensor,
                       kt_scale: Optional[torch.Tensor] = None,
                       v_scale: Optional[torch.Tensor] = None,
                       heads: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """x bf16 [B,D]; LN g, b f32 [D]; wq, wo [D,D] both int8 or both bf16
    with f32 [D] scales and biases; kt [B,H,Dh,K], v [B,H,K,Dh] both int8
    (with f32 scales) or both bf16 -> bf16 [B,D]. Three launches (see
    csrc/decode_block.cu), counted as one call; D and H as
    `cross_block_plan` takes them, K >= 1."""
    if _lib.dispatch_device(x) == "cpu":
        return decode_cross_block_plain(x, g, b, wq, sq, bq, wo, so, bo, kt,
                                        v, kt_scale, v_scale, heads, eps)
    bsz, d = x.shape
    dh, nk = d // heads, kt.shape[-1]
    _check_block_weights(x, g, b, ((wq, sq, bq), (wo, so, bo)), d)
    _lib.check(kt, "kt", (torch.int8, torch.bfloat16), (bsz, heads, dh, nk))
    _lib.check(v, "v", (kt.dtype,), (bsz, heads, nk, dh))
    ks_ptr = vs_ptr = None
    if kt_scale is not None:
        _lib.check(kt_scale, "kt_scale", (torch.float32,), (bsz, heads, nk))
        ks_ptr = kt_scale.data_ptr()
    if v_scale is not None:
        _lib.check(v_scale, "v_scale", (torch.float32,), (bsz, heads, dh))
        vs_ptr = v_scale.data_ptr()
    s_q, s_out = cross_block_plan(bsz, d, heads)
    if nk < 1:
        raise ValueError("decode_cross_block needs at least one cross key")
    q = torch.empty(bsz, d, dtype=torch.float32, device=x.device)
    attn = torch.empty_like(x)
    out = torch.empty_like(x)
    _lib.call("ecap_decode_cross_block", x.data_ptr(), g.data_ptr(),
              b.data_ptr(), wq.data_ptr(), sq.data_ptr(), bq.data_ptr(),
              wo.data_ptr(), so.data_ptr(), bo.data_ptr(), kt.data_ptr(),
              v.data_ptr(), ks_ptr, vs_ptr, q.data_ptr(), attn.data_ptr(),
              out.data_ptr(), bsz, d, heads, nk, float(eps),
              int(wq.dtype == torch.int8), int(kt.dtype == torch.int8), s_q,
              s_out)
    _lib.launches["decode_cross_block"] += 1
    return out
