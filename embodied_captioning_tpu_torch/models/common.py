"""Transformer building blocks, in the numerics of the JAX package's
kernel path (`ECAP_USE_PALLAS=1`).

Products take bf16 operands with float32 accumulation and a float32
result; the bias is added in float32 and the sum rounded to bf16 once
(JAX's `preferred_element_type=f32` then `.astype(bf16)`). Parameters are
plain dicts of tensors in the JAX package's layouts.

Every LayerNorm runs through the LayerNorm kernel (`layernorm`).

W8A8 serving (`w8a8=True`, an argument of `dense`, `mha`, `mlp`,
`block` and `precompute_kv`, the JAX package's `ECAP_W8A8`): every
product with an int8 weight quantizes its activations per token and runs
int8 x int8 -> int32 (`quantize.dense_w8a8`); float weights multiply as
before. The fused decode-block and decode-MLP kernels multiply bf16
activations, so under `w8a8` a decode step takes the route of separate
calls (`decode_route`), with the standalone decode attention kernels.
`int8_kv` (`precompute_kv`, the JAX package's `ECAP_INT8_KV`) quantizes
the cross-attention K/V of int8 projections (on by default; off, they
stay bf16).

The attention paths:
  - uncached self-attention without a mask at a head dim the flash kernel
    has an instance for (`flash_attention_fits`): the flash kernel, except where
    autograd records and an input needs a gradient (training): the flash
    kernel has no backward, as the TPU kernel has none, so those calls take
    the plain path below, the attention the JAX package's `train_step`
    differentiates;
  - one-token cached decoding in `block`: the whole self-attention and
    cross-attention sublayers as the block kernels (`decode_blocks=True`,
    the default), or, with `decode_blocks=False`, LayerNorm, projections
    and the decode self-/cross-attention kernels as separate calls. Each
    sublayer takes its kernel only at a shape the kernel takes
    (`decode_route`), and the route of separate calls elsewhere, as the
    JAX package's dispatchers fall back to XLA;
  - everything else (masked, multi-token cached, cross over a feature
    map, or heads or caches the flash and decode attention kernels do not
    take):
    plain tensor ops with bf16 scores and bf16 probabilities, as the JAX
    fallback path.

Tensor parallelism (Megatron's column / row pairs over the leaves
`parallel.mesh.shard_params` cuts): `mha`, `mlp` and `block` take the
"model" axis's process group (`group`, or a `TP` for a block; None is one
rank and computes what it computes without one). A column-parallel
product (q/k/v, fc) takes its input through `replicate`, a row-parallel
one (o, proj) sums its float32 partial products over the group before the
replicated bias (`dense`'s `group`). A sublayer whose leaves were kept
whole (a width that does not divide) runs replicated. Cached decoding is
refused under a group: the decode kernels take whole widths.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import (
    decode_cross_attention, decode_cross_block, decode_mlp,
    decode_self_attention, decode_self_block, flash_attention,
)
from ..kernels import layernorm as layernorm_kernel
from ..kernels.decode_attention import (
    cross_attention_fits, cross_block_fits, mlp_fits, self_attention_fits,
    self_block_fits,
)
from ..kernels.flash_attention import HEAD_DIMS
from ..ops.geometry import reciprocal32
from ..parallel.mesh import replicate, sum_replicated
from .quantize import (
    QuantizedArray, QuantizedKV, dense_w8a8, maybe_dequant, quantize_kv,
)

BERT_LN_EPS = 1e-12  # HF BertConfig.layer_norm_eps
NEG_INF = -1e30


def flash_attention_fits(d: int) -> bool:
    """The flash kernel has an instance for head dim `d` (each a multiple
    of 8: the JAX package's dispatcher sends other head dims to XLA
    attention, as `mha` sends them to the plain attention). Every
    sequence length stays on the kernel."""
    return d in HEAD_DIMS


def _records_grad(*ts: torch.Tensor) -> bool:
    """Autograd records and one of `ts` needs a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., M, K] @ b [K, N] or [..., K, N] with float32 accumulation
    and a float32 result. bf16 products are exact in float32, so on the
    CPU the operands are widened; on the card cuBLAS multiplies the bf16
    operands on the tensor cores and writes float32 (two float32 operands
    multiply as they are). Differentiable
    (`_MatmulF32`) where autograd records and an operand needs a
    gradient."""
    if _records_grad(a, b):
        return _MatmulF32.apply(a, b)
    return _matmul_f32(a, b)


def _sum_to(t: torch.Tensor, shape) -> torch.Tensor:
    """t summed over the axes that broadcasting added to `shape`."""
    lead = t.dim() - len(shape)
    if lead:
        t = t.sum(dim=tuple(range(lead)))
    dims = tuple(i for i, s in enumerate(shape) if s == 1 and t.shape[i] != 1)
    return t.sum(dim=dims, keepdim=True) if dims else t


class _MatmulF32(torch.autograd.Function):
    """`matmul_f32` with the backward JAX takes of `jnp.dot` /
    `jnp.einsum(..., preferred_element_type=float32)`: each operand's
    gradient is the float32 product of the float32 cotangent with the
    other operand widened to float32, summed over the axes broadcasting
    added, rounded to the operand's type. (cuBLAS's `mm` and `bmm` with
    `out_dtype=float32` have no autograd formula.)"""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        return _matmul_f32(a, b)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a, b = ctx.saved_tensors
        if b.dim() > 2:
            ga = gb = None
            if ctx.needs_input_grad[0]:
                ga = _sum_to(torch.matmul(g, b.float().transpose(-1, -2)),
                             a.shape).to(a.dtype)
            if ctx.needs_input_grad[1]:
                gb = _sum_to(torch.matmul(a.float().transpose(-1, -2), g),
                             b.shape).to(b.dtype)
            return ga, gb
        g2 = g.reshape(-1, g.shape[-1])
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.mm(g2, b.float().t()).reshape(a.shape).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.mm(a.reshape(-1, a.shape[-1]).float().t(),
                          g2).to(b.dtype)
        return ga, gb


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cpu" or (a.dtype == torch.float32
                                  and b.dtype == torch.float32):
        return torch.matmul(a.float(), b.float())
    if b.dim() == 2:
        lead = a.shape[:-1]
        y = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return y.reshape(*lead, b.shape[-1])
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a3 = a.expand(*lead, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
    b3 = b.expand(*lead, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
    y = torch.bmm(a3, b3, out_dtype=torch.float32)
    return y.reshape(*lead, *y.shape[-2:])


def _refuse_tp_w8a8(group, w8a8: bool) -> None:
    if w8a8 and group is not None:
        raise ValueError("w8a8 under tensor parallelism is not ported: "
                         "dense_w8a8 quantizes whole rows, and a "
                         "row-parallel product holds a block of them")


def dense(p: dict, x: torch.Tensor, compute_dtype=torch.bfloat16,
          group=None, w8a8: bool = False) -> torch.Tensor:
    """x @ w + b in `compute_dtype` with float32 accumulation; int8
    weights are dequantized in bf16 first, or with `w8a8` multiply int8
    activations (`dense_w8a8`). With `group`, the row-parallel form: w is
    this rank's block of rows and x its block of features; the float32
    partial products are summed over the group, then the replicated bias
    is added once and the sum cast (refused under `w8a8`)."""
    _refuse_tp_w8a8(group, w8a8)
    if w8a8 and isinstance(p["w"], QuantizedArray):
        return (dense_w8a8(x, p["w"]) + p["b"]).to(compute_dtype)
    w = maybe_dequant(p["w"], compute_dtype)
    if compute_dtype == torch.float32:
        y = torch.matmul(x.float(), w)
    else:
        y = matmul_f32(x.to(compute_dtype), w)
    return (sum_replicated(y, group) + p["b"]).to(compute_dtype)


class TP(NamedTuple):
    """A tower's tensor-parallel context: the "model" axis's process group
    and the tower's full MLP width (the attention's full width is its
    output projection's). A sublayer runs tensor-parallel where its local
    leaves are narrower than the full width."""

    group: object
    mlp_hidden: int


def tp_group(group, local: int, full: int):
    """`group` where a sublayer's leaves hold `local` of a width of `full`
    (cut over the group), None where they were kept whole."""
    return group if group is not None and local < full else None


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5,
              out_dtype=None) -> torch.Tensor:
    """LayerNorm over the last axis with float32 statistics, through the
    LayerNorm kernel in the mode the JAX package's default path uses for
    the input's dtype: one-pass with a relative floor for bf16 input,
    two-pass for float32 input. Under training, its backward is the
    LayerNorm backward kernel."""
    return layernorm_kernel(x, p["g"], p["b"], eps, out_dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu`'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp(p: dict, x: torch.Tensor, compute_dtype=torch.bfloat16,
        group=None, w8a8: bool = False) -> torch.Tensor:
    """proj(gelu_tanh(fc(x))); with `group`, fc column-parallel and proj
    row-parallel over it."""
    _refuse_tp_w8a8(group, w8a8)
    if group is not None:
        x = replicate(x, group)
    return dense(p["proj"], gelu_tanh(dense(p["fc"], x, compute_dtype,
                                            w8a8=w8a8)),
                 compute_dtype, group, w8a8)


class KVCache(NamedTuple):
    """Per-layer decode cache: k [B, H, Dh, T_max] (time minor), v
    [B, T_max, H, Dh]; `index` is the next write position. `mha` and
    `block` write the new keys/values into k and v in place and return
    the cache with the index advanced; positions >= index are never read,
    so rewinding the index discards them."""

    k: torch.Tensor
    v: torch.Tensor
    index: int

    @staticmethod
    def create(batch: int, t_max: int, heads: int, head_dim: int,
               device, dtype=torch.bfloat16) -> "KVCache":
        return KVCache(
            k=torch.zeros(batch, heads, head_dim, t_max, dtype=dtype,
                          device=device),
            v=torch.zeros(batch, t_max, heads, head_dim, dtype=dtype,
                          device=device),
            index=0)


def sinusoidal_positions(t: int, dim: int, device=None) -> torch.Tensor:
    """[t, 2 * (dim // 2)] float32: sin then cos of pos / 10000^(2i/dim)."""
    pos = torch.arange(t, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=device),
                            2 * i * reciprocal32(dim))
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def causal_mask(t: int, device=None) -> torch.Tensor:
    """[1, 1, T, T] lower-triangular attend mask."""
    return torch.tril(torch.ones(t, t, dtype=torch.bool, device=device)
                      )[None, None]


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, heads, d // heads)


def precompute_kv(p: dict, kv_src: torch.Tensor, heads: int,
                  w8a8: bool = False, int8_kv: bool = True):
    """Project cross-attention K/V once per generation: kt [B, H, Dh, K],
    v head-major [B, H, K, Dh] (bf16). With int8 projection weights and
    `int8_kv` the K/V are quantized to int8 as well (`QuantizedKV`);
    `w8a8` goes to the projections (`dense`)."""
    kt = _split_heads(dense(p["k"], kv_src, w8a8=w8a8),
                      heads).permute(0, 2, 3, 1)
    v = _split_heads(dense(p["v"], kv_src, w8a8=w8a8), heads)
    if int8_kv and isinstance(p["k"]["w"], QuantizedArray):
        q = quantize_kv(kt, v)
        return q._replace(kt=q.kt.contiguous(),
                          v=q.v.permute(0, 2, 1, 3).contiguous())
    return kt.contiguous(), v.permute(0, 2, 1, 3).contiguous()


def _attention_plain(q: torch.Tensor, kt: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor],
                     kt_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B,Tq,H,Dh] in the compute dtype (bf16, or float32 for the
    float32 sentence encoder), kt [B,H,Dh,Tk], v head-major [B,H,Tk,Dh]
    (bf16 or float32, or int8 with kt_scale [B,H,Tk] and v_scale [B,H,Dh])
    -> [B,Tq,H*Dh] f32. Scores and probabilities in q's dtype, float32
    max/denominator, normalisation after PV, as the JAX package computes
    them in its compute dtype. The max is a constant to autograd, as the
    JAX package's `stop_gradient` makes it."""
    dh, cdt = q.shape[-1], q.dtype
    logits = matmul_f32(q.permute(0, 2, 1, 3), kt.to(cdt))
    # the jitted `/ sqrt(dh)`: a product with its float32 reciprocal
    logits = logits.to(cdt).float() * reciprocal32(math.sqrt(dh))
    if kt_scale is not None:
        logits = logits * kt_scale[:, :, None, :]
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True).detach()
    pexp = torch.exp(logits - m).to(cdt)
    denom = pexp.float().sum(dim=-1)  # [B, H, Tq]
    out = matmul_f32(pexp, v.to(cdt))  # [B, H, Tq, Dh]
    if v_scale is not None:
        out = out * v_scale[:, :, None, :]
    out = out / denom[..., None]
    b, h, tq, d = out.shape
    return out.permute(0, 2, 1, 3).reshape(b, tq, h * d)


def mha(p: dict, x: torch.Tensor, heads: int,
        kv: Optional[torch.Tensor] = None,
        mask: Optional[torch.Tensor] = None,
        cache: Optional[KVCache] = None,
        compute_dtype=torch.bfloat16,
        kv_precomputed=None,
        cache_block_causal: bool = True,
        group=None,
        w8a8: bool = False,
        ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Multi-head attention. x [B, Tq, D]; kv [B, Tk, Dkv] (cross source,
    default x); mask broadcastable to [B, H, Tq, Tk] (True = attend; Tk is
    the cache capacity for cached decoding); cache: cached self-attention,
    the Tq new positions are written at cache.index and query i sees keys
    at positions <= index + i, or, with `cache_block_causal=False` (a
    prefix-LM's priming pass), every position written so far (< index +
    Tq; no decode kernel then, as in the JAX package); kv_precomputed:
    (kt, v) or QuantizedKV from `precompute_kv`. With `group` (uncached
    only) and q/k/v, o cut over it, this rank runs its heads (the local q
    width over the head dim) and o row-parallel. `w8a8` goes to every
    projection (`dense`). Returns (out [B, Tq, D], cache)."""
    b, tq = x.shape[:2]
    _refuse_tp_w8a8(group, w8a8)
    if group is not None:
        if cache is not None or kv_precomputed is not None:
            raise ValueError("cached decoding under tensor parallelism is "
                             "not ported: the decode kernels take whole "
                             "widths")
        wo = p["o"]["w"]
        group = tp_group(group, wo.shape[0], wo.shape[1])
    if group is not None:
        heads = _out_width(p["q"]["w"]) // (wo.shape[1] // heads)
        x = replicate(x, group)
        kv = None if kv is None else replicate(kv, group)
    if kv_precomputed is not None:
        if cache is not None:
            raise ValueError("kv_precomputed cannot be combined with a KV "
                             "cache")
        q = _split_heads(dense(p["q"], x, compute_dtype, w8a8=w8a8), heads)
        if isinstance(kv_precomputed, QuantizedKV):
            kt, v = kv_precomputed.kt, kv_precomputed.v
            scales = (kv_precomputed.kt_scale, kv_precomputed.v_scale)
        else:
            (kt, v), scales = kv_precomputed, (None, None)
        if tq == 1 and mask is None and cross_attention_fits(q.shape[-1]):
            out = decode_cross_attention(q[:, 0].to(compute_dtype), kt, v,
                                         *scales)
            out = out.reshape(b, 1, -1)
        else:
            out = _attention_plain(q.to(compute_dtype), kt, v, mask, *scales)
        return dense(p["o"], out.to(compute_dtype), compute_dtype,
                     w8a8=w8a8), None

    q = _split_heads(dense(p["q"], x, compute_dtype, w8a8=w8a8), heads)
    src = x if kv is None else kv
    k = _split_heads(dense(p["k"], src, compute_dtype, w8a8=w8a8), heads)
    v = _split_heads(dense(p["v"], src, compute_dtype, w8a8=w8a8), heads)

    if cache is not None:
        if kv is not None:
            raise ValueError("the cache serves self-attention only")
        pos = cache.index
        cache.k[:, :, :, pos:pos + tq] = k.permute(0, 2, 3, 1).to(
            cache.k.dtype)
        cache.v[:, pos:pos + tq] = v.to(cache.v.dtype)
        cache = KVCache(cache.k, cache.v, pos + tq)
        if (tq == 1 and mask is None and cache_block_causal
                and self_attention_fits(q.shape[-1], cache.k.shape[-1])):
            out = decode_self_attention(q[:, 0].to(compute_dtype), cache.k,
                                        cache.v, pos)
            out = out.reshape(b, 1, -1)
        else:
            key_pos = torch.arange(cache.k.shape[-1], device=x.device)
            if cache_block_causal:
                # causal within the newly written block too
                q_pos = pos + torch.arange(tq, device=x.device)
                seen = key_pos[None, None, None, :] <= q_pos[None, None, :,
                                                             None]
            else:
                seen = key_pos[None, None, None, :] < pos + tq
            out = _attention_plain(
                q.to(compute_dtype), cache.k, cache.v.permute(0, 2, 1, 3),
                seen if mask is None else (mask & seen))
        return dense(p["o"], out.to(compute_dtype), compute_dtype,
                     w8a8=w8a8), cache

    if (kv is None and mask is None and not _records_grad(q, k, v)
            and flash_attention_fits(q.shape[-1])):
        out = flash_attention(
            q.transpose(1, 2).to(compute_dtype).contiguous(),
            k.transpose(1, 2).to(compute_dtype).contiguous(),
            v.transpose(1, 2).to(compute_dtype).contiguous())
        out = out.transpose(1, 2).reshape(b, tq, -1)
        return dense(p["o"], out, compute_dtype, group, w8a8), None

    out = _attention_plain(q.to(compute_dtype),
                           k.to(compute_dtype).permute(0, 2, 3, 1),
                           v.to(compute_dtype).permute(0, 2, 1, 3), mask)
    return dense(p["o"], out.to(compute_dtype), compute_dtype, group,
                 w8a8), None


class DecodeRoute(NamedTuple):
    """Which sublayers of a one-token decode step run as fused kernels."""

    self_block: bool   # decode_self_block
    cross_block: bool  # decode_cross_block
    mlp: bool          # decode_mlp


def decode_route(rows: int, d: int, heads: int, f: int, t: int,
                 decode_blocks: bool, w8a8: bool = False) -> DecodeRoute:
    """The fused kernels a one-token decode step of `rows` rows takes, per
    sublayer, at width d with `heads` heads, MLP width f and a self-attention
    cache of t positions: each kernel where its plan takes the shape (the
    block kernels only with `decode_blocks`), as the JAX package's
    `maybe_decode_*` dispatchers return None at shapes their kernels do not
    take. A cache too long for the self block's shared memory runs that
    sublayer as separate calls (`decode_self_attention` takes it in
    tiles; `mha` runs plain ops where `self_attention_fits` refuses).
    Under `w8a8` no sublayer takes a fused kernel, whatever its leaves'
    type, as the JAX package's `_decode_fusion_ok` turns them off: they
    multiply bf16 activations."""
    fused = not w8a8
    return DecodeRoute(
        self_block=(fused and decode_blocks
                    and self_block_fits(rows, d, heads, t)),
        cross_block=(fused and decode_blocks
                     and cross_block_fits(rows, d, heads)),
        mlp=fused and mlp_fits(rows, d, f))


def _out_width(w) -> int:
    return (w.q if isinstance(w, QuantizedArray) else w).shape[-1]


def block(p: dict, x: torch.Tensor, heads: int,
          mask: Optional[torch.Tensor] = None,
          cache: Optional[KVCache] = None, compute_dtype=torch.bfloat16,
          cross_kv=None, decode_blocks: bool = True,
          cross: Optional[torch.Tensor] = None,
          cache_block_causal: bool = True,
          tp: Optional[TP] = None,
          w8a8: bool = False,
          ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Pre-LN transformer block with an optional cross-attention sublayer,
    over precomputed K/V (`cross_kv`, the decode loop) or over a feature
    map (`cross`, the training forward; `ln_kv` is applied to it first
    where present). One token per row on a bf16 stream is the decode
    step: the MLP sublayer (LN + fc + GELU + proj + residual) runs as the
    fused decode-MLP kernel when there is a cache, and with `decode_blocks`
    the cached self-attention sublayer and the cross-attention sublayer
    run as one block-kernel call each; without it they run as LayerNorm,
    projections and the decode attention kernels. A sublayer whose kernel
    does not take the shape runs as those separate calls
    (`decode_route`). `cache_block_causal` goes to the self-attention
    (`mha`); the self block kernel runs only with it. A block with a
    mixture-of-experts MLP ("moe" in place of "mlp", the MoE captioner's
    text blocks) runs it as `parallel.moe.moe_mlp` (top-2, capped by the
    expert count) after its attention sublayers, which take their kernels
    as in any block; it never takes the decode-MLP kernel. With `tp`, each
    sublayer whose leaves were cut runs tensor-parallel (`mha`, `mlp`),
    the mixture-of-experts MLP replicated; cached decoding (the decode
    kernels) is refused. `w8a8` goes to every product and to the route."""
    moe = p.get("moe")
    _refuse_tp_w8a8(tp, w8a8)
    if tp is not None and (cache is not None or cross_kv is not None):
        raise ValueError("cached decoding under tensor parallelism is not "
                         "ported: the decode kernels take whole widths")
    group = None if tp is None else tp.group
    one_token = (x.shape[1] == 1 and compute_dtype == torch.bfloat16
                 and x.dtype == torch.bfloat16)
    route = DecodeRoute(False, False, False)
    if one_token:
        route = decode_route(x.shape[0], x.shape[-1], heads,
                             (moe["fc_w"].shape[-1] if moe is not None
                              else _out_width(p["mlp"]["fc"]["w"])),
                             0 if cache is None else cache.k.shape[-1],
                             decode_blocks, w8a8)
        if moe is not None:
            route = route._replace(mlp=False)
    if "attn" in p:
        if (route.self_block and cache is not None and mask is None
                and cache_block_causal):
            x, cache = _decode_self_block(p["attn"], p["ln1"], x, cache,
                                          heads)
        else:
            h, cache = mha(p["attn"], layernorm(p["ln1"], x), heads,
                           mask=mask, cache=cache,
                           compute_dtype=compute_dtype,
                           cache_block_causal=cache_block_causal,
                           group=group, w8a8=w8a8)
            x = x + h
    if cross is not None and "xattn" in p:
        if "ln_kv" in p:
            cross = layernorm(p["ln_kv"], cross)
        h, _ = mha(p["xattn"], layernorm(p["ln_x"], x), heads, kv=cross,
                   compute_dtype=compute_dtype, group=group, w8a8=w8a8)
        x = x + h
    elif cross_kv is not None and "xattn" in p:
        if route.cross_block:
            x = _decode_cross_block(p["xattn"], p["ln_x"], x, cross_kv,
                                    heads)
        else:
            h, _ = mha(p["xattn"], layernorm(p["ln_x"], x), heads,
                       compute_dtype=compute_dtype, kv_precomputed=cross_kv,
                       w8a8=w8a8)
            x = x + h
    if moe is not None:
        from ..parallel.moe import moe_mlp  # moe.py imports this module

        h = moe_mlp(moe, layernorm(p["ln2"], x),
                    top_k=min(2, moe["gate"]["b"].shape[-1]),
                    compute_dtype=compute_dtype)
        return x + h, cache
    if cache is not None and route.mlp:
        return _decode_mlp_block(p["mlp"], p["ln2"], x), cache
    if tp is not None:
        group = tp_group(group, _out_width(p["mlp"]["fc"]["w"]),
                         tp.mlp_hidden)
    return x + mlp(p["mlp"], layernorm(p["ln2"], x), compute_dtype,
                   group, w8a8), cache


def _kernel_weight(w) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 or bf16 weight, float32 per-output-channel scale)."""
    if isinstance(w, QuantizedArray):
        return w.q, w.scale.float()
    return w.to(torch.bfloat16), torch.ones(w.shape[-1], dtype=torch.float32,
                                            device=w.device)


def _decode_mlp_block(p_mlp: dict, p_ln: dict, x: torch.Tensor
                      ) -> torch.Tensor:
    wfc, sfc = _kernel_weight(p_mlp["fc"]["w"])
    wpj, spj = _kernel_weight(p_mlp["proj"]["w"])
    out = decode_mlp(x[:, 0].contiguous(), p_ln["g"], p_ln["b"],
                     wfc, sfc, p_mlp["fc"]["b"], wpj, spj,
                     p_mlp["proj"]["b"])
    return out[:, None]


def _decode_self_block(p_attn: dict, p_ln: dict, x: torch.Tensor,
                       cache: KVCache, heads: int
                       ) -> Tuple[torch.Tensor, KVCache]:
    ws = [t for n in "qkvo"
          for t in (*_kernel_weight(p_attn[n]["w"]), p_attn[n]["b"])]
    out, k, v = decode_self_block(x[:, 0].contiguous(), p_ln["g"], p_ln["b"],
                                  *ws, cache.k, cache.v, cache.index, heads)
    return out[:, None], KVCache(k, v, cache.index + 1)


def _decode_cross_block(p_xattn: dict, p_ln: dict, x: torch.Tensor,
                        cross_kv, heads: int) -> torch.Tensor:
    ws = [t for n in "qo"
          for t in (*_kernel_weight(p_xattn[n]["w"]), p_xattn[n]["b"])]
    if isinstance(cross_kv, QuantizedKV):
        kv = (cross_kv.kt, cross_kv.v, cross_kv.kt_scale, cross_kv.v_scale)
    else:
        kv = cross_kv
    out = decode_cross_block(x[:, 0].contiguous(), p_ln["g"], p_ln["b"], *ws,
                             *kv, heads=heads)
    return out[:, None]


def block_post_ln(p: dict, x: torch.Tensor, heads: int,
                  mask: Optional[torch.Tensor] = None,
                  compute_dtype=torch.bfloat16,
                  w8a8: bool = False) -> torch.Tensor:
    """Post-LN (BERT/MiniLM) block: x = LN1(x + attn(x));
    x = LN2(x + mlp(x)) with exact (erf) GELU and BERT's eps."""
    h, _ = mha(p["attn"], x, heads, mask=mask, compute_dtype=compute_dtype,
               w8a8=w8a8)
    x = layernorm(p["ln1"], x + h, eps=BERT_LN_EPS)
    h = dense(p["mlp"]["proj"],
              F.gelu(dense(p["mlp"]["fc"], x, compute_dtype, w8a8=w8a8)),
              compute_dtype, w8a8=w8a8)
    return layernorm(p["ln2"], x + h, eps=BERT_LN_EPS)


# ---------------------------------------------------------------------------
# initialisation (shapes and scales of the JAX package's init functions)
# ---------------------------------------------------------------------------

def randn(g: torch.Generator, shape, device, scale: float = 1.0
          ) -> torch.Tensor:
    t = torch.randn(*shape, generator=g, dtype=torch.float32,
                    device=g.device)
    return (t * scale).to(device)


def dense_init(g, d_in: int, d_out: int, device,
               scale: Optional[float] = None) -> dict:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return {"w": randn(g, (d_in, d_out), device, scale),
            "b": torch.zeros(d_out, device=device)}


def layernorm_init(dim: int, device) -> dict:
    return {"g": torch.ones(dim, device=device),
            "b": torch.zeros(dim, device=device)}


def mha_init(g, dim: int, kv_dim: Optional[int], device) -> dict:
    kv_dim = kv_dim or dim
    return {"q": dense_init(g, dim, dim, device),
            "k": dense_init(g, kv_dim, dim, device),
            "v": dense_init(g, kv_dim, dim, device),
            "o": dense_init(g, dim, dim, device, scale=1.0 / math.sqrt(dim))}


def block_init(g, dim: int, mlp_ratio: float, device,
               cross_dim: Optional[int] = None) -> dict:
    hidden = int(dim * mlp_ratio)
    p = {"ln1": layernorm_init(dim, device),
         "attn": mha_init(g, dim, None, device),
         "ln2": layernorm_init(dim, device),
         "mlp": {"fc": dense_init(g, dim, hidden, device),
                 "proj": dense_init(g, hidden, dim, device)}}
    if cross_dim is not None:
        p["ln_x"] = layernorm_init(dim, device)
        p["xattn"] = mha_init(g, dim, cross_dim, device)
    return p
