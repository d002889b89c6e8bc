"""Transformer building blocks, in the numerics of the JAX package's
kernel path (`ECAP_USE_PALLAS=1`).

Products take bf16 operands with float32 accumulation and a float32
result; the bias is added in float32 and the sum rounded to bf16 once
(JAX's `preferred_element_type=f32` then `.astype(bf16)`). Parameters are
plain dicts of tensors in the JAX package's layouts.

Every LayerNorm runs through the LayerNorm kernel (`layernorm`).

The attention paths:
  - uncached self-attention without a mask: the flash kernel, except where
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
    map, or heads or caches the decode attention kernels do not take):
    plain tensor ops with bf16 scores and bf16 probabilities, as the JAX
    fallback path.
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
from .quantize import QuantizedArray, QuantizedKV, maybe_dequant, quantize_kv

BERT_LN_EPS = 1e-12  # HF BertConfig.layer_norm_eps
NEG_INF = -1e30


def _records_grad(*ts: torch.Tensor) -> bool:
    """Autograd records and one of `ts` needs a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., M, K] @ b [K, N] or [..., K, N] with float32 accumulation
    and a float32 result. bf16 products are exact in float32, so on the
    CPU the operands are widened; on the card cuBLAS multiplies the bf16
    operands on the tensor cores and writes float32. Differentiable
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
    if a.device.type == "cpu":
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


def dense(p: dict, x: torch.Tensor, compute_dtype=torch.bfloat16
          ) -> torch.Tensor:
    """x @ w + b in `compute_dtype` with float32 accumulation; int8
    weights are dequantized in bf16 first."""
    w = maybe_dequant(p["w"], compute_dtype)
    if compute_dtype == torch.float32:
        y = torch.matmul(x.float(), w)
    else:
        y = matmul_f32(x.to(compute_dtype), w)
    return (y + p["b"]).to(compute_dtype)


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


def mlp(p: dict, x: torch.Tensor, compute_dtype=torch.bfloat16
        ) -> torch.Tensor:
    return dense(p["proj"], gelu_tanh(dense(p["fc"], x, compute_dtype)),
                 compute_dtype)


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


def causal_mask(t: int, device=None) -> torch.Tensor:
    """[1, 1, T, T] lower-triangular attend mask."""
    return torch.tril(torch.ones(t, t, dtype=torch.bool, device=device)
                      )[None, None]


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, heads, d // heads)


def precompute_kv(p: dict, kv_src: torch.Tensor, heads: int):
    """Project cross-attention K/V once per generation: kt [B, H, Dh, K],
    v head-major [B, H, K, Dh]. With int8 projection weights the K/V are
    quantized to int8 as well (`QuantizedKV`)."""
    kt = _split_heads(dense(p["k"], kv_src), heads).permute(0, 2, 3, 1)
    v = _split_heads(dense(p["v"], kv_src), heads)
    if isinstance(p["k"]["w"], QuantizedArray):
        q = quantize_kv(kt, v)
        return q._replace(kt=q.kt.contiguous(),
                          v=q.v.permute(0, 2, 1, 3).contiguous())
    return kt.contiguous(), v.permute(0, 2, 1, 3).contiguous()


def _attention_plain(q: torch.Tensor, kt: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor],
                     kt_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B,Tq,H,Dh] bf16, kt [B,H,Dh,Tk], v head-major [B,H,Tk,Dh] (bf16,
    or int8 with kt_scale [B,H,Tk] and v_scale [B,H,Dh]) -> [B,Tq,H*Dh]
    f32. bf16 scores, float32 max/denominator, bf16 probabilities,
    normalisation after PV. The max is a constant to autograd, as the JAX
    package's `stop_gradient` makes it."""
    dh = q.shape[-1]
    logits = matmul_f32(q.permute(0, 2, 1, 3), kt.to(torch.bfloat16))
    logits = logits.to(torch.bfloat16).float() / math.sqrt(dh)
    if kt_scale is not None:
        logits = logits * kt_scale[:, :, None, :]
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True).detach()
    pexp = torch.exp(logits - m).to(torch.bfloat16)
    denom = pexp.float().sum(dim=-1)  # [B, H, Tq]
    out = matmul_f32(pexp, v.to(torch.bfloat16))  # [B, H, Tq, Dh]
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
        ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Multi-head attention. x [B, Tq, D]; kv [B, Tk, Dkv] (cross source,
    default x); mask broadcastable to [B, H, Tq, Tk] (True = attend; Tk is
    the cache capacity for cached decoding); cache: cached self-attention,
    the Tq new positions are written at cache.index and query i sees keys
    at positions <= index + i; kv_precomputed: (kt, v) or QuantizedKV from
    `precompute_kv`. Returns (out [B, Tq, D], cache)."""
    b, tq = x.shape[:2]
    if kv_precomputed is not None:
        if cache is not None:
            raise ValueError("kv_precomputed cannot be combined with a KV "
                             "cache")
        q = _split_heads(dense(p["q"], x, compute_dtype), heads)
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
        return dense(p["o"], out.to(compute_dtype), compute_dtype), None

    q = _split_heads(dense(p["q"], x, compute_dtype), heads)
    src = x if kv is None else kv
    k = _split_heads(dense(p["k"], src, compute_dtype), heads)
    v = _split_heads(dense(p["v"], src, compute_dtype), heads)

    if cache is not None:
        if kv is not None:
            raise ValueError("the cache serves self-attention only")
        pos = cache.index
        cache.k[:, :, :, pos:pos + tq] = k.permute(0, 2, 3, 1).to(
            cache.k.dtype)
        cache.v[:, pos:pos + tq] = v.to(cache.v.dtype)
        cache = KVCache(cache.k, cache.v, pos + tq)
        if (tq == 1 and mask is None
                and self_attention_fits(q.shape[-1], cache.k.shape[-1])):
            out = decode_self_attention(q[:, 0].to(compute_dtype), cache.k,
                                        cache.v, pos)
            out = out.reshape(b, 1, -1)
        else:
            # causal within the newly written block too
            key_pos = torch.arange(cache.k.shape[-1], device=x.device)
            q_pos = pos + torch.arange(tq, device=x.device)
            causal = key_pos[None, None, None, :] <= q_pos[None, None, :,
                                                           None]
            out = _attention_plain(
                q.to(compute_dtype), cache.k, cache.v.permute(0, 2, 1, 3),
                causal if mask is None else (mask & causal))
        return dense(p["o"], out.to(compute_dtype), compute_dtype), cache

    if kv is None and mask is None and not _records_grad(q, k, v):
        out = flash_attention(
            q.transpose(1, 2).to(compute_dtype).contiguous(),
            k.transpose(1, 2).to(compute_dtype).contiguous(),
            v.transpose(1, 2).to(compute_dtype).contiguous())
        out = out.transpose(1, 2).reshape(b, tq, -1)
        return dense(p["o"], out, compute_dtype), None

    out = _attention_plain(q.to(compute_dtype),
                           k.to(compute_dtype).permute(0, 2, 3, 1),
                           v.to(compute_dtype).permute(0, 2, 1, 3), mask)
    return dense(p["o"], out.to(compute_dtype), compute_dtype), None


class DecodeRoute(NamedTuple):
    """Which sublayers of a one-token decode step run as fused kernels."""

    self_block: bool   # decode_self_block
    cross_block: bool  # decode_cross_block
    mlp: bool          # decode_mlp


def decode_route(rows: int, d: int, heads: int, f: int, t: int,
                 decode_blocks: bool) -> DecodeRoute:
    """The fused kernels a one-token decode step of `rows` rows takes, per
    sublayer, at width d with `heads` heads, MLP width f and a self-attention
    cache of t positions: each kernel where its plan takes the shape (the
    block kernels only with `decode_blocks`), as the JAX package's
    `maybe_decode_*` dispatchers return None at shapes their kernels do not
    take. A cache too long for the self block's shared memory runs that
    sublayer as separate calls (`decode_self_attention` takes it in
    tiles; `mha` runs plain ops where `self_attention_fits` refuses)."""
    return DecodeRoute(
        self_block=decode_blocks and self_block_fits(rows, d, heads, t),
        cross_block=decode_blocks and cross_block_fits(rows, d, heads),
        mlp=mlp_fits(rows, d, f))


def _out_width(w) -> int:
    return (w.q if isinstance(w, QuantizedArray) else w).shape[-1]


def block(p: dict, x: torch.Tensor, heads: int,
          mask: Optional[torch.Tensor] = None,
          cache: Optional[KVCache] = None, compute_dtype=torch.bfloat16,
          cross_kv=None, decode_blocks: bool = True,
          cross: Optional[torch.Tensor] = None,
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
    (`decode_route`)."""
    one_token = (x.shape[1] == 1 and compute_dtype == torch.bfloat16
                 and x.dtype == torch.bfloat16)
    route = DecodeRoute(False, False, False)
    if one_token:
        route = decode_route(x.shape[0], x.shape[-1], heads,
                             _out_width(p["mlp"]["fc"]["w"]),
                             0 if cache is None else cache.k.shape[-1],
                             decode_blocks)
    if "attn" in p:
        if route.self_block and cache is not None and mask is None:
            x, cache = _decode_self_block(p["attn"], p["ln1"], x, cache,
                                          heads)
        else:
            h, cache = mha(p["attn"], layernorm(p["ln1"], x), heads,
                           mask=mask, cache=cache,
                           compute_dtype=compute_dtype)
            x = x + h
    if cross is not None and "xattn" in p:
        if "ln_kv" in p:
            cross = layernorm(p["ln_kv"], cross)
        h, _ = mha(p["xattn"], layernorm(p["ln_x"], x), heads, kv=cross,
                   compute_dtype=compute_dtype)
        x = x + h
    elif cross_kv is not None and "xattn" in p:
        if route.cross_block:
            x = _decode_cross_block(p["xattn"], p["ln_x"], x, cross_kv,
                                    heads)
        else:
            h, _ = mha(p["xattn"], layernorm(p["ln_x"], x), heads,
                       compute_dtype=compute_dtype, kv_precomputed=cross_kv)
            x = x + h
    if cache is not None and route.mlp:
        return _decode_mlp_block(p["mlp"], p["ln2"], x), cache
    return x + mlp(p["mlp"], layernorm(p["ln2"], x), compute_dtype), cache


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
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Post-LN (BERT/MiniLM) block: x = LN1(x + attn(x));
    x = LN2(x + mlp(x)) with exact (erf) GELU and BERT's eps."""
    h, _ = mha(p["attn"], x, heads, mask=mask, compute_dtype=compute_dtype)
    x = layernorm(p["ln1"], x + h, eps=BERT_LN_EPS)
    h = dense(p["mlp"]["proj"],
              F.gelu(dense(p["mlp"]["fc"], x, compute_dtype)),
              compute_dtype)
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
