"""Sequence parallelism: ring attention over a "seq" mesh axis.

Activations are split on the token axis, one contiguous block of tokens a
rank, so activation memory per rank scales 1/n with sequence length.
Everything token-pointwise (patch embedding, LayerNorm, projections, MLP)
runs on the local block without communication; only attention mixes
tokens, and it runs as ring attention: each rank attends its queries to
the resident K/V block with a float32 online softmax, then passes the
block to the next rank (`mesh.ring_shift`), n - 1 times, so no rank holds
the whole K/V or the [T, T] scores. Forward only (no autograd through the
ring).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..models.common import dense, layernorm, matmul_f32, mlp
from ..models.quantize import maybe_dequant
from .mesh import all_gather_cat, axis_group, axis_rank, axis_size, ring_shift

NEG = -1e30


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, axis: str = "seq",
                   key_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bidirectional attention with Q/K/V split on the token axis.

    q, k, v: this rank's blocks [B, H, Tl, Dh] (block r holds tokens
    [r*Tl, (r+1)*Tl)); key_valid: [B, Tl] bool, True = real key (pad and
    mask through it). Returns this rank's output block [B, H, Tl, Dh];
    rows of padding queries are garbage, slice them off outside. Masked
    keys contribute exactly 0, even in a block of padding only."""
    group = axis_group(mesh, axis)
    n = axis_size(mesh, axis)
    if key_valid is None:
        key_valid = torch.ones(k.shape[0], k.shape[2], dtype=torch.bool,
                               device=k.device)
    qf = q.float() * (1.0 / math.sqrt(q.shape[-1]))
    b, h, tq, _ = q.shape
    m = torch.full((b, h, tq), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros(b, h, tq, dtype=torch.float32, device=q.device)
    o = torch.zeros(b, h, tq, v.shape[-1], dtype=torch.float32,
                    device=q.device)

    def process(k_blk, v_blk, val_blk, m, l, o):
        s = torch.einsum("bhqd,bhkd->bhqk", qf, k_blk.float())
        val = val_blk[:, None, None, :]
        s = torch.where(val, s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None]) * val.float()
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                               v_blk.float())
        return m_new, l, o

    # the resident block first, then n - 1 rotations
    m, l, o = process(k, v, key_valid, m, l, o)
    for _ in range(n - 1):
        k, v, key_valid = (ring_shift(t, group) for t in (k, v, key_valid))
        m, l, o = process(k, v, key_valid, m, l, o)
    return (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def _proj_headmajor(p_one: dict, x: torch.Tensor, heads: int,
                    compute_dtype) -> torch.Tensor:
    """[B, T, Din] @ [Din, H*Dh] + b -> [B, H, T, Dh] in compute_dtype."""
    b, t, _ = x.shape
    w = maybe_dequant(p_one["w"], compute_dtype)
    y = matmul_f32(x.to(compute_dtype), w) + p_one["b"]
    return y.reshape(b, t, heads, -1).transpose(1, 2).to(compute_dtype)


def _sp_block(p: dict, x: torch.Tensor, heads: int, mesh, axis: str,
              valid: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Pre-LN self-attention block (`models.common.block` for the
    encoder) with ring attention, on this rank's token block."""
    hh = layernorm(p["ln1"], x)
    q, k, v = (_proj_headmajor(p["attn"][n], hh, heads, compute_dtype)
               for n in "qkv")
    out = ring_attention(q, k, v, mesh, axis, key_valid=valid)
    b, _, tl, _ = out.shape
    out = out.transpose(1, 2).reshape(b, tl, -1).to(compute_dtype)
    y = matmul_f32(out, maybe_dequant(p["attn"]["o"]["w"], compute_dtype))
    x = x + (y + p["attn"]["o"]["b"]).to(compute_dtype)
    return x + mlp(p["mlp"], layernorm(p["ln2"], x), compute_dtype)


def vit_features_seqparallel(params: dict, patch_tokens: torch.Tensor, cfg,
                             mesh, axis: str = "seq",
                             compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Sequence-parallel `models.vit.vit_features` of replicated patch
    tokens [B, T, p*p*3]: the T+1 tokens (cls + patches) are padded to a
    multiple of the ring, each rank runs its block (pad keys masked out of
    every attention), and an all-gather returns the whole [B, T+1, width]
    on every rank."""
    n, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    x = dense(params["patch"], patch_tokens, compute_dtype)
    b, t, _ = x.shape
    cls = params["cls"].expand(b, 1, cfg.width)
    x = (torch.cat([cls, x.float()], dim=1) + params["pos"][None]
         ).to(compute_dtype)
    t1 = t + 1
    tl = -(-t1 // n)
    x = F.pad(x, (0, 0, 0, tl * n - t1))[:, r * tl:(r + 1) * tl]
    valid = (torch.arange(r * tl, (r + 1) * tl, device=x.device) < t1
             )[None].expand(b, tl)
    x = layernorm(params["ln_pre"], x)
    for blk in params["blocks"]:
        x = _sp_block(blk, x, cfg.heads, mesh, axis, valid, compute_dtype)
    x = layernorm(params["ln_post"], x)
    x = all_gather_cat(x.transpose(0, 1), axis_group(mesh, axis))
    return x.transpose(0, 1)[:, :t1]
