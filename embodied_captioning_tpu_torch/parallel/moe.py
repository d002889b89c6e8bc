"""Mixture-of-experts MLP with expert parallelism over a process group.

The JAX package's formulation, kept whole:

- fixed capacity per expert (overflow tokens are dropped, the Switch /
  GShard contract);
- tokens routed in groups of `group_size` (GShard's group axis): capacity
  and the one-hot dispatch are per group;
- dispatch and combine are one-hot products (`nec,nd->ecd` /
  `nec,ecd->nd`), expert weights stacked on a leading [E, ...] axis.

The gate is a float32 product (never TF32: a routing flip near a tie
changes the expert). The expert products follow the backend, as the JAX
package's trace-time branch does (ROADMAP C.34): float32 on the CPU, bf16
operands with float32 accumulation on the card. With a process group
(`shard_experts`), each rank holds E / W experts, runs only those, and the
partial combines are summed over the group.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.common import dense_init, gelu_tanh, matmul_f32
from ..models.quantize import maybe_dequant
from .mesh import sum_replicated

EXPERT_LEAVES = ("fc_w", "fc_b", "proj_w", "proj_b")


def moe_init(g: torch.Generator, dim: int, hidden: int, n_experts: int,
             device) -> dict:
    fc, pr = [], []
    for _ in range(n_experts):
        fc.append(dense_init(g, dim, hidden, device))
        pr.append(dense_init(g, hidden, dim, device))
    return {
        "gate": dense_init(g, dim, n_experts, device),
        "fc_w": torch.stack([p["w"] for p in fc]),    # [E, D, H]
        "fc_b": torch.stack([p["b"] for p in fc]),    # [E, H]
        "proj_w": torch.stack([p["w"] for p in pr]),  # [E, H, D]
        "proj_b": torch.stack([p["b"] for p in pr]),  # [E, D]
    }


def shard_experts(params: dict, group) -> dict:
    """This rank's experts: the stacked leaves' block [r*E/W, (r+1)*E/W)
    of the group's W ranks; the gate stays whole."""
    w, r = dist.get_world_size(group), dist.get_rank(group)
    e = params["fc_w"].shape[0]
    if e % w:
        raise ValueError(f"{e} experts do not divide over {w} ranks")
    per = e // w
    return {k: (v[r * per:(r + 1) * per].contiguous()
                if k in EXPERT_LEAVES else v) for k, v in params.items()}


def _route_group(probs: torch.Tensor, top_k: int, cap: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routing of groups: probs [G, Ng, E] (zero rows for pad tokens) ->
    (dispatch [G, Ng, E, C] 0/1, combine [G, Ng, E, C] gate-weighted).
    Top-k by repeated argmax (the first maximum on ties); capacity slots go
    to earlier tokens (GShard cumsum), route r+1 queued after all of route
    r; a token past capacity keeps its other routes."""
    g, ng, e = probs.shape
    disp = probs.new_zeros(g, ng, e, cap)
    comb = probs.new_zeros(g, ng, e, cap)
    prior = probs.new_zeros(g, 1, e)
    masked = probs
    for _ in range(top_k):
        w = masked.amax(dim=-1)
        idx = masked.argmax(dim=-1)
        # pad tokens (all-zero probs) route nowhere
        onehot = (F.one_hot(idx, e).float()
                  * (w > 0.0).float()[..., None])
        masked = masked * (1.0 - onehot)
        pos = torch.cumsum(onehot, dim=1) - onehot + prior      # [G, Ng, E]
        prior = prior + onehot.sum(dim=1, keepdim=True)
        pos_id = (pos * onehot).sum(dim=-1).to(torch.int64)
        fits = (pos_id < cap).float()
        keep = onehot.sum(dim=-1) * fits
        slot = F.one_hot(pos_id.clamp(max=cap - 1), cap).float() * fits[
            ..., None]                                          # [G, Ng, C]
        hot = onehot[..., None] * slot[:, :, None, :] * keep[..., None, None]
        disp = disp + hot
        comb = comb + hot * w[..., None, None]
    return disp, comb


def _gate_logits(x32: torch.Tensor, p_gate: dict) -> torch.Tensor:
    """x [N, D] f32 @ gate [D, E] + b in float32, TF32 off on the card."""
    w = maybe_dequant(p_gate["w"], torch.float32)
    if x32.device.type != "cuda":
        return x32 @ w + p_gate["b"]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return x32 @ w + p_gate["b"]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _expert_product(a: torch.Tensor, w: torch.Tensor, dtype
                    ) -> torch.Tensor:
    """[G, E, C, K] @ [E, K, N] -> float32, with operands of `dtype`
    (float32 or bf16 with float32 accumulation)."""
    if dtype == torch.float32:
        return torch.matmul(a.float(), w.float())
    return matmul_f32(a.to(dtype), w.to(dtype))


def capacity(top_k: int, ng: int, e: int, capacity_factor: float) -> int:
    return max(1, min(math.ceil(top_k * ng / e * capacity_factor), ng))


def moe_mlp(p: dict, x: torch.Tensor, capacity_factor: float = 1.25,
            top_k: int = 2, group=None, group_size: int = 1024,
            compute_dtype=torch.bfloat16, return_gate_probs: bool = False,
            expert_dtype: Optional[torch.dtype] = None):
    """Top-k gated MoE MLP. x: [B, T, D] -> [B, T, D] (x's dtype).

    Tokens are split into groups of `group_size`; each group gets expert
    capacity C = ceil(top_k * Ng / E * cf). Overflow beyond C is dropped
    (the token keeps only its other routes; callers add the residual).
    With `group` (a process group; `p` from `shard_experts`), this rank
    runs its experts only and the partial combines are summed over the
    group: x and the result are replicated. `return_gate_probs=True` also
    returns the [N, E] gate softmax (before pad masking). `expert_dtype`
    is the expert products' operand type; by default float32 on the CPU
    and `compute_dtype` on the card, as the JAX package's backend branch
    (ROADMAP C.34)."""
    b, t, d = x.shape
    n = b * t
    e = p["gate"]["b"].shape[-1]
    e_local = p["fc_w"].shape[0]
    if top_k > e:
        raise ValueError(f"top_k={top_k} exceeds expert count {e}")
    ng = min(group_size, n)
    g = math.ceil(n / ng)
    n_pad = g * ng
    cap = capacity(top_k, ng, e, capacity_factor)
    xf = x.reshape(n, d).to(compute_dtype)

    probs = torch.softmax(_gate_logits(xf.float(), p["gate"]), dim=-1)
    xp = F.pad(xf, (0, 0, 0, n_pad - n))
    pp = F.pad(probs, (0, 0, 0, n_pad - n))               # pad rows all-zero
    disp, comb = _route_group(pp.reshape(g, ng, e), top_k, cap)
    if e_local != e:
        first = dist.get_rank(group) * e_local
        disp = disp[:, :, first:first + e_local]
        comb = comb[:, :, first:first + e_local]

    if expert_dtype is None:
        expert_dtype = (torch.float32 if x.device.type == "cpu"
                        else compute_dtype)
    # dispatch: one token per slot, so the product is exact
    dd = disp.to(compute_dtype).reshape(g, ng, e_local * cap)
    ex_in = matmul_f32(dd.transpose(1, 2), xp.reshape(g, ng, d))
    ex_in = ex_in.reshape(g, e_local, cap, d)              # [G, E, C, D]
    h = _expert_product(ex_in, p["fc_w"], expert_dtype)
    h = gelu_tanh(h + p["fc_b"][None, :, None, :])
    out_e = (_expert_product(h, p["proj_w"], expert_dtype)
             + p["proj_b"][None, :, None, :])
    out = matmul_f32(comb.to(compute_dtype).reshape(g, ng, e_local * cap),
                     out_e.to(compute_dtype).reshape(g, e_local * cap, d))
    if e_local != e:
        out = sum_replicated(out, group)
    out = out.reshape(n_pad, d)[:n].reshape(b, t, d).to(x.dtype)
    return (out, probs) if return_gate_probs else out


def load_balance_loss(p: dict, x: torch.Tensor,
                      gate_probs: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Switch-style auxiliary loss: E * sum_e f_e * P_e, f_e the fraction
    of tokens whose top-1 route is e, P_e the mean gate prob. Pass
    `gate_probs` from `moe_mlp(..., return_gate_probs=True)` to reuse the
    layer's routing distribution."""
    if gate_probs is None:
        b, t, d = x.shape
        gate_probs = torch.softmax(
            _gate_logits(x.reshape(b * t, d).float(), p["gate"]), dim=-1)
    e = gate_probs.shape[-1]
    top1 = F.one_hot(gate_probs.argmax(dim=-1), e).float()
    return e * torch.sum(top1.mean(dim=0) * gate_probs.mean(dim=0))
