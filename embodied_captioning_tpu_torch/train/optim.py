"""Parameter trees and the one optimizer of the port: gradients clipped by
their global norm, then Adam or AdamW.

The arithmetic is the JAX package's optax chains written out on the tree,
`optax.chain(clip_by_global_norm(max_norm), adam(lr, eps=eps))` (PPO) and
`optax.chain(clip_by_global_norm(max_norm), adamw(lr,
weight_decay=wd))` (the captioner's fine-tune): the global norm over the
leaves in sorted-key order, `(t / norm) * max_norm` only where the norm
reaches `max_norm`, Adam's bias-corrected moments with `eps` outside the
square root, AdamW's decay `wd * p` added to the step on every leaf, the
step scaled by -lr.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Sequence

import numpy as np
import torch

ADAM_B1 = 0.9
ADAM_B2 = 0.999


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Leaves in JAX's order: dict keys sorted, lists in order; None is an
    empty subtree, as in JAX."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree: Any, leaves: Sequence) -> Any:
    """`tree`'s structure with `leaves` (in `tree_leaves` order)."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)

    return build(tree)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def value_and_grad(fn: Callable[[Any], Any], params: Any):
    """`jax.value_and_grad(fn, has_aux=True)(params)` on a tree of tensors:
    fn(params) -> (loss, aux); returns (loss, aux, gradients as a tree like
    `params`), detached. A leaf the loss does not reach gets zeros."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, aux = fn(tree_unflatten(params, leaves))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    if isinstance(aux, dict):
        aux = {k: v.detach() for k, v in aux.items()}
    else:
        aux = tuple(a.detach() for a in aux)
    return loss.detach(), aux, tree_unflatten(params, grads)


class AdamState(NamedTuple):
    count: int
    mu: Any
    nu: Any


def adam_init(params: Any) -> AdamState:
    return AdamState(0, tree_map(torch.zeros_like, params),
                     tree_map(torch.zeros_like, params))


def clip_by_global_norm(grads: Any, max_norm: float) -> Any:
    leaves = tree_leaves(grads)
    norm = torch.sqrt(sum(torch.sum(torch.square(x)) for x in leaves))
    keep = norm < max_norm
    return tree_map(lambda t: torch.where(keep, t, (t / norm) * max_norm),
                    grads)


def adam_update(params: Any, opt: AdamState, grads: Any, lr: float,
                max_norm: float, eps: float = 1e-8,
                weight_decay: float = 0.0):
    """One step of the clip-then-Adam(W) chain: (new params, new state)."""
    grads = clip_by_global_norm(grads, max_norm)
    mu = tree_map(lambda g, m: (1 - ADAM_B1) * g + ADAM_B1 * m, grads, opt.mu)
    nu = tree_map(lambda g, v: (1 - ADAM_B2) * (g * g) + ADAM_B2 * v, grads,
                  opt.nu)
    count = opt.count + 1
    # the corrections in float32, as optax's `1 - decay**count`
    bc1 = float(np.float32(1) - np.float32(ADAM_B1) ** np.float32(count))
    bc2 = float(np.float32(1) - np.float32(ADAM_B2) ** np.float32(count))
    step = -lr

    def update(p, m, v):
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            u = u + weight_decay * p
        return p + u * step

    return tree_map(update, params, mu, nu), AdamState(count, mu, nu)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """optax's `warmup_cosine_decay_schedule` (exponent 1), computed as it
    computes it, in float32: a linear ramp from `init_value` to
    `peak_value` over `warmup_steps`, then a cosine from `peak_value` to
    `end_value` at `decay_steps` (counted from 0, warmup included), held
    there after. Maps the optimizer's count before the update (0 for the
    first step, as optax's schedule reads it) to the step size."""
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError("the cosine part needs decay_steps > warmup_steps")

    def linear(count: int) -> np.float32:
        if warmup_steps <= 0:
            return f32(init_value)
        c = min(max(count, 0), warmup_steps)
        frac = f32(1) - f32(c) / f32(warmup_steps)
        return f32(init_value - peak_value) * frac + f32(peak_value)

    def cosine(count: int) -> np.float32:
        c = f32(min(count, cos_steps))
        decay = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(cos_steps)))
        return f32(peak_value) * (f32(1 - alpha) * decay + f32(alpha))

    def schedule(count: int) -> float:
        value = (linear(count) if count < warmup_steps
                 else cosine(count - warmup_steps))
        return float(value)

    return schedule
