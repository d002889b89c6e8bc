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
    """Leaves in JAX's order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree: Any, leaves: Sequence) -> Any:
    """`tree`'s structure with `leaves` (in `tree_leaves` order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)

    return build(tree)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


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
