"""GPipe-style pipeline parallelism over a "pipe" mesh axis.

S stages hold L/S contiguous blocks each, one stage a rank; M microbatches
stream through a ring schedule of M + S - 1 steps: at every step each
rank applies its stage and sends the activations to the next stage
(`mesh.ring_shift`), and the last stage banks its outputs. A final
all-reduce replicates the result on every rank, as the JAX package's
`psum` does. Every rank builds the same autograd graph (the feed and the
banking are selects, as the JAX program's `where`s), so the backward runs
the same collectives in the same order everywhere: each ring step's
backward sends the cotangent one stage back.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional, Sequence

import torch

from ..train.optim import tree_map_with_path
from .mesh import (
    axis_group, axis_rank, axis_size, replicate, ring_shift, sum_replicated,
)


def _at(tree: Any, path: tuple) -> Any:
    return functools.reduce(lambda node, k: node[k], path, tree)


def _tree_stack(trees: Sequence[Any]) -> Any:
    """Trees of one structure -> that structure with each leaf stacked."""
    return tree_map_with_path(
        lambda p, _: torch.stack([_at(t, p) for t in trees]), trees[0])


def _tree_index(tree: Any, i) -> Any:
    return tree_map_with_path(lambda _, leaf: leaf[i], tree)


def _leading(tree: Any) -> int:
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree.shape[0]


def stack_stages(layer_params: Sequence[Any], stages: int) -> Any:
    """[L] per-layer param trees -> one tree with leaves [S, L//S, ...]
    (stage-major). Requires L % S == 0 (homogeneous block stacks)."""
    n = len(layer_params)
    if n % stages != 0:
        raise ValueError(f"{n} layers not divisible into {stages} stages")
    per = n // stages
    return _tree_stack([_tree_stack(layer_params[i * per:(i + 1) * per])
                        for i in range(stages)])


def shard_stacked(stacked: Any, mesh, axis: str = "pipe") -> Any:
    """This rank's stage of a stacked tree: leaves [1, L//S, ...]."""
    r = axis_rank(mesh, axis)
    return _tree_index(stacked, slice(r, r + 1))


class _RingShift(torch.autograd.Function):
    """`ring_shift` one step forward; its backward shifts the cotangent
    one step back."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return ring_shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return ring_shift(g, ctx.group, -1), None


def pipeline_apply(stacked: Any, x: torch.Tensor,
                   block_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   mesh, axis: str = "pipe",
                   microbatches: int = 4) -> torch.Tensor:
    """Run a block stack distributed over `axis` on activations x [B, ...]
    (replicated: every rank passes the same x).

    `stacked` is this rank's stage (`shard_stacked`; with one stage the
    whole `stack_stages(..., 1)`); block_fn(layer_params, h) -> h applies
    ONE block. The result equals the sequential composition (up to float
    reassociation) and is replicated. B % microbatches == 0.
    Differentiable: gradients reach this rank's stage parameters and x."""
    s = axis_size(mesh, axis)
    group = axis_group(mesh, axis)
    idx = axis_rank(mesh, axis)
    b = x.shape[0]
    m = microbatches
    if b % m != 0:
        raise ValueError(f"batch {b} not divisible into {m} microbatches")
    sp = _tree_index(stacked, 0)
    layers = [_tree_index(sp, i) for i in range(_leading(sp))]
    xs = replicate(x, group).reshape(m, b // m, *x.shape[1:])
    first = torch.tensor(idx == 0, device=x.device)
    t_total = m + s - 1

    carry = torch.zeros_like(xs[0])
    outs = [torch.zeros_like(xs[0]) for _ in range(m)]
    for t in range(t_total):
        h = torch.where(first, xs[min(t, m - 1)], carry)
        for layer in layers:
            h = block_fn(layer, h)
        # the last stage banks its result at output index t-(S-1)
        o = min(max(t - (s - 1), 0), m - 1)
        write = torch.tensor(idx == s - 1 and t >= s - 1, device=x.device)
        outs[o] = torch.where(write, h, outs[o])
        if t < t_total - 1:
            carry = h if group is None else _RingShift.apply(h, group)
    # other stages banked zeros: the sum replicates the result
    out = sum_replicated(torch.stack(outs), group)
    return out.reshape(b, *x.shape[1:])


def pipeline_vit_features(params: dict, patch_tokens: torch.Tensor, cfg,
                          mesh, axis: str = "pipe", microbatches: int = 4,
                          final_ln: bool = True,
                          stacked: Optional[Any] = None) -> torch.Tensor:
    """`models.vit.vit_features` with the block stack distributed over
    the pipe axis (cfg.layers % S == 0); embedding and LayerNorms run on
    every rank. Pass `stacked` = shard_stacked(stack_stages(
    params["blocks"], S), mesh) prepared once; None restacks per call."""
    from ..models.common import block, dense, layernorm

    x = dense(params["patch"], patch_tokens)
    b = x.shape[0]
    cls = params["cls"].expand(b, 1, cfg.width)
    x = (torch.cat([cls, x.float()], dim=1) + params["pos"][None]
         ).to(torch.bfloat16)
    x = layernorm(params["ln_pre"], x)
    if stacked is None:
        stacked = shard_stacked(stack_stages(
            params["blocks"], axis_size(mesh, axis)), mesh, axis)
    x = pipeline_apply(stacked, x, lambda p, h: block(p, h, cfg.heads)[0],
                       mesh, axis=axis, microbatches=microbatches)
    return layernorm(params["ln_post"], x) if final_ln else x
