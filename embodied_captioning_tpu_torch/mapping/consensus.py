"""Per-voxel class-consensus strategies over streaming statistics.

  seal      class = argmax of column-max; logits = column-max
  bayesian  logsumexp over rows, renormalised; class = argmax
  ours      class = argmax of column-max; logits = row mean
  avg       logits = row mean; class = argmax of the mean
  max       class = argmax of column-max; logits = column-max

Each is a function of sufficient statistics that scatter-accumulate into
dense grids: col_max, col_sum, col_exp (sum of exp, for logsumexp) and
the row count.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

SOLUTIONS = ("seal", "bayesian", "ours", "avg", "max")


class VoxelStats(NamedTuple):
    """Streaming per-voxel logit statistics, shapes [..., C] / [...]."""

    col_max: torch.Tensor
    col_sum: torch.Tensor
    col_exp: torch.Tensor
    count: torch.Tensor

    @staticmethod
    def empty(shape, num_classes: int, device="cuda") -> "VoxelStats":
        return VoxelStats(
            col_max=torch.full((*shape, num_classes), -torch.inf,
                               device=device),
            col_sum=torch.zeros((*shape, num_classes), device=device),
            col_exp=torch.zeros((*shape, num_classes), device=device),
            count=torch.zeros(tuple(shape), dtype=torch.int32, device=device),
        )


def resolve(stats: VoxelStats, solution: str):
    """(classes [...] int32, -1 where count == 0; logits [..., C], 0
    there) from accumulated stats."""
    if solution not in SOLUTIONS:
        raise ValueError(f"unknown consensus solution {solution!r}")
    occupied = stats.count > 0
    if solution in ("seal", "max"):
        logits = stats.col_max
        cls = logits.argmax(dim=-1)
    elif solution == "bayesian":
        lse = torch.log(torch.clamp(stats.col_exp, min=1e-30))
        norm = lse.sum(dim=-1, keepdim=True)
        logits = lse / torch.where(norm.abs() > 1e-30, norm, 1.0)
        cls = logits.argmax(dim=-1)
    else:
        logits = stats.col_sum / torch.clamp(stats.count, min=1
                                             ).float()[..., None]
        cls = (stats.col_max if solution == "ours" else logits
               ).argmax(dim=-1)
    cls = torch.where(occupied, cls, -1).to(torch.int32)
    return cls, torch.where(occupied[..., None], logits, 0.0)


def accumulate_rows(stats: VoxelStats, logits_rows: torch.Tensor,
                    valid: torch.Tensor) -> VoxelStats:
    """Fold logit rows [N, C] (masked by valid [N]) into one voxel's
    stats."""
    v = valid[:, None]
    return VoxelStats(
        col_max=torch.maximum(
            stats.col_max,
            torch.where(v, logits_rows, -torch.inf).amax(dim=0)),
        col_sum=stats.col_sum + torch.where(v, logits_rows, 0.0).sum(dim=0),
        col_exp=stats.col_exp + torch.where(v, torch.exp(logits_rows),
                                            0.0).sum(dim=0),
        count=stats.count + valid.to(torch.int32).sum(),
    )


def resolve_rows(logits_rows: torch.Tensor, valid: torch.Tensor,
                 solution: str):
    """Resolve a set of logit rows directly."""
    stats = VoxelStats.empty((), logits_rows.shape[-1], logits_rows.device)
    return resolve(accumulate_rows(stats, logits_rows, valid), solution)
