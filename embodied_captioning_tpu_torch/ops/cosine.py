"""Pairwise-cosine disagreement.

The disagreement score of an object is the mean pairwise cosine distance
over its multi-view caption embeddings, the zero diagonal included.
Embeddings live in fixed-capacity per-object buffers [..., M, K, D] with
per-object counts.
"""

from __future__ import annotations

import torch


def cosine_disagreement(embeddings: torch.Tensor, count: torch.Tensor,
                        eps: float = 1e-8) -> torch.Tensor:
    """embeddings [..., M, K, D] (rows >= count are ignored), count
    [..., M] int -> [..., M] float32 mean pairwise cosine distance;
    exactly 0 for objects with < 2 views."""
    k = embeddings.shape[-2]
    cnt = count.float()
    row_mask = (torch.arange(k, device=embeddings.device)
                < count[..., None])                      # [..., M, K]
    e = torch.where(row_mask[..., None], embeddings.float(), 0.0)
    norms = torch.sqrt((e * e).sum(dim=-1))
    safe = torch.clamp(norms, min=eps)
    gram = torch.matmul(e, e.transpose(-1, -2))
    cos = gram / (safe[..., :, None] * safe[..., None, :])
    pair_mask = row_mask[..., :, None] & row_mask[..., None, :]
    dist = torch.where(pair_mask, 1.0 - cos, 0.0)
    out = dist.sum(dim=(-2, -1)) / torch.clamp(cnt * cnt, min=1.0)
    return torch.where(count >= 2, out, 0.0)


def cosine_similarity_matrix(a: torch.Tensor, b: torch.Tensor,
                             eps: float = 1e-8) -> torch.Tensor:
    """[N, D] x [M, D] -> [N, M] cosine similarities."""
    an = a / torch.clamp(torch.linalg.norm(a, dim=-1, keepdim=True), min=eps)
    bn = b / torch.clamp(torch.linalg.norm(b, dim=-1, keepdim=True), min=eps)
    return an @ bn.T


def mean_pairwise_cosine_distance(embs: torch.Tensor, valid: torch.Tensor
                                  ) -> torch.Tensor:
    """Scalar mean pairwise cosine distance over one set [K, D] with a
    validity mask."""
    return cosine_disagreement(embs[None], valid.int().sum()[None])[0]
