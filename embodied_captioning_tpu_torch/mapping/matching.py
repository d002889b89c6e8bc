"""Prediction <-> ground-truth instance-id assignment.

Detections get persistent object ids either by best-IoU match against
labeled instances (threshold 0.3, fresh ids from a counter starting at
500) or always-fresh unique ids (a counter from 5,000,000). The id counter
is explicit state (`IdAllocator`). Also the clustering label helpers
(DBSCAN, Wasserstein and grid labels).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.detections import Detections, pairwise_iou


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


FRESH_ID_START_MATCHED = 500
FRESH_ID_START_UNIQUE = 5_000_000


@dataclass
class IdAllocator:
    """Monotonic unique-id source."""

    next_id: int = FRESH_ID_START_UNIQUE

    def take(self, n: int) -> np.ndarray:
        ids = np.arange(self.next_id, self.next_id + n, dtype=np.int64)
        self.next_id += n
        return ids


def match_ids_iou(pred: Detections, gt: Detections,
                  allocator: Optional[IdAllocator] = None,
                  episode: int = -1, thr: float = 0.3,
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Best-IoU id assignment: each valid prediction inherits the object id
    of its best-overlapping GT instance if IoU > thr, else receives a
    fresh unique id. Returns (object_ids [N] int64, episode_ids [N] int64)
    as host arrays.

    With no allocator, fresh ids come from the matched-path 500-series
    counter so they are distinguishable from the unique-path
    5,000,000-series ids callers usually pass in."""
    if allocator is None:
        allocator = IdAllocator(FRESH_ID_START_MATCHED)
    n = pred.capacity
    pv = _host(pred.valid)
    gv = _host(gt.valid)
    out_ids = np.full((n,), -1, np.int64)
    out_eps = np.full((n,), -1, np.int64)
    if gv.any():
        iou = _host(pairwise_iou(torch.as_tensor(pred.boxes),
                                 torch.as_tensor(gt.boxes)).float())
        iou = iou * gv[None, :]
    else:
        iou = np.zeros((n, max(gt.capacity, 1)))
    gt_obj = (_host(gt.object_ids) if gt.object_ids is not None
              else np.full((gt.capacity,), -1))
    for i in np.nonzero(pv)[0]:
        j = int(np.argmax(iou[i])) if iou.shape[1] else 0
        if iou.shape[1] and iou[i, j] > thr and gt_obj[j] >= 0:
            out_ids[i] = gt_obj[j]
        else:
            out_ids[i] = allocator.take(1)[0]
        out_eps[i] = episode
    return out_ids, out_eps


# ---------------------------------------------------------------------------
# clustering label helpers
# ---------------------------------------------------------------------------


def _dbscan(dist: np.ndarray, eps: float, min_samples: int = 2) -> np.ndarray:
    """DBSCAN over a precomputed distance matrix (sklearn semantics on the
    shapes the reference uses: core point = >= min_samples neighbors incl.
    self; noise label -1), without sklearn."""
    n = dist.shape[0]
    labels = np.full(n, -1, np.int64)
    neighbors = [np.nonzero(dist[i] <= eps)[0] for i in range(n)]
    core = np.array([len(nb) >= min_samples for nb in neighbors])
    cluster = 0
    for i in range(n):
        if labels[i] != -1 or not core[i]:
            continue
        labels[i] = cluster
        stack = list(neighbors[i])
        while stack:
            j = stack.pop()
            if labels[j] == -1:
                labels[j] = cluster
                if core[j]:
                    stack.extend(neighbors[j])
        cluster += 1
    return labels


def _pairwise_distances(x: np.ndarray, squared: bool = False) -> np.ndarray:
    """||xi - xj|| matrix."""
    x = np.asarray(x, np.float64)
    sq = np.sum(x * x, axis=1)
    d2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T), 0.0)
    return d2 if squared else np.sqrt(d2)


def get_wasserstein_labels(centroids: np.ndarray, covs: np.ndarray,
                           thr: float) -> np.ndarray:
    """Cluster object observations by a 2-Wasserstein-style gaussian distance
    (squared centroid distance + squared covariance-vector distance), DBSCAN
    at eps=thr. As in the JAX package, the distance matrix is fed to
    DBSCAN as row *features* (sklearn's default metric), not as
    precomputed distances."""
    n = len(centroids)
    dist = (_pairwise_distances(centroids, squared=True)
            + _pairwise_distances(np.asarray(covs).reshape(n, -1),
                                  squared=True))
    return _dbscan(_pairwise_distances(dist), thr)


def get_centroids_labels_dbscan(centroids: np.ndarray,
                                infos: Optional[np.ndarray] = None,
                                thr: float = 4.0) -> np.ndarray:
    """DBSCAN on (centroid [, info]) euclidean distances; as in the JAX
    package, the *rows of the distance matrix* are clustered as feature
    vectors."""
    pts = np.asarray(centroids, np.float64)
    if infos is not None:
        pts = np.hstack([pts, np.asarray(infos, np.float64)[:, None]])
    feat = _pairwise_distances(pts, squared=False)
    return _dbscan(_pairwise_distances(feat), thr)


def get_centroids_labels_grid(centroids: np.ndarray,
                              infos: Optional[np.ndarray] = None,
                              thr: float = 4.0) -> np.ndarray:
    """Voxel-grid clustering: points sharing a (thr-sized) grid cell get the
    same label (torch_cluster.grid_cluster semantics)."""
    pts = np.asarray(centroids, np.float64)
    if infos is not None:
        pts = np.hstack([pts, np.asarray(infos, np.float64)[:, None]])
    cells = np.floor(pts / thr).astype(np.int64)
    _, labels = np.unique(cells, axis=0, return_inverse=True)
    return labels.astype(np.int64)


def unique_ids(pred: Detections, allocator: IdAllocator, episode: int,
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Always-fresh ids: every detection is a new observation-object;
    merging happens later in the map."""
    n = pred.capacity
    pv = _host(pred.valid)
    out_ids = np.full((n,), -1, np.int64)
    out_eps = np.full((n,), -1, np.int64)
    k = int(pv.sum())
    fresh = allocator.take(k)
    out_ids[np.nonzero(pv)[0]] = fresh
    out_eps[pv] = episode
    return out_ids, out_eps
