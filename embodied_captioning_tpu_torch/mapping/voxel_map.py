"""3D semantic voxel map on the device: the disagreement core.

The map is a dense voxel grid over the scene bounds (0.05 m by default)
updated by scatter ops, with fixed-capacity object tables:

  grids   per-voxel streaming consensus stats (mapping/consensus.py) and
          the per-voxel owning object slot
  objects per-object centroid accumulators, class, and ring buffers of K
          view logits and K caption embeddings

Persistent object identity is resolved by centroid matching (same class
within a match radius).

`VoxelMapState` is a NamedTuple of tensors. Every function takes a state
for one env or, with a leading env axis on every field (and on the frame
inputs), for E envs at once; that axis replaces the JAX package's `vmap`.
`integrate_frame` consumes its state: it updates the tensors in place
(the JAX function's buffers are donated likewise) and returns the state.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import MapConfig
from ..ops.cosine import cosine_disagreement
from ..ops.geometry import (
    max_pool, backproject_depth, depth_outlier_mask, dilate_mask,
    erode_mask, morph_close, reciprocal32,
)
from .consensus import VoxelStats, resolve

MATCH_RADIUS = 0.75  # meters: detections this close to a centroid merge


class VoxelMapState(NamedTuple):
    # grids, flattened over voxels V = X*Y*Z
    col_max: torch.Tensor  # [V, C] f32 streaming column max of logits
    col_sum: torch.Tensor  # [V, C] f32 streaming column sum
    col_exp: torch.Tensor  # [V, C] f32 streaming sum of exp (bayesian)
    count: torch.Tensor    # [V] i32 observation count
    vox_obj: torch.Tensor  # [V] i32 owning object slot (-1 = free)
    # object tables, M slots
    obj_active: torch.Tensor   # [M] bool
    obj_class: torch.Tensor    # [M] i32
    obj_pos_sum: torch.Tensor  # [M, 3] f32
    obj_pts: torch.Tensor      # [M] f32 point count
    obj_logits: torch.Tensor   # [M, K, C] f32 ring buffer
    obj_logit_cnt: torch.Tensor  # [M] i32
    obj_emb: torch.Tensor      # [M, K, D] f32 ring buffer
    obj_emb_cnt: torch.Tensor  # [M] i32
    # geometry
    lower: torch.Tensor  # [3] world-space lower bound
    episode: torch.Tensor  # [] i32

    @property
    def num_objects(self) -> torch.Tensor:
        return self.obj_active.to(torch.int32).sum(dim=-1)


def create(cfg: MapConfig, lower_bound, episode: int = 0, device="cuda"
           ) -> VoxelMapState:
    """An empty map for one env, or for E envs when `lower_bound` is
    [E, 3]."""
    if isinstance(lower_bound, torch.Tensor):
        lower = lower_bound.to(device=device, dtype=torch.float32).clone()
    else:
        lower = torch.tensor(np.asarray(lower_bound, np.float32),
                             device=device)
    lead = tuple(lower.shape[:-1])
    X, Y, Z = cfg.grid
    V = X * Y * Z
    C = cfg.num_classes
    M = cfg.max_objects
    K = cfg.max_views_per_object
    D = cfg.embed_dim
    i32 = torch.int32

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(*lead, *shape, dtype=dtype, device=device)

    def full(shape, value, dtype=torch.float32):
        return torch.full((*lead, *shape), value, dtype=dtype, device=device)

    return VoxelMapState(
        col_max=full((V, C), -torch.inf),
        col_sum=zeros(V, C),
        col_exp=zeros(V, C),
        count=zeros(V, dtype=i32),
        vox_obj=full((V,), -1, i32),
        obj_active=zeros(M, dtype=torch.bool),
        obj_class=full((M,), -1, i32),
        obj_pos_sum=zeros(M, 3),
        obj_pts=zeros(M),
        obj_logits=zeros(M, K, C),
        obj_logit_cnt=zeros(M, dtype=i32),
        obj_emb=zeros(M, K, D),
        obj_emb_cnt=zeros(M, dtype=i32),
        lower=lower,
        episode=full((), episode, i32),
    )


# ---------------------------------------------------------------------------
# voxel indexing
# ---------------------------------------------------------------------------

def world_to_voxel(points: torch.Tensor, lower: torch.Tensor, cfg: MapConfig):
    """World points [..., 3] -> (flat voxel index [...] int64, in-bounds
    mask)."""
    X, Y, Z = cfg.grid
    ijk = torch.floor((points - lower) * reciprocal32(cfg.voxel_size)
                      ).to(torch.int32)
    hi = torch.tensor([X - 1, Y - 1, Z - 1], dtype=torch.int32,
                      device=points.device)
    inb = ((ijk >= 0) & (ijk <= hi)).all(dim=-1)
    ijk = torch.minimum(torch.clamp(ijk, min=0), hi).long()
    flat = (ijk[..., 0] * Y + ijk[..., 1]) * Z + ijk[..., 2]
    return flat, inb


def voxel_centers(flat: torch.Tensor, lower: torch.Tensor, cfg: MapConfig
                  ) -> torch.Tensor:
    X, Y, Z = cfg.grid
    x = flat // (Y * Z)
    y = (flat // Z) % Y
    z = flat % Z
    ijk = torch.stack([x, y, z], dim=-1).float()
    return lower + (ijk + 0.5) * cfg.voxel_size


# ---------------------------------------------------------------------------
# the per-frame fusion update
# ---------------------------------------------------------------------------

@torch.no_grad()
def integrate_frame(state: VoxelMapState, depth: torch.Tensor,
                    pose: torch.Tensor, masks: torch.Tensor,
                    classes: torch.Tensor, logits: torch.Tensor,
                    embeddings: torch.Tensor, det_valid: torch.Tensor,
                    cfg: MapConfig, hfov_deg: float = 79.0,
                    min_depth: float = 0.5, max_depth: float = 15.0,
                    ) -> VoxelMapState:
    """Fuse one frame's detections into the map, in place: mask erosion
    (7x7), depth clamps, per-instance 1-sigma depth outlier removal,
    voxelisation, streaming consensus stats, object identity.

    Args (each with an optional leading env axis, as the state):
      depth: [H, W]; pose: [4, 4] T_world_cam; masks: [N, H, W]
      float/bool; classes: [N] i32; logits: [N, C]; embeddings: [N, D];
      det_valid: [N].
    """
    if depth.dim() == 2:
        integrate_frame(
            VoxelMapState(*(x[None] for x in state)), depth[None], pose[None],
            masks[None], classes[None], logits[None], embeddings[None],
            det_valid[None], cfg, hfov_deg, min_depth, max_depth)
        return state
    e, n_det = masks.shape[:2]
    dev = depth.device
    det_valid = det_valid.bool()
    points, dvalid = backproject_depth(depth, pose, hfov_deg, min_depth,
                                       max_depth)            # [E, H, W, 3]
    flat_idx, inb = world_to_voxel(points, state.lower[:, None, None, :], cfg)
    V = state.count.shape[1]

    # per-detection refined pixel masks: erode 7x7, depth range, outliers
    m = erode_mask(masks > 0.5, 7) & dvalid[:, None]
    pix_masks = (depth_outlier_mask(depth[:, None], m)
                 & det_valid[:, :, None, None]).flatten(2)    # [E, N, P]

    # ---- object identity: sequential allocate/match over the N dets -------
    pix_counts = pix_masks.sum(dim=-1)                        # [E, N]
    csum = torch.bmm(pix_masks.float(), points.flatten(1, 2))  # [E, N, 3]
    counts_f = pix_counts.float()
    centroids = csum / torch.clamp(counts_f, min=1.0)[..., None]
    usable = det_valid & (pix_counts > 0)

    ar = torch.arange(e, device=dev)
    classes = classes.to(torch.int32)
    slots = torch.empty(e, n_det, dtype=torch.int64, device=dev)
    n_slots = state.obj_active.shape[1]
    slot_ids = torch.arange(n_slots, device=dev)
    for i in range(n_det):
        c, cls = centroids[:, i], classes[:, i]
        cent = state.obj_pos_sum / torch.clamp(state.obj_pts,
                                               min=1.0)[..., None]
        d = cent - c[:, None, :]
        dist = torch.sqrt((d * d).sum(dim=-1))                # [E, M]
        cand = (state.obj_active & (state.obj_class == cls[:, None])
                & (dist < MATCH_RADIUS))
        dist_m = torch.where(cand, dist, torch.inf)
        best_d, best = dist_m.min(dim=-1)
        # first inactive slot; when every slot is active and nothing
        # matched, drop the detection (slot -1) instead of merging it into
        # slot 0
        free = torch.where(state.obj_active, n_slots, slot_ids).amin(dim=-1)
        slot = torch.where(torch.isfinite(best_d), best,
                           torch.where(free < n_slots, free, -1))
        slot = torch.where(usable[:, i], slot, -1)
        upd = slot >= 0
        # a dropped detection writes slot 0's own values back: a no-op
        s = torch.clamp(slot, min=0)
        state.obj_active[ar, s] = state.obj_active[ar, s] | upd
        state.obj_class[ar, s] = torch.where(upd, cls, state.obj_class[ar, s])
        state.obj_pos_sum[ar, s] += torch.where(
            upd[:, None], c * counts_f[:, i, None], 0.0)
        state.obj_pts[ar, s] += torch.where(upd, counts_f[:, i], 0.0)
        slots[:, i] = slot

    # ---- append view logits / embeddings into the ring buffers ------------
    K = state.obj_emb.shape[2]
    ok_det = usable & (slots >= 0)
    logits = logits.float()
    embeddings = embeddings.float()
    for i in range(n_det):
        s = torch.clamp(slots[:, i], min=0)
        upd = ok_det[:, i]
        lpos = (state.obj_logit_cnt[ar, s] % K).long()
        epos = (state.obj_emb_cnt[ar, s] % K).long()
        state.obj_logits[ar, s, lpos] = torch.where(
            upd[:, None], logits[:, i], state.obj_logits[ar, s, lpos])
        state.obj_logit_cnt[ar, s] += upd.to(torch.int32)
        state.obj_emb[ar, s, epos] = torch.where(
            upd[:, None], embeddings[:, i], state.obj_emb[ar, s, epos])
        state.obj_emb_cnt[ar, s] += upd.to(torch.int32)

    # ---- voxel scatter of consensus stats + ownership ---------------------
    # Only the pixels that pass every mask are scattered (the JAX function
    # sends the others to a dump row appended to each grid). Detections
    # dropped on object-table overflow scatter nothing: their stats must
    # not accumulate, and -1 in vox_obj would erase a real object's
    # ownership. The loop over detections stays sequential: a later
    # detection overwrites an earlier one's vox_obj. Inside one detection
    # duplicate voxel targets all carry the same value, so the order of
    # the scatter's writes does not matter.
    pix_ok = (pix_masks & inb.flatten(1)[:, None] & ok_det[..., None]
              ).permute(1, 0, 2)                              # [N, E, P]
    _, e_idx, p_idx = pix_ok.nonzero(as_tuple=True)           # sorted by det
    per_det = pix_ok.sum(dim=(1, 2)).tolist()
    target = e_idx * V + flat_idx.flatten(1)[e_idx, p_idx]    # into [E*V]
    env_of = e_idx.split(per_det)
    col_max, col_sum, col_exp = (x.view(e * V, -1) for x in (
        state.col_max, state.col_sum, state.col_exp))
    count, vox_obj = state.count.view(e * V), state.vox_obj.view(e * V)
    det_exp = torch.exp(logits)
    one = torch.ones((), dtype=torch.int32, device=dev)
    for i, t in enumerate(target.split(per_det)):
        if t.numel() == 0:
            continue
        ei = env_of[i]
        col_max.scatter_reduce_(0, t[:, None].expand(-1, col_max.shape[1]),
                                logits[ei, i], "amax")
        col_sum.index_add_(0, t, logits[ei, i])
        col_exp.index_add_(0, t, det_exp[ei, i])
        count.index_add_(0, t, one.expand(t.numel()))
        vox_obj[t] = slots[ei, i].to(torch.int32)
    return state


# ---------------------------------------------------------------------------
# readouts
# ---------------------------------------------------------------------------

def object_disagreement(state: VoxelMapState, cfg: MapConfig) -> torch.Tensor:
    """[..., M] mean pairwise cosine distance of each object's view
    embeddings."""
    K = state.obj_emb.shape[-2]
    return cosine_disagreement(state.obj_emb,
                               torch.clamp(state.obj_emb_cnt, max=K))


def resolve_map(state: VoxelMapState, cfg: MapConfig):
    """Per-voxel (class, logits) via the configured consensus strategy."""
    stats = VoxelStats(state.col_max, state.col_sum, state.col_exp,
                       state.count)
    return resolve(stats, cfg.solution)


def _grid(x: torch.Tensor, cfg: MapConfig) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], *cfg.grid)


def _disagreement_map(state: VoxelMapState, cfg: MapConfig) -> torch.Tensor:
    """[..., Z, X] per-column max of the owning objects' disagreement
    scores, inflated 3x3."""
    M = state.obj_active.shape[-1]
    dis = object_disagreement(state, cfg)                     # [..., M]
    dis_pad = torch.cat([dis, torch.zeros_like(dis[..., :1])], dim=-1)
    owner = torch.where(state.vox_obj < 0, M, state.vox_obj).long()
    vox_dis = torch.gather(dis_pad, -1, owner)
    vox_dis = torch.where(state.count > 0, vox_dis, 0.0)
    dmap = _grid(vox_dis, cfg).amax(dim=-2)                   # [..., X, Z]
    # values are >= 0, so the pooling's padding never wins
    return max_pool(dmap.transpose(-1, -2), 3)


@torch.no_grad()
def topdown_maps(state: VoxelMapState, cfg: MapConfig) -> torch.Tensor:
    """4-channel top-down map [..., Z, X, 4]: (obstacle, explored,
    semantic, disagreement), at voxel resolution with rows = Z and
    cols = X. Obstacle = occupancy within the height band, dilated 3x3
    and closed; explored = any occupancy below the upper height; semantic
    = consensus class + 1 (0 = free); disagreement = per-column max of the
    owning objects' disagreement scores, inflated 3x3."""
    X, Y, Z = cfg.grid
    occ3 = _grid(state.count > 0, cfg)
    ylow, yhigh = cfg.height_thresh
    y_m = ((torch.arange(Y, device=state.count.device) + 0.5)
           * cfg.voxel_size + state.lower[..., 1:2])          # [..., Y]
    band = ((y_m > ylow) & (y_m < yhigh))[..., None, :, None]
    below_high = (y_m < yhigh)[..., None, :, None]

    obstacle = (occ3 & band).any(dim=-2)                      # [..., X, Z]
    explored = (occ3 & below_high).any(dim=-2)

    cls, _ = resolve_map(state, cfg)
    sem = torch.where(occ3 & below_high, _grid(cls, cfg) + 1, 0
                      ).amax(dim=-2)                          # 0 = free

    obstacle_t = morph_close(dilate_mask(obstacle.transpose(-1, -2), 3), 3)
    explored_t = morph_close(explored.transpose(-1, -2), 3) | obstacle_t
    return torch.stack([obstacle_t.float(), explored_t.float(),
                        sem.transpose(-1, -2).float(),
                        _disagreement_map(state, cfg)], dim=-1)


@torch.no_grad()
def disagreement_reward(state: VoxelMapState, cfg: MapConfig,
                        scale: float = 1e-3) -> torch.Tensor:
    """[...] reward = the disagreement channel of `topdown_maps`, summed,
    times `scale`."""
    return _disagreement_map(state, cfg).sum(dim=(-2, -1)) * scale


@torch.no_grad()
def kl_score(state: VoxelMapState, depth: torch.Tensor, pose: torch.Tensor,
             pred_masks: torch.Tensor, pred_logits: torch.Tensor,
             pred_valid: torch.Tensor, cfg: MapConfig,
             hfov_deg: float = 79.0) -> torch.Tensor:
    """Per-detection KL(map-consensus logits || prediction logits) over
    the pixels of each detection that land on mapped voxels, for one env
    (depth [H, W], pose [4, 4], pred_masks [N, H, W], pred_logits [N, C]).
    Returns [N] float32, 0 where a detection hits no mapped voxel or is
    invalid."""
    points, dvalid = backproject_depth(depth, pose, hfov_deg)
    flat_idx, inb = world_to_voxel(points, state.lower, cfg)
    _, map_logits = resolve_map(state, cfg)
    hit = ((pred_masks > 0.5) & (dvalid & inb)
           & (state.count > 0)[flat_idx])                    # [N, H, W]
    w = hit.float()
    n = torch.clamp(w.sum(dim=(1, 2)), min=1.0)
    tgt = torch.einsum("nhw,hwc->nc", w, map_logits[flat_idx]) / n[:, None]
    p = torch.softmax(tgt, dim=-1)
    logq = torch.log_softmax(pred_logits.float(), dim=-1)
    kl = (p * (torch.log(torch.clamp(p, min=1e-12)) - logq)).sum(dim=-1)
    kl = torch.where(hit.flatten(1).any(dim=1), kl, 0.0)
    return torch.where(pred_valid.bool(), kl, 0.0)


@torch.no_grad()
def raytrace_pseudo_labels(state: VoxelMapState, depth: torch.Tensor,
                           pose: torch.Tensor, cfg: MapConfig,
                           hfov_deg: float = 79.0, max_objects_out: int = 16,
                           min_pixels: int = 100):
    """Re-render the map's objects into a camera, for one env: each pixel's
    owning object by exact voxel lookup of the back-projected depth.

    Returns (masks [O, H, W] bool, object slots [O] int32, classes [O]
    int32, logits [O, C], valid [O]) of the `max_objects_out` objects with
    the most visible pixels (at least `min_pixels`), ties to the lower
    slot; each object's logits resolved from its ring buffer of view
    logits with the map's consensus strategy."""
    points, dvalid = backproject_depth(depth, pose, hfov_deg)
    flat_idx, inb = world_to_voxel(points, state.lower, cfg)
    ok = dvalid & inb
    vox_obj = torch.where(state.count > 0, state.vox_obj, -1)
    pix_obj = torch.where(ok, vox_obj[flat_idx], -1)            # [H, W]

    M = state.obj_active.shape[0]
    flat = pix_obj.reshape(-1)
    counts = torch.bincount(torch.where(flat < 0, M, flat).long(),
                            minlength=M + 1)[:M].to(torch.int32)
    eligible = state.obj_active & (counts >= min_pixels)
    counts_m = torch.where(eligible, counts, -1)
    top = torch.argsort(-counts_m, stable=True)[:max_objects_out]
    valid = eligible[top]

    masks = (pix_obj[None] == top[:, None, None]) & valid[:, None, None]
    classes = torch.where(valid, state.obj_class[top], -1)

    K = state.obj_logits.shape[1]
    rows = state.obj_logits[top]                                # [O, K, C]
    rcnt = torch.clamp(state.obj_logit_cnt[top], max=K)
    row_valid = (torch.arange(K, device=rows.device)[None, :]
                 < rcnt[:, None])[..., None]
    stats = VoxelStats(
        col_max=torch.where(row_valid, rows, -torch.inf).amax(dim=1),
        col_sum=torch.where(row_valid, rows, 0.0).sum(dim=1),
        col_exp=torch.where(row_valid, torch.exp(rows), 0.0).sum(dim=1),
        count=rcnt)
    _, logits = resolve(stats, cfg.solution)
    return masks, top.to(torch.int32), classes, logits, valid
