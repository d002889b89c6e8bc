"""Built-in simulator: procedural indoor scenes rendered by analytic
ray-AABB casting on the device.

Scenes are static AABB sets with per-box class, instance and albedo.
Rendering is exact (no marching): slab-test every ray against every box,
take the nearest hit, shade lambertian with a hash-noise texture. The
visibility pass (nearest hit and its box index per ray) is the raycast
kernel on the card and its plain version on the CPU; everything after it
is the same tensor code on both. Every render mode of the JAX package is
accepted (`render_batch`); the tile-culled one ("onehot@TxK") slab-tests
each tile's candidate boxes in plain tensor ops, as the JAX package
computes it outside any kernel.

Geometry: +Y up, agent yaw about +Y, the camera looks down -Z (see
ops/geometry.py). Scene generation is host-side numpy with
`np.random.default_rng`, so a seed gives the same scene as in the JAX
package.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import CLASS_NAMES, NUM_CLASSES, SensorConfig, SimConfig
from ..kernels import raycast_minargmin
from ..ops.detections import Detections, boxes_from_masks
from ..ops.geometry import (
    fma, intrinsics_from_hfov, reciprocal32, rotate,
)
from ..sensor_data import Pose, quat_from_yaw

AGENT_RADIUS = 0.2
AGENT_HEIGHT = 0.88  # camera height above the floor


class Scene(NamedTuple):
    """Static AABB scene, padded to max_boxes; batched scenes carry a
    leading env axis on every field. Objects may span several boxes
    sharing one instance_id (composite furniture). Per-scene lighting and
    texture fields vary the appearance across scenes."""

    box_min: torch.Tensor    # [B, 3]
    box_max: torch.Tensor    # [B, 3]
    albedo: torch.Tensor     # [B, 3] float 0..1
    class_id: torch.Tensor   # [B] int32 local class, -1 = structure
    instance_id: torch.Tensor  # [B] int32 unique per object, -1 = structure
    valid: torch.Tensor      # [B] bool
    lower: torch.Tensor      # [3] scene bounds
    upper: torch.Tensor      # [3]
    light_dir: torch.Tensor  # [3] unit, per scene
    ambient: torch.Tensor    # [] 0..1
    tex_amp: torch.Tensor    # [] texture contrast


# object footprint (w, h, d ranges in meters) per class
# object footprint (w, h, d ranges in meters) per class
_OBJ_DIMS = {
    "couch": ((1.4, 2.2), (0.7, 0.9), (0.8, 1.0)),
    "plant": ((0.3, 0.6), (0.5, 1.4), (0.3, 0.6)),
    "bed": ((1.4, 2.0), (0.5, 0.7), (1.9, 2.2)),
    "table": ((0.8, 1.8), (0.7, 0.8), (0.8, 1.2)),
    "toilet": ((0.4, 0.5), (0.7, 0.8), (0.6, 0.7)),
    "tv": ((0.9, 1.6), (0.6, 0.9), (0.1, 0.15)),
}
_OBJ_COLORS = {
    "couch": (0.55, 0.27, 0.15), "plant": (0.13, 0.55, 0.13),
    "bed": (0.66, 0.66, 0.86), "table": (0.52, 0.37, 0.26),
    "toilet": (0.92, 0.92, 0.95), "tv": (0.08, 0.08, 0.1),
}


def generate_scene(cfg: SimConfig, seed: Optional[int] = None,
                   device="cuda") -> Scene:
    """Procedural room: floor, 4 walls, ceiling, `num_objects` furniture
    boxes with non-overlapping footprints, as tensors on `device`."""
    rng = np.random.default_rng(cfg.scene_seed if seed is None else seed)
    size = cfg.scene_size
    wall_h = 2.6
    t = 0.15  # structure thickness
    mins: List[np.ndarray] = []
    maxs: List[np.ndarray] = []
    albs: List[Tuple[float, float, float]] = []
    clss: List[int] = []
    inst: List[int] = []

    def add(mn, mx, alb, cls=-1, iid=-1):
        mins.append(np.asarray(mn, np.float32))
        maxs.append(np.asarray(mx, np.float32))
        albs.append(alb)
        clss.append(cls)
        inst.append(iid)

    # floor / ceiling / walls — per-scene material variation (wood/carpet/
    # tile floors, painted walls): unseen scenes look genuinely different
    floor = tuple(np.clip(
        np.asarray(rng.choice([(0.75, 0.72, 0.68), (0.55, 0.38, 0.24),
                               (0.45, 0.5, 0.55), (0.7, 0.6, 0.5)]))
        + rng.normal(0, 0.05, 3), 0.05, 0.95))
    wall = tuple(np.clip(
        np.asarray((0.85, 0.83, 0.8)) * rng.uniform(0.6, 1.1)
        + rng.normal(0, 0.04, 3), 0.1, 0.95))
    add([0, -t, 0], [size, 0, size], floor)
    add([0, wall_h, 0], [size, wall_h + t, size], (0.9, 0.9, 0.9))
    add([-t, 0, -t], [0, wall_h, size + t], wall)
    add([size, 0, -t], [size + t, wall_h, size + t], wall)
    add([-t, 0, -t], [size + t, wall_h, 0], tuple(0.95 * c for c in wall))
    add([-t, 0, size], [size + t, wall_h, size + t],
        tuple(0.95 * c for c in wall))

    # interior wall segments for occlusion structure
    for _ in range(cfg.interior_walls):
        if rng.random() < 0.5:
            x0 = rng.uniform(0.25, 0.7) * size
            z0 = rng.uniform(0.1, 0.5) * size
            add([x0, 0, z0], [x0 + t, wall_h, z0 + rng.uniform(0.2, 0.4) * size],
                (0.82, 0.8, 0.78))
        else:
            x0 = rng.uniform(0.1, 0.5) * size
            z0 = rng.uniform(0.25, 0.7) * size
            add([x0, 0, z0], [x0 + rng.uniform(0.2, 0.4) * size, wall_h, z0 + t],
                (0.82, 0.8, 0.78))

    # furniture
    placed: List[Tuple[float, float, float, float]] = []
    iid = 0
    tries = 0
    while iid < cfg.num_objects and tries < 200:
        tries += 1
        cls = int(rng.integers(0, NUM_CLASSES))
        name = CLASS_NAMES[cls]
        (w0, w1), (h0, h1), (d0, d1) = _OBJ_DIMS[name]
        w, h, d = rng.uniform(w0, w1), rng.uniform(h0, h1), rng.uniform(d0, d1)
        x = rng.uniform(0.5, size - 0.5 - w)
        z = rng.uniform(0.5, size - 0.5 - d)
        rect = (x - 0.3, z - 0.3, x + w + 0.3, z + d + 0.3)
        if any(not (rect[2] < r[0] or rect[0] > r[2] or rect[3] < r[1]
                    or rect[1] > r[3]) for r in placed):
            continue
        placed.append(rect)
        base = np.asarray(_OBJ_COLORS[name])
        # wide material jitter: color alone must not identify the class
        alb = tuple(np.clip(base * rng.uniform(0.55, 1.45)
                            + rng.normal(0, 0.10, 3), 0.02, 0.98))
        y0 = 0.0
        if name == "tv":
            y0 = rng.uniform(0.6, 1.2)  # mounted
        # composite shapes give each class a geometric signature
        if name == "couch":
            seat_h = h * rng.uniform(0.4, 0.55)
            add([x, 0, z], [x + w, seat_h, z + d], alb, cls, iid)  # seat
            bd = d * rng.uniform(0.2, 0.3)
            add([x, seat_h, z], [x + w, h, z + bd], alb, cls, iid)  # back
            aw = w * rng.uniform(0.08, 0.14)
            arm_h = h * rng.uniform(0.7, 0.9)
            add([x, seat_h, z], [x + aw, arm_h, z + d], alb, cls, iid)
            add([x + w - aw, seat_h, z], [x + w, arm_h, z + d], alb, cls,
                iid)
        elif name == "table":
            top = h * rng.uniform(0.1, 0.18)
            lw = min(w, d) * rng.uniform(0.08, 0.15)
            add([x, h - top, z], [x + w, h, z + d], alb, cls, iid)  # top
            for lx, lz in ((x, z), (x + w - lw, z), (x, z + d - lw),
                           (x + w - lw, z + d - lw)):
                add([lx, 0, lz], [lx + lw, h - top, lz + lw], alb, cls, iid)
        elif name == "bed":
            add([x, 0, z], [x + w, h, z + d], alb, cls, iid)  # mattress
            hb_h = h * rng.uniform(1.4, 2.0)
            add([x, 0, z], [x + w, hb_h, z + 0.08], alb, cls, iid)  # headbd
            pw = w * rng.uniform(0.3, 0.42)
            pill = tuple(np.clip(np.asarray(alb) + 0.25, 0, 0.98))
            add([x + 0.1 * w, h, z + 0.1], [x + 0.1 * w + pw, h + 0.12,
                                            z + 0.1 + 0.35], pill, cls, iid)
        elif name == "plant":
            pot_h = h * rng.uniform(0.25, 0.4)
            pot = (0.5 + rng.uniform(-0.2, 0.3), 0.3, 0.25)
            add([x, 0, z], [x + w, pot_h, z + d], pot, cls, iid)  # pot
            fw = w * rng.uniform(0.7, 1.3)
            cx = x + w / 2
            cz = z + d / 2
            add([cx - fw / 2, pot_h, cz - fw / 2],
                [cx + fw / 2, h, cz + fw / 2], alb, cls, iid)  # foliage
        else:
            add([x, y0, z], [x + w, y0 + h, z + d], alb, cls, iid)
        iid += 1

    # distractor clutter: non-target objects (class_id/instance_id -1, like
    # structure) whose colors come from the target classes' jittered
    # palettes and whose footprints may sit flush against furniture: the
    # detector must reject them on shape and context, and they partially
    # occlude real objects
    placed_d = 0
    tries = 0
    while placed_d < cfg.num_distractors and tries < 200:
        tries += 1
        w = rng.uniform(0.3, 1.2)
        h = rng.uniform(0.3, 1.3)
        d = rng.uniform(0.3, 1.2)
        x = rng.uniform(0.4, size - 0.4 - w)
        z = rng.uniform(0.4, size - 0.4 - d)
        # allow near-contact with furniture (occlusion pressure) but keep
        # footprints from swallowing an object whole
        rect = (x, z, x + w, z + d)
        overlap = sum(
            max(0.0, min(rect[2], r[2]) - max(rect[0], r[0]))
            * max(0.0, min(rect[3], r[3]) - max(rect[1], r[1]))
            for r in placed)
        if overlap > 0.25 * w * d:
            continue
        base = np.asarray(_OBJ_COLORS[CLASS_NAMES[
            int(rng.integers(0, NUM_CLASSES))]])
        alb = tuple(np.clip(base * rng.uniform(0.55, 1.45)
                            + rng.normal(0, 0.10, 3), 0.02, 0.98))
        y0 = rng.uniform(0.0, 0.3) if rng.random() < 0.8 else rng.uniform(
            0.5, 1.0)
        add([x, y0, z], [x + w, y0 + h, z + d], alb)
        if rng.random() < 0.4:  # stacked second box: composite clutter
            sw, sd = w * rng.uniform(0.4, 0.8), d * rng.uniform(0.4, 0.8)
            add([x + (w - sw) / 2, y0 + h, z + (d - sd) / 2],
                [x + (w + sw) / 2, y0 + h + rng.uniform(0.2, 0.6),
                 z + (d + sd) / 2], alb)
        placed_d += 1

    n = len(mins)
    assert n <= cfg.max_boxes, f"scene has {n} boxes > capacity"
    pad = cfg.max_boxes - n
    box_min = np.stack(mins + [np.zeros(3, np.float32)] * pad)
    box_max = np.stack(maxs + [np.zeros(3, np.float32)] * pad)
    albedo = np.asarray(albs + [(0, 0, 0)] * pad, np.float32)
    class_id = np.asarray(clss + [-1] * pad, np.int32)
    instance_id = np.asarray(inst + [-1] * pad, np.int32)
    valid = np.asarray([True] * n + [False] * pad)
    # per-scene illumination: azimuth/elevation + ambient + texture contrast
    az = rng.uniform(0, 2 * np.pi)
    el = rng.uniform(0.5, 1.3)
    light = np.asarray([np.cos(az) * np.cos(el), np.sin(el),
                        np.sin(az) * np.cos(el)], np.float32)
    def dev(a, dtype=None):
        return torch.from_numpy(np.asarray(a, dtype)).to(device)

    return Scene(
        box_min=dev(box_min), box_max=dev(box_max), albedo=dev(albedo),
        class_id=dev(class_id), instance_id=dev(instance_id),
        valid=dev(valid),
        lower=dev([-t, -t, -t], np.float32),
        upper=dev([size + t, wall_h + t, size + t], np.float32),
        light_dir=dev(light / np.linalg.norm(light)),
        ambient=dev(rng.uniform(0.25, 0.5), np.float32),
        tex_amp=dev(rng.uniform(0.05, 0.22) + cfg.tex_boost, np.float32),
    )


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

_HASH_X, _HASH_Y, _HASH_Z = 12.9898, 78.233, 37.719


def _hash_noise(p: torch.Tensor) -> torch.Tensor:
    """Cheap value noise in [0, 1) from a world position [..., 3].

    `sin(..) * 43758.5453` amplifies one ulp of the sine's argument to
    the whole range of the noise, so the argument's rounding is pinned:
    fma(z, cz, fma(x, cx, y * cy)), the order in which XLA's CPU compiler
    contracts the JAX package's `x*cx + y*cy + z*cz`. Spelled through
    float64 (see ops.geometry.fma), it is the same on the CPU and on the
    card."""
    cx, cy, cz = (torch.tensor(c, dtype=torch.float32, device=p.device)
                  for c in (_HASH_X, _HASH_Y, _HASH_Z))
    arg = fma(p[..., 2], cz, fma(p[..., 0], cx, p[..., 1] * cy))
    return torch.remainder(torch.sin(arg) * 43758.5453, 1.0)


def _gather_boxes(table: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """table [E, Bx, C], best [E, H, W] int64 -> [E, H, W, C]."""
    e, h, w = best.shape
    c = table.shape[-1]
    idx = best.reshape(e, h * w, 1).expand(e, h * w, c)
    return torch.gather(table, 1, idx).reshape(e, h, w, c)


def ray_directions(poses: torch.Tensor, height: int, width: int,
                   hfov_deg: float):
    """The pixel rays of cameras `poses` [E, 4, 4]: (origin [E, 3], world
    directions [E, H, W, 3] on the unit z = -1 plane, their reciprocals
    with zero components clamped to +-1e8)."""
    dev = poses.device
    fx, fy, xc, yc = intrinsics_from_hfov(height, width, hfov_deg)
    ys = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    dx = ((xs - xc) * reciprocal32(fx)).expand(height, width)
    dy = (-(ys - yc) * reciprocal32(fy)).expand(height, width)
    dirs_cam = torch.stack([dx, dy, -torch.ones_like(dx)], dim=-1)
    R = poses[:, :3, :3].float()
    origin = poses[:, :3, 3].float()
    dirs = rotate(dirs_cam, R)
    inv = 1.0 / torch.where(dirs.abs() < 1e-8,
                            torch.where(dirs >= 0, 1e-8, -1e-8), dirs)
    return origin, dirs, inv


def _parse_cull(attr_mode: str):
    """"onehot@160x48" -> ("onehot", 160, 48); no "@" -> (mode, 0, 0)."""
    if "@" not in attr_mode:
        return attr_mode, 0, 0
    mode, spec = attr_mode.split("@", 1)
    t, k = spec.split("x")
    return mode, int(t), int(k)


def resolve_attr_mode(mode: Optional[str], height: int, width: int) -> str:
    """The render mode of a `height` x `width` sensor asked for `mode`
    (the JAX package reads it from ECAP_RENDER_MODE): None is "onehot",
    and a culled mode whose tile does not divide the image falls back to
    its base."""
    if mode is None:
        return "onehot"
    base, tile, _ = _parse_cull(mode)
    if tile and (height % tile or width % tile):
        return base
    return mode


_BASE_MODES = ("gather", "onehot", "onehot16")


def _split_mode(attr_mode: str) -> Tuple[str, int, int]:
    """(base mode, tile, K) of a render mode; tile 0 for the full slab
    test. The "+vr" and "+pk" suffixes name the JAX package's two other
    spellings of the visibility pass (a variadic (min, argmin) reduce and
    its Pallas raycast kernel), which give the same bits as its
    `argmin` / `min`: here every one of them is the raycast kernel."""
    base, tile, k = _parse_cull(attr_mode)
    if tile:
        if base != "onehot":
            raise ValueError("culling supports the onehot base mode only")
        return base, tile, k
    if base.endswith(("+vr", "+pk")):
        base = base[:-3]
    if base not in _BASE_MODES:
        raise ValueError(f"unknown attr_mode {attr_mode!r}")
    return base, 0, 0


def _tile_candidates(scenes: Scene, origin: torch.Tensor, R: torch.Tensor,
                     fx: float, fy: float, xc: float, yc: float,
                     height: int, width: int, tile: int, k: int):
    """Conservative per-tile candidate boxes for the culled render, per
    env (the JAX package's `_tile_candidates` with a leading env axis).

    Each AABB's 8 corners are projected to the screen; a box whose corners
    all lie strictly in front of the camera gets the bbox of their
    projections, padded by a pixel (a pixel whose ray hits the box lies
    inside it); a box with a corner at or behind the camera plane is a
    candidate for every tile. The corner rotation and the projection are
    spelled as XLA's CPU compiler computes them (`rotate`, `fma`; ROADMAP
    C.10), so the candidate sets are the JAX package's.

    Returns (cand [E, T, K] int64: ascending box indices, padded with the
    last box; cand_valid [E, T, K] bool; overflow [E] int64: the most
    candidates a tile of the env dropped beyond K). overflow 0 makes the
    culled render the full one, bit for bit."""
    nb = scenes.box_min.shape[-2]
    dev = scenes.box_min.device
    th, tw = height // tile, width // tile
    bit = torch.arange(3, device=dev)
    sel = ((torch.arange(8, device=dev)[:, None] >> bit[None]) & 1) == 1
    corners = torch.where(sel[None, None], scenes.box_max[:, :, None, :],
                          scenes.box_min[:, :, None, :])      # [E, B, 8, 3]
    # (corners - origin) @ R as XLA's dot sums it: rotate(v, R^T)
    q = rotate(corners - origin[:, None, None, :], R.transpose(-1, -2))
    z = q[..., 2]
    front = (z < -1e-6).all(dim=-1)                           # [E, B]
    zsafe = torch.clamp(z, max=-1e-6)
    fxt, fyt, xct, yct = (torch.tensor(v, dtype=torch.float32, device=dev)
                          for v in (fx, fy, xc, yc))
    sx = fma(q[..., 0] / -zsafe, fxt, xct)
    sy = fma(q[..., 1] / -zsafe, -fyt, yct)
    pad = 1.0  # float32 projection rounding guard (px)
    inf = torch.tensor(math.inf, device=dev)
    bxmin = torch.where(front, sx.amin(-1) - pad, -inf)
    bxmax = torch.where(front, sx.amax(-1) + pad, inf)
    bymin = torch.where(front, sy.amin(-1) - pad, -inf)
    bymax = torch.where(front, sy.amax(-1) + pad, inf)
    tx0 = (torch.arange(tw, device=dev) * tile).float()[None, :, None]
    ty0 = (torch.arange(th, device=dev) * tile).float()[None, :, None]
    ox = (bxmax[:, None] >= tx0) & (bxmin[:, None] <= tx0 + tile - 1)
    oy = (bymax[:, None] >= ty0) & (bymin[:, None] <= ty0 + tile - 1)
    overlap = (oy[:, :, None, :] & ox[:, None, :, :]
               & scenes.valid[:, None, None, :]).reshape(-1, th * tw, nb)
    ids = torch.arange(nb, device=dev)
    cand = torch.sort(torch.where(overlap, ids, nb), dim=-1).values[..., :k]
    count = overlap.sum(dim=-1).amax(dim=-1)
    overflow = torch.clamp(count - k, min=0)
    return torch.clamp(cand, max=nb - 1), cand < nb, overflow


def _culled_visibility(scenes: Scene, table: torch.Tensor,
                       origin: torch.Tensor, R: torch.Tensor,
                       inv: torch.Tensor, height: int, width: int,
                       hfov_deg: float, tile: int, k: int):
    """The culled visibility pass and attribute selection: each tile's
    rays slab-tested against its K candidates only (batched over envs and
    tiles), the nearest hit's attributes taken from the candidates' rows
    of `table` [E, Bx, 11]. Returns (t_best [E, H, W], attrs [E, H, W,
    11])."""
    if height % tile or width % tile:
        raise ValueError("image size must be divisible by the tile")
    e, nb = table.shape[:2]
    k = min(k, nb)
    fx, fy, xc, yc = intrinsics_from_hfov(height, width, hfov_deg)
    cand, cand_valid, _ = _tile_candidates(scenes, origin, R, fx, fy, xc,
                                           yc, height, width, tile, k)
    nth, ntw = height // tile, width // tile
    rows = torch.arange(e, device=table.device)[:, None, None]
    tab = table[rows, cand]                                 # [E, T, K, 11]
    o = origin[:, None, None, :]
    a_min = (scenes.box_min[rows, cand] - o)[:, :, None, None]
    a_max = (scenes.box_max[rows, cand] - o)[:, :, None, None]
    inv_t = inv.reshape(e, nth, tile, ntw, tile, 3).permute(
        0, 1, 3, 2, 4, 5).reshape(e, nth * ntw, tile, tile, 1, 3)
    t0, t1 = a_min * inv_t, a_max * inv_t         # [E, T, t, t, K, 3]
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    del t0, t1
    hit = ((t_near <= t_far) & (t_far > 1e-4)
           & cand_valid[:, :, None, None, :])
    t_hit = torch.where(hit, torch.clamp(t_near, min=1e-4), torch.inf)
    t_b = t_hit.amin(dim=-1)                                # [E, T, t, t]
    # the first lowest candidate (all-miss: 0), as jnp.argmin
    best = torch.where(t_hit == t_b[..., None],
                       torch.arange(k, device=table.device), k).amin(-1)
    best = torch.clamp(best, max=k - 1)
    attrs = torch.gather(tab, 2, best.reshape(e, nth * ntw, -1, 1).expand(
        -1, -1, -1, 11)).reshape(e, nth * ntw, tile, tile, 11)

    def from_tiles(x: torch.Tensor) -> torch.Tensor:
        c = x.shape[4:]
        x = x.reshape(e, nth, ntw, tile, tile, *c).transpose(2, 3)
        return x.reshape(e, height, width, *c)

    return from_tiles(t_b), from_tiles(attrs)


@torch.no_grad()
def render_batch(scenes: Scene, poses: torch.Tensor, height: int, width: int,
                 hfov_deg: float, max_depth: float = 15.0,
                 attr_mode: str = "onehot") -> Dict[str, torch.Tensor]:
    """Render one camera per env.

    Args:
      scenes: batched Scene ([E, ...] on every field).
      poses: [E, 4, 4] T_world_cam (the camera looks down -Z).
      attr_mode: how the winning box's attributes reach each pixel, any
        mode of the JAX package's `render`. "onehot" contracts a {0,1}
        [H*W, Bx] matrix with the [Bx, 11] attribute table (exactly one
        non-zero float32 term per pixel, so it equals "gather" bit for
        bit); "onehot16" builds that matrix in bf16 (0 and 1 are exact)
        and widens it before the product; "gather" indexes the table. A
        "+vr" or "+pk" suffix names another spelling of the visibility
        pass in the JAX package; here every mode's visibility is the
        raycast kernel. "onehot@TxK" tests each TxT tile's rays against
        its K candidate boxes only (`_tile_candidates`): the same bits
        unless a tile has more than K candidates, where the K lowest
        indices are kept, as in the JAX package.

    Returns dict: rgb [E, H, W, 3] uint8, depth [E, H, W] f32 meters
    (planar depth along the camera's -Z), instances [E, H, W] i32
    per-pixel instance id (-1 none), classes [E, H, W] i32 (-1 none).
    """
    base, tile, cull_k = _split_mode(attr_mode)
    dev = poses.device
    origin, dirs, inv = ray_directions(poses, height, width, hfov_deg)
    table = None
    if base != "gather":
        table = torch.cat(
            [scenes.box_min, scenes.box_max, scenes.albedo,
             scenes.class_id[..., None].float(),
             scenes.instance_id[..., None].float()], dim=-1)   # [E, Bx, 11]
    attrs = None
    if tile:
        t_best, attrs = _culled_visibility(
            scenes, table, origin, poses[:, :3, :3].float(), inv, height,
            width, hfov_deg, tile, cull_k)
    else:
        # visibility: nearest hit and its box per ray; the [H, W, Bx]
        # hit-distance tensor exists only in the plain version
        o = origin[:, None, :]
        t_best, best = raycast_minargmin(scenes.box_min - o,
                                         scenes.box_max - o,
                                         scenes.valid, inv)
    valid = torch.isfinite(t_best)

    # planar depth: dirs_cam has z = -1, so the distance along -Z is t
    depth = torch.where(valid, torch.clamp(t_best, max=max_depth), max_depth)

    # shading
    # one rounding (see ops.geometry.fma): XLA contracts the JAX package's
    # `origin + dirs * t` the same way, and floor(p_hit * 7) below is
    # sensitive to the last bit
    p_hit = fma(dirs, t_best[..., None], origin[:, None, None, :])
    if attrs is None and base != "gather":
        best = best.long()
        nb = table.shape[1]
        attrs = torch.empty(*best.shape, 11, device=dev)
        # one env at a time bounds the {0,1} matrix to H*W*Bx floats
        for i in range(best.shape[0]):
            oh = best[i].reshape(-1, 1) == torch.arange(nb, device=dev)
            oh = (oh.to(torch.bfloat16).float() if base == "onehot16"
                  else oh.float())
            attrs[i] = torch.matmul(oh, table[i]).reshape(height, width, 11)
    if attrs is not None:
        bmin, bmax = attrs[..., 0:3], attrs[..., 3:6]
        albedo_px = attrs[..., 6:9]
        class_px = torch.round(attrs[..., 9]).to(torch.int32)
        inst_px = torch.round(attrs[..., 10]).to(torch.int32)
    else:
        best = best.long()
        bmin = _gather_boxes(scenes.box_min, best)
        bmax = _gather_boxes(scenes.box_max, best)
        albedo_px = _gather_boxes(scenes.albedo, best)
        class_px = torch.gather(scenes.class_id, 1,
                                best.flatten(1)).reshape(best.shape)
        inst_px = torch.gather(scenes.instance_id, 1,
                               best.flatten(1)).reshape(best.shape)
    # face normal: the axis where the hit point touches a slab
    eps = 1e-3
    normal = torch.where((p_hit - bmin).abs() < eps, -1.0,
                         torch.where((p_hit - bmax).abs() < eps, 1.0, 0.0))
    nn = torch.clamp(torch.sqrt((normal * normal).sum(dim=-1, keepdim=True)),
                     min=1e-6)
    normal = normal / nn
    light = scenes.light_dir[:, None, None, :]
    lambert = torch.clamp((normal * light).sum(dim=-1), 0.0, 1.0)
    amb = scenes.ambient[:, None, None]
    amp = scenes.tex_amp[:, None, None]
    tex = 1.0 - amp + amp * _hash_noise(torch.floor(p_hit * 7.0))
    shade = (amb + (1.0 - amb) * lambert) * tex
    rgb = albedo_px * shade[..., None]
    rgb = torch.where(valid[..., None], rgb, 0.0)
    rgb_u8 = torch.clamp(rgb * 255.0, 0, 255).to(torch.uint8)

    return {"rgb": rgb_u8, "depth": depth,
            "instances": torch.where(valid, inst_px, -1),
            "classes": torch.where(valid, class_px, -1)}


# device bytes `render_batch` holds per ray at its peak, outputs included
# (float32 rays, reciprocals and hit points with their float64
# temporaries, the [H, W, 11] attribute table, shading temporaries), and
# the {0,1} [H*W, Bx] product it builds for one env at a time (bool and
# float32, or bf16 then float32): what `render_batch_chunked` budgets for
# (16 envs at 1280^2 and 96 boxes take about 2/3 of this on an H100,
# chip_smoke.py phase 8). The culled mode holds, for every env of the
# call at once, [tiles, tile^2, K] slab tests: two float32 [.., 3] hit
# distances and their min / max temporaries, the near and far distances,
# the hit masks and distances and the argmin's temporaries, per ray and
# candidate
RENDER_BYTES_PER_RAY = 256
ONEHOT_BYTES_PER_RAY_BOX = 5
ONEHOT16_BYTES_PER_RAY_BOX = 7
CULL_BYTES_PER_RAY_CAND = 80


def render_batch_chunked(scenes: Scene, poses: torch.Tensor, height: int,
                         width: int, hfov_deg: float, max_depth: float = 15.0,
                         budget_bytes: int = 6 << 30,
                         attr_mode: str = "onehot"
                         ) -> Dict[str, torch.Tensor]:
    """`render_batch` in chunks of envs that bound device memory: the
    chunk is the largest divisor of the batch whose intermediates
    (RENDER_BYTES_PER_RAY per ray and env, plus one env's one-hot
    product, or each env's culled slab tests) fit `budget_bytes`, so
    every chunk has one shape."""
    base, tile, cull_k = _split_mode(attr_mode)
    n = poses.shape[0]
    rays = height * width
    nb = scenes.box_min.shape[-2]
    per_ray = RENDER_BYTES_PER_RAY
    fixed = 0
    if tile:
        per_ray += min(cull_k, nb) * CULL_BYTES_PER_RAY_CAND
    elif base != "gather":
        fixed = rays * nb * (ONEHOT16_BYTES_PER_RAY_BOX if base == "onehot16"
                             else ONEHOT_BYTES_PER_RAY_BOX)
    cap = max(1, (budget_bytes - fixed) // (rays * per_ray))
    if cap >= n:
        return render_batch(scenes, poses, height, width, hfov_deg,
                            max_depth, attr_mode)
    chunk = max(d for d in range(1, cap + 1) if n % d == 0)
    outs = [render_batch(Scene(*(x[i:i + chunk] for x in scenes)),
                         poses[i:i + chunk], height, width, hfov_deg,
                         max_depth, attr_mode)
            for i in range(0, n, chunk)]
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def render(scene: Scene, pose: torch.Tensor, height: int, width: int,
           hfov_deg: float, max_depth: float = 15.0,
           attr_mode: str = "onehot") -> Dict[str, torch.Tensor]:
    """Render one camera: `render_batch` for one scene and one [4, 4]
    pose, without the env axis."""
    out = render_batch(Scene(*(x[None] for x in scene)), pose[None], height,
                       width, hfov_deg, max_depth, attr_mode)
    return {k: v[0] for k, v in out.items()}


def gt_detections(instances: torch.Tensor, classes: torch.Tensor,
                  max_instances: int = 16, min_pixels: int = 300
                  ) -> Detections:
    """Per-pixel instance/class ids [H, W] -> padded ground-truth
    Detections with full-frame masks and one-hot logits; instances below
    `min_pixels` are dropped."""
    dev = instances.device
    ids = torch.arange(max_instances, device=dev)
    masks = instances[None, :, :] == ids[:, None, None]  # [M, H, W]
    areas = masks.sum(dim=(1, 2))
    valid = areas >= min_pixels
    big = 1 << 30
    # class of each instance: min over pixels (uniform anyway)
    cls = torch.where(masks, torch.where(classes[None] < 0, big,
                                         classes[None]), big).amin(dim=(1, 2))
    cls = torch.where(valid, cls, 0).to(torch.int32)
    boxes = boxes_from_masks(masks.float(), valid)
    logits = torch.nn.functional.one_hot(
        cls.long(), NUM_CLASSES).float() * valid[:, None]
    return Detections(
        boxes=boxes, classes=cls * valid,
        scores=valid.float(), logits=logits, valid=valid,
        masks=masks.float(),
        object_ids=torch.where(valid, ids, -1).to(torch.int32),
        episode_ids=torch.full((max_instances,), -1, dtype=torch.int32,
                               device=dev),
    )


# ---------------------------------------------------------------------------
# agent state + motion (host-side)
# ---------------------------------------------------------------------------

# discrete actions: 0 stop, 1 forward 0.25 m, 2 turn left 10 deg, 3 turn
# right 10 deg
ACTION_STOP = 0
ACTION_FORWARD = 1
ACTION_LEFT = 2
ACTION_RIGHT = 3


class AgentState:
    def __init__(self, x: float, z: float, yaw: float):
        self.x = x
        self.z = z
        self.yaw = yaw  # radians about +Y; yaw=0 faces -Z

    def pose(self) -> Pose:
        return Pose(np.array([self.x, 0.0, self.z]), quat_from_yaw(self.yaw))

    def camera_matrix(self) -> np.ndarray:
        return self.pose().camera_pose().matrix()


class RaycastSim:
    """Host wrapper around one procedural scene: motion, collision,
    traversability grid. The scene's tensors live on `device`;
    `render_mode` is the render mode of its observations, as
    `resolve_attr_mode` gives it."""

    def __init__(self, sim_cfg: SimConfig, sensor_cfg: SensorConfig,
                 seed: Optional[int] = None, device="cuda",
                 render_mode: str = "onehot"):
        self.cfg = sim_cfg
        self.sensors = sensor_cfg
        self.render_mode = render_mode
        self.scene = generate_scene(sim_cfg, seed, device)
        self._scene_np = Scene(*(x.cpu().numpy() for x in self.scene))
        self.agent = self._spawn(np.random.default_rng(
            (seed if seed is not None else sim_cfg.scene_seed) + 1234))

    # -- collision / traversability --------------------------------------
    def _blocked(self, x: float, z: float) -> bool:
        s = self._scene_np
        for i in range(len(s.valid)):
            if not s.valid[i]:
                continue
            mn, mx = s.box_min[i], s.box_max[i]
            if mx[1] <= 0.05 or mn[1] > AGENT_HEIGHT + 0.4:
                continue  # floor/ceiling/mounted don't block
            if (x > mn[0] - AGENT_RADIUS and x < mx[0] + AGENT_RADIUS
                    and z > mn[2] - AGENT_RADIUS and z < mx[2] + AGENT_RADIUS):
                return True
        size = self.cfg.scene_size
        return not (AGENT_RADIUS < x < size - AGENT_RADIUS
                    and AGENT_RADIUS < z < size - AGENT_RADIUS)

    def _spawn(self, rng) -> AgentState:
        for _ in range(100):
            x = rng.uniform(0.5, self.cfg.scene_size - 0.5)
            z = rng.uniform(0.5, self.cfg.scene_size - 0.5)
            if not self._blocked(x, z):
                return AgentState(x, z, rng.uniform(0, 2 * np.pi))
        return AgentState(self.cfg.scene_size / 2, self.cfg.scene_size / 2, 0.0)

    def traversability(self, resolution: float = 0.1) -> np.ndarray:
        """[H, W] uint8 free-space grid (rows = z, cols = x)."""
        n = int(self.cfg.scene_size / resolution)
        grid = np.zeros((n, n), np.uint8)
        for iz in range(n):
            for ix in range(n):
                grid[iz, ix] = 0 if self._blocked((ix + 0.5) * resolution,
                                                  (iz + 0.5) * resolution) else 1
        return grid

    # -- stepping ---------------------------------------------------------
    def step(self, action: int) -> bool:
        """Apply one discrete action; returns True if a collision blocked
        the move."""
        a = self.agent
        if action == ACTION_FORWARD:
            nx = a.x - np.sin(a.yaw) * self.cfg.forward_step
            nz = a.z - np.cos(a.yaw) * self.cfg.forward_step
            if self._blocked(nx, nz):
                return True
            a.x, a.z = float(nx), float(nz)
        elif action == ACTION_LEFT:
            a.yaw += np.deg2rad(self.cfg.turn_angle_deg)
        elif action == ACTION_RIGHT:
            a.yaw -= np.deg2rad(self.cfg.turn_angle_deg)
        return False

    # -- observation ------------------------------------------------------
    def observe(self) -> Dict[str, torch.Tensor]:
        pose = torch.from_numpy(self.agent.camera_matrix()).float().to(
            self.scene.box_min.device)
        return render(self.scene, pose, self.sensors.height,
                      self.sensors.width, self.sensors.hfov_deg,
                      self.sensors.max_depth, self.render_mode)

    def gt_detections(self, obs: Dict[str, torch.Tensor],
                      max_instances: int = 16) -> Detections:
        min_px = max(50, (self.sensors.height * self.sensors.width) // 2184)
        return gt_detections(obs["instances"], obs["classes"],
                             max_instances=max_instances, min_pixels=min_px)

    def bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        return self._scene_np.lower, self._scene_np.upper
