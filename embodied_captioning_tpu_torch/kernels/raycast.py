"""Ray-AABB visibility kernel (csrc/raycast.cu) and its plain PyTorch
version.

Replaces the TPU kernel raycast_minargmin of
embodied_captioning_tpu/ops/pallas/raycast.py, with a leading env axis in
place of that kernel's `vmap`. On a CUDA tensor the wrapper launches the
kernel; on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _lib

MAX_BOXES = 1024
# the plain version's [rows, W, boxes, 3] intermediates stay below this
PLAIN_CHUNK_ELEMS = 1 << 26


def raycast_minargmin_plain(a_min: torch.Tensor, a_max: torch.Tensor,
                            valid: torch.Tensor, inv: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The slab test against every box materialised as a [H, W, boxes]
    hit-distance tensor, then min and first-lowest-index argmin over the
    boxes. Goes env by env in row chunks to bound that tensor."""
    e, h, w, _ = inv.shape
    nb = a_min.shape[1]
    rows = max(1, min(h, PLAIN_CHUNK_ELEMS // max(1, w * nb * 3)))
    box_ids = torch.arange(nb, dtype=torch.int32, device=inv.device)
    t_best = torch.empty(e, h, w, dtype=torch.float32, device=inv.device)
    best = torch.empty(e, h, w, dtype=torch.int32, device=inv.device)
    for i in range(e):
        for r in range(0, h, rows):
            iv = inv[i, r:r + rows, :, None, :]
            t0 = a_min[i] * iv
            t1 = a_max[i] * iv
            t_near = torch.minimum(t0, t1).amax(dim=-1)
            t_far = torch.maximum(t0, t1).amin(dim=-1)
            hit = (t_near <= t_far) & (t_far > 1e-4) & valid[i].bool()
            t_hit = torch.where(hit, torch.clamp(t_near, min=1e-4),
                                torch.inf)
            tb = t_hit.amin(dim=-1)
            t_best[i, r:r + rows] = tb
            # argmin with the first lowest index on ties; an all-miss
            # row (all inf) gives 0
            best[i, r:r + rows] = torch.where(
                t_hit == tb[..., None], box_ids, nb).amin(dim=-1)
    return t_best, best


def raycast_minargmin(a_min: torch.Tensor, a_max: torch.Tensor,
                      valid: torch.Tensor, inv: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t_best, best) of the ray-AABB slab test.

    a_min, a_max: [E, Bx, 3] f32 box extents already translated by
    -origin; valid: [E, Bx] bool (invalid boxes never hit); inv:
    [E, H, W, 3] f32 reciprocal ray directions (zero-clamped upstream).
    Returns t_best [E, H, W] f32, inf where nothing is hit, and best
    [E, H, W] i32, the first nearest box, 0 where nothing is hit."""
    if _lib.dispatch_device(inv) == "cpu":
        return raycast_minargmin_plain(a_min, a_max, valid, inv)
    e, h, w, _ = inv.shape
    nb = a_min.shape[1]
    if nb > MAX_BOXES:
        raise ValueError(f"the kernel's shared-memory tables hold "
                         f"{MAX_BOXES} boxes, got {nb}")
    f32 = (torch.float32,)
    _lib.check(inv, "inv", f32, (e, h, w, 3))
    _lib.check(a_min, "a_min", f32, (e, nb, 3))
    _lib.check(a_max, "a_max", f32, (e, nb, 3))
    validf = valid.to(torch.float32).contiguous()
    _lib.check(validf, "valid", f32, (e, nb))
    t_best = torch.empty(e, h, w, dtype=torch.float32, device=inv.device)
    best = torch.empty(e, h, w, dtype=torch.int32, device=inv.device)
    _lib.call("ecap_raycast_minargmin", a_min.data_ptr(), a_max.data_ptr(),
              validf.data_ptr(), inv.data_ptr(), t_best.data_ptr(),
              best.data_ptr(), e, nb, h * w)
    _lib.launches["raycast_minargmin"] += 1
    return t_best, best
