"""Camera geometry: depth back-projection to the world frame, mask
morphology, reprojection.

Conventions: the camera looks down -Z, +X right, +Y up;
fx = W/2 / tan(hfov/2), fy = H/2 / tan(hfov/2), xc = (W-1)/2,
yc = (H-1)/2; world = T_world_cam @ [x, y, z, 1].

Every function takes optional leading batch axes (`depth [..., H, W]`,
`pose [..., 4, 4]`), which replace the JAX package's `vmap`s.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def intrinsics_from_hfov(height: int, width: int, hfov_deg: float
                         ) -> Tuple[float, float, float, float]:
    t = float(np.tan(np.deg2rad(hfov_deg) / 2.0))
    fx = width / 2.0 / t
    fy = height / 2.0 / t
    xc = (width - 1.0) / 2.0
    yc = (height - 1.0) / 2.0
    return fx, fy, xc, yc


def reciprocal32(c: float) -> float:
    """1 / c rounded as float32 arithmetic rounds it. XLA compiles the JAX
    package's divisions by a constant into products with this value, and
    a floor or a compare downstream can see the last bit."""
    return float(np.float32(1.0) / np.float32(c))


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """round_f32(a * b + c) for float32 tensors: the product of two float32
    values is exact in float64, so this is a fused multiply-add whatever
    the device (up to a double rounding in about one case in 2^29)."""
    return (a.double() * b.double() + c.double()).float()


def rotate(v: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """v [..., H, W, 3] @ R^T for R [..., 3, 3]: out_j = sum_k v_k R_jk,
    accumulated as fma(v2, R_j2, fma(v1, R_j1, v0 * R_j0)).

    Each library sums a K=3 product in its own order, and an ulp in a ray
    direction can move an argmin at a box edge. This chain is the order of
    XLA's CPU dot (and of a BLAS sgemm), written out elementwise so that
    the CPU and the card give the same bits."""
    Rb = R[..., None, None, :, :]            # [..., 1, 1, 3(j), 3(k)]
    acc = v[..., None, 0] * Rb[..., 0]
    acc = fma(v[..., None, 1], Rb[..., 1], acc)
    return fma(v[..., None, 2], Rb[..., 2], acc)


def _pixel_grid(h: int, w: int, device):
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return ys.expand(h, w), xs.expand(h, w)


def backproject_depth(depth: torch.Tensor, pose: torch.Tensor,
                      hfov_deg: float, min_depth: float = 0.5,
                      max_depth: float = 15.0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """depth [..., H, W] f32 meters, pose [..., 4, 4] T_world_cam ->
    (points [..., H, W, 3] world coordinates, garbage where invalid;
    valid [..., H, W] bool: min_depth < depth < max_depth)."""
    h, w = depth.shape[-2:]
    fx, fy, xc, yc = intrinsics_from_hfov(h, w, hfov_deg)
    ys, xs = _pixel_grid(h, w, depth.device)
    d = depth.float()
    x_cam = (xs - xc) * reciprocal32(fx) * d
    y_cam = -(ys - yc) * reciprocal32(fy) * d
    pts_cam = torch.stack([x_cam, y_cam, -d], dim=-1)
    R = pose[..., :3, :3].float()
    t = pose[..., :3, 3].float()
    points = rotate(pts_cam, R) + t[..., None, None, :]
    return points, (d > min_depth) & (d < max_depth)


def depth_outlier_mask(depth: torch.Tensor, mask: torch.Tensor,
                       max_deviations: float = 1.0) -> torch.Tensor:
    """Keep the pixels of `mask` [..., H, W] whose depth is within
    `max_deviations` sigma (Bessel-corrected, plus 1e-3 so a flat region
    survives) of the masked region's mean depth. `depth` broadcasts
    against `mask`."""
    m = mask.float()
    n = torch.clamp(m.sum(dim=(-2, -1), keepdim=True), min=1.0)
    mean = (depth * m).sum(dim=(-2, -1), keepdim=True) / n
    sq = (torch.square(depth - mean) * m).sum(dim=(-2, -1), keepdim=True)
    var = sq / torch.clamp(n - 1.0, min=1.0)
    keep = torch.abs(depth - mean) < max_deviations * torch.sqrt(var) + 1e-3
    return mask & keep


def max_pool(x: torch.Tensor, kernel: int) -> torch.Tensor:
    """Stride-1 'same' max over the last two axes; the border sees only
    in-bounds values (max_pool2d pads with -inf)."""
    lead = x.shape[:-2]
    y = F.max_pool2d(x.reshape(-1, 1, *x.shape[-2:]), kernel, 1, kernel // 2)
    return y.reshape(*lead, *x.shape[-2:])


def erode_mask(mask: torch.Tensor, kernel: int = 7) -> torch.Tensor:
    """Binary erosion with a square kernel; outside the image counts as
    set."""
    return -max_pool(-mask.float(), kernel) > 0.5


def dilate_mask(mask: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """Binary dilation; outside the image counts as clear."""
    return max_pool(mask.float(), kernel) > 0.5


def morph_close(mask: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    return erode_mask(dilate_mask(mask, kernel), kernel)


def project_points_to_image(points: torch.Tensor, pose: torch.Tensor,
                            height: int, width: int, hfov_deg: float,
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """World points [..., 3] into the camera `pose` [4, 4]: (pix [..., 2]
    (x, y) pixel coordinates, in_front [...] bool)."""
    fx, fy, xc, yc = intrinsics_from_hfov(height, width, hfov_deg)
    R = pose[:3, :3].float()
    t = pose[:3, 3].float()
    cam = torch.matmul(points - t, R)  # R^T applied from the right
    z = -cam[..., 2]
    in_front = z > 1e-6
    zs = torch.where(in_front, z, 1.0)
    x_pix = cam[..., 0] / zs * fx + xc
    y_pix = -cam[..., 1] / zs * fy + yc
    return torch.stack([x_pix, y_pix], dim=-1), in_front


def reproject_box(box: torch.Tensor, depth: torch.Tensor,
                  pose_src: torch.Tensor, pose_dst: torch.Tensor,
                  hfov_deg: float) -> torch.Tensor:
    """An XYXY box seen in camera `src` onto camera `dst`: back-project
    the box region and re-project its extremes."""
    h, w = depth.shape
    points, valid = backproject_depth(depth, pose_src, hfov_deg)
    ys, xs = _pixel_grid(h, w, depth.device)
    inside = ((xs >= box[0]) & (xs < box[2]) & (ys >= box[1]) & (ys < box[3])
              & valid)
    pix, in_front = project_points_to_image(points, pose_dst, h, w, hfov_deg)
    ok = inside & in_front
    big = 1e9
    x1 = torch.where(ok, pix[..., 0], big).min()
    y1 = torch.where(ok, pix[..., 1], big).min()
    x2 = torch.where(ok, pix[..., 0], -big).max()
    y2 = torch.where(ok, pix[..., 1], -big).max()
    out = torch.stack([x1.clamp(0, w), y1.clamp(0, h),
                       x2.clamp(0, w), y2.clamp(0, h)])
    return torch.where(ok.any(), out, torch.zeros_like(out))
