"""Image ops: bilinear resize, CLIP normalisation, patchify, ROI crops.

Every resampling op is separable: two dense products with bilinear
hat-weight matrices (out = Wy @ img @ Wx^T), the formulation of the JAX
package's `ops/image.py`, kept so that both packages compute the same sums.
Images are NHWC (channels last) throughout; leading batch dims broadcast.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..kernels import fused_preprocess
from ..kernels.preprocess import CLIP_MEAN, CLIP_STD


def _interp_weights(src: torch.Tensor, in_n: int,
                    zero_outside: bool = False) -> torch.Tensor:
    """Bilinear weight matrix [..., S, in_n] for source coords [..., S]
    (2-tap hat weights at floor/ceil). `zero_outside`: taps outside
    [0, in_n-1] contribute zero instead of clamping (grid_sample zero
    padding)."""
    ys = torch.arange(in_n, device=src.device)
    if zero_outside:
        i0 = torch.floor(src).to(torch.int32)
        f = (src - i0.to(torch.float32))[..., None]
        i0 = i0[..., None]
        return (torch.where(ys == i0, 1.0 - f, 0.0)
                + torch.where(ys == i0 + 1, f, 0.0))
    s = torch.clamp(src, 0.0, in_n - 1.0)
    i0 = torch.floor(s).to(torch.int32)
    i1 = torch.clamp(i0 + 1, max=in_n - 1)
    f = (s - i0.to(torch.float32))[..., None]
    return (torch.where(ys == i0[..., None], 1.0 - f, 0.0)
            + torch.where(ys == i1[..., None], f, 0.0))


def _src_coords(out_n: int, in_n: int, device) -> torch.Tensor:
    """Half-pixel-centre source coordinates (align_corners=False)."""
    scale = in_n / out_n
    src = (torch.arange(out_n, dtype=torch.float32, device=device) + 0.5
           ) * scale - 0.5
    return torch.clamp(src, 0.0, in_n - 1.0)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int
                    ) -> torch.Tensor:
    """Bilinear resize of [..., H, W, C] images (half-pixel centres, the
    cv2.INTER_LINEAR convention) in float32."""
    h, w = img.shape[-3], img.shape[-2]
    wy = _interp_weights(_src_coords(out_h, h, img.device), h)
    wx = _interp_weights(_src_coords(out_w, w, img.device), w)
    y = torch.einsum("oh,...hwc->...owc", wy, img.float())
    return torch.einsum("pw,...owc->...opc", wx, y)


def normalize(img: torch.Tensor, mean: Sequence[float] = CLIP_MEAN,
              std: Sequence[float] = CLIP_STD) -> torch.Tensor:
    """Normalise [..., H, W, 3] float images in [0, 1]."""
    m = torch.tensor(mean, dtype=torch.float32, device=img.device)
    s = torch.tensor(std, dtype=torch.float32, device=img.device)
    return (img.float() - m) / s


def patchify(img: torch.Tensor, patch: int) -> torch.Tensor:
    """[..., H, W, C] -> [..., H/p * W/p, p*p*C] patch tokens."""
    *lead, h, w, c = img.shape
    gh, gw = h // patch, w // patch
    x = img.reshape(*lead, gh, patch, gw, patch, c)
    x = torch.movedim(x, -4, -3)  # [..., gh, gw, p, p, c]
    return x.reshape(*lead, gh * gw, patch * patch * c)


def preprocess_for_vit(img_u8: torch.Tensor, image_size: int, patch: int
                       ) -> torch.Tensor:
    """[..., H, W, 3] -> normalised patch tokens for the ViT. A uint8 batch
    [N, H, W, 3] with `image_size` a multiple of `patch` goes through the
    fused preprocess kernel; anything else through the separate ops."""
    if (img_u8.dtype == torch.uint8 and img_u8.dim() == 4
            and image_size % patch == 0):
        return fused_preprocess(img_u8.contiguous(), image_size, patch)
    x = img_u8.float() / 255.0
    x = resize_bilinear(x, image_size, image_size)
    return patchify(normalize(x), patch)


def _box_interp_weights(boxes: torch.Tensor, samples: int, h: int, w: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-box weights wy [..., N, samples, H], wx [..., N, samples, W]
    for half-pixel-centred samples spanning each XYXY box. Box arithmetic
    runs in the boxes' dtype, as in the JAX package."""
    x1, y1 = boxes[..., 0:1], boxes[..., 1:2]
    bw = torch.clamp(boxes[..., 2:3] - x1, min=1e-3)
    bh = torch.clamp(boxes[..., 3:4] - y1, min=1e-3)
    u = (torch.arange(samples, dtype=torch.float32, device=boxes.device)
         + 0.5) / samples
    sx = torch.clamp(x1 + u * bw - 0.5, 0.0, w - 1.0)
    sy = torch.clamp(y1 + u * bh - 0.5, 0.0, h - 1.0)
    return _interp_weights(sy, h), _interp_weights(sx, w)


def _resample_with_weights(img: torch.Tensor, wy: torch.Tensor,
                           wx: torch.Tensor) -> torch.Tensor:
    """img [..., H, W, C], wy [..., N, S, H], wx [..., N, T, W] ->
    [..., N, S, T, C] by two float32 contractions."""
    *lead, h, w, c = img.shape
    imgf = img.float().reshape(*lead, h, w * c)
    rows = torch.einsum("...nsh,...hk->...nsk", wy, imgf)
    rows = rows.reshape(*rows.shape[:-1], w, c)
    return torch.einsum("...ntw,...nswc->...nstc", wx, rows)


def crop_and_resize(img: torch.Tensor, boxes: torch.Tensor, out_size: int
                    ) -> torch.Tensor:
    """Bilinear crop-resize of XYXY pixel boxes: img [..., H, W, C] float,
    boxes [..., N, 4] -> [..., N, out, out, C]."""
    h, w = img.shape[-3], img.shape[-2]
    wy, wx = _box_interp_weights(boxes, out_size, h, w)
    return _resample_with_weights(img, wy, wx)


def roi_align(feat: torch.Tensor, boxes: torch.Tensor, out_size: int,
              spatial_scale: float = 1.0, sampling_ratio: int = 2
              ) -> torch.Tensor:
    """ROIAlign with `sampling_ratio`^2 samples per bin, averaged. The bin
    average is folded into the interpolation weights (averaging sample rows
    commutes with the linear resampling), so the products run at
    out_size samples. feat [..., H, W, C], boxes [..., N, 4]."""
    h, w = feat.shape[-3], feat.shape[-2]
    s = out_size * sampling_ratio
    wy, wx = _box_interp_weights(boxes * spatial_scale, s, h, w)
    wy = wy.reshape(*wy.shape[:-2], out_size, sampling_ratio, h).mean(dim=-2)
    wx = wx.reshape(*wx.shape[:-2], out_size, sampling_ratio, w).mean(dim=-2)
    return _resample_with_weights(feat, wy, wx)


def paste_masks(mask_probs: torch.Tensor, boxes: torch.Tensor, height: int,
                width: int) -> torch.Tensor:
    """Paste [..., N, m, m] ROI mask probabilities into full-frame
    [..., N, H, W] maps, weights zero outside each box."""
    m = mask_probs.shape[-1]
    ys = torch.arange(height, dtype=torch.float32, device=boxes.device)
    xs = torch.arange(width, dtype=torch.float32, device=boxes.device)
    x1, y1 = boxes[..., 0:1], boxes[..., 1:2]
    bw = torch.clamp(boxes[..., 2:3] - x1, min=1e-3)
    bh = torch.clamp(boxes[..., 3:4] - y1, min=1e-3)
    u = (xs - x1) / bw * m - 0.5  # [..., N, W]
    v = (ys - y1) / bh * m - 0.5  # [..., N, H]
    wx = _interp_weights(u, m, zero_outside=True)
    wy = _interp_weights(v, m, zero_outside=True)
    tmp = torch.einsum("...nhv,...nvu->...nhu", wy, mask_probs.float())
    return torch.einsum("...nwu,...nhu->...nhw", wx, tmp)
