"""Batched detection augmentation on the device: random horizontal flip
(image, masks, boxes), random-resized "zoom-in" crop (nearest resampling,
exact box transform, slivers dropped from `valid`) and brightness / colour
jitter, for training batches gathered from a corpus that stays on the
device.

The counterpart of the JAX package's `ops/augment.py`. The draws
(`draw_augment_params`, from a `torch.Generator`) are apart from their
application (`apply_augment`), so that tests can hand the JAX package's
draws across: jax.random and torch never draw the same numbers. Nearest
resampling is a pair of one-hot products per sample, as in the JAX
package: each output pixel is one source pixel times 1.0, exact in any
summation order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .detections import Detections


class AugmentParams(NamedTuple):
    """Per-sample draws.

    do_crop  [B] bool      apply the random-resized crop
    scale    [B] f32       crop scale in (0, 1]; window = floor(dim * scale)
    oy, ox   [B] f32       in [0, 1): window offset fractions
    do_flip  [B] bool      horizontal flip
    bright   [B] f32       multiplicative brightness
    shift    [B, 3] f32    additive per-channel colour shift
    """

    do_crop: torch.Tensor
    scale: torch.Tensor
    oy: torch.Tensor
    ox: torch.Tensor
    do_flip: torch.Tensor
    bright: torch.Tensor
    shift: torch.Tensor


def draw_augment_params(generator: torch.Generator, batch: int, device, *,
                        crop: bool = True, crop_prob: float = 0.5,
                        crop_range: Tuple[float, float] = (0.55, 0.95),
                        flip: bool = True, jitter: bool = True,
                        bright_range: Tuple[float, float] = (0.75, 1.25),
                        shift_amp: float = 15.0) -> AugmentParams:
    """The JAX package's distributions, drawn from `generator`."""
    def uniform(*shape, lo=0.0, hi=1.0):
        u = torch.rand(shape, generator=generator, device=device)
        return u * (hi - lo) + lo

    one = torch.ones(batch, device=device)
    no = torch.zeros(batch, dtype=torch.bool, device=device)
    return AugmentParams(
        do_crop=uniform(batch) < crop_prob if crop else no,
        scale=(uniform(batch, lo=crop_range[0], hi=crop_range[1]) if crop
               else one),
        oy=uniform(batch), ox=uniform(batch),
        do_flip=uniform(batch) < 0.5 if flip else no,
        bright=(uniform(batch, lo=bright_range[0], hi=bright_range[1])
                if jitter else one),
        shift=(uniform(batch, 3, lo=-shift_amp, hi=shift_amp) if jitter
               else torch.zeros(batch, 3, device=device)))


def _axis_onehots(n: int, win: torch.Tensor, off: torch.Tensor,
                  flip: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-sample nearest-resample one-hot matrices [B, n, n]: output i
    reads source off + (i * win) // n; with `flip`, what n-1-i would."""
    i = torch.arange(n, device=win.device, dtype=torch.int32)
    src = off[:, None] + torch.div(i[None, :] * win[:, None], n,
                                   rounding_mode="floor")
    if flip is not None:
        src = torch.where(flip[:, None], torch.flip(src, [1]), src)
    return (src[:, :, None] == i[None, None, :]).float()


def apply_augment(rgb: torch.Tensor, det: Detections, p: AugmentParams,
                  *, min_box: float = 4.0
                  ) -> Tuple[torch.Tensor, Detections]:
    """Apply the draws `p` to a batch: rgb [B, H, W, 3] uint8, batched
    Detections with boxes [B, N, 4] XYXY pixels and masks [B, N, H, W].
    Returns (uint8 rgb, Detections with moved boxes and masks and slivers
    under `min_box` pixels dropped from `valid`)."""
    b, h, w = rgb.shape[0], rgb.shape[1], rgb.shape[2]
    i32 = torch.int32
    ch = torch.where(p.do_crop, torch.clamp((h * p.scale).to(i32), min=8), h)
    cw = torch.where(p.do_crop, torch.clamp((w * p.scale).to(i32), min=8), w)
    oy = torch.where(p.do_crop, (p.oy * (h - ch + 1).float()).to(i32), 0)
    ox = torch.where(p.do_crop, (p.ox * (w - cw + 1).float()).to(i32), 0)
    oy, ox = oy.to(i32), ox.to(i32)

    wy = _axis_onehots(h, ch, oy, None)                 # [B, H, H]
    wx = _axis_onehots(w, cw, ox, p.do_flip)            # [B, W, W]
    img = torch.einsum("bih,bhwc->biwc", wy, rgb.float())
    img = torch.einsum("bjw,biwc->bijc", wx, img)
    out_masks = None
    if det.masks is not None:
        m = torch.einsum("bih,bnhw->bniw", wy, det.masks.float())
        m = torch.einsum("bjw,bniw->bnij", wx, m)
        out_masks = (m >= 0.5).to(det.masks.dtype)

    # boxes: the crop's scale and clip, then the flip (w / t in torch is
    # w * (1 / t), two roundings: divide a tensor of w instead)
    f32 = torch.float32
    sx = (torch.full_like(cw, w, dtype=f32) / cw.float())[:, None]
    sy = (torch.full_like(ch, h, dtype=f32) / ch.float())[:, None]
    bx = det.boxes.float()
    x1 = torch.clamp((bx[..., 0] - ox[:, None].float()) * sx, 0, w)
    y1 = torch.clamp((bx[..., 1] - oy[:, None].float()) * sy, 0, h)
    x2 = torch.clamp((bx[..., 2] - ox[:, None].float()) * sx, 0, w)
    y2 = torch.clamp((bx[..., 3] - oy[:, None].float()) * sy, 0, h)
    keep = (x2 - x1 >= min_box) & (y2 - y1 >= min_box) & det.valid
    fx1 = torch.where(p.do_flip[:, None], w - x2, x1)
    fx2 = torch.where(p.do_flip[:, None], w - x1, x2)
    boxes = torch.stack([fx1, y1, fx2, y2], dim=-1)

    # brightness and colour jitter, a product and a sum rounded apart
    img = img * p.bright[:, None, None, None] + p.shift[:, None, None, :]
    img = torch.clamp(img, 0, 255).to(torch.uint8)
    return img, det.replace(boxes=boxes, masks=out_masks, valid=keep)


def augment_batch(generator: torch.Generator, rgb: torch.Tensor,
                  det: Detections, *, crop: bool = True, flip: bool = True,
                  jitter: bool = True, min_box: float = 4.0
                  ) -> Tuple[torch.Tensor, Detections]:
    """Draw and apply in one call (the training loop's entry)."""
    p = draw_augment_params(generator, rgb.shape[0], rgb.device, crop=crop,
                            flip=flip, jitter=jitter)
    return apply_augment(rgb, det, p, min_box=min_box)
