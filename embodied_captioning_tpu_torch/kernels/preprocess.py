"""Fused image preprocess kernel (csrc/preprocess.cu) and its plain PyTorch
version: uint8 crops -> bilinear resize -> CLIP normalisation -> ViT patch
tokens.

Replaces the TPU kernel fused_preprocess of
embodied_captioning_tpu/ops/pallas/preprocess.py, with a leading batch axis
in place of a map over images. The normalisation is spelled
`(v / 255 - mean) / std`, the spelling of the unfused
`ops/image.preprocess_for_vit` (the TPU kernel multiplies by a folded
reciprocal, which differs in the last bits of an f32). On a CUDA tensor the
wrapper launches the kernel; on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch

from . import _lib

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@functools.lru_cache(maxsize=32)
def source_taps(out_n: int, in_n: int, device
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Half-pixel-centre bilinear taps of an in_n -> out_n resize: the two
    source indices (int32) and the upper one's weight (f32), per output
    index. Cached per size and device; callers only read them."""
    src = (torch.arange(out_n, dtype=torch.float32, device=device) + 0.5
           ) * (in_n / out_n) - 0.5
    src = torch.clamp(src, 0.0, in_n - 1.0)
    i0 = torch.floor(src).to(torch.int32)
    i1 = torch.clamp(i0 + 1, max=in_n - 1)
    return i0, i1, src - i0.to(torch.float32)


def _patch_tokens(img: torch.Tensor, patch: int) -> torch.Tensor:
    """[N, S, S, 3] -> [N, (S/p)^2, p*p*3]: a token holds its patch's rows,
    then columns, then channels."""
    n, s = img.shape[0], img.shape[1]
    g = s // patch
    x = img.reshape(n, g, patch, g, patch, 3).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, g * g, patch * patch * 3)


def fused_preprocess_plain(img_u8: torch.Tensor, out_size: int, patch: int,
                           mean: Sequence[float] = CLIP_MEAN,
                           std: Sequence[float] = CLIP_STD) -> torch.Tensor:
    """[N, H, W, 3] uint8 -> [N, T, p*p*3] f32: vertical lerp, then
    horizontal, each product and sum rounded on its own, then
    `(v / 255 - mean) / std`."""
    dev = img_u8.device
    h, w = img_u8.shape[1], img_u8.shape[2]
    y0, y1, fy = source_taps(out_size, h, dev)
    x0, x1, fx = source_taps(out_size, w, dev)
    fy, fx = fy[None, :, None, None], fx[None, None, :, None]
    rows = (img_u8[:, y0.long()].float() * (1.0 - fy)
            + img_u8[:, y1.long()].float() * fy)          # [N, out, W, 3]
    v = (rows[:, :, x0.long()] * (1.0 - fx)
         + rows[:, :, x1.long()] * fx)                    # [N, out, out, 3]
    m = torch.tensor(mean, dtype=torch.float32, device=dev)
    s = torch.tensor(std, dtype=torch.float32, device=dev)
    # a tensor divisor: PyTorch on the card turns a division by a Python
    # scalar into a product with its reciprocal
    c255 = torch.tensor(255.0, dtype=torch.float32, device=dev)
    return _patch_tokens((v / c255 - m) / s, patch)


def fused_preprocess(img_u8: torch.Tensor, out_size: int, patch: int,
                     mean: Sequence[float] = CLIP_MEAN,
                     std: Sequence[float] = CLIP_STD) -> torch.Tensor:
    """uint8 [N, H, W, 3] -> normalised patch tokens f32
    [N, (out_size/patch)^2, patch*patch*3]; one launch for the batch."""
    if img_u8.dim() != 4 or img_u8.shape[-1] != 3:
        raise ValueError(f"expected [N, H, W, 3], got {tuple(img_u8.shape)}")
    if out_size % patch:
        raise ValueError(f"out_size {out_size} is not a multiple of the "
                         f"patch size {patch}")
    if _lib.dispatch_device(img_u8) == "cpu":
        return fused_preprocess_plain(img_u8, out_size, patch, mean, std)
    n, h, w, _ = img_u8.shape
    _lib.check(img_u8, "img_u8", (torch.uint8,), align=1)
    dev = img_u8.device
    taps = [t.contiguous() for t in (*source_taps(out_size, h, dev),
                                     *source_taps(out_size, w, dev))]
    g = out_size // patch
    out = torch.empty(n, g * g, patch * patch * 3, dtype=torch.float32,
                      device=dev)
    _lib.call("ecap_fused_preprocess", img_u8.data_ptr(),
              *(t.data_ptr() for t in taps), out.data_ptr(), n, h, w,
              out_size, patch, *(float(x) for x in mean),
              *(float(x) for x in std))
    _lib.launches["fused_preprocess"] += 1
    return out
