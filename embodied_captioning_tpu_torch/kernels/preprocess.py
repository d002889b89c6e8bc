"""Fused image preprocess kernel (csrc/preprocess.cu) and its plain PyTorch
version: uint8 crops -> bilinear resize -> CLIP normalisation -> ViT patch
tokens.

Replaces the TPU kernel fused_preprocess of
embodied_captioning_tpu/ops/pallas/preprocess.py, with a leading batch axis
in place of a map over images. The arithmetic is that of the JAX package's
default path, `ops/image.preprocess_for_vit` as XLA on the CPU computes it:
`v / 255` first, the vertical two-tap sum, the horizontal one, then
`(v - mean) / std` (the TPU kernel resizes raw values and multiplies by a
folded reciprocal, which differs in the last bits of an f32). Each two-tap
sum is two rounded products and their rounded sum, as XLA rounds the
resize's dense weight product at 224 (the large preset), where the two
packages agree bit for bit. At some other output sizes (with the XLA this
was measured on: 0 or 49-63 rows mod 64, the tiny preset's 64 among them)
XLA sums the two taps in one FMA instead, and the tokens differ by at
most 2^-21, two float32 ulps of the largest tokens (|t| < 2.2): one more
rounding in each of the two passes, scaled by 1/std (~3.7). On a CUDA
tensor the wrapper launches the kernel; on a CPU tensor it runs the plain
version.
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


def _two_taps(lo: torch.Tensor, hi: torch.Tensor,
              w_hi: torch.Tensor) -> torch.Tensor:
    """(1 - w_hi) * lo + w_hi * hi in float32: two rounded products and
    their rounded sum."""
    return lo * (1.0 - w_hi) + hi * w_hi


def fused_preprocess_plain(img_u8: torch.Tensor, out_size: int, patch: int,
                           mean: Sequence[float] = CLIP_MEAN,
                           std: Sequence[float] = CLIP_STD) -> torch.Tensor:
    """[N, H, W, 3] uint8 -> [N, T, p*p*3] f32: `v / 255`, the vertical
    two-tap sum, then the horizontal one, then `(v - mean) / std`."""
    dev = img_u8.device
    h, w = img_u8.shape[1], img_u8.shape[2]
    y0, y1, fy = source_taps(out_size, h, dev)
    x0, x1, fx = source_taps(out_size, w, dev)
    # tensor divisors: PyTorch on the card turns a division by a Python
    # scalar into a product with its reciprocal
    c255 = torch.tensor(255.0, dtype=torch.float32, device=dev)
    x = img_u8.float() / c255
    rows = _two_taps(x[:, y0.long()], x[:, y1.long()],
                     fy[None, :, None, None])      # [N, out, W, 3]
    v = _two_taps(rows[:, :, x0.long()], rows[:, :, x1.long()],
                  fx[None, None, :, None])         # [N, out, out, 3]
    m = torch.tensor(mean, dtype=torch.float32, device=dev)
    s = torch.tensor(std, dtype=torch.float32, device=dev)
    return _patch_tokens((v - m) / s, patch)


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
              out_size, patch,
              *(float(x) for x in mean), *(float(x) for x in std))
    _lib.launches["fused_preprocess"] += 1
    return out
