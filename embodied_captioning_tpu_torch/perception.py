"""The per-frame perception program: detect -> crop -> caption -> embed.

  images [E, S, S, 3] uint8 (sensor resolution)
    -> bilinear resize to the detector input (fed as float)
    -> detector forward, full-frame mask paste
    -> box expansion 0.2, per-frame top-k caption slots
    -> crop-resize from the sensor frame
    -> ViT encode + KV-cached greedy decode
    -> sentence embedding of the caption tokens
    -> results scattered back to the [E, N] detection slots
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .config import ExperimentConfig
from .models import captioner as CAP
from .models import detector as DET
from .models import sbert as SB
from .models.tokenizer import Tokenizer, default_tokenizer
from .ops.detections import Detections, expand_boxes
from .ops.image import crop_and_resize, resize_bilinear
from .params import PerceptionParams, init_perception

CROP_EXPAND = 0.2


class FrameResult(NamedTuple):
    detections: Detections            # [E, N, ...] with masks, embeddings
    caption_tokens: torch.Tensor      # [E, N, L] int32
    caption_logprobs: torch.Tensor    # [E, N, L-1] chosen-token log-probs
    caption_lengths: torch.Tensor     # [E, N] int32


@torch.no_grad()
def perceive(params: PerceptionParams, images_u8: torch.Tensor,
             cfg: ExperimentConfig, decode_blocks: bool = True,
             w8a8: bool = False, int8_kv: bool = True) -> FrameResult:
    """images [E, S, S, 3] uint8 -> FrameResult.

    `decode_blocks` picks the captioner's decode route (see
    `models.captioner.generate`). The serving opt-ins (the JAX package's
    `ECAP_W8A8` and `ECAP_INT8_KV`): `w8a8` runs every product with an
    int8 weight (detector heads, ViT, captioner, sentence encoder) on int8
    activations, and the decode on the route of separate calls; `int8_kv`
    quantizes the captioner's cross-attention K/V where its projections
    are int8 (off: bf16 K/V).

    With `runtime.caption_slots_per_frame` = k in (0, N), only the k
    highest-scored detection slots of EACH frame are cropped, captioned and
    embedded (the others get zeros); 0 captions every slot. Invalid slots
    start finished (PAD only) unless `runtime.caption_invalid_slots`."""
    e, src = images_u8.shape[0], images_u8.shape[1]
    size = cfg.detector.image_size
    det_in = (resize_bilinear(images_u8.float(), size, size) if src != size
              else images_u8)
    det = DET.forward(params.detector, det_in, cfg.detector, w8a8=w8a8)
    paste = cfg.detector.paste_size or size
    det = det.replace(masks=DET.full_masks(det, paste, size))

    n = det.capacity
    spf = cfg.runtime.caption_slots_per_frame
    c = e * spf if 0 < spf < n else e * n
    boxes = expand_boxes(det.boxes, CROP_EXPAND, size, size) * (src / size)
    crop_size = cfg.captioner.vision.image_size
    frames = images_u8.float()
    dev = images_u8.device
    if c < e * n:
        # per-frame top-k (ties to the lower slot, as lax.top_k); gather
        # boxes per frame, never frames per box
        key = det.scores * det.valid
        sel_n = torch.sort(key, dim=1, descending=True,
                           stable=True).indices[:, :spf]
        sel = (torch.arange(e, device=dev)[:, None] * n + sel_n).reshape(c)
        boxes = torch.gather(boxes, 1, sel_n[..., None].expand(e, spf, 4))
        row_valid = torch.gather(det.valid, 1, sel_n).reshape(c)
    else:
        sel = torch.arange(e * n, device=dev)
        row_valid = det.valid.reshape(e * n)
    crops = crop_and_resize(frames, boxes, crop_size)
    flat = crops.reshape(c, crop_size, crop_size, 3).to(torch.uint8)

    if cfg.runtime.caption_invalid_slots:
        row_valid = None
    tokens, logprobs, lengths = CAP.generate(
        params.captioner, flat, cfg.captioner,
        max_len=cfg.captioner.max_caption_len, row_valid=row_valid,
        decode_blocks=decode_blocks, w8a8=w8a8, int8_kv=int8_kv)

    # the sentence encoder masks id 0: map the captioner's pad id onto it
    se_len = cfg.sentence_encoder.max_len
    l = tokens.shape[1]
    se_src = torch.where(tokens == cfg.captioner.text.pad_id, 0, tokens)
    se_tokens = (se_src[:, :se_len] if l >= se_len
                 else F.pad(se_src, (0, se_len - l)))
    emb = SB.encode_tokens(params.sbert, se_tokens, cfg.sentence_encoder,
                           w8a8)

    def scatter(x: torch.Tensor) -> torch.Tensor:
        full = torch.zeros((e * n,) + tuple(x.shape[1:]), dtype=x.dtype,
                           device=dev)
        full[sel] = x
        return full.reshape(e, n, *x.shape[1:])

    emb = scatter(emb) * det.valid[..., None]
    return FrameResult(
        detections=det.replace(embeddings=emb),
        caption_tokens=scatter(tokens),
        caption_logprobs=scatter(logprobs),
        caption_lengths=scatter(lengths),
    )


def perceive_sharded(params: PerceptionParams, images_u8: torch.Tensor,
                     cfg: ExperimentConfig, mesh, decode_blocks: bool = True,
                     w8a8: bool = False, int8_kv: bool = True
                     ) -> FrameResult:
    """Multi-device serving: the frame batch split over the mesh's "data"
    axis, one contiguous block of frames a rank (params replicated). Each
    rank runs `perceive` on its block and an all-gather assembles the
    whole FrameResult on every rank. Caption slots are chosen per frame,
    so the split keeps which slots are captioned. The batch must be
    divisible by the "data" axis. The route and serving arguments go to
    `perceive`."""
    from .parallel.mesh import (
        all_gather_cat, axis_group, axis_rank, axis_size)

    n = axis_size(mesh, "data")
    assert images_u8.shape[0] % n == 0, (
        f"batch {images_u8.shape[0]} not divisible by data axis {n}")
    per, r = images_u8.shape[0] // n, axis_rank(mesh, "data")
    local = perceive(params, images_u8[r * per:(r + 1) * per], cfg,
                     decode_blocks, w8a8, int8_kv)
    group = axis_group(mesh, "data")
    if group is None:
        return local

    def gather(x):
        return None if x is None else all_gather_cat(x, group)

    det = local.detections
    det = det.replace(**{f: gather(getattr(det, f)) for f in (
        "boxes", "classes", "scores", "logits", "valid", "masks",
        "embeddings", "object_ids", "episode_ids")})
    return FrameResult(det, *(gather(x) for x in local[1:]))


class Perceiver:
    """Host-facing wrapper: owns params, the serving opt-ins (`w8a8`,
    `int8_kv`, see `perceive`) and the tokenizer; decodes caption strings
    on demand."""

    def __init__(self, cfg: ExperimentConfig,
                 params: Optional[PerceptionParams] = None, seed: int = 0,
                 device="cuda", w8a8: bool = False, int8_kv: bool = True):
        self.cfg = cfg
        self.device = torch.device(device)
        self.w8a8, self.int8_kv = w8a8, int8_kv
        if params is None:
            g = torch.Generator(device=self.device).manual_seed(seed)
            params = init_perception(g, cfg, self.device)
        self.params = params
        self.tokenizer: Tokenizer = default_tokenizer(
            cfg.captioner.text.vocab_size)

    def process(self, images_u8) -> FrameResult:
        """Square [.., H, H, 3] uint8 frames at any resolution (non-square
        frames are resized to a square first), as a tensor (used where it
        lies when on the perceiver's device, never copied through the
        host) or a numpy array."""
        images = torch.as_tensor(images_u8, device=self.device)
        if images.dim() == 3:
            images = images[None]
        if images.shape[1] != images.shape[2]:
            side = max(images.shape[1], images.shape[2])
            images = torch.clamp(resize_bilinear(images.float(), side, side),
                                 0, 255).to(torch.uint8)
        return perceive(self.params, images, self.cfg, w8a8=self.w8a8,
                        int8_kv=self.int8_kv)

    def captions(self, result: FrameResult) -> list:
        """[[caption per detection slot] per frame]."""
        toks = result.caption_tokens.cpu().numpy()
        return [[self.tokenizer.decode(t) for t in row] for row in toks]
