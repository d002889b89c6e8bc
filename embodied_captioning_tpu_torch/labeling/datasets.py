"""Episode datasets over the npz observation store, and their
augmentations.

The counterpart of the JAX package's `labeling/datasets.py` (the
reference's torch Dataset family, ref: experimenting_env/detector/
dataset.py): `EpisodeDetectionDataset` pairs each rgb frame with the
label modality (`bbs`, or `bbsgt`) of its episode, `collate` pads samples
into fixed-shape numpy batches, `SequentialEpisodeDataset` yields windows
of consecutive observations, `PartiallyAnnotatedEpisodeDataset` keeps the
labels of a seeded fraction of frames. Samples are numpy; a caller moves a batch to
its device. Augmentations (ref: detector/augmentations.py "none" /
"bbs_crop" / "bbs_crop_strong" / "strong_image") are numpy transforms
that keep boxes and masks consistent.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..config import NUM_CLASSES
from ..utils.obs_store import SampleLoader


@dataclasses.dataclass
class Sample:
    image: np.ndarray                 # [H, W, 3] uint8
    boxes: np.ndarray                 # [N, 4] xyxy
    classes: np.ndarray               # [N]
    logits: np.ndarray                # [N, C] (one-hot for GT, soft for pseudo)
    masks: Optional[np.ndarray]       # [N, H, W] or None
    valid: np.ndarray                 # [N]
    object_ids: np.ndarray            # [N]
    depth: Optional[np.ndarray] = None
    pose: Optional[np.ndarray] = None  # [4, 4] T_world_cam
    scores: Optional[np.ndarray] = None       # [N] detector confidence
    embeddings: Optional[np.ndarray] = None   # [N, E] caption embeddings
    episode: int = -1
    step: int = -1
    camera: int = 0


class EpisodeDetectionDataset:
    """(rgb, bbs|bbsgt) pairs from a recorded experiment directory."""

    def __init__(self, exp_path: str, label_modality: str = "bbs",
                 with_depth_pose: bool = False,
                 transform: Optional[str] = None,
                 max_detections: int = 16,
                 loader: Optional[SampleLoader] = None):
        self.loader = loader or SampleLoader(exp_path)
        self.label_modality = label_modality
        self.with_depth_pose = with_depth_pose
        self.max_detections = max_detections
        self.transform = transform
        self._rng = np.random.default_rng(0)
        self.index: List[Tuple[int, int, int]] = []
        for ep in self.loader.episodes:
            for cam in self.loader.cameras(ep):
                mods = self.loader.modalities(ep, cam)
                if "rgb" not in mods:
                    continue
                label_cam = self._find_cam(ep, label_modality)
                if label_cam is None:
                    continue
                for step in self.loader.steps(ep, cam, "rgb"):
                    self.index.append((ep, cam, step))

    def _find_cam(self, ep: int, modality: str) -> Optional[int]:
        for cam in self.loader.cameras(ep):
            if modality in self.loader.modalities(ep, cam):
                return cam
        return None

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, i: int) -> Sample:
        ep, cam, step = self.index[i]
        rgb = self.loader.get_sample(ep, cam, "rgb", step).data
        n = self.max_detections
        h, w = rgb.shape[:2]
        s = Sample(
            image=rgb,
            boxes=np.zeros((n, 4), np.float32),
            classes=np.zeros((n,), np.int32),
            logits=np.zeros((n, NUM_CLASSES), np.float32),
            masks=np.zeros((n, h, w), np.float32),
            valid=np.zeros((n,), bool),
            object_ids=np.full((n,), -1, np.int64),
            episode=ep, step=step, camera=cam,
        )
        lcam = self._find_cam(ep, self.label_modality)
        if lcam is not None and step in self.loader.paths[ep][lcam].get(
                self.label_modality, {}):
            bbs = self.loader.get_sample(ep, lcam, self.label_modality,
                                         step).data
            k = min(n, len(bbs.get("boxes", [])))
            if k:
                valid_src = np.asarray(bbs.get("valid",
                                               np.ones(k, bool)))[:k]
                s.boxes[:k] = np.asarray(bbs["boxes"])[:k]
                s.classes[:k] = np.asarray(bbs["classes"])[:k]
                if "logits" in bbs:
                    s.logits[:k] = np.asarray(bbs["logits"])[:k]
                if "masks" in bbs and np.asarray(bbs["masks"]).size:
                    m = np.asarray(bbs["masks"])[:k]
                    if m.shape[-2:] != (h, w):
                        m = _resize_masks(m, h, w)
                    s.masks[:k] = m
                if "object_ids" in bbs:
                    s.object_ids[:k] = np.asarray(bbs["object_ids"])[:k]
                s.valid[:k] = valid_src
        if self.with_depth_pose:
            dcam = self._find_cam(ep, "depth")
            pcam = self._find_cam(ep, "position")
            if dcam is not None:
                s.depth = self.loader.get_sample(ep, dcam, "depth", step).data
            if pcam is not None:
                cam_pose = self.loader.get_sample(ep, pcam, "position",
                                                  step).data
                s.pose = cam_pose.matrix().astype(np.float32)
        if self.transform:
            s = apply_augmentation(s, self.transform, self._rng)
        return s

    # -- batching ---------------------------------------------------------
    def batches(self, batch_size: int, shuffle: bool = False,
                seed: int = 0, weights: Optional[np.ndarray] = None,
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Padded batches; `weights` enables weighted-repeat sampling
        (ref: detector/dataset.py:459-525 + train_helpers.py:192-215
        DistributedWeightSampler)."""
        order = np.arange(len(self))
        rng = np.random.default_rng(seed)
        if weights is not None:
            p = np.asarray(weights, np.float64)
            p = p / p.sum()
            order = rng.choice(len(self), size=len(self), p=p)
        elif shuffle:
            rng.shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            samples = [self[j] for j in order[i:i + batch_size]]
            yield collate(samples)


def collate(samples: Sequence[Sample]) -> Dict[str, np.ndarray]:
    out = {
        "image": np.stack([s.image for s in samples]),
        "boxes": np.stack([s.boxes for s in samples]),
        "classes": np.stack([s.classes for s in samples]),
        "logits": np.stack([s.logits for s in samples]),
        "valid": np.stack([s.valid for s in samples]),
        "object_ids": np.stack([s.object_ids for s in samples]),
        "episode": np.asarray([s.episode for s in samples]),
        "step": np.asarray([s.step for s in samples]),
    }
    if samples[0].masks is not None:
        out["masks"] = np.stack([s.masks for s in samples])
    if samples[0].depth is not None:
        out["depth"] = np.stack([s.depth for s in samples])
    if samples[0].pose is not None:
        out["pose"] = np.stack([s.pose for s in samples])
    return out


class SequentialEpisodeDataset:
    """Windows of consecutive observations within an episode
    (ref: detector/dataset.py:254-457 EpisodeSequentalObservationsDataset /
    EpisodeFullDataset): item i is a list of `window` consecutive Samples
    from one episode/camera, for temporally-consistent labeling."""

    def __init__(self, base: EpisodeDetectionDataset, window: int = 4,
                 stride: int = 1):
        self.base = base
        self.window = window
        self.windows: List[List[int]] = []
        by_ep: Dict[Tuple[int, int], List[int]] = {}
        for idx, (ep, cam, step) in enumerate(base.index):
            by_ep.setdefault((ep, cam), []).append(idx)
        for idxs in by_ep.values():
            for s in range(0, len(idxs) - window + 1, stride):
                self.windows.append(idxs[s:s + window])

    def __len__(self) -> int:
        return len(self.windows)

    def __getitem__(self, i: int) -> List[Sample]:
        return [self.base[j] for j in self.windows[i]]


class PartiallyAnnotatedEpisodeDataset(EpisodeDetectionDataset):
    """Only a fraction of frames carry labels; the others yield every label
    slot invalid, for semi-supervised training
    (ref: detector/dataset.py:527 PartiallyAnnotatedEpisodeFullDataset).
    Frame i is annotated where the i-th draw of
    `np.random.default_rng(seed).random(len(index))` is below
    `annotated_fraction`: the JAX package's draw, so both pick the same
    frames."""

    def __init__(self, *args, annotated_fraction: float = 0.5, seed: int = 0,
                 **kw):
        super().__init__(*args, **kw)
        rng = np.random.default_rng(seed)
        self._annotated = rng.random(len(self.index)) < annotated_fraction

    def __getitem__(self, i: int) -> Sample:
        s = super().__getitem__(i)
        if not self._annotated[i]:
            s.valid[:] = False
        return s


def _resize_masks(masks: np.ndarray, h: int, w: int) -> np.ndarray:
    mh, mw = masks.shape[-2:]
    ys = (np.arange(h) * mh / h).astype(np.int32)
    xs = (np.arange(w) * mw / w).astype(np.int32)
    return masks[:, ys][:, :, xs]


# ---------------------------------------------------------------------------
# augmentations
# ---------------------------------------------------------------------------

AUGMENTATIONS = ("none", "bbs_crop", "bbs_crop_strong", "strong_image")


def apply_augmentation(s: Sample, name: str, rng: np.random.Generator
                       ) -> Sample:
    if name == "none":
        return s
    if name not in AUGMENTATIONS:
        raise ValueError(f"unknown augmentation {name!r}")
    img = s.image.astype(np.float32)
    h, w = img.shape[:2]
    # horizontal flip (all stacks)
    if rng.random() < 0.5:
        img = img[:, ::-1]
        if s.masks is not None:
            s.masks = s.masks[:, :, ::-1]
        x1 = w - s.boxes[:, 2]
        x2 = w - s.boxes[:, 0]
        s.boxes = np.stack([x1, s.boxes[:, 1], x2, s.boxes[:, 3]], axis=1)
    strong = "strong" in name
    # color jitter
    if strong or name == "strong_image":
        img = img * rng.uniform(0.7, 1.3)
        img = img + rng.uniform(-20, 20, size=(1, 1, 3))
    else:
        img = img * rng.uniform(0.9, 1.1)
    # bbox-aware random crop (keeps all valid boxes inside)
    if name.startswith("bbs_crop"):
        frac = 0.7 if strong else 0.85
        vb = s.boxes[s.valid]
        if len(vb):
            x_lo = min(0.0, vb[:, 0].min())
            y_lo = min(0.0, vb[:, 1].min())
            cw = max(int(w * frac), int(vb[:, 2].max() - vb[:, 0].min()) + 2)
            ch = max(int(h * frac), int(vb[:, 3].max() - vb[:, 1].min()) + 2)
            cw, ch = min(cw, w), min(ch, h)
            x0 = int(rng.uniform(max(0, vb[:, 2].max() - cw),
                                 min(vb[:, 0].min(), w - cw) + 1e-6))
            y0 = int(rng.uniform(max(0, vb[:, 3].max() - ch),
                                 min(vb[:, 1].min(), h - ch) + 1e-6))
        else:
            cw, ch = int(w * frac), int(h * frac)
            x0 = int(rng.uniform(0, w - cw))
            y0 = int(rng.uniform(0, h - ch))
        img = img[y0:y0 + ch, x0:x0 + cw]
        if s.masks is not None:
            s.masks = s.masks[:, y0:y0 + ch, x0:x0 + cw]
        s.boxes = s.boxes - np.asarray([x0, y0, x0, y0], np.float32)
        s.boxes = np.clip(s.boxes, 0, [cw, ch, cw, ch])
    s.image = np.clip(img, 0, 255).astype(np.uint8)
    return s
