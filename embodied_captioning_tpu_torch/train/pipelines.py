"""Teacher-student detector distillation pipelines.

The counterpart of the JAX package's `train/pipelines.py` (the reference's
orchestration layer, ref: experimenting_env/pipelines.py): a teacher
detector labels an exploration dataset through a consensus labeler, a
student detector trains on those labels, and the teacher is refreshed
from the student (replaced after each round, or an EMA of it).

  TeacherStudent        student from the seeded init, teacher a copy; the
                        labeler's perceiver detects with the teacher;
                        clip-by-global-norm(1) then AdamW (decay 1e-4)
  OnlineTeacherStudent  the teacher labels each batch on the fly
  Pipeline              generate the dataset where it is missing,
                        pseudo-label it, fit the student, refresh
  GTPipeline            train on the store's ground truth (`bbsgt`)
  OnlinePipeline        with OnlineTeacherStudent
  SWAPipeline           the student's snapshots averaged at the end

EMA and SWA are maps over the parameter trees. Saved pipelines are numpy
trees in the JAX package's layout (`params.to_numpy`), which load in both
packages.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import ExperimentConfig
from ..labeling.datasets import EpisodeDetectionDataset, Sample, collate
from ..labeling.pseudolabeler import CONSENSUS_REGISTRY, ConsensusLabeler
from ..models import detector as DET
from ..ops.detections import Detections
from ..params import from_jax, to_numpy
from ..utils.metrics import evaluate_detections
from .optim import (
    adam_init, adam_update, piecewise_constant_schedule, tree_map,
    value_and_grad, warmup_cosine_decay_schedule,
)

MAX_GRAD_NORM = 1.0
WEIGHT_DECAY = 1e-4  # optax.adamw's default


def ema_update(teacher: dict, student: dict, decay: float = 0.996) -> dict:
    """teacher <- decay * teacher + (1 - decay) * student, leaf by leaf."""
    return tree_map(lambda t, s: decay * t + (1.0 - decay) * s, teacher,
                    student)


def swa_average(snapshots: List[dict]) -> dict:
    """The leafwise mean of parameter trees: summed in order, then divided
    by their number (a true division, as the JAX package's)."""
    n = len(snapshots)

    def mean(*xs):
        total = sum(xs)
        return total / torch.tensor(float(n), dtype=total.dtype,
                                    device=total.device)

    return tree_map(mean, *snapshots)


def mixup_batch(batch: Dict[str, np.ndarray], rng: np.random.Generator,
                alpha: float = 0.2) -> Dict[str, np.ndarray]:
    """Image mixup within a batch: frame b blends with frame perm[b] at
    lam ~ Beta(alpha, alpha); its targets are the union of both frames'
    valid slots, up to capacity."""
    lam = float(rng.beta(alpha, alpha))
    perm = rng.permutation(batch["image"].shape[0])
    out = dict(batch)
    out["image"] = (lam * batch["image"].astype(np.float32)
                    + (1 - lam) * batch["image"][perm].astype(np.float32)
                    ).astype(batch["image"].dtype)
    boxes, classes, logits, valid = (batch["boxes"].copy(),
                                     batch["classes"].copy(),
                                     batch["logits"].copy(),
                                     batch["valid"].copy())
    for b in range(len(perm)):
        src = perm[b]
        free = np.nonzero(~valid[b])[0]
        take = np.nonzero(batch["valid"][src])[0][: len(free)]
        if len(take):
            sel = free[: len(take)]
            boxes[b, sel] = batch["boxes"][src, take]
            classes[b, sel] = batch["classes"][src, take]
            logits[b, sel] = batch["logits"][src, take]
            valid[b, sel] = True
    out.update(boxes=boxes, classes=classes, logits=logits, valid=valid)
    return out


def make_lr_schedule(kind: str = "constant", lr: float = 1e-4,
                     warmup_steps: int = 100, total_steps: int = 10_000):
    """`constant` (the step size itself), `cosine` (linear warmup from 0,
    cosine decay to 0 at `total_steps`) or `step` (x0.1 at half and again
    at three quarters of `total_steps`), as optax computes them."""
    if kind == "constant":
        return lr
    if kind == "cosine":
        return warmup_cosine_decay_schedule(0.0, lr, warmup_steps,
                                            total_steps)
    if kind == "step":
        return piecewise_constant_schedule(
            lr, {total_steps // 2: 0.1, (3 * total_steps) // 4: 0.1})
    raise ValueError(f"unknown schedule {kind!r}")


def _clone(tree: dict) -> dict:
    return tree_map(lambda t: t.clone(), tree)


class TeacherStudent:
    """A teacher (through a consensus labeler) distills into a trainable
    student detector. The student starts from the seeded init (a
    `torch.Generator` seeded with `seed`) or `student_params`; the
    teacher from a copy of it or `teacher_params`. `perceiver` (default:
    the labeler's seeded one on `device`) detects with the teacher."""

    def __init__(self, cfg: ExperimentConfig, consensus: str = "soft",
                 head: str = "focal", lr: float = 1e-4,
                 student_params: Optional[dict] = None,
                 teacher_params: Optional[dict] = None, seed: int = 0,
                 device="cuda", perceiver=None):
        self.cfg = cfg
        self.head = head
        self.lr = lr
        self.device = torch.device(device)
        self.student = student_params or DET.init_detector(
            torch.Generator(device=self.device).manual_seed(seed),
            cfg.detector, self.device)
        self.teacher = teacher_params or _clone(self.student)
        self.labeler: ConsensusLabeler = CONSENSUS_REGISTRY[consensus](
            cfg, perceiver=perceiver, device=self.device)
        self._teach()
        self.opt_state = adam_init(self.student)

    def _teach(self) -> None:
        """The labeler's perceiver detects with the teacher."""
        per = self.labeler.perceiver
        per.params = per.params._replace(detector=self.teacher)

    # -- steps -------------------------------------------------------------
    def _train_step(self, images: torch.Tensor, gt: Detections):
        loss, aux, grads = value_and_grad(
            lambda p: DET.detector_loss(p, images, gt, self.cfg.detector,
                                        head=self.head), self.student)
        self.student, self.opt_state = adam_update(
            self.student, self.opt_state, grads, self.lr, MAX_GRAD_NORM,
            weight_decay=WEIGHT_DECAY)
        return {"loss": float(loss), **{k: float(v) for k, v in aux.items()}}

    def _to_detector_scale(self, batch: Dict[str, np.ndarray]):
        """Images resized to the detector's square input (bilinear, clipped,
        truncated to uint8) and boxes scaled with them (the factors in
        double, then float32)."""
        from ..ops.image import resize_bilinear

        size = self.cfg.detector.image_size
        dev = self.device
        images = torch.as_tensor(batch["image"], device=dev)
        h, w = images.shape[1:3]
        boxes = torch.as_tensor(np.asarray(batch["boxes"], np.float32),
                                device=dev)
        if (h, w) != (size, size):
            images = torch.clamp(resize_bilinear(images.float(), size, size),
                                 0, 255).to(torch.uint8)
            boxes = boxes * torch.tensor([size / w, size / h, size / w,
                                          size / h], dtype=torch.float32,
                                         device=dev)
        return images, boxes

    def _targets(self, batch, boxes: torch.Tensor) -> Detections:
        dev = self.device
        valid = torch.as_tensor(batch["valid"], device=dev)
        return Detections(
            boxes=boxes, classes=torch.as_tensor(batch["classes"],
                                                 device=dev),
            scores=valid.float(),
            logits=torch.as_tensor(batch["logits"], device=dev),
            valid=valid)

    def training_step(self, batch: Dict[str, np.ndarray]
                      ) -> Dict[str, float]:
        images, boxes = self._to_detector_scale(batch)
        return self._train_step(images, self._targets(batch, boxes))

    @torch.no_grad()
    def validate(self, dataset: EpisodeDetectionDataset,
                 batch_size: int = 4, max_batches: int = 16
                 ) -> Dict[str, float]:
        """mAP@50 of the student against the dataset's labels."""
        preds, gts = [], []
        for bi, batch in enumerate(dataset.batches(batch_size)):
            if bi >= max_batches:
                break
            images, boxes = self._to_detector_scale(batch)
            det = DET.forward(self.student, images, self.cfg.detector,
                              with_masks=False)
            gt = self._targets(batch, boxes)
            for b in range(images.shape[0]):
                preds.append(det.index(b))
                gts.append(gt.index(b))
        m = evaluate_detections(preds, gts, self.cfg.detector.num_classes)
        return {"val_map_50": m["map"]}

    def update_teacher_ema(self, decay: float = 0.996) -> None:
        self.teacher = ema_update(self.teacher, self.student, decay)
        self._teach()

    def replace_teacher(self) -> None:
        """teacher <- student."""
        self.teacher = _clone(self.student)
        self._teach()


class OnlineTeacherStudent(TeacherStudent):
    """The teacher labels each batch on the fly (its detections, without
    masks, are the targets)."""

    def training_step(self, batch: Dict[str, np.ndarray]
                      ) -> Dict[str, float]:
        images, _ = self._to_detector_scale(batch)
        with torch.no_grad():
            det = DET.forward(self.teacher, images, self.cfg.detector,
                              with_masks=False)
        gt = Detections(boxes=det.boxes, classes=det.classes,
                        scores=det.scores, logits=det.logits,
                        valid=det.valid)
        return self._train_step(images, gt)


class Pipeline:
    """explore -> pseudo-label -> fit the student -> refresh the teacher."""

    TS_CLS = TeacherStudent

    def __init__(self, cfg: ExperimentConfig, trainer_name: str =
                 "randombaseline", consensus: str = "soft",
                 head: str = "focal", use_ema: bool = False, device="cuda",
                 perceiver=None):
        self.cfg = cfg
        self.trainer_name = trainer_name
        self.device = torch.device(device)
        self.ts = self.TS_CLS(cfg, consensus=consensus, head=head,
                              device=self.device, perceiver=perceiver)
        self.use_ema = use_ema

    def collect_pseudolabeled_dataset(self, obs_dir: str,
                                      num_steps: Optional[int] = None,
                                      ) -> List[Sample]:
        """Generate the dataset with the trainer (and the labeler's
        perceiver) where it is missing, then pseudo-label it."""
        if not os.path.exists(obs_dir) or not os.listdir(obs_dir):
            from ..agents import get_trainer

            runtime = dataclasses.replace(self.cfg.runtime, obs_dir=obs_dir)
            gen_cfg = dataclasses.replace(self.cfg, runtime=runtime)
            trainer = get_trainer(self.trainer_name)(
                gen_cfg, device=self.device,
                perceiver=self.ts.labeler.perceiver)
            trainer.generate(num_steps)
            trainer.envs.close()
        dataset = EpisodeDetectionDataset(obs_dir, label_modality="bbs",
                                          with_depth_pose=True)
        preds = self.ts.labeler.predict(dataset)
        return self.ts.labeler.get_pseudo_labels(preds)

    @staticmethod
    def _batch_starts(n: int, batch_size: int):
        """Whole batches, the tail dropped; a round smaller than one batch
        trains on one undersized batch of what it has."""
        starts = list(range(0, n - batch_size + 1, batch_size))
        if not starts and n > 0:
            return [0], n
        return starts, batch_size

    def fit_student(self, labeled: List[Sample], epochs: int = 1,
                    batch_size: int = 4) -> List[Dict[str, float]]:
        logs = []
        starts, bs = self._batch_starts(len(labeled), batch_size)
        for _ in range(epochs):
            for i in starts:
                batch = collate(labeled[i:i + bs])
                logs.append(self.ts.training_step(batch))
                if self.use_ema:
                    self.ts.update_teacher_ema()
        return logs

    def run_round(self, obs_dir: str, num_steps: Optional[int] = None,
                  epochs: int = 1) -> List[Dict[str, float]]:
        labeled = self.collect_pseudolabeled_dataset(obs_dir, num_steps)
        logs = self.fit_student(labeled, epochs)
        # a student that did not train this round keeps the teacher
        if logs and not self.use_ema:
            self.ts.replace_teacher()
        return logs

    # -- persistence -------------------------------------------------------
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "wb") as fh:
            pickle.dump({"teacher": to_numpy(self.ts.teacher),
                         "student": to_numpy(self.ts.student)}, fh)

    def load(self, path: str) -> None:
        with open(path, "rb") as fh:
            d = pickle.load(fh)
        self.ts.teacher = from_jax(d["teacher"], self.device)
        self.ts.student = from_jax(d["student"], self.device)
        self.ts._teach()


class GTPipeline(Pipeline):
    """Train on the store's ground truth (`bbsgt`), no consensus."""

    def collect_pseudolabeled_dataset(self, obs_dir, num_steps=None):
        dataset = EpisodeDetectionDataset(obs_dir, label_modality="bbsgt",
                                          with_depth_pose=False)
        return [dataset[i] for i in range(len(dataset))]


class OnlinePipeline(Pipeline):
    """Online distillation."""

    TS_CLS = OnlineTeacherStudent


class SWAPipeline(Pipeline):
    """Keeps a snapshot of the student every `snapshot_every` steps and
    averages the snapshots and the last student at the end of a fit."""

    def __init__(self, cfg, snapshot_every: int = 50, **kw):
        super().__init__(cfg, **kw)
        self.snapshot_every = snapshot_every
        self._snapshots: List[dict] = []
        self._count = 0

    def fit_student(self, labeled, epochs: int = 1, batch_size: int = 4):
        logs = []
        starts, bs = self._batch_starts(len(labeled), batch_size)
        for _ in range(epochs):
            for i in starts:
                batch = collate(labeled[i:i + bs])
                logs.append(self.ts.training_step(batch))
                if self.use_ema:  # SWA composes with an EMA teacher
                    self.ts.update_teacher_ema()
                self._count += 1
                if self._count % self.snapshot_every == 0:
                    self._snapshots.append(_clone(self.ts.student))
        if self._snapshots:
            self.ts.student = swa_average(
                self._snapshots + [self.ts.student])
        return logs
