"""Detection consensus pseudo-labelers and the consensus captioner.

The counterpart of the JAX package's `labeling/pseudolabeler.py` (the
reference's family, ref: experimenting_env/detector/pseudolabeler.py):
`ConsensusLabeler` runs `Perceiver.process` over a dataset and gives each
prediction a persistent object id; its subclasses fuse the labels of each
(episode, object) over its views:

  VanillaConsensusLabeler        predictions become labels unchanged
  SoftConsensusLabeler           softmax(mean logits / T) per instance
  MajorityConsensusLabeler       majority class vote, one-hot logits
  MaxScoreConsensusLabeler       the highest-scoring view's class/logits
  SemanticMapConsensusLabeler    one voxel map per episode on the device,
                                 labels re-rendered by raytracing the map
  SemanticMapConsensusCaptioner  the same, with the views' captions kept
                                 and the raytraced instances re-captioned

Predictions are copied to the host once per batch. The detector's boxes
are bf16: a `Sample` holds them widened to float32 (exact), and the id
match computes its IoU on the bf16 tensor, as the JAX package's bf16
arrays round. The four host consensus stages are numpy, as in the JAX
package. Label files are `bbs` npz payloads; the port writes bf16 fields
as float32 (numpy has no bf16), which both packages read.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import NUM_CLASSES, ExperimentConfig
from ..mapping import voxel_map as V
from ..mapping.matching import IdAllocator
from ..ops.detections import (
    Detections, boxes_from_masks, expand_boxes, pairwise_iou,
)
from ..ops.image import crop_and_resize
from ..perception import Perceiver
from ..utils.obs_store import save_obs
from .datasets import EpisodeDetectionDataset, Sample, _resize_masks

MATCH_IOU = 0.3  # a prediction inherits a labelled id above this IoU


def _host(x: torch.Tensor) -> np.ndarray:
    """A CPU tensor as a numpy copy (bf16 widened to float32, exactly)."""
    x = x.float() if x.dtype == torch.bfloat16 else x
    return x.numpy().copy()


class ConsensusLabeler:
    """Base: run the perceiver over a dataset, assign instance ids by IoU
    against each frame's labels, let subclasses fuse per-instance labels.
    `perceiver` defaults to seeded random weights on `device`."""

    def __init__(self, cfg: ExperimentConfig,
                 perceiver: Optional[Perceiver] = None, device="cuda"):
        self.cfg = cfg
        self.perceiver = perceiver or Perceiver(cfg, device=device)
        self.device = torch.device(getattr(self.perceiver, "device", device))
        self.alloc = IdAllocator()

    # -- stage 1: predict over the dataset --------------------------------
    def predict(self, dataset: EpisodeDetectionDataset, batch_size: int = 8
                ) -> List[Sample]:
        """Per-frame predicted Samples with matched object ids, over the
        dataset's whole batches."""
        outs: List[Sample] = []
        for batch in dataset.batches(batch_size):
            result = self.perceiver.process(batch["image"])
            det = result.detections.to("cpu")
            for b in range(batch["image"].shape[0]):
                pred = self._build_sample(det, batch, b)
                pred.object_ids = self._match_ids(pred, batch, b,
                                                  det.boxes[b])
                self._collect(pred, det, result, b)
                outs.append(pred)
        return outs

    def _build_sample(self, det: Detections, batch, b: int) -> Sample:
        """Frame b of host detections as a Sample (numpy copies: the
        consensus stages write labels in place)."""
        n = det.valid.shape[1]
        pred = Sample(
            image=batch["image"][b],
            boxes=_host(det.boxes[b]),
            classes=_host(det.classes[b]),
            logits=_host(det.logits[b]),
            masks=_host(det.masks[b]),
            valid=_host(det.valid[b]),
            scores=_host(det.scores[b]),
            object_ids=np.full((n,), -1, np.int64),
            episode=int(batch["episode"][b]),
            step=int(batch["step"][b]),
        )
        if det.embeddings is not None:
            pred.embeddings = _host(det.embeddings[b])
        if "depth" in batch:
            pred.depth = batch["depth"][b]
        if "pose" in batch:
            pred.pose = batch["pose"][b]
        return pred

    def _collect(self, pred: Sample, det: Detections, result, b: int
                 ) -> None:
        """Hook for subclasses that harvest extra per-frame outputs
        (captions, embeddings) from the perception result."""

    def _match_ids(self, pred: Sample, batch, b: int,
                   boxes: Optional[torch.Tensor] = None) -> np.ndarray:
        """IoU-match predictions to the frame's labelled instances to
        inherit their ids (above MATCH_IOU, first best); the others take
        fresh ids. `boxes`: the detector's own (bf16) tensor of the
        predictions, which the IoU is computed in; default `pred.boxes`."""
        n = len(pred.valid)
        ids = np.full((n,), -1, np.int64)
        gt_boxes = batch["boxes"][b]
        gt_valid = batch["valid"][b]
        gt_ids = batch["object_ids"][b]
        if boxes is None:
            boxes = torch.from_numpy(pred.boxes)
        iou = pairwise_iou(boxes.cpu(), torch.from_numpy(
            np.asarray(gt_boxes))).numpy()
        iou = iou * gt_valid[None, :]
        for i in np.nonzero(pred.valid)[0]:
            j = int(np.argmax(iou[i])) if iou.shape[1] else 0
            if iou.shape[1] and iou[i, j] > MATCH_IOU and gt_ids[j] >= 0:
                ids[i] = gt_ids[j]
            else:
                ids[i] = self.alloc.take(1)[0]
        return ids

    # -- stage 2: consensus ------------------------------------------------
    def get_pseudo_labels(self, preds: List[Sample]) -> List[Sample]:
        raise NotImplementedError

    # -- io ----------------------------------------------------------------
    @staticmethod
    def save_pseudo_labels(preds: List[Sample], out_dir: str) -> List[str]:
        """Per-frame `bbs` npz payloads in `out_dir`. Scores are the
        detector's confidences where the predictor gave them, else each
        slot's largest class probability, else the validity."""
        paths = []
        for p in preds:
            if p.scores is not None:
                scores = np.asarray(p.scores, np.float32)
            elif p.logits is not None:
                scores = p.logits.max(-1).astype(np.float32)
            else:
                scores = p.valid.astype(np.float32)
            payload = {
                "boxes": p.boxes, "classes": p.classes, "logits": p.logits,
                "valid": p.valid, "object_ids": p.object_ids,
                "scores": scores * p.valid,
            }
            if p.masks is not None:
                payload["masks"] = p.masks
            obs = {"bbs": np.array({"instances": payload}, dtype=object)}
            paths += save_obs(out_dir, p.episode, obs, p.step)
        return paths


class VanillaConsensusLabeler(ConsensusLabeler):
    """Predictions become labels unchanged."""

    def get_pseudo_labels(self, preds: List[Sample]) -> List[Sample]:
        return preds


def _group_by_object(preds: List[Sample]):
    groups: Dict[Tuple[int, int], List[Tuple[Sample, int]]] = defaultdict(
        list)
    for p in preds:
        for i in np.nonzero(p.valid)[0]:
            groups[(p.episode, int(p.object_ids[i]))].append((p, int(i)))
    return groups


class SoftConsensusLabeler(ConsensusLabeler):
    """Per-instance soft logits: the softmax of the mean logits over every
    view of the instance, at `temperature`."""

    def __init__(self, cfg, temperature: float = 2.0, **kw):
        super().__init__(cfg, **kw)
        self.temperature = temperature

    def get_pseudo_labels(self, preds: List[Sample]) -> List[Sample]:
        groups = _group_by_object(preds)
        fused: Dict[Tuple[int, int], np.ndarray] = {}
        for key, items in groups.items():
            logits = np.stack([p.logits[i] for p, i in items])
            mean = logits.mean(0) / self.temperature
            e = np.exp(mean - mean.max())
            fused[key] = (e / e.sum()).astype(np.float32)
        for p in preds:
            for i in np.nonzero(p.valid)[0]:
                soft = fused[(p.episode, int(p.object_ids[i]))]
                p.logits[i] = soft
                p.classes[i] = int(soft.argmax())
        return preds


class MajorityConsensusLabeler(ConsensusLabeler):
    """Majority class vote per instance (ties to the lower class); every
    view is relabelled to the winner, with one-hot logits."""

    def get_pseudo_labels(self, preds: List[Sample]) -> List[Sample]:
        groups = _group_by_object(preds)
        winner: Dict[Tuple[int, int], int] = {}
        for key, items in groups.items():
            votes = np.bincount([p.classes[i] for p, i in items],
                                minlength=NUM_CLASSES)
            winner[key] = int(votes.argmax())
        for p in preds:
            for i in np.nonzero(p.valid)[0]:
                c = winner[(p.episode, int(p.object_ids[i]))]
                p.classes[i] = c
                one = np.zeros(NUM_CLASSES, np.float32)
                one[c] = 1.0
                p.logits[i] = one
        return preds


class MaxScoreConsensusLabeler(ConsensusLabeler):
    """Each instance keeps the class and logits of its single
    highest-scoring view (the first of equals)."""

    def get_pseudo_labels(self, preds: List[Sample]) -> List[Sample]:
        groups = _group_by_object(preds)
        best: Dict[Tuple[int, int], Tuple[np.ndarray, int]] = {}
        for key, items in groups.items():
            scores = [float(p.logits[i].max()) for p, i in items]
            p, i = items[int(np.argmax(scores))]
            best[key] = (p.logits[i].copy(), int(p.classes[i]))
        for p in preds:
            for i in np.nonzero(p.valid)[0]:
                lg, c = best[(p.episode, int(p.object_ids[i]))]
                p.logits[i] = lg
                p.classes[i] = c
        return preds


class SemanticMapConsensusLabeler(ConsensusLabeler):
    """3D-consistent pseudo-labels: every frame fuses into its episode's
    voxel map on the device, then each frame's labels are re-rendered by
    raytracing the map (`voxel_map.raytrace_pseudo_labels`)."""

    def __init__(self, cfg, **kw):
        super().__init__(cfg, **kw)
        self.global_maps: Dict[int, V.VoxelMapState] = {}

    def _map_for(self, episode: int) -> V.VoxelMapState:
        if episode not in self.global_maps:
            self.global_maps[episode] = V.create(
                self.cfg.map, lower_bound=[0.0, -0.5, 0.0], episode=episode,
                device=self.device)
        return self.global_maps[episode]

    def accumulate(self, preds: List[Sample]) -> None:
        """Fuse every prediction with depth and pose into its episode's
        map, with its caption embeddings where the predictor gave them at
        the map's width (zeros otherwise)."""
        dev = self.device
        for p in preds:
            if p.depth is None or p.pose is None:
                continue
            state = self._map_for(p.episode)
            if (p.embeddings is not None
                    and p.embeddings.shape[-1] == self.cfg.map.embed_dim):
                emb = np.asarray(p.embeddings, np.float32)
            else:
                emb = np.zeros((len(p.valid), self.cfg.map.embed_dim),
                               np.float32)
            masks = p.masks
            if masks.shape[-2:] != p.depth.shape:
                masks = _resize_masks(masks, *p.depth.shape)

            def on(x):
                return torch.as_tensor(np.asarray(x), device=dev)

            self.global_maps[p.episode] = V.integrate_frame(
                state, on(p.depth), on(p.pose), on(masks), on(p.classes),
                on(p.logits), on(emb), on(p.valid), self.cfg.map,
                hfov_deg=self.cfg.sensors.hfov_deg,
                min_depth=self.cfg.sensors.min_depth,
                max_depth=self.cfg.sensors.max_depth)

    def get_pseudo_labels(self, preds: List[Sample]) -> List[Sample]:
        self.accumulate(preds)
        dev = self.device
        out: List[Sample] = []
        for p in preds:
            if p.depth is None or p.pose is None:
                out.append(p)
                continue
            state = self.global_maps[p.episode]
            masks, slots, classes, logits, valid = V.raytrace_pseudo_labels(
                state, torch.as_tensor(p.depth, device=dev),
                torch.as_tensor(p.pose, device=dev), self.cfg.map,
                hfov_deg=self.cfg.sensors.hfov_deg,
                max_objects_out=len(p.valid),
                min_pixels=max(20, p.depth.size // 2184))
            masks = masks.float()
            boxes = boxes_from_masks(masks, valid)
            valid_np = valid.cpu().numpy()
            out.append(Sample(
                image=p.image, boxes=boxes.cpu().numpy(),
                classes=classes.cpu().numpy() * valid_np,
                logits=logits.float().cpu().numpy() * valid_np[:, None],
                masks=masks.cpu().numpy(), valid=valid_np,
                object_ids=np.where(valid_np, slots.cpu().numpy(), -1),
                depth=p.depth, pose=p.pose, episode=p.episode, step=p.step))
        return out


class SemanticMapConsensusCaptioner(SemanticMapConsensusLabeler):
    """Adds captions: each prediction's caption and embedding are kept
    during `predict` (the perceiver computes both), the embeddings fuse
    into the map, and `recaption` captions the raytraced instances from
    their boxes."""

    def predict(self, dataset, batch_size: int = 8) -> List[Sample]:
        self.captions: Dict[Tuple[int, int], List[str]] = defaultdict(list)
        self.embeddings: Dict[Tuple[int, int], List[np.ndarray]] = \
            defaultdict(list)
        self._caps_cache: Tuple[int, Optional[List]] = (-1, None)
        return super().predict(dataset, batch_size)

    def _collect(self, pred: Sample, det: Detections, result, b: int
                 ) -> None:
        # decode a batch's captions once (called per sample)
        if self._caps_cache[0] != id(result):
            self._caps_cache = (id(result), self.perceiver.captions(result))
        caps = self._caps_cache[1]
        for i in np.nonzero(pred.valid)[0]:
            key = (pred.episode, int(pred.object_ids[i]))
            self.captions[key].append(caps[b][int(i)])
            if pred.embeddings is not None:
                self.embeddings[key].append(pred.embeddings[i])

    def recaption(self, pseudo: List[Sample]) -> Dict[Tuple[int, int], str]:
        """A greedy caption of each raytraced instance's crop."""
        out: Dict[Tuple[int, int], str] = {}
        for p in pseudo:
            idx = np.nonzero(p.valid)[0]
            if len(idx) == 0:
                continue
            caps = self._caption_boxes(p.image, p.boxes[idx])
            for i, c in zip(idx, caps):
                out[(p.episode, int(p.object_ids[i]))] = c
        return out

    def _caption_boxes(self, image: np.ndarray, boxes: np.ndarray
                       ) -> List[str]:
        """Captions of `boxes` [k, 4] of a uint8 frame: crops expanded by
        0.2, resized to the ViT's input, greedy `generate`. The rows are
        padded to a power of two, as the JAX package pads them (the decode
        route depends on the row count)."""
        from ..models.captioner import generate

        cfg = self.cfg.captioner
        dev = self.device
        h, w = image.shape[:2]
        k = len(boxes)
        cap = 1
        while cap < k:
            cap *= 2
        padded = np.zeros((cap, 4), np.float32)
        padded[:k] = boxes
        eb = expand_boxes(torch.from_numpy(padded).to(dev), 0.2, h, w)
        crops = crop_and_resize(torch.as_tensor(image, device=dev).float(),
                                eb, cfg.vision.image_size).to(torch.uint8)
        toks, _, _ = generate(self.perceiver.params.captioner, crops, cfg,
                              w8a8=self.perceiver.w8a8,
                              int8_kv=self.perceiver.int8_kv)
        return [self.perceiver.tokenizer.decode(t)
                for t in toks.cpu().numpy()[:k]]


CONSENSUS_REGISTRY = {
    "vanilla": VanillaConsensusLabeler,
    "logits": SoftConsensusLabeler,
    "soft": SoftConsensusLabeler,
    "majority": MajorityConsensusLabeler,
    "max_score": MaxScoreConsensusLabeler,
    "semantic_map": SemanticMapConsensusLabeler,
    "semantic_map_captioner": SemanticMapConsensusCaptioner,
}
