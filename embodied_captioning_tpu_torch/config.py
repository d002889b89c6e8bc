"""Configuration dataclasses for the perception and exploration-loop slices.

A copy of the fields of the JAX package's configuration tree that the
ported paths read (detector, captioner, sentence encoder, sensors,
simulator, voxel map, reward scale, runtime), with the same presets and
the same `merge` / `apply_dotlist` overlay rules, so one overlay dict
configures both packages alike.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Dict, List, Tuple

CLASS_NAMES: Tuple[str, ...] = ("couch", "plant", "bed", "table", "toilet",
                               "tv")
NUM_CLASSES = len(CLASS_NAMES)
CLIP_VOCAB_SIZE = 49408  # open_clip CLIP BPE vocabulary size


@dataclass(frozen=True)
class SensorConfig:
    height: int = 256
    width: int = 256
    hfov_deg: float = 79.0
    min_depth: float = 0.5
    max_depth: float = 15.0


@dataclass(frozen=True)
class SimConfig:
    """Built-in raycast simulator."""

    scene_seed: int = 0
    scene_size: float = 12.0  # square room extent in meters
    num_objects: int = 12
    max_boxes: int = 96  # static capacity of the scene's AABB set
    forward_step: float = 0.25
    turn_angle_deg: float = 10.0
    num_distractors: int = 0  # non-target clutter objects (class -1)
    interior_walls: int = 2   # occluding wall segments
    tex_boost: float = 0.0    # added texture contrast


@dataclass(frozen=True)
class VitConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16
    mlp_ratio: float = 4.0
    pool_queries: int = 256
    pool_heads: int = 8
    embed_dim: int = 768


@dataclass(frozen=True)
class TextDecoderConfig:
    context_length: int = 77
    vocab_size: int = CLIP_VOCAB_SIZE
    width: int = 768
    heads: int = 12
    layers: int = 12
    cross_layers: int = 12
    mlp_ratio: float = 4.0
    pad_id: int = 0
    bos_id: int = 1
    eos_id: int = 2


@dataclass(frozen=True)
class CaptionerConfig:
    vision: VitConfig = field(default_factory=VitConfig)
    text: TextDecoderConfig = field(default_factory=TextDecoderConfig)
    max_caption_len: int = 30

    @staticmethod
    def tiny() -> "CaptionerConfig":
        return CaptionerConfig(
            vision=VitConfig(image_size=64, patch_size=8, width=64, layers=2,
                             heads=2, pool_queries=16, pool_heads=2,
                             embed_dim=64),
            text=TextDecoderConfig(context_length=32, vocab_size=1024,
                                   width=64, heads=2, layers=2,
                                   cross_layers=2),
            max_caption_len=12,
        )

    @staticmethod
    def base() -> "CaptionerConfig":
        return CaptionerConfig(
            vision=VitConfig(image_size=224, patch_size=16, width=768,
                             layers=12, heads=12, pool_queries=128,
                             pool_heads=8, embed_dim=512),
            text=TextDecoderConfig(context_length=77,
                                   vocab_size=CLIP_VOCAB_SIZE, width=512,
                                   heads=8, layers=6, cross_layers=6),
        )

    @staticmethod
    def large() -> "CaptionerConfig":
        return CaptionerConfig()


@dataclass(frozen=True)
class SentenceEncoderConfig:
    vocab_size: int = 1024
    width: int = 384
    layers: int = 6
    heads: int = 12
    mlp_ratio: float = 4.0
    max_len: int = 64
    embed_dim: int = 384
    post_ln: bool = False  # BERT/MiniLM layer ordering
    dtype: str = "bfloat16"  # compute dtype; "float32" for parity runs

    @staticmethod
    def tiny() -> "SentenceEncoderConfig":
        return SentenceEncoderConfig(width=64, layers=2, heads=2, max_len=32,
                                     embed_dim=384)


@dataclass(frozen=True)
class DetectorConfig:
    """FPN + RPN + ROI instance segmenter (the rcnn family)."""

    image_size: int = 256
    backbone_width: int = 64
    backbone_depths: Tuple[int, ...] = (2, 2, 2, 2)
    block: str = "basic"  # basic | bottleneck
    norm: str = "gn"      # gn | affine
    fpn_dim: int = 128
    min_level: int = 0
    add_p6: bool = False
    num_classes: int = NUM_CLASSES
    pre_nms_topk: int = 256
    num_proposals: int = 64
    max_detections: int = 16
    roi_size: int = 7
    mask_roi_size: int = 14
    mask_size: int = 28
    paste_size: int = 0
    score_threshold: float = 0.5
    nms_iou_threshold: float = 0.5
    family: str = "rcnn"  # the port has the rcnn family only
    stem_s2d: bool = False  # the port has the direct stem only

    @property
    def fpn_strides(self) -> Tuple[int, ...]:
        s = tuple(4 * (2 ** i) for i in range(self.min_level, 4))
        return s + (64,) if self.add_p6 else s

    @staticmethod
    def tiny() -> "DetectorConfig":
        return DetectorConfig(image_size=64, backbone_width=16,
                              backbone_depths=(1, 1, 1, 1), fpn_dim=32,
                              pre_nms_topk=64, num_proposals=16,
                              max_detections=8)

    @staticmethod
    def large() -> "DetectorConfig":
        return DetectorConfig(image_size=1024, backbone_width=64,
                              backbone_depths=(3, 4, 6, 3),
                              block="bottleneck", norm="affine", fpn_dim=256,
                              min_level=1, add_p6=True, pre_nms_topk=1024,
                              num_proposals=128, max_detections=16,
                              paste_size=256)


@dataclass(frozen=True)
class MapConfig:
    """3D semantic voxel map."""

    voxel_size: float = 0.05
    grid: Tuple[int, int, int] = (256, 64, 256)  # X (x), Y (height), Z
    max_objects: int = 128
    max_views_per_object: int = 16  # caption-embedding capacity per object
    embed_dim: int = 384
    num_classes: int = NUM_CLASSES
    solution: str = "max"  # seal | bayesian | ours | avg | max
    # obstacle height band in world-y meters
    height_thresh: Tuple[float, float] = (0.10, 0.25)

    @staticmethod
    def tiny() -> "MapConfig":
        return MapConfig(grid=(64, 16, 64), max_objects=32,
                         max_views_per_object=8)


@dataclass(frozen=True)
class PPOConfig:
    reward_scale: float = 1e-3  # disagreement sum / 1000


@dataclass(frozen=True)
class RuntimeConfig:
    num_envs: int = 4
    # caption only the top-k scored detection slots of each frame (0 = all)
    caption_slots_per_frame: int = 0
    # decode padded (invalid) slots too, so decode work does not depend on
    # how many detections the detector returns
    caption_invalid_slots: bool = False


@dataclass(frozen=True)
class ExperimentConfig:
    preset: str = "tiny"
    sensors: SensorConfig = field(default_factory=SensorConfig)
    sim: SimConfig = field(default_factory=SimConfig)
    captioner: CaptionerConfig = field(default_factory=CaptionerConfig.tiny)
    sentence_encoder: SentenceEncoderConfig = field(
        default_factory=SentenceEncoderConfig.tiny)
    detector: DetectorConfig = field(default_factory=DetectorConfig.tiny)
    map: MapConfig = field(default_factory=MapConfig.tiny)
    ppo: PPOConfig = field(default_factory=PPOConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)

    @staticmethod
    def preset_config(name: str = "tiny") -> "ExperimentConfig":
        if name == "tiny":
            return ExperimentConfig(preset=name)
        if name in ("base", "large"):
            return ExperimentConfig(
                preset=name,
                captioner=(CaptionerConfig.base() if name == "base"
                           else CaptionerConfig.large()),
                sentence_encoder=SentenceEncoderConfig(
                    vocab_size=CLIP_VOCAB_SIZE, post_ln=True),
                detector=(DetectorConfig() if name == "base"
                          else DetectorConfig.large()),
                sensors=(SensorConfig() if name == "base"
                         else SensorConfig(height=1280, width=1280)),
                map=MapConfig(),
            )
        raise ValueError(f"unknown preset {name!r}")


def merge(cfg: Any, overlay: Dict[str, Any]) -> Any:
    """Copy of frozen dataclass `cfg` with a nested dict overlay applied."""
    updates: Dict[str, Any] = {}
    names = {f.name for f in fields(cfg)}
    for key, value in overlay.items():
        if key not in names:
            raise KeyError(
                f"unknown config key {key!r} on {type(cfg).__name__}")
        cur = getattr(cfg, key)
        if is_dataclass(cur) and isinstance(value, dict):
            updates[key] = merge(cur, value)
        else:
            if isinstance(cur, tuple) and isinstance(value, (list, tuple)):
                value = tuple(value)
            updates[key] = value
    return dataclasses.replace(cfg, **updates)


def _parse_value(text: str) -> Any:
    try:
        return json.loads(text)
    except ValueError:
        return text


def apply_dotlist(cfg: Any, overrides: List[str]) -> Any:
    """Apply `a.b.c=value` overrides."""
    overlay: Dict[str, Any] = {}
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} must look like a.b.c=value")
        path, raw = item.split("=", 1)
        node = overlay
        keys = path.split(".")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = _parse_value(raw)
    return merge(cfg, overlay)
