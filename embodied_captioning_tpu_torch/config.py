"""Configuration dataclasses: a copy of the JAX package's configuration
tree, field for field, with the same presets, YAML overlays and
`a.b.c=value` dotlist overrides, so one overlay configures both packages
alike and `to_dict` of the two trees is equal.

A few fields select paths the port does not have; the modules that would
read them say what they do instead where the field is declared. The
detector `family` selects the
rcnn stack or the query (Mask2Former-class) set predictor, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Dict, List, Optional, Tuple

# the 6 target object classes, keyed by COCO ids
# {57 couch, 58 plant, 59 bed, 60 table, 61 toilet, 62 tv}
COCO_CLASS_IDS: Tuple[int, ...] = (57, 58, 59, 60, 61, 62)
CLASS_NAMES: Tuple[str, ...] = ("couch", "plant", "bed", "table", "toilet",
                               "tv")
NUM_CLASSES = len(CLASS_NAMES)
COCO_TO_LOCAL: Dict[int, int] = {c: i for i, c in enumerate(COCO_CLASS_IDS)}
LOCAL_TO_COCO: Dict[int, int] = {i: c for i, c in enumerate(COCO_CLASS_IDS)}
CLIP_VOCAB_SIZE = 49408  # open_clip CLIP BPE vocabulary size


@dataclass(frozen=True)
class SensorConfig:
    height: int = 256
    width: int = 256
    hfov_deg: float = 79.0
    min_depth: float = 0.5
    max_depth: float = 15.0
    camera_height: float = 0.88  # camera above the agent's base


@dataclass(frozen=True)
class SimConfig:
    """Built-in raycast simulator."""

    backend: str = "raycast"  # read by neither package; replay is Viz-v0/1
    scene_seed: int = 0
    scene_size: float = 12.0  # square room extent in meters
    num_objects: int = 12
    max_boxes: int = 96  # static capacity of the scene's AABB set
    episode_steps: int = 300
    forward_step: float = 0.25
    turn_angle_deg: float = 10.0
    replay_dir: Optional[str] = None  # the npz store Viz-v0/v1 replay
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
    moe_experts: int = 0  # > 0: mixture-of-experts MLPs in the text blocks


@dataclass(frozen=True)
class CaptionerConfig:
    vision: VitConfig = field(default_factory=VitConfig)
    text: TextDecoderConfig = field(default_factory=TextDecoderConfig)
    max_caption_len: int = 30
    dtype: str = "bfloat16"
    remat: bool = False  # rematerialised encoder blocks (training)

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
    """Instance segmenter: FPN + RPN + ROI heads (the rcnn family) or, with
    `family="query"`, the Mask2Former-class set predictor over the same
    backbone and FPN (`models/query_detector.py`)."""

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
    # approximate proposal top-k on the TPU; the port's top-k is exact, as
    # the JAX package's is off the TPU
    approx_topk: bool = False
    stem_s2d: bool = False  # the stem as space-to-depth(2) + a 2x2 conv
    dtype: str = "bfloat16"
    family: str = "rcnn"  # rcnn | query
    # query family: object queries, masked-attention decoder layers, the
    # no-object class weight, and the one-to-many matching of the aux
    # layers (each ground truth's k lowest-cost queries; 0: Hungarian)
    num_queries: int = 64
    query_layers: int = 6
    no_object_weight: float = 0.1
    query_aux_topk: int = 0

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
                              paste_size=256, approx_topk=True)


@dataclass(frozen=True)
class MapConfig:
    """3D semantic voxel map."""

    voxel_size: float = 0.05
    map_scale: float = 0.025  # top-down raster
    grid: Tuple[int, int, int] = (256, 64, 256)  # X (x), Y (height), Z
    max_objects: int = 128
    max_views_per_object: int = 16  # caption-embedding capacity per object
    embed_dim: int = 384
    num_classes: int = NUM_CLASSES
    solution: str = "max"  # seal | bayesian | ours | avg | max
    # obstacle height band in world-y meters
    height_thresh: Tuple[float, float] = (0.10, 0.25)
    cc_connectivity: int = 26

    @staticmethod
    def tiny() -> "MapConfig":
        return MapConfig(grid=(64, 16, 64), max_objects=32,
                         max_views_per_object=8)


@dataclass(frozen=True)
class PolicyConfig:
    """Global exploration policy."""

    map_size: int = 128  # input maps resized to map_size x map_size
    input_channels: int = 2
    hidden: int = 256
    orientation_bins: int = 72
    recurrent: bool = False
    action_space: str = "box2"  # (x, y) in [0,1]^2 map goal


@dataclass(frozen=True)
class PPOConfig:
    clip_param: float = 0.2
    ppo_epoch: int = 4
    num_mini_batch: int = 2
    value_loss_coef: float = 0.5
    entropy_coef: float = 0.001
    lr: float = 2.5e-4
    eps: float = 1e-5
    max_grad_norm: float = 0.5
    gamma: float = 0.99
    tau: float = 0.95
    use_gae: bool = True
    num_global_steps: int = 20
    replanning_steps: int = 80
    reward_scale: float = 1e-3  # disagreement sum / 1000


@dataclass(frozen=True)
class RuntimeConfig:
    num_envs: int = 4
    env_name: str = "Habitat3Env"  # envs/registry.py name
    detector_batch: int = 8
    # caption only the top-k scored detection slots of each frame (0 = all)
    caption_slots_per_frame: int = 0
    # decode padded (invalid) slots too, so decode work does not depend on
    # how many detections the detector returns
    caption_invalid_slots: bool = False
    mesh_shape: Tuple[int, ...] = (1,)  # the port runs on one device
    mesh_axes: Tuple[str, ...] = ("data",)
    seed: int = 7
    obs_dir: Optional[str] = None  # where to save npz observations
    save_gt_obs: bool = False  # also record the ground-truth detections
    checkpoint_dir: Optional[str] = None
    save_periodic: int = 100
    log_interval: int = 10


@dataclass(frozen=True)
class ExperimentConfig:
    trainer_name: str = "goalexplorationbaseline-v0"
    mode: str = "generate"  # train | generate
    preset: str = "tiny"
    sensors: SensorConfig = field(default_factory=SensorConfig)
    sim: SimConfig = field(default_factory=SimConfig)
    captioner: CaptionerConfig = field(default_factory=CaptionerConfig.tiny)
    sentence_encoder: SentenceEncoderConfig = field(
        default_factory=SentenceEncoderConfig.tiny)
    detector: DetectorConfig = field(default_factory=DetectorConfig.tiny)
    map: MapConfig = field(default_factory=MapConfig.tiny)
    policy: PolicyConfig = field(default_factory=PolicyConfig)
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


def to_dict(cfg: Any) -> Any:
    if is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    if isinstance(cfg, dict):
        return {k: to_dict(v) for k, v in cfg.items()}
    return cfg


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


def load_yaml(path: str) -> Dict[str, Any]:
    import yaml  # imported here: only YAML overlays need pyyaml

    with open(path) as fh:
        return yaml.safe_load(fh) or {}


def load_config(preset: str = "tiny", yaml_path: Optional[str] = None,
                overrides: Optional[List[str]] = None) -> ExperimentConfig:
    cfg = ExperimentConfig.preset_config(preset)
    if yaml_path:
        cfg = merge(cfg, load_yaml(yaml_path))
    if overrides:
        cfg = apply_dotlist(cfg, overrides)
    return cfg
