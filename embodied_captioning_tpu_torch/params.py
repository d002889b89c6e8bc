"""Weight bridge: JAX parameter trees and the detector artifact -> tensors,
and float trees of tensors -> numpy trees in the JAX package's layout.

Layouts are kept as the JAX package has them (dense kernels [in, out],
int8 `QuantizedArray(q, scale)` with per-output-channel scales), with one
exception: 4-D convolution kernels named "w" arrive HWIO and are stored
OIHW, the layout `torch.nn.functional.conv2d` takes. For an int8 conv
kernel the scale stays per output channel, now axis 0. `to_numpy` turns
them back, so a pickled numpy tree (a `policy.pkl` checkpoint) written by
either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from .config import DetectorConfig, ExperimentConfig
from .models.quantize import QuantizedArray


class PerceptionParams(NamedTuple):
    detector: dict
    captioner: dict
    sbert: dict


def _tensor(arr: Any, device) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _hwio_to_oihw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(3, 2, 0, 1).contiguous()


def _is_quantized(node: Any) -> bool:
    # the JAX QuantizedArray, the artifact's stand-in, or the port's own
    return getattr(node, "_fields", None) == ("q", "scale")


def from_jax(tree: Any, device="cuda") -> Any:
    """Convert a JAX parameter tree (nested dicts/lists/NamedTuples of
    arrays, with `QuantizedArray` leaves) into the port's tensors on
    `device`. Array leaves may be numpy or anything `np.asarray` takes."""

    def walk(node: Any, name: str) -> Any:
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if _is_quantized(node):
            q = _tensor(node.q, device)
            if name == "w" and q.dim() == 4:
                q = _hwio_to_oihw(q)
            return QuantizedArray(q, _tensor(node.scale, device))
        if hasattr(node, "_fields"):
            fields = node._fields
            vals = [walk(getattr(node, f), "") for f in fields]
            if fields == PerceptionParams._fields:
                return PerceptionParams(*vals)
            return tuple(vals)
        if isinstance(node, (list, tuple)):
            return [walk(v, "") for v in node]
        t = _tensor(node, device)
        if name == "w" and t.dim() == 4:
            t = _hwio_to_oihw(t)
        return t

    return walk(tree, "")


def to_numpy(tree: Any) -> Any:
    """The inverse of `from_jax` for float trees (nested dicts and lists
    of tensors, None kept): numpy arrays, 4-D kernels named "w" back to
    HWIO."""

    def walk(node: Any, name: str) -> Any:
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, "") for v in node]
        t = node.detach()
        if name == "w" and t.dim() == 4:
            t = t.permute(2, 3, 1, 0)
        return t.cpu().contiguous().numpy()

    return walk(tree, "")


def load_pickle(path: str) -> Any:
    """Unpickle a tree of numpy arrays (a JAX package artifact or
    checkpoint) without JAX, refusing every class outside numpy."""
    with open(path, "rb") as fh:
        return _ArtifactUnpickler(fh).load()


class _ArtifactUnpickler(pickle.Unpickler):
    """Resolves only numpy's array reconstruction and the JAX package's
    `QuantizedArray` (mapped to a plain (q, scale) tuple), so the artifact
    loads without JAX and cannot name any other class."""

    def find_class(self, module: str, name: str):
        if (module == "embodied_captioning_tpu.models.quantize"
                and name == "QuantizedArray"):
            return _PickledQuantized
        if module == "numpy" or module.startswith("numpy."):
            # the artifact was pickled under numpy 2 (numpy._core); numpy 1
            # names that module numpy.core
            if module.startswith("numpy._core") and not hasattr(np, "_core"):
                module = "numpy.core" + module[len("numpy._core"):]
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"the pickle names a class outside numpy: {module}.{name}")


class _PickledQuantized(NamedTuple):
    q: Any
    scale: Any


def _struct_from_jax(cls, obj: Any, device):
    """A NamedTuple of arrays -> the port's NamedTuple `cls` of tensors,
    field by field, dtypes kept (bool, int32, float32)."""
    return cls(*(_tensor(getattr(obj, f), device) for f in cls._fields))


def scene_from_jax(scene: Any, device="cuda"):
    """A JAX `Scene` (single or batched), handed over as numpy or JAX
    arrays -> the port's `Scene`."""
    from .envs.sim import Scene

    return _struct_from_jax(Scene, scene, device)


def loop_state_from_jax(state: Any, device="cuda"):
    """A JAX `LoopState` -> the port's."""
    from .envs.device_loop import LoopState

    return _struct_from_jax(LoopState, state, device)


def map_state_from_jax(state: Any, device="cuda"):
    """A JAX `VoxelMapState` (single or [E]-batched) -> the port's."""
    from .mapping.voxel_map import VoxelMapState

    return _struct_from_jax(VoxelMapState, state, device)


def load_detector_artifact(path: str, device="cuda"
                           ) -> Tuple[dict, dict]:
    """Read a serving artifact (`det_serving_256.pkl`): returns (served
    detector params on `device`, serving config as a dict of the port's
    `DetectorConfig` fields). Query-family settings, the compute type
    and the approximate top-k switch are dropped: the port serves the
    rcnn family in bf16 and its proposal top-k is always exact."""
    artifact = load_pickle(path)
    cfg = dict(artifact["serving_cfg"])
    if cfg.get("family", "rcnn") != "rcnn" or cfg.get("stem_s2d", False):
        raise ValueError("the port serves the rcnn family with the direct "
                         "stem only")
    known = {f.name for f in dataclasses.fields(DetectorConfig)} - {
        "approx_topk", "dtype", "num_queries", "query_layers",
        "no_object_weight", "query_aux_topk"}
    cfg = {k: v for k, v in cfg.items() if k in known}
    return from_jax(artifact["served"], device), cfg


def init_perception(generator: torch.Generator, cfg: ExperimentConfig,
                    device="cuda") -> PerceptionParams:
    """Random weights with the shapes and init scales of the JAX `init_*`
    functions, drawn from `generator` (numbers differ from jax.random)."""
    from .models.captioner import init_captioner
    from .models.detector import init_detector
    from .models.sbert import init_sentence_encoder

    return PerceptionParams(
        detector=init_detector(generator, cfg.detector, device),
        captioner=init_captioner(generator, cfg.captioner, device),
        sbert=init_sentence_encoder(generator, cfg.sentence_encoder, device),
    )
