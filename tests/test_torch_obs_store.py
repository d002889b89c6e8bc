"""The port's observation store (utils/obs_store.py), Sense classes and
geometry helpers (sensor_data.py) and the Detections payload
(ops/detections.py) against the JAX package's: the same payload gives the
same file names, each package's `SampleLoader` reads the other's files
with equal values, and the Sense classes, `rotmat_to_quat`, `Intrinsics`
and `Pose` agree (exactly, or to 1e-12 in float64)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_captioning_tpu import sensor_data as JSD
from embodied_captioning_tpu.ops.detections import Detections as JDet
from embodied_captioning_tpu.utils import obs_store as JOS
from embodied_captioning_tpu_torch import sensor_data as SD
from embodied_captioning_tpu_torch.ops.detections import Detections
from embodied_captioning_tpu_torch.utils import obs_store as OS
from torch_parity import np32


def _payload(rng, n=4):
    det = {"boxes": rng.uniform(0, 60, (n, 4)).astype(np.float32),
           "classes": rng.integers(0, 6, n).astype(np.int32),
           "scores": rng.uniform(0, 1, n).astype(np.float32),
           "logits": rng.uniform(0, 1, (n, 6)).astype(np.float32),
           "valid": rng.uniform(0, 1, n) > 0.4,
           "masks": (rng.uniform(0, 1, (n, 8, 8)) > 0.5).astype(np.float32),
           "object_ids": np.arange(n, dtype=np.int64),
           "captions": np.array([f"a couch {i}" for i in range(n)],
                                dtype=object)}
    pose = {"position": rng.uniform(0, 8, 3),
            "orientation": JSD.quat_from_yaw(rng.uniform(0, 6))}
    return {"rgb": rng.integers(0, 256, (16, 16, 3), dtype=np.uint8),
            "depth": rng.uniform(0.5, 15, (16, 16)).astype(np.float32),
            "position": np.array(pose, dtype=object),
            "bbs": np.array({"instances": det}, dtype=object)}


def _write(store, root, rng):
    paths = []
    for ep, step in ((3, 0), (3, 1), (3, 1), (100001, 0)):
        paths += store.save_obs(os.path.join(root, f"env{ep // 100000}"), ep,
                                _payload(rng), step)
    return paths


def test_file_names_equal(tmp_path):
    ours = _write(OS, str(tmp_path / "t"), np.random.default_rng(0))
    ref = _write(JOS, str(tmp_path / "j"), np.random.default_rng(0))
    rel = [os.path.relpath(p, str(tmp_path / "t")) for p in ours]
    assert rel == [os.path.relpath(p, str(tmp_path / "j")) for p in ref]
    assert len(rel) == 16 and OS.FILENAME_RE.pattern == JOS.FILENAME_RE.pattern
    info, jinfo = OS.get_sense_info(ours[5]), JOS.get_sense_info(ref[5])
    assert (info.mod, info.episode, info.step, info.camera_id) == (
        jinfo.mod, jinfo.episode, jinfo.step, jinfo.camera_id) == (
        "depth", 3, 1, 1)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_loader_reads_the_others_files(tmp_path, writer):
    store = OS if writer == "port" else JOS
    _write(store, str(tmp_path), np.random.default_rng(1))
    ours, ref = OS.SampleLoader(str(tmp_path)), JOS.SampleLoader(
        str(tmp_path))
    assert ours.episodes == ref.episodes == [3, 100001]
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours.get_episode_and_steps_dense_list(),
                    ref.get_episode_and_steps_dense_list()):
        np.testing.assert_array_equal(a, b)
    mods = ["rgb", "depth", "position", "bbs"]
    got = list(ours.iter_steps(3, modalities=mods))
    want = list(ref.iter_steps(3, modalities=mods))
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 1]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a["rgb"].data, b["rgb"].data)
        assert a["depth"].data.dtype == np.float32
        np.testing.assert_array_equal(a["depth"].data, b["depth"].data)
        # AgentPoseSense loads as the camera pose
        np.testing.assert_array_equal(a["position"].data.position,
                                      b["position"].data.position)
        assert a["position"].data.reference == "cam"
        for k, v in b["bbs"].data.items():
            np.testing.assert_array_equal(a["bbs"].data[k], v, err_msg=k)
        assert a["rgb"].name == b["rgb"].name


def test_mask_more_n_equal():
    arr = np.array([1, 1, 1, 2, 2, 3, 1, 1])
    for n in (1, 2, 3):
        np.testing.assert_array_equal(OS.mask_more_n(arr, n),
                                      JOS.mask_more_n(arr, n))
    assert OS.mask_more_n(np.zeros(0), 1).shape == (0,)


def test_rotations_intrinsics_and_poses_equal():
    rng = np.random.default_rng(2)
    for _ in range(50):
        q = rng.normal(size=4)
        R = JSD.quat_to_rotmat(q)
        np.testing.assert_array_equal(SD.quat_to_rotmat(q), R)
        np.testing.assert_array_equal(SD.rotmat_to_quat(R),
                                      JSD.rotmat_to_quat(R))
        # the round trip returns the rotation
        np.testing.assert_allclose(SD.quat_to_rotmat(SD.rotmat_to_quat(R)),
                                   R, atol=1e-12)
    for w, h, fov in ((64, 64, 79.0), (1280, 720, 90.0)):
        a, b = SD.Intrinsics.from_hfov(w, h, fov), JSD.Intrinsics.from_hfov(
            w, h, fov)
        np.testing.assert_array_equal(a.matrix(), b.matrix())
    pose = {"position": np.array([1.0, 0.0, 2.0]),
            "orientation": JSD.quat_from_yaw(0.7)}
    p, jp = SD.Pose.from_any(pose), JSD.Pose.from_any(pose)
    np.testing.assert_array_equal(p.camera_pose().matrix(),
                                  jp.camera_pose().matrix())
    np.testing.assert_allclose(SD.Pose.from_any(p.matrix()).matrix(),
                               p.matrix(), atol=1e-12)
    np.testing.assert_array_equal(p.transformation_to(SD.Pose.from_any(
        np.eye(4))), jp.transformation_to(JSD.Pose.from_any(np.eye(4))))
    assert set(SD.MODALITY_REGISTRY) == set(JSD.MODALITY_REGISTRY)
    for code in SD.MODALITY_REGISTRY:
        assert (SD.get_class_from_modality_code(code).__name__
                == JSD.get_class_from_modality_code(code).__name__)
    assert SD.BBSense.REMAP == JSD.BBSense.REMAP


def test_detections_payload_round_trip():
    """to_numpy_dict / from_numpy_dict against the JAX container's: bf16
    boxes widen to float32 (numpy has none) with equal values; a JAX
    payload's bfloat16 boxes come back as bf16; index and count equal."""
    rng = np.random.default_rng(3)
    d = _payload(rng, 5)["bbs"].item()["instances"]
    ref = JDet.from_numpy_dict(d)
    out = Detections.from_numpy_dict(d, device="cpu")
    for k, v in ref.to_numpy_dict().items():
        np.testing.assert_array_equal(out.to_numpy_dict()[k], v, err_msg=k)
    assert int(out.count()) == int(ref.count())
    for f in ("boxes", "valid", "masks", "object_ids"):
        np.testing.assert_array_equal(np32(getattr(out.index(2), f)),
                                      np32(getattr(ref.index(2), f)))
    jb = ref.replace(boxes=ref.boxes.astype(jnp.bfloat16)).to_numpy_dict()
    back = Detections.from_numpy_dict(jb, device="cpu")
    assert back.boxes.dtype == torch.bfloat16
    np.testing.assert_array_equal(back.to_numpy_dict()["boxes"],
                                  np32(jb["boxes"]))
    e, je = Detections.empty(3, mask_size=4, embed_dim=2, device="cpu"), \
        JDet.empty(3, mask_size=4, embed_dim=2)
    for k, v in je.to_numpy_dict().items():
        a = e.to_numpy_dict()[k]
        assert a.dtype == v.dtype and a.shape == v.shape, k
        np.testing.assert_array_equal(a, v)
