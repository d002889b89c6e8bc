"""The port's native host library (native/ccl3d.cpp, built by
mapping/components.py), its planner (agents/planner.py) and id matching
(mapping/matching.py) against the JAX package's. Native outputs equal the
JAX package's native outputs exactly; native against the Python versions:
the same components (labels up to renumbering) and A* paths of equal cost
(equal-cost paths may differ in which cells they take)."""

import math
from pathlib import Path

import numpy as np
import pytest

from embodied_captioning_tpu.agents import planner as JP
from embodied_captioning_tpu.mapping import components as JC
from embodied_captioning_tpu.mapping import matching as JM
from embodied_captioning_tpu.ops.detections import Detections as JDet
from embodied_captioning_tpu_torch.agents import planner as P
from embodied_captioning_tpu_torch.mapping import components as C
from embodied_captioning_tpu_torch.mapping import matching as M
from embodied_captioning_tpu_torch.ops.detections import Detections

PORT = Path(C.__file__).resolve().parents[1]


def test_native_library_is_the_ports_own_build():
    lib = C.native_library()
    path = Path(lib._name).resolve()
    assert path.is_relative_to(PORT / "native" / "build"), path
    assert path.name == "libecap_port_native.so"
    assert C._load_native() is lib
    # the same path on a second call: the build is keyed and reused
    assert C.build_native() == path


def _grids():
    rng = np.random.default_rng(0)
    yield (rng.uniform(0, 1, (12, 6, 12)) < 0.3) * rng.integers(
        1, 4, (12, 6, 12))
    g = np.zeros((8, 8, 8), np.int32)
    g[1:3, 1:3, 1:3] = 1
    g[5:7, 5:7, 5:7] = 1
    g[1:3, 5:7, 1:3] = 2
    g[3, 3, 3] = 1  # touches the first block diagonally
    yield g
    yield np.zeros((3, 4, 5), np.int32)


def _same_partition(a, b):
    pairs = set(zip(a.ravel().tolist(), b.ravel().tolist()))
    return (len(pairs) == len({p[0] for p in pairs})
            == len({p[1] for p in pairs}))


@pytest.mark.parametrize("case", range(3))
def test_connected_components_native_scipy_and_jax(case):
    grid = list(_grids())[case]
    comps, n = C.connected_components_26(grid)
    ref, n_ref = JC.connected_components_26(grid)
    np.testing.assert_array_equal(comps, ref)
    assert comps.dtype == ref.dtype and n == n_ref
    sp, n_sp = C._scipy_cc(np.asarray(grid, np.int32))
    np.testing.assert_array_equal(sp, JC._scipy_cc(np.asarray(grid,
                                                              np.int32))[0])
    assert n_sp == n and _same_partition(comps, sp)
    assert ((comps > 0) == (grid > 0)).all()


def test_connected_components_fall_back_to_scipy(monkeypatch):
    grid = list(_grids())[1]
    monkeypatch.setattr(C, "_load_native", lambda: None)
    comps, n = C.connected_components_26(grid)
    np.testing.assert_array_equal(comps, C._scipy_cc(grid)[0])
    assert n == 3


def test_resegment_objects_equal():
    grid = list(_grids())[0]
    rng = np.random.default_rng(1)
    vox_obj = np.where(grid > 0, rng.integers(-1, 9, grid.shape), -1)
    for a, b in zip(C.resegment_objects(grid, vox_obj),
                    JC.resegment_objects(grid, vox_obj)):
        np.testing.assert_array_equal(a, b)


def _cost(path):
    return sum(math.hypot(a[0] - b[0], a[1] - b[1])
               for a, b in zip(path, path[1:]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_astar_native_python_and_jax(seed):
    rng = np.random.default_rng(seed)
    grid = (rng.uniform(0, 1, (40, 40)) > 0.25).astype(np.uint8)
    grid[18:30, 20] = 0
    start, goal = (2, 3), (37, 35)
    path = P.astar(grid, start, goal)
    assert path == JP.astar(grid, start, goal)
    py = P._astar_py(grid, P._snap_free(grid, start),
                     P._snap_free(grid, goal))
    assert py == JP._astar_py(grid, JP._snap_free(grid, start),
                              JP._snap_free(grid, goal))
    assert path and py and path[0] == py[0] and path[-1] == py[-1]
    assert abs(_cost(path) - _cost(py)) < 1e-3
    assert all(grid[r, c] for r, c in path)
    assert P.skeleton_waypoints(grid, start, goal, every=6) == \
        JP.skeleton_waypoints(grid, start, goal, every=6)


def test_astar_unreachable_and_snapped():
    grid = np.ones((8, 8), np.uint8)
    grid[:, 4] = 0
    assert P.astar(grid, (2, 1), (2, 7)) == JP.astar(grid, (2, 1),
                                                      (2, 7)) == []
    grid = np.ones((8, 8), np.uint8)
    grid[3, 3] = 0  # a start on a wall cell snaps to the nearest free cell
    assert P.astar(grid, (3, 3), (7, 7)) == JP.astar(grid, (3, 3), (7, 7))


def _dets(rng, n=6, boxes_dtype=np.float32):
    xy = rng.uniform(0, 40, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 20, (n, 2))], 1)
    return dict(boxes=boxes.astype(boxes_dtype),
                classes=rng.integers(0, 6, n).astype(np.int32),
                scores=rng.uniform(0, 1, n).astype(np.float32),
                logits=rng.uniform(0, 1, (n, 6)).astype(np.float32),
                valid=rng.uniform(0, 1, n) > 0.3,
                object_ids=rng.integers(0, 50, n).astype(np.int32))


def test_unique_ids_and_iou_matching_equal():
    rng = np.random.default_rng(4)
    for _ in range(5):
        pred, gt = _dets(rng), _dets(rng)
        gt["boxes"][:3] = pred["boxes"][:3] + rng.uniform(-2, 2, (3, 4))
        tp, tg = (Detections.from_numpy_dict(d, "cpu") for d in (pred, gt))
        jp, jg = JDet.from_numpy_dict(pred), JDet.from_numpy_dict(gt)
        a, ja = M.IdAllocator(), JM.IdAllocator()
        for x, y in zip(M.match_ids_iou(tp, tg, a, episode=7),
                        JM.match_ids_iou(jp, jg, ja, episode=7)):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(M.match_ids_iou(tp, tg), JM.match_ids_iou(jp, jg)):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(M.unique_ids(tp, a, 3), JM.unique_ids(jp, ja, 3)):
            np.testing.assert_array_equal(x, y)
        assert a.next_id == ja.next_id


def test_clustering_labels_equal():
    rng = np.random.default_rng(5)
    cents = np.concatenate([rng.normal(0, 0.3, (6, 3)),
                            rng.normal(5, 0.3, (6, 3))])
    infos = rng.uniform(0, 1, 12)
    covs = rng.uniform(0, 0.1, (12, 3, 3))
    for thr in (0.5, 2.0, 4.0):
        for inf in (None, infos):
            np.testing.assert_array_equal(
                M.get_centroids_labels_dbscan(cents, inf, thr),
                JM.get_centroids_labels_dbscan(cents, inf, thr))
            np.testing.assert_array_equal(
                M.get_centroids_labels_grid(cents, inf, thr),
                JM.get_centroids_labels_grid(cents, inf, thr))
        np.testing.assert_array_equal(
            M.get_wasserstein_labels(cents, covs, thr),
            JM.get_wasserstein_labels(cents, covs, thr))
    dist = np.abs(np.subtract.outer(np.arange(8.0), np.arange(8.0)))
    np.testing.assert_array_equal(M._dbscan(dist, 1.0, 3),
                                  JM._dbscan(dist, 1.0, 3))
