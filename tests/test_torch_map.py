"""The port's geometry, cosine, consensus and voxel-map modules against
the JAX package's, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_captioning_tpu.config import MapConfig as JMapCfg
from embodied_captioning_tpu.config import SensorConfig as JSensorCfg
from embodied_captioning_tpu.config import SimConfig as JSimCfg
from embodied_captioning_tpu.envs import sim as JS
from embodied_captioning_tpu.mapping import consensus as JC
from embodied_captioning_tpu.mapping import voxel_map as JV
from embodied_captioning_tpu.ops import cosine as JCOS
from embodied_captioning_tpu.ops import geometry as JG
from embodied_captioning_tpu_torch import params as P
from embodied_captioning_tpu_torch.config import MapConfig
from embodied_captioning_tpu_torch.mapping import consensus as C
from embodied_captioning_tpu_torch.mapping import voxel_map as V
from embodied_captioning_tpu_torch.ops import cosine as COS
from embodied_captioning_tpu_torch.ops import geometry as G
from torch_parity import t

HFOV = 79.0
SIZE = 64


def _pose(yaw=0.7, pos=(3.0, 0.88, 4.0)):
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    T[:3, 3] = pos
    return T


# ---------------------------------------------------------------------------
# ops/geometry.py
# ---------------------------------------------------------------------------

def test_intrinsics_equal():
    assert G.intrinsics_from_hfov(48, 64, HFOV) == JG.intrinsics_from_hfov(
        48, 64, HFOV)


def test_backproject_depth_matches_jitted_jax():
    # equal bit for bit under jit: the port spells the constant divisions
    # and the K=3 product as XLA compiles them
    rng = np.random.default_rng(0)
    depth = rng.uniform(0.2, 16.0, (48, 64)).astype(np.float32)
    pose = _pose()
    ref_p, ref_v = jax.jit(JG.backproject_depth, static_argnums=(2,))(
        jnp.asarray(depth), jnp.asarray(pose), HFOV)
    pts, valid = G.backproject_depth(t(depth), t(pose), HFOV)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(pts.numpy(), np.asarray(ref_p))
    # a leading env axis gives the per-env result
    pb, vb = G.backproject_depth(t(depth)[None].repeat(2, 1, 1),
                                 torch.stack([t(pose), t(_pose(-2.0))]), HFOV)
    assert torch.equal(pb[0], pts) and torch.equal(vb[0], valid)
    assert not torch.equal(pb[1], pts)


def test_masks_morphology_and_outliers():
    rng = np.random.default_rng(1)
    mask = rng.random((3, 40, 40)) > 0.35
    mask[0, :9, :9] = True                     # touches the border
    depth = rng.uniform(1.0, 3.0, (40, 40)).astype(np.float32)
    for name, k in (("erode_mask", 7), ("erode_mask", 3), ("dilate_mask", 3),
                    ("morph_close", 3)):
        ref = jax.vmap(lambda m: getattr(JG, name)(m, k))(jnp.asarray(mask))
        out = getattr(G, name)(t(mask), k)
        assert out.dtype == torch.bool
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref), name)
    # sums run in another order: the kept set may differ only where a
    # pixel's depth sits on the 1-sigma threshold (none here)
    ref = jax.vmap(lambda m: JG.depth_outlier_mask(jnp.asarray(depth), m))(
        jnp.asarray(mask))
    out = G.depth_outlier_mask(t(depth), t(mask))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    flat = np.ones((40, 40), bool)
    assert G.depth_outlier_mask(torch.full((40, 40), 2.0), t(flat)).all()


def test_projection_and_box_reprojection():
    # f32 products in another order than XLA's: 1e-3 px at ~100 px
    rng = np.random.default_rng(2)
    pts = rng.uniform(-5, 5, (50, 3)).astype(np.float32)
    pose = _pose()
    ref_pix, ref_front = JG.project_points_to_image(
        jnp.asarray(pts), jnp.asarray(pose), 48, 64, HFOV)
    pix, front = G.project_points_to_image(t(pts), t(pose), 48, 64, HFOV)
    np.testing.assert_array_equal(front.numpy(), np.asarray(ref_front))
    np.testing.assert_allclose(pix.numpy(), np.asarray(ref_pix), rtol=1e-4,
                               atol=1e-3)
    depth = rng.uniform(1.5, 4.0, (48, 64)).astype(np.float32)
    box = np.array([10.0, 8.0, 40.0, 30.0], np.float32)
    dst = _pose(0.9, (3.2, 0.88, 4.1))
    ref = JG.reproject_box(jnp.asarray(box), jnp.asarray(depth),
                           jnp.asarray(pose), jnp.asarray(dst), HFOV)
    out = G.reproject_box(t(box), t(depth), t(pose), t(dst), HFOV)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-2)
    none = G.reproject_box(t(box), torch.full((48, 64), 0.1), t(pose), t(dst),
                           HFOV)
    assert (none == 0).all()


# ---------------------------------------------------------------------------
# ops/cosine.py, mapping/consensus.py
# ---------------------------------------------------------------------------

def test_cosine_disagreement_counts():
    # counts 0, 1, 2 and K; f32 sums in another order: 1e-6
    rng = np.random.default_rng(3)
    k = 6
    emb = rng.standard_normal((5, k, 32)).astype(np.float32)
    emb[4, 1] = emb[4, 0]                        # identical views
    count = np.array([0, 1, 2, k, 2], np.int32)
    ref = JCOS.cosine_disagreement(jnp.asarray(emb), jnp.asarray(count))
    out = COS.cosine_disagreement(t(emb), t(count))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    assert out[0] == 0 and out[1] == 0 and out[2] > 0 and abs(out[4]) < 1e-6
    both = COS.cosine_disagreement(t(emb)[None].repeat(2, 1, 1, 1),
                                   t(count)[None].repeat(2, 1))
    assert torch.equal(both[1], out)
    a, b = emb[0], emb[1, :4]
    np.testing.assert_allclose(
        COS.cosine_similarity_matrix(t(a), t(b)).numpy(),
        np.asarray(JCOS.cosine_similarity_matrix(jnp.asarray(a),
                                                 jnp.asarray(b))), atol=1e-6)
    valid = np.array([True, True, False, True, False, False])
    np.testing.assert_allclose(
        COS.mean_pairwise_cosine_distance(t(emb[3]), t(valid)).numpy(),
        np.asarray(JCOS.mean_pairwise_cosine_distance(
            jnp.asarray(emb[3]), jnp.asarray(valid))), atol=1e-6)


@pytest.mark.parametrize("solution", C.SOLUTIONS)
def test_resolve_strategies(solution):
    rng = np.random.default_rng(4)
    rows = rng.standard_normal((7, 6)).astype(np.float32)
    valid = np.array([1, 1, 0, 1, 0, 1, 1], bool)
    ref_c, ref_l = JC.resolve_rows(jnp.asarray(rows), jnp.asarray(valid),
                                   solution)
    cls, logits = C.resolve_rows(t(rows), t(valid), solution)
    assert cls.dtype == torch.int32 and int(cls) == int(ref_c)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_l), rtol=1e-6,
                               atol=1e-6)
    # a grid of voxels, some empty
    stats = C.VoxelStats(t(rng.standard_normal((9, 6)).astype(np.float32)),
                         t(rng.standard_normal((9, 6)).astype(np.float32)),
                         t(rng.uniform(0.1, 3, (9, 6)).astype(np.float32)),
                         t(np.array([0, 1, 2, 0, 3, 1, 1, 0, 5], np.int32)))
    jstats = JC.VoxelStats(*(jnp.asarray(x.numpy()) for x in stats))
    ref_c, ref_l = JC.resolve(jstats, solution)
    cls, logits = C.resolve(stats, solution)
    np.testing.assert_array_equal(cls.numpy(), np.asarray(ref_c))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_l), rtol=1e-6,
                               atol=1e-6)


def test_resolve_rejects_unknown_solution():
    with pytest.raises(ValueError, match="unknown consensus"):
        C.resolve(C.VoxelStats.empty((2,), 6, "cpu"), "median")


# ---------------------------------------------------------------------------
# mapping/voxel_map.py
# ---------------------------------------------------------------------------

def test_voxel_indexing():
    cfg, jcfg = MapConfig.tiny(), JMapCfg.tiny()
    rng = np.random.default_rng(5)
    pts = rng.uniform(-1, 5, (200, 3)).astype(np.float32)
    pts[:8] = np.arange(8)[:, None] * 0.05       # on voxel faces
    lower = np.array([-0.15, -0.15, -0.15], np.float32)
    ref_f, ref_in = jax.jit(JV.world_to_voxel, static_argnums=(2,))(
        jnp.asarray(pts), jnp.asarray(lower), jcfg)
    flat, inb = V.world_to_voxel(t(pts), t(lower), cfg)
    np.testing.assert_array_equal(inb.numpy(), np.asarray(ref_in))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(ref_f))
    np.testing.assert_allclose(
        V.voxel_centers(flat, t(lower), cfg).numpy(),
        np.asarray(JV.voxel_centers(ref_f, jnp.asarray(lower), jcfg)),
        atol=1e-6)


def _frames(n_frames, seed=15):
    """Depth, pose and ground-truth detections from the JAX package's own
    simulator along a short trajectory, with seeded logits and embeddings."""
    sim = JS.RaycastSim(JSimCfg(), JSensorCfg(height=SIZE, width=SIZE),
                        seed=seed)
    rng = np.random.default_rng(seed)
    out = []
    for a in (2, 2, 1, 3, 2, 1)[:n_frames]:
        sim.step(a)
        obs = sim.observe()
        det = JS.gt_detections(obs["instances"], obs["classes"],
                               max_instances=12, min_pixels=20)
        n = det.valid.shape[0]
        out.append(dict(
            depth=np.asarray(obs["depth"]),
            pose=sim.agent.camera_matrix().astype(np.float32),
            masks=np.asarray(det.masks), classes=np.asarray(det.classes),
            logits=rng.standard_normal((n, 6)).astype(np.float32),
            embeddings=rng.standard_normal((n, 16)).astype(np.float32),
            valid=np.asarray(det.valid)))
    return out, np.asarray(sim.scene.lower)


FRAME_KEYS = ("depth", "pose", "masks", "classes", "logits", "embeddings",
              "valid")


def _integrate_both(frames, lower, **cfg_kw):
    kw = dict(grid=(64, 16, 64), voxel_size=0.2, embed_dim=16,
              max_views_per_object=3, **cfg_kw)
    jcfg, cfg = JMapCfg(**kw), MapConfig(**kw)
    jst = JV.create(jcfg, lower)
    st = V.create(cfg, lower, device="cpu")
    for f in frames:
        jst = JV.integrate_frame(jst, *(jnp.asarray(f[k]) for k in FRAME_KEYS),
                                 jcfg, hfov_deg=HFOV)
        st = V.integrate_frame(st, *(t(f[k]) for k in FRAME_KEYS), cfg,
                               hfov_deg=HFOV)
    return jst, st, jcfg, cfg


def _assert_states_match(st, jst):
    """Counts, slots, classes and flags equal; float accumulators within
    1e-5 relative (pixel sums run in another order)."""
    for f in st._fields:
        a, b = getattr(st, f).numpy(), np.asarray(getattr(jst, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if a.dtype == np.float32:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


def test_create_and_bridge():
    cfg, jcfg = MapConfig.tiny(), JMapCfg.tiny()
    lower = np.array([-0.15, -0.15, -0.15], np.float32)
    jst = JV.create(jcfg, lower, episode=3)
    _assert_states_match(V.create(cfg, lower, episode=3, device="cpu"), jst)
    bridged = P.map_state_from_jax(jax.tree_util.tree_map(np.asarray, jst),
                                   "cpu")
    assert isinstance(bridged, V.VoxelMapState)
    _assert_states_match(bridged, jst)
    two = V.create(cfg, np.stack([lower, lower + 1]), device="cpu")
    assert two.count.shape == (2, 64 * 16 * 64) and two.lower.shape == (2, 3)
    assert two.num_objects.tolist() == [0, 0]


@pytest.mark.parametrize("solution", ["max", "bayesian"])
def test_integrate_frame_and_readouts_match_jax(solution):
    frames, lower = _frames(5)
    jst, st, jcfg, cfg = _integrate_both(frames, lower, solution=solution)
    assert int(st.num_objects) >= 2 and int(st.obj_emb_cnt.max()) > 3
    _assert_states_match(st, jst)
    ref_maps = JV.topdown_maps(jst, jcfg)
    maps = V.topdown_maps(st, cfg)
    assert maps.shape == (64, 64, 4)
    for c, name in enumerate(("obstacle", "explored", "semantic")):
        np.testing.assert_array_equal(maps[..., c].numpy(),
                                      np.asarray(ref_maps[..., c]), name)
    np.testing.assert_allclose(maps[..., 3].numpy(),
                               np.asarray(ref_maps[..., 3]), atol=1e-6)
    ref_r = float(JV.disagreement_reward(jst, jcfg))
    assert ref_r > 1e-3
    np.testing.assert_allclose(float(V.disagreement_reward(st, cfg)), ref_r,
                               rtol=1e-4)
    np.testing.assert_allclose(
        V.object_disagreement(st, cfg).numpy(),
        np.asarray(JV.object_disagreement(jst, jcfg)), atol=1e-6)
    ref_c, ref_l = JV.resolve_map(jst, jcfg)
    cls, logits = V.resolve_map(st, cfg)
    np.testing.assert_array_equal(cls.numpy(), np.asarray(ref_c))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_l), rtol=1e-5,
                               atol=1e-5)


def test_integrate_frame_full_object_table_drops_detections():
    # two slots only: later detections find no match and no free slot, get
    # slot -1, and must leave the last slot and the grids alone
    frames, lower = _frames(4)
    jst, st, _, _ = _integrate_both(frames, lower, max_objects=2)
    assert bool(st.obj_active.all())
    dropped = sum(int(f["valid"].sum()) for f in frames) - int(
        st.obj_logit_cnt.sum())
    assert dropped > 0
    _assert_states_match(st, jst)


def test_integrate_frame_batched_equals_per_env():
    # a leading env axis (the port's form of vmap) changes nothing
    fa, lower_a = _frames(3, seed=15)
    fb, lower_b = _frames(3, seed=13)
    kw = dict(grid=(64, 16, 64), voxel_size=0.2, embed_dim=16,
              max_views_per_object=3)
    cfg = MapConfig(**kw)
    both = V.create(cfg, np.stack([lower_a, lower_b]), device="cpu")
    singles = [V.create(cfg, lo, device="cpu") for lo in (lower_a, lower_b)]
    for a, b in zip(fa, fb):
        both = V.integrate_frame(
            both, *(torch.stack([t(a[k]), t(b[k])]) for k in FRAME_KEYS),
            cfg, hfov_deg=HFOV)
        for s, f in zip(singles, (a, b)):
            V.integrate_frame(s, *(t(f[k]) for k in FRAME_KEYS), cfg,
                              hfov_deg=HFOV)      # in place
    for i, s in enumerate(singles):
        for f in s._fields:
            assert torch.equal(getattr(both, f)[i], getattr(s, f)), (i, f)
    r = V.disagreement_reward(both, cfg)
    assert r.shape == (2,)
    for i, s in enumerate(singles):
        assert torch.equal(r[i], V.disagreement_reward(s, cfg))
    assert V.topdown_maps(both, cfg).shape == (2, 64, 64, 4)
