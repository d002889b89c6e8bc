"""The port's pseudo-labeling slice against the JAX package's, on the CPU
at tiny sizes: the map's raytrace (`voxel_map.raytrace_pseudo_labels`),
the detector's inference variants (`flip_detections`, `forward_tta`,
`forward_mc`), the seven consensus labelers of
`labeling/pseudolabeler.py` on handed frames and weights, their label
files in both packages, and the `run_pseudolabeler` entry point beside
`scripts/run_pseudolabeler.py`.
"""

import contextlib
import copy
import dataclasses
import io
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_captioning_tpu.config import DetectorConfig as JDetCfg
from embodied_captioning_tpu.config import MapConfig as JMapCfg
from embodied_captioning_tpu.config import SensorConfig as JSensorCfg
from embodied_captioning_tpu.config import SimConfig as JSimCfg
from embodied_captioning_tpu.envs import sim as JS
from embodied_captioning_tpu.labeling import datasets as JDS
from embodied_captioning_tpu.labeling import pseudolabeler as JPL
from embodied_captioning_tpu.mapping import voxel_map as JV
from embodied_captioning_tpu.models import detector as JD
from embodied_captioning_tpu.ops.detections import Detections as JDet
from embodied_captioning_tpu.ops.detections import pairwise_iou as jiou
from embodied_captioning_tpu_torch import params as P
from embodied_captioning_tpu_torch import run_pseudolabeler
from embodied_captioning_tpu_torch.config import NUM_CLASSES
from embodied_captioning_tpu_torch.config import DetectorConfig as TDetCfg
from embodied_captioning_tpu_torch.config import MapConfig, load_config
from embodied_captioning_tpu_torch.labeling import datasets as TDS
from embodied_captioning_tpu_torch.labeling import pseudolabeler as TPL
from embodied_captioning_tpu_torch.mapping import voxel_map as V
from embodied_captioning_tpu_torch.models import detector as TD
from embodied_captioning_tpu_torch.ops.detections import Detections as TDet
from embodied_captioning_tpu_torch.perception import Perceiver
from embodied_captioning_tpu_torch.sensor_data import Pose, quat_from_yaw
from torch_parity import STORE_OVERRIDES, jax_kernel_path, jax_store, np32, t

HFOV = 79.0
SIZE = 64
REPO = Path(__file__).resolve().parents[1]
BATCH = 4
HOST_CONSENSUS = ("vanilla", "logits", "soft", "majority", "max_score")
SAMPLE_FIELDS = ("boxes", "classes", "logits", "masks", "valid", "scores",
                 "object_ids", "embeddings")


# ---------------------------------------------------------------------------
# voxel_map.raytrace_pseudo_labels
# ---------------------------------------------------------------------------

FRAME_KEYS = ("depth", "pose", "masks", "classes", "logits", "embeddings",
              "valid")


def _sim_frames(n_frames: int, seed: int):
    """Depth, pose and ground-truth detections from the JAX package's
    simulator along a short walk, with seeded logits and embeddings."""
    sim = JS.RaycastSim(JSimCfg(), JSensorCfg(height=SIZE, width=SIZE),
                        seed=seed)
    rng = np.random.default_rng(seed)
    out = []
    for a in (2, 2, 1, 3, 2, 1, 2, 3)[:n_frames]:
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


@pytest.fixture(scope="module", params=["max", "bayesian"])
def integrated(request):
    """A map the JAX package integrates from six frames, bridged to the
    port, and the port's own map integrated from the same frames."""
    frames, lower = _sim_frames(6, seed=15)
    kw = dict(grid=(64, 16, 64), voxel_size=0.2, embed_dim=16,
              max_views_per_object=3, solution=request.param)
    jcfg, cfg = JMapCfg(**kw), MapConfig(**kw)
    jst = JV.create(jcfg, lower)
    st = V.create(cfg, lower, device="cpu")
    for f in frames:
        jst = JV.integrate_frame(jst, *(jnp.asarray(f[k]) for k in FRAME_KEYS),
                                 jcfg, hfov_deg=HFOV)
        st = V.integrate_frame(st, *(t(f[k]) for k in FRAME_KEYS), cfg,
                               hfov_deg=HFOV)
    bridged = P.map_state_from_jax(jax.tree_util.tree_map(np.asarray, jst),
                                   "cpu")
    return dict(frames=frames, jst=jst, st=st, bridged=bridged, jcfg=jcfg,
                cfg=cfg)


@pytest.mark.parametrize("max_out,min_pixels", [(4, 20), (12, 1), (40, 60)])
def test_raytrace_matches_jax(integrated, max_out, min_pixels):
    """On the bridged map and on the port's own: masks, slots, classes and
    validity equal (ties in pixel count, such as the ineligible slots'
    -1, go to the lower slot in both: a stable sort); logits within 1e-6
    (the ring buffer's sums over K <= 3 rows)."""
    g = integrated
    checked = 0
    for f in g["frames"]:
        want = JV.raytrace_pseudo_labels(
            g["jst"], jnp.asarray(f["depth"]), jnp.asarray(f["pose"]),
            g["jcfg"], hfov_deg=HFOV, max_objects_out=max_out,
            min_pixels=min_pixels)
        for st in (g["bridged"], g["st"]):
            got = V.raytrace_pseudo_labels(
                st, t(f["depth"]), t(f["pose"]), g["cfg"], hfov_deg=HFOV,
                max_objects_out=max_out, min_pixels=min_pixels)
            for name, a, b in zip(("masks", "slots", "classes", "logits",
                                   "valid"), got, want):
                b = np.asarray(b)
                assert a.numpy().dtype == b.dtype and a.shape == b.shape, name
                if name == "logits":
                    np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                               atol=1e-6)
                else:
                    np.testing.assert_array_equal(a.numpy(), b, name)
        checked += int(np.asarray(want[4]).sum())
    assert checked > 0


# ---------------------------------------------------------------------------
# detector.flip_detections, forward_tta, forward_mc
# ---------------------------------------------------------------------------

TTA_OVER = dict(score_threshold=0.01)


def _tta_frames(rng, size: int, n: int = 2) -> np.ndarray:
    """tests/test_tta.py's frames: noise with two solid blocks."""
    img = rng.integers(0, 255, (n, size, size, 3)).astype(np.uint8)
    img[:, 10:30, 8:24] = (200, 40, 40)
    img[:, 34:54, 40:60] = (40, 200, 40)
    return img


def test_flip_detections_involution_and_math():
    """tests/test_tta.py's case, and bf16 boxes as the JAX package rounds
    them (x -> size - x in bf16)."""
    size = 64.0
    masks = np.arange(2 * 4 * 4, dtype=np.float32).reshape(1, 2, 4, 4)
    det = TDet(boxes=torch.tensor([[[4.0, 6.0, 20.0, 30.0],
                                    [0.0, 0.0, 0.0, 0.0]]]),
               classes=torch.tensor([[2, 0]], dtype=torch.int32),
               scores=torch.tensor([[0.9, 0.0]]), logits=torch.zeros(1, 2, 6),
               valid=torch.tensor([[True, False]]),
               masks=torch.from_numpy(masks))
    f = TD.flip_detections(det, size)
    np.testing.assert_allclose(f.boxes[0, 0].numpy(),
                               [size - 20.0, 6.0, size - 4.0, 30.0])
    np.testing.assert_array_equal(f.boxes[0, 1].numpy(), 0.0)
    np.testing.assert_array_equal(f.masks.numpy(), masks[..., ::-1])
    ff = TD.flip_detections(f, size)
    np.testing.assert_allclose(ff.boxes[0, 0].numpy(), det.boxes[0, 0].numpy(),
                               atol=1e-5)
    np.testing.assert_array_equal(ff.masks.numpy(), masks)
    rng = np.random.default_rng(3)
    b = rng.uniform(0, 64, (2, 5, 4)).astype(np.float32)
    valid = rng.random((2, 5)) < 0.7
    jb = jnp.asarray(b, jnp.bfloat16)
    want = JD.flip_detections(JDet(boxes=jb, classes=jnp.zeros((2, 5), int),
                                   scores=jnp.zeros((2, 5)),
                                   logits=jnp.zeros((2, 5, 6)),
                                   valid=jnp.asarray(valid)), 64.0)
    got = TD.flip_detections(TDet(boxes=t(jb), classes=torch.zeros(2, 5),
                                  scores=torch.zeros(2, 5),
                                  logits=torch.zeros(2, 5, 6),
                                  valid=torch.from_numpy(valid)), 64.0)
    assert got.boxes.dtype == torch.bfloat16 and got.masks is None
    np.testing.assert_array_equal(np32(got.boxes), np32(want.boxes))


@pytest.fixture(scope="module")
def tta_pair():
    jc = dataclasses.replace(JDetCfg.tiny(), **TTA_OVER)
    tc = dataclasses.replace(TDetCfg.tiny(), **TTA_OVER)
    p = JD.init_detector(jax.random.PRNGKey(0), jc)
    imgs = _tta_frames(np.random.default_rng(0), jc.image_size)
    return dict(jc=jc, tc=tc, p=p, tp=P.from_jax(p, "cpu"), imgs=imgs,
                want=JD.forward_tta(p, jnp.asarray(imgs), jc),
                got=TD.forward_tta(P.from_jax(p, "cpu"),
                                   torch.from_numpy(imgs), tc))


def test_forward_tta_matches_jax(tta_pair):
    """Within the detector's parity limits (test_torch_detector.py): equal
    validity and classes, boxes within one bf16 ulp at 64 px, scores and
    logits within 5e-3, masks within 2 bf16 ulps at 1."""
    want, got = tta_pair["want"], tta_pair["got"]
    assert np32(want.valid).sum() >= 3
    np.testing.assert_array_equal(np32(got.valid), np32(want.valid))
    np.testing.assert_array_equal(np32(got.classes), np32(want.classes))
    assert got.boxes.dtype == torch.bfloat16
    np.testing.assert_allclose(np32(got.boxes), np32(want.boxes), atol=0.25,
                               rtol=0)
    for f, atol in (("scores", 5e-3), ("logits", 5e-3), ("masks", 2e-2)):
        np.testing.assert_allclose(np32(getattr(got, f)),
                                   np32(getattr(want, f)), atol=atol,
                                   rtol=0, err_msg=f)


def test_forward_tta_contract_and_flip_equivariance(tta_pair):
    """tests/test_tta.py's contract on the port: shapes, boxes in the
    frame, score order, and flip equivariance (the merged candidate set of
    the mirrored frame is the mirror of the original's) to bf16
    resolution."""
    tc, tp, imgs = tta_pair["tc"], tta_pair["tp"], tta_pair["imgs"]
    det = tta_pair["got"]
    n = tc.max_detections
    assert det.boxes.shape == (2, n, 4)
    assert det.masks.shape == (2, n, tc.mask_size, tc.mask_size)
    bx = np32(det.boxes)
    assert bx.min() >= 0 and bx.max() <= tc.image_size
    v, sc = np32(det.valid), np32(det.scores)
    for b in range(2):
        assert (np.diff(sc[b][v[b]]) <= 1e-6).all()
    det_m = TD.forward_tta(tp, torch.from_numpy(imgs[:, :, ::-1].copy()), tc)
    back = TD.flip_detections(det_m, float(tc.image_size))
    np.testing.assert_array_equal(np32(det.valid), np32(back.valid))
    np.testing.assert_allclose(np32(back.boxes), bx, atol=0.5, rtol=0)
    np.testing.assert_array_equal(np32(det.classes), np32(back.classes))


def test_forward_tta_refuses_the_query_family(tta_pair):
    """The query family (ported since): `forward_tta` takes it, as the JAX
    package's does (the flip merge of the query forward on the frames and
    their mirror); `forward_mc` refuses it with the JAX package's
    message."""
    qc = dataclasses.replace(tta_pair["tc"], family="query")
    qp = TD.init_detector(torch.Generator().manual_seed(0), qc, "cpu")
    imgs = torch.from_numpy(tta_pair["imgs"])
    got = TD.forward_tta(qp, imgs, qc)
    want = TD.merge_flipped(TD.forward(qp, imgs, qc),
                            TD.forward(qp, torch.flip(imgs, dims=[2]), qc),
                            qc)
    for f in ("boxes", "classes", "scores", "logits", "valid", "masks"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    with pytest.raises(ValueError, match="rcnn family"):
        TD.forward_mc(qp, imgs, qc)


def _jax_mc_masks(key, samples: int, batch: int, proposals: int,
                  rate: float) -> np.ndarray:
    """The keep masks forward_mc draws: a key per sample, a key per image
    of it, bernoulli(1 - rate) over [P, 1024]."""
    return np.stack([np.stack([
        np.asarray(jax.random.bernoulli(k, 1 - rate, (proposals, 1024)))
        for k in jax.random.split(ks, batch)])
        for ks in jax.random.split(key, samples)])


def test_forward_mc_on_handed_masks_matches_jax(tta_pair):
    """The JAX package's own dropout draws handed across: equal validity,
    and equal proposals where valid (invalid ones are degenerate boxes
    that tie in NMS); on the valid rows, mean and standard deviation (a
    population deviation) within 3e-3: the box
    head's bf16 outputs sit a bf16 ulp apart on some units, as in
    test_torch_detector_train.py's dropout case, and the 1 / (1 - rate)
    scale doubles them (measured 1.2e-3 and 4.5e-4)."""
    jc, p, tp, imgs = (tta_pair["jc"], tta_pair["p"], tta_pair["tp"],
                       tta_pair["imgs"])
    # the JAX function takes its default rate (a rate passed in is traced)
    key, samples, rate = jax.random.PRNGKey(5), 3, 0.5
    props, pvalid, mean, std = JD.forward_mc(p, jnp.asarray(imgs), key, jc,
                                             samples=samples)
    keep = _jax_mc_masks(key, samples, imgs.shape[0], jc.num_proposals, rate)
    got = TD.forward_mc(tp, torch.from_numpy(imgs), tta_pair["tc"], samples,
                        rate, dropout_keep=torch.from_numpy(keep))
    v = np32(pvalid)
    np.testing.assert_array_equal(np32(got[1]), v)
    assert v.sum() >= 4
    np.testing.assert_array_equal(np32(got[0])[v], np32(props)[v])
    np.testing.assert_allclose(np32(got[2])[v], np32(mean)[v], atol=3e-3,
                               rtol=0)
    np.testing.assert_allclose(np32(got[3])[v], np32(std)[v], atol=3e-3,
                               rtol=0)
    assert float(np32(std).max()) > 1e-2
    # the population deviation of the samples the port drew itself
    g = torch.Generator().manual_seed(1)
    own = TD.forward_mc(tp, torch.from_numpy(imgs), tta_pair["tc"], 4, rate,
                        generator=g)
    again = TD.forward_mc(tp, torch.from_numpy(imgs), tta_pair["tc"], 4,
                          rate, generator=torch.Generator().manual_seed(1))
    assert torch.equal(own[2], again[2]) and torch.equal(own[3], again[3])
    np.testing.assert_allclose(own[2].sum(-1).numpy(), 1.0, atol=1e-5)


# ---------------------------------------------------------------------------
# labeling/pseudolabeler.py: the seven consensus labelers
# ---------------------------------------------------------------------------


def _port_sample(s):
    """A JAX package's Sample as the port's (bf16 fields widened)."""
    kw = {f.name: getattr(s, f.name) for f in dataclasses.fields(s)}
    for k, v in kw.items():
        if isinstance(v, np.ndarray):
            kw[k] = (v.astype(np.float32) if v.dtype.name == "bfloat16"
                     else v.copy())
    return TDS.Sample(**kw)


@pytest.fixture(scope="module")
def labeled(tmp_path_factory):
    """A store of the JAX package's loop (8 frames), its perceiver's seeded
    weights handed to the port, and both packages' predictions through the
    semantic-map captioner (the base `predict` plus the captions)."""
    root = tmp_path_factory.mktemp("pseudolabel")
    store = str(root / "obs")
    jcfg = jax_store(store)
    cfg = load_config("tiny", overrides=STORE_OVERRIDES)
    jl = JPL.SemanticMapConsensusCaptioner(jcfg)
    jds = JDS.EpisodeDetectionDataset(store, with_depth_pose=True)
    with jax_kernel_path(blocks=True):
        jpreds = jl.predict(jds, BATCH)
    tper = Perceiver(cfg, params=P.from_jax(jl.perceiver.params, "cpu"),
                     device="cpu")
    tl = TPL.SemanticMapConsensusCaptioner(cfg, perceiver=tper)
    tpreds = tl.predict(TDS.EpisodeDetectionDataset(store,
                                                    with_depth_pose=True),
                        BATCH)
    return dict(root=root, store=store, jcfg=jcfg, cfg=cfg, jl=jl, tl=tl,
                jpreds=jpreds, tpreds=tpreds, tper=tper)


def _agree(a, b) -> bool:
    """A frame's detections agree: validity, classes and boxes equal."""
    return (np.array_equal(a.valid, b.valid)
            and np.array_equal(a.classes, b.classes)
            and np.array_equal(np.asarray(a.boxes, np.float32),
                               np.asarray(b.boxes, np.float32)))


def test_predict_matches_jax(labeled):
    """On the JAX package's frames and weights: every frame's fields have
    the JAX dtypes (bf16 boxes widened); where a frame's detections agree
    (validity, classes, boxes) its ids, scores and masks do too (ids equal,
    scores and logits within 5e-3, masks within 2 bf16 ulps at 1, as
    test_torch_detector.py holds `forward`); captions equal on at least
    half of the valid slots (greedy decoding of random weights flips at
    near-ties, ROADMAP C.8)."""
    jp, tp = labeled["jpreds"], labeled["tpreds"]
    assert len(jp) == len(tp) == 8
    agree = [i for i, (a, b) in enumerate(zip(tp, jp)) if _agree(a, b)]
    assert len(agree) >= 6 and sum(int(jp[i].valid.sum()) for i in agree) > 8
    for i in agree:
        a, b = tp[i], jp[i]
        for f in SAMPLE_FIELDS:
            x, y = getattr(a, f), np.asarray(getattr(b, f))
            want = np.float32 if y.dtype.name == "bfloat16" else y.dtype
            assert x.dtype == want and x.shape == y.shape, f
        np.testing.assert_array_equal(a.object_ids, b.object_ids)
        for f, atol in (("scores", 5e-3), ("logits", 5e-3), ("masks", 2e-2)):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       atol=atol, rtol=0, err_msg=f)
        assert (a.episode, a.step) == (b.episode, b.step)
    keys = sorted(set(labeled["jl"].captions) & set(labeled["tl"].captions))
    assert len(keys) >= 4
    same = [labeled["tl"].captions[k] == labeled["jl"].captions[k]
            for k in keys]
    assert np.mean(same) >= 0.5, same


def test_match_ids_at_the_threshold_matches_jax(labeled):
    """`_match_ids` on bf16 boxes against float32 labels whose IoU sits
    within a bf16 rounding of 0.3: the JAX package's bf16 arithmetic
    (widths and areas round) decides, and the port's bf16 tensor gives the
    same ids; widened to float32 first, some would fall the other way."""
    rng = np.random.default_rng(0)
    m = 4000
    x, y = rng.uniform(0, 60, m), rng.uniform(0, 60, m)
    w, h = rng.uniform(20, 200, m), rng.uniform(20, 200, m)
    gt = np.stack([x, y, x + w, y + h], 1).astype(np.float32)
    # a prediction covering 0.3 of the label's width
    frac = 0.3 + rng.uniform(-0.003, 0.003, m)
    pr = np.stack([x + 0.37, y, x + frac * w + 0.37, y + h], 1)
    pr = np.asarray(jnp.asarray(pr, jnp.bfloat16))
    want = np.diagonal(np.asarray(jiou(jnp.asarray(pr), jnp.asarray(gt))))
    wide = np.diagonal(np.asarray(jiou(jnp.asarray(pr.astype(np.float32)),
                                       jnp.asarray(gt))))
    flip = np.nonzero((want > 0.3) != (wide > 0.3))[0][:6]
    rest = np.nonzero(np.abs(want - 0.3) < 0.01)[0][:6]
    sel = np.concatenate([flip, rest])
    assert len(flip) >= 3
    n = len(sel)
    jl = JPL.VanillaConsensusLabeler(labeled["jcfg"],
                                     perceiver=labeled["jl"].perceiver)
    tl = TPL.VanillaConsensusLabeler(labeled["cfg"],
                                     perceiver=labeled["tper"])
    for k in range(n):
        # one labelled box a frame, one prediction on it
        batch = {"boxes": gt[sel[k]][None, None], "valid": np.ones((1, 1),
                                                                  bool),
                 "object_ids": np.array([[40 + k]], np.int64)}
        jpred = JDS.Sample(image=None, boxes=pr[sel[k]][None],
                           classes=np.zeros(1, np.int32),
                           logits=np.zeros((1, 6), np.float32), masks=None,
                           valid=np.ones(1, bool),
                           object_ids=np.full(1, -1, np.int64))
        tpred = _port_sample(jpred)
        want_ids = jl._match_ids(jpred, batch, 0)
        got_ids = tl._match_ids(tpred, batch, 0,
                                torch.from_numpy(tpred.boxes).to(
                                    torch.bfloat16))
        assert int(want_ids[0] == 40 + k) == int(want[sel[k]] > 0.3)
        assert (got_ids[0] == 40 + k) == (want_ids[0] == 40 + k), k


def _consensus_pair(labeled, name):
    """The JAX package's and the port's `name` consensus on the same
    predictions (the JAX package's, handed across)."""
    jpreds = copy.deepcopy(labeled["jpreds"])
    tpreds = [_port_sample(s) for s in jpreds]
    jl = JPL.CONSENSUS_REGISTRY[name](labeled["jcfg"],
                                      perceiver=labeled["jl"].perceiver)
    tl = TPL.CONSENSUS_REGISTRY[name](labeled["cfg"],
                                      perceiver=labeled["tper"])
    return jl, tl, jl.get_pseudo_labels(jpreds), tl.get_pseudo_labels(tpreds)


@pytest.mark.parametrize("name", HOST_CONSENSUS)
def test_host_consensus_equals_jax_on_handed_predictions(labeled, name):
    """The four host consensus stages (numpy in both packages) on the JAX
    package's predictions: every field equal."""
    _, _, want, got = _consensus_pair(labeled, name)
    fused = 0
    for a, b in zip(got, want):
        for f in SAMPLE_FIELDS:
            np.testing.assert_array_equal(
                getattr(a, f), np.asarray(getattr(b, f)).astype(
                    getattr(a, f).dtype), f)
        fused += int(b.valid.sum())
    assert fused > 8


@pytest.mark.parametrize("name", ["semantic_map", "semantic_map_captioner"])
def test_semantic_map_consensus_matches_jax_on_handed_predictions(labeled,
                                                                  name):
    """Per-episode maps fused from the JAX package's predictions, labels
    raytraced back: masks, boxes, classes, ids and validity equal, logits
    within 1e-6 (test_raytrace_matches_jax's limit)."""
    jl, tl, want, got = _consensus_pair(labeled, name)
    assert sorted(tl.global_maps) == sorted(jl.global_maps)
    n = 0
    for a, b in zip(got, want):
        for f in ("boxes", "classes", "masks", "valid", "object_ids"):
            x, y = getattr(a, f), np.asarray(getattr(b, f))
            assert x.dtype == y.dtype and x.shape == y.shape, f
            np.testing.assert_array_equal(x, y, f)
        np.testing.assert_allclose(a.logits, b.logits, rtol=1e-6, atol=1e-6)
        n += int(b.valid.sum())
    assert n > 0


def test_recaption_matches_jax(labeled):
    """The raytraced instances of the JAX package's consensus, captioned by
    both packages' greedy `generate` on their crops (the box count padded
    to a power of two): equal on at least half of the instances (ROADMAP
    C.8), and the same keys."""
    jl, tl, want, got = _consensus_pair(labeled, "semantic_map_captioner")
    with jax_kernel_path(blocks=True):
        jcap = jl.recaption(want)
    tcap = tl.recaption([_port_sample(s) for s in want])
    assert sorted(tcap) == sorted(jcap) and len(jcap) > 0
    assert np.mean([tcap[k] == jcap[k] for k in jcap]) >= 0.5


def _read_bbs(path):
    return np.load(path, allow_pickle=True)["arr_0"].item()["instances"]


def test_pseudo_label_files_load_in_both_packages(labeled, tmp_path):
    """`save_pseudo_labels` of the same labels: the same file names; the
    port's payload holds the JAX payload's values (its bf16 boxes as
    float32); each package's dataset reads the other's files as its own."""
    _, _, want, got = _consensus_pair(labeled, "soft")
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jpaths = JPL.ConsensusLabeler.save_pseudo_labels(want, str(jdir))
    tpaths = TPL.ConsensusLabeler.save_pseudo_labels(got, str(tdir))
    assert [Path(p).name for p in tpaths] == [Path(p).name for p in jpaths]
    for jp, tp in zip(jpaths, tpaths):
        a, b = _read_bbs(tp), _read_bbs(jp)
        assert sorted(a) == sorted(b)
        assert b["boxes"].dtype.name == "bfloat16"
        assert a["boxes"].dtype == np.float32
        for k in b:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]).astype(
                a[k].dtype), k)
    # each package's dataset on either directory (rgb copied beside)
    for d in (jdir, tdir):
        for f in Path(labeled["store"]).rglob("*rgb*"):
            (d / f.name).write_bytes(f.read_bytes())
    for d in (jdir, tdir):
        ours = TDS.EpisodeDetectionDataset(str(d))
        theirs = JDS.EpisodeDetectionDataset(str(d))
        assert len(ours) == len(theirs) == len(tpaths)
        for i in range(len(ours)):
            a, b = ours[i], theirs[i]
            for f in ("boxes", "classes", "logits", "valid", "object_ids",
                      "masks"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def _run(main, argv, jax_side: bool):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.MonkeyPatch.context() as mp:
        if jax_side:
            mp.setattr(sys, "argv", ["script.py"] + argv)
            rc = main()
        else:
            rc = main(argv + ["--device", "cpu"])
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def _script(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("consensus", ["semantic_map", "vanilla"])
def test_entry_point_matches_jax_script(labeled, consensus, tmp_path):
    """`run_pseudolabeler` beside `scripts/run_pseudolabeler.py` on the JAX
    store, the JAX perceiver's weights on both sides: the same JSON keys
    and types, frames and files; the same label file names."""
    argv = [labeled["store"], "--consensus", consensus, "--batch",
            str(BATCH)] + STORE_OVERRIDES
    with jax_kernel_path(blocks=True):
        jrc, want = _run(_script("run_pseudolabeler").main,
                         argv + ["--out", str(tmp_path / "j")], True)
    params = labeled["tper"].params
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TPL, "Perceiver",
                   lambda cfg, device="cuda": Perceiver(
                       cfg, params=params, device=device))
        rc, got = _run(run_pseudolabeler.main,
                       argv + ["--out", str(tmp_path / "t")], False)
    assert rc == 0 and jrc is None
    assert set(got) == set(want)
    for k, v in want.items():
        assert type(got[k]) is type(v), k
    for k in ("frames", "files"):
        assert got[k] == want[k] == 8, k
    assert got["instances"] > 0 and want["instances"] > 0
    assert (sorted(p.name for p in (tmp_path / "t").rglob("*.npz"))
            == sorted(p.name for p in (tmp_path / "j").rglob("*.npz")))


def test_entry_point_needs_a_card_or_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run_pseudolabeler.main([str(tmp_path), "--out",
                                   str(tmp_path / "o")]) == 2


# the JAX package's own cases (tests/test_labeling.py,
# tests/test_semantic_map_labeler.py) on the port


def _fake_preds():
    def mk(cls, logits_scale, step):
        n = 4
        s = TDS.Sample(
            image=np.zeros((32, 32, 3), np.uint8),
            boxes=np.zeros((n, 4), np.float32),
            classes=np.zeros((n,), np.int32),
            logits=np.zeros((n, NUM_CLASSES), np.float32),
            masks=np.zeros((n, 32, 32), np.float32),
            valid=np.zeros((n,), bool),
            object_ids=np.full((n,), -1, np.int64),
            episode=0, step=step)
        s.valid[0] = True
        s.classes[0] = cls
        s.logits[0, cls] = logits_scale
        s.object_ids[0] = 500
        return s

    return [mk(1, 0.9, 0), mk(1, 0.7, 1), mk(2, 0.95, 2)]


def test_host_consensus_cases_of_the_jax_tests():
    out = TPL.MajorityConsensusLabeler.__new__(
        TPL.MajorityConsensusLabeler).get_pseudo_labels(_fake_preds())
    assert all(p.classes[0] == 1 and p.logits[0].argmax() == 1 for p in out)
    out = TPL.MaxScoreConsensusLabeler.__new__(
        TPL.MaxScoreConsensusLabeler).get_pseudo_labels(_fake_preds())
    assert all(p.classes[0] == 2 for p in out)
    soft = TPL.SoftConsensusLabeler.__new__(TPL.SoftConsensusLabeler)
    soft.temperature = 2.0
    for p in soft.get_pseudo_labels(_fake_preds()):
        np.testing.assert_allclose(p.logits[0].sum(), 1.0, rtol=1e-5)
        assert p.classes[0] == 1


def test_build_sample_is_writable_and_save_keeps_scores(tmp_path):
    """Samples are writable numpy copies carrying the detector's scores
    (bf16 boxes widened), and the written labels keep the scores."""
    n = 2
    det = TDet(
        boxes=torch.tensor([[[1, 1, 5, 5], [2, 2, 6, 6]]],
                           dtype=torch.bfloat16),
        classes=torch.tensor([[1, 3]], dtype=torch.int32),
        scores=torch.tensor([[0.9, 0.4]]),
        logits=torch.from_numpy(np.eye(NUM_CLASSES,
                                       dtype=np.float32)[[[1, 3]]]),
        valid=torch.tensor([[True, True]]),
        masks=torch.ones(1, n, 8, 8), embeddings=torch.ones(1, n, 4))
    batch = {"image": np.zeros((1, 8, 8, 3), np.uint8),
             "episode": np.array([0]), "step": np.array([0])}
    labeler = TPL.ConsensusLabeler.__new__(TPL.ConsensusLabeler)
    pred = labeler._build_sample(det, batch, 0)
    for arr in (pred.boxes, pred.classes, pred.logits, pred.valid):
        assert arr.flags.writeable
    assert pred.boxes.dtype == np.float32
    pred.logits[0] = 0.5
    pred.classes[0] = 2
    assert det.classes[0, 0] == 1
    np.testing.assert_allclose(pred.scores, [0.9, 0.4])
    assert pred.embeddings.shape == (n, 4)
    preds = _fake_preds()
    for p in preds:
        p.scores = np.array([0.7] * len(p.valid), np.float32)
    paths = TPL.ConsensusLabeler.save_pseudo_labels(preds, str(tmp_path))
    payload = _read_bbs(paths[0])
    np.testing.assert_allclose(payload["scores"][payload["valid"]], 0.7)


def test_semantic_map_labeler_raytraces_synthetic_views():
    """tests/test_semantic_map_labeler.py: three views of one object fuse
    into one map object, raytraced back with its class."""
    cfg = load_config("tiny", overrides=[
        "map.voxel_size=0.1", "sensors.hfov_deg=90.0",
        "sensors.min_depth=0.5", "sensors.max_depth=3.5"])

    def sample(step, cls=2):
        h = w = 32
        depth = np.full((h, w), 4.0, np.float32)
        masks = np.zeros((4, h, w), np.float32)
        masks[0, 8:24, 10:24] = 1.0
        depth[8:24, 10:24] = 2.0
        logits = np.zeros((4, NUM_CLASSES), np.float32)
        logits[0, cls] = 4.0
        pose = Pose(np.array([2.4, 0.0, 4.5]), quat_from_yaw(0.0)
                    ).camera_pose().matrix().astype(np.float32)
        return TDS.Sample(
            image=np.zeros((h, w, 3), np.uint8),
            boxes=np.array([[10, 8, 24, 24]] + [[0, 0, 0, 0]] * 3,
                           np.float32),
            classes=np.array([cls, 0, 0, 0], np.int32), logits=logits,
            masks=masks, valid=np.array([True, False, False, False]),
            object_ids=np.array([500, -1, -1, -1], np.int64),
            depth=depth, pose=pose, episode=0, step=step)

    labeler = TPL.SemanticMapConsensusLabeler(cfg, perceiver=object(),
                                              device="cpu")
    out = labeler.get_pseudo_labels([sample(s) for s in range(3)])
    got = [p for p in out if p.valid.any()]
    assert len(out) == 3 and got
    p = got[0]
    i = int(np.argmax(p.valid))
    assert p.classes[i] == 2 and p.logits[i].argmax() == 2
    assert p.masks[i][10:22, 12:22].mean() > 0.3
    assert int(labeler.global_maps[0].num_objects) == 1
