"""The query detector family through the port's entry points, on the CPU
at the tiny preset: its weights and artifacts in both packages, the
detector self-check (`--pack-masks`, `--ckpt`) beside the JAX script, and
`export_serving_artifact`. Its training state and the exploration and
labeling entry points: tests/test_torch_query_loops.py."""

import contextlib
import importlib.util
import io
import json
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_captioning_tpu.config import load_config as jload_config
from embodied_captioning_tpu.models import detector as JD
from embodied_captioning_tpu.models.quantize import (
    QuantizedArray as JQuantized,
)
from embodied_captioning_tpu.models.quantize import (
    quantize_params as jquantize,
)
from embodied_captioning_tpu_torch import export_serving_artifact as EX
from embodied_captioning_tpu_torch import selfcheck_detector as SD
from embodied_captioning_tpu_torch.models import detector as TD
from embodied_captioning_tpu_torch.models.quantize import QuantizedArray
from embodied_captioning_tpu_torch.params import (
    dump_tree, from_jax, load_detector_artifact, load_pickle, to_numpy,
)

REPO = Path(__file__).resolve().parents[1]
QUERY = ["detector.family=query", "detector.query_aux_topk=3"]


def _jax_query_params(seed: int = 0):
    cfg = jload_config("tiny", overrides=QUERY).detector
    return JD.init_detector(jax.random.PRNGKey(seed), cfg), cfg


def _leaves_equal(a, b) -> None:
    def int8(x) -> bool:  # either package's int8 leaf, or load_pickle's
        return getattr(x, "_fields", None) == ("q", "scale")

    la = jax.tree_util.tree_leaves(a, is_leaf=int8)
    lb = jax.tree_util.tree_leaves(b, is_leaf=int8)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if hasattr(x, "scale"):
            np.testing.assert_array_equal(np.asarray(x.q), np.asarray(y.q))
            np.testing.assert_array_equal(np.asarray(x.scale),
                                          np.asarray(y.scale))
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ---------------------------------------------------------------------------
# weights and artifacts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantized", [False, True])
def test_query_tree_round_trip(quantized, tmp_path):
    """`from_jax` then `to_numpy` gives back the JAX package's query tree
    (the layers list, query and level embeddings, int8 leaves of a
    `quantize_params(min_size=64)` tree); `dump_tree` writes it so that a
    plain `pickle.load` rebuilds the JAX package's `QuantizedArray` and
    `load_pickle` reads it without JAX."""
    p, _ = _jax_query_params()
    if quantized:
        p = jquantize(p, min_size=64)
    tp = from_jax(p, "cpu")
    assert isinstance(tp["layers"], list) and len(tp["layers"]) == 6
    assert tp["query_embed"].shape == (64, 32)
    assert tp["level_embed"].shape == (3, 32)
    if quantized:
        assert isinstance(tp["layers"][0]["xattn"]["q"]["w"], QuantizedArray)
        assert isinstance(tp["mask_conv"]["w"], QuantizedArray)
        assert isinstance(tp["query_embed"], torch.Tensor)  # not a "w"
    back = to_numpy(tp)
    _leaves_equal(back, p)
    dump_tree({"served": back}, str(tmp_path / "t.pkl"))
    with open(tmp_path / "t.pkl", "rb") as fh:
        plain = pickle.load(fh)["served"]
    if quantized:
        assert isinstance(plain["mask_conv"]["w"], JQuantized)
    _leaves_equal(plain, p)
    _leaves_equal(load_pickle(str(tmp_path / "t.pkl"))["served"], p)


def test_query_artifact_loads_and_serves(tmp_path):
    """A query-family serving artifact (the JAX package's int8 tree and
    serving config): `load_detector_artifact` keeps the family and its
    fields, and the port's `forward` runs on it, as the JAX package's
    does."""
    p, cfg = _jax_query_params(1)
    from embodied_captioning_tpu.config import to_dict

    served = jax.tree_util.tree_map(np.asarray, jquantize(p, min_size=64))
    with open(tmp_path / "q.pkl", "wb") as fh:
        pickle.dump({"served": served, "serving_cfg": to_dict(cfg),
                     "metrics": {}, "source": "x"}, fh)
    tp, tcfg = load_detector_artifact(str(tmp_path / "q.pkl"), "cpu")
    assert tcfg["family"] == "query" and tcfg["num_queries"] == 64
    assert tcfg["query_aux_topk"] == 3
    from embodied_captioning_tpu_torch.config import DetectorConfig

    dcfg = DetectorConfig(**tcfg)
    x = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), np.uint8)
    det = TD.forward(tp, torch.from_numpy(x), dcfg)
    want = JD.forward(jax.tree_util.tree_map(jnp.asarray, served),
                      jnp.asarray(x), cfg)
    assert det.boxes.shape == tuple(want.boxes.shape)
    assert det.masks.shape == tuple(want.masks.shape)
    assert torch.isfinite(det.masks).all()


# ---------------------------------------------------------------------------
# the detector self-check
# ---------------------------------------------------------------------------

def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_main(main, argv, jax_side: bool):
    """A script's or the port's `main` with `argv`: (rc, last JSON line,
    the whole output)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.MonkeyPatch.context() as mp:
        if jax_side:
            mp.setattr(sys, "argv", ["script.py"] + argv)
            rc = main()
        else:
            rc = main(argv + ["--device", "cpu"])
    out = buf.getvalue()
    return rc, json.loads(out.strip().splitlines()[-1]), out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The JAX script's training and eval corpora (2 scenes x 3 frames, 1
    x 8), saved by its `save_corpus`."""
    root = tmp_path_factory.mktemp("query_selfcheck")
    mod = _script("selfcheck_detector")
    cfg = jload_config("tiny")
    tr = mod.collect(cfg, 2, 3, 0, np.random.default_rng(0),
                     skip_seeds=(500, 8))
    te = mod.collect(cfg, 1, 8, 500, np.random.default_rng(500))
    mod.save_corpus(str(root / "train.npz"), tr)
    mod.save_corpus(str(root / "eval.npz"), te)
    return dict(mod=mod, root=root)


ARGV = ["--preset", "tiny", "--batch", "4", "--eval-scenes", "1",
        "--eval-ep-steps", "8", "--device-train", "--pack-masks"]


def _argv(corpus, *more) -> list:
    root = corpus["root"]
    return ARGV + ["--train-cache", str(root / "train.npz"), "--eval-cache",
                   str(root / "eval.npz"), *more]


@pytest.fixture(scope="module")
def query_entry(corpus, tmp_path_factory):
    """The JAX script and the port's entry point, query family with the
    rung's aux matching, device-side training with bit-packed masks, on
    the JAX script's corpora and the JAX package's seeded weights, 4
    steps; each saves its artifact."""
    out = tmp_path_factory.mktemp("query_entry")
    argv = _argv(corpus, "--steps", "4") + QUERY
    params, _ = _jax_query_params(0)
    jrc, jline, _ = _run_main(corpus["mod"].main, argv + [
        "--save", str(out / "j.pkl")], True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TD, "init_detector",
                   lambda g, cfg, dev: from_jax(params, dev))
        rc, line, _ = _run_main(SD.main, argv + ["--save",
                                                 str(out / "t.pkl")], False)
    return dict(rc=rc, line=line, jrc=jrc, jline=jline, out=out)


def test_selfcheck_line_matches_the_jax_script(query_entry):
    """Same keys and types; the same corpora; the first step's loss on
    the same weights and batch within 3e-3 of itself (the decoder's
    spread, tests/test_torch_query_detector.py: 7e-4 measured at QCFG);
    every number finite, the maps in [0, 1]."""
    got, want = query_entry["line"], query_entry["jline"]
    assert query_entry["rc"] == 0 and query_entry["jrc"] is None
    assert set(got) == set(want)
    for k in ("seed", "eval_sha", "frames", "steps", "map50_after_ema"):
        assert got[k] == want[k], k
    assert abs(got["first_loss"] - want["first_loss"]) <= 3e-3 * abs(
        want["first_loss"]), (got["first_loss"], want["first_loss"])
    for k in ("map50_before", "map50_after", "map50_train", "mask_iou"):
        assert 0.0 <= got[k] <= 1.0, k
    assert np.isfinite(got["last_loss"])


def test_selfcheck_artifact_exports_and_loads_in_both(query_entry,
                                                      tmp_path):
    """The port's `export_serving_artifact` of the port's `--save`: equal
    to the JAX script's export of it (int8 leaves, scales, float leaves,
    serving config); `load_detector_artifact` serves it in the port and
    the JAX package's reader (a plain `pickle.load`) serves it in the JAX
    package."""
    art = query_entry["out"] / "t.pkl"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert EX.main([str(art), "--out", str(tmp_path / "t_served.pkl"),
                        "--metrics", '{"map50": 0.5}', "--device",
                        "cpu"]) == 0
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert line["norm"] == "gn" and line["out"].endswith("t_served.pkl")
    jmod = _script("export_serving_artifact")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["x.py", str(art), "--out",
                                 str(tmp_path / "j_served.pkl")])
        with contextlib.redirect_stdout(io.StringIO()):
            jmod.main()
    with open(tmp_path / "t_served.pkl", "rb") as fh:
        ours = pickle.load(fh)
    with open(tmp_path / "j_served.pkl", "rb") as fh:
        theirs = pickle.load(fh)
    assert ours["serving_cfg"] == theirs["serving_cfg"]
    assert ours["serving_cfg"]["family"] == "query"
    assert ours["metrics"] == {"map50": 0.5}
    _leaves_equal(ours["served"], theirs["served"])
    cfg = jload_config("tiny", overrides=QUERY).detector
    x = jnp.zeros((1, 64, 64, 3), jnp.uint8)
    det = JD.forward(jax.tree_util.tree_map(jnp.asarray, ours["served"]), x,
                     cfg)
    assert det.boxes.shape == (1, cfg.max_detections, 4)
    tp, tcfg = load_detector_artifact(str(tmp_path / "t_served.pkl"), "cpu")
    from embodied_captioning_tpu_torch.config import DetectorConfig

    out = TD.forward(tp, torch.zeros(1, 64, 64, 3, dtype=torch.uint8),
                     DetectorConfig(**tcfg))
    assert out.boxes.shape == (1, cfg.max_detections, 4)


def test_export_runs_on_the_card_by_default(query_entry, tmp_path, capsys,
                                            monkeypatch):
    """Without `--device` the export loads and quantizes on the card; with
    no card it exits 2 and writes nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "d.pkl"
    assert EX.main([str(query_entry["out"] / "t.pkl"), "--out",
                    str(out)]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not out.exists()


def test_export_refuses_affine_for_the_query_family(query_entry, tmp_path):
    art = load_pickle(str(query_entry["out"] / "t.pkl"))
    with pytest.raises(ValueError, match="--calibrate"):
        EX.main([str(query_entry["out"] / "t.pkl"), "--out",
                 str(tmp_path / "a.pkl"), "--norm", "affine", "--device",
                 "cpu"])
    art["affine"] = art["params"]
    with open(tmp_path / "with_affine.pkl", "wb") as fh:
        pickle.dump(art, fh)
    with pytest.raises(ValueError, match="rcnn family"):
        EX.main([str(tmp_path / "with_affine.pkl"), "--out",
                 str(tmp_path / "a.pkl"), "--norm", "affine", "--device",
                 "cpu"])


def test_calibrate_refuses_the_query_family(corpus):
    """As the JAX script: `--calibrate` reaches `calibrate_affine`, which
    refuses the query family."""
    with pytest.raises(ValueError, match="rcnn family"):
        _run_main(SD.main, _argv(corpus, "--steps", "1", "--calibrate")
                  + QUERY, False)


def test_checkpoint_flag_resumes_through_the_entry_point(corpus, tmp_path):
    """`--ckpt` through `main`: the first call writes the checkpoint, the
    second resumes from it and says so."""
    argv = _argv(corpus, "--ckpt", str(tmp_path / "c.pkl"), "--ckpt-every",
                 "1") + QUERY
    rc, line, out = _run_main(SD.main, argv + ["--steps", "1"], False)
    assert rc == 0 and "checkpoint @ step 1" in out
    rc, line, out = _run_main(SD.main, argv + ["--steps", "2"], False)
    assert rc == 0 and "resumed from" in out and "at step 1" in out
    assert line["steps"] == 2 and np.isfinite(line["last_loss"])
