"""The weight bridge, int8 quantization and the detector artifact loader."""

import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from embodied_captioning_tpu.models import detector as JD
from embodied_captioning_tpu.models.quantize import (
    QuantizedArray as JQA, quantize_kv as jqkv, quantize_params as jqp,
)
from embodied_captioning_tpu.config import DetectorConfig as JDetCfg
from embodied_captioning_tpu_torch.models import quantize as TQ
from embodied_captioning_tpu_torch.params import (
    from_jax, load_detector_artifact,
)
from torch_parity import np32, t

REPO = Path(__file__).resolve().parents[1]
ARTIFACT = REPO / "embodied_captioning_tpu/models/data/det_serving_256.pkl"


def test_bridge_round_trip_with_int8_and_conv_layouts():
    p = jqp(JD.init_detector(jax.random.PRNGKey(0), JDetCfg.tiny()),
            min_size=0)
    tp = from_jax(p, "cpu")
    jw, tw = p["stem"]["w"], tp["stem"]["w"]
    assert isinstance(jw, JQA) and isinstance(tw, TQ.QuantizedArray)
    # HWIO -> OIHW, int8 bits and scales unchanged
    np.testing.assert_array_equal(np32(tw.q), np.transpose(np32(jw.q),
                                                           (3, 2, 0, 1)))
    np.testing.assert_array_equal(np32(tw.scale), np32(jw.scale))
    # a dense kernel keeps [in, out]; bf16 dequantization is bit-equal
    jd, td = p["box_fc1"]["w"], tp["box_fc1"]["w"]
    np.testing.assert_array_equal(np32(td.dequantize()),
                                  np32(jd.dequantize()))
    assert td.dequantize().dtype == torch.bfloat16
    np.testing.assert_array_equal(np32(TQ.maybe_dequant(td)),
                                  np32(jd.dequantize()))
    assert tp["stages"][0][0]["sc"] is None or isinstance(
        tp["stages"][0][0]["sc"], dict)
    np.testing.assert_array_equal(np32(tp["stem_gn"]["g"]),
                                  np32(p["stem_gn"]["g"]))


def test_quantize_params_and_kv_match_jax():
    rng = np.random.default_rng(0)
    tree = {"w": jnp.asarray(rng.standard_normal((128, 256)), jnp.float32),
            "conv": {"w": jnp.asarray(rng.standard_normal((3, 3, 16, 32)),
                                      jnp.float32)},
            "small": {"w": jnp.asarray(rng.standard_normal((8, 8)),
                                       jnp.float32)},
            "emb": jnp.asarray(rng.standard_normal((300, 64)), jnp.float32)}
    ref = jqp(tree, min_size=1024)
    out = TQ.quantize_params(from_jax(tree, "cpu"), min_size=1024)
    for key in ("w",):
        np.testing.assert_array_equal(np32(out[key].q), np32(ref[key].q))
        np.testing.assert_array_equal(np32(out[key].scale),
                                      np32(ref[key].scale))
    np.testing.assert_array_equal(
        np32(out["conv"]["w"].q),
        np.transpose(np32(ref["conv"]["w"].q), (3, 2, 0, 1)))
    np.testing.assert_array_equal(np32(out["conv"]["w"].scale),
                                  np32(ref["conv"]["w"].scale))
    assert isinstance(out["small"]["w"], torch.Tensor)
    assert isinstance(out["emb"], torch.Tensor)
    kt = jnp.asarray(rng.standard_normal((2, 3, 8, 10)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((2, 10, 3, 8)), jnp.bfloat16)
    for a, b in zip(TQ.quantize_kv(t(kt), t(v)), jqkv(kt, v)):
        np.testing.assert_array_equal(np32(a), np32(b))


def test_artifact_loads_like_the_jax_pickle():
    with open(ARTIFACT, "rb") as fh:
        art = pickle.load(fh)  # resolves the JAX QuantizedArray class
    ref = from_jax(art["served"], "cpu")
    out, cfg = load_detector_artifact(str(ARTIFACT), "cpu")
    assert cfg["block"] == "bottleneck" and cfg["image_size"] == 256
    assert "approx_topk" not in cfg and "num_queries" not in cfg
    ra, oa = ref["stages"][3][0]["c2"]["w"], out["stages"][3][0]["c2"]["w"]
    assert oa.q.shape == (512, 512, 3, 3)
    assert torch.equal(ra.q, oa.q) and torch.equal(ra.scale, oa.scale)
    assert torch.equal(ref["box_fc1"]["b"], out["box_fc1"]["b"])


def test_artifact_loads_and_detects_without_jax():
    code = (
        "import sys, torch\n"
        "from embodied_captioning_tpu_torch.config import DetectorConfig\n"
        "from embodied_captioning_tpu_torch.models import detector as D\n"
        "from embodied_captioning_tpu_torch.params import "
        "load_detector_artifact\n"
        f"p, c = load_detector_artifact({str(ARTIFACT)!r}, 'cpu')\n"
        "g = torch.Generator().manual_seed(0)\n"
        "x = torch.randint(0, 256, (1, 256, 256, 3), generator=g,"
        " dtype=torch.uint8)\n"
        "det = D.forward(p, x, DetectorConfig(**c))\n"
        "assert torch.isfinite(det.boxes.float()).all()\n"
        "assert det.masks.shape == (1, 16, 28, 28)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'embodied_captioning_tpu'"
        " or m.startswith('embodied_captioning_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok")
