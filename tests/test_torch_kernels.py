"""The port's kernel plain versions against the JAX package's Pallas kernels
(interpret mode on the CPU), and the wrappers' device dispatch."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_captioning_tpu.models.quantize import quantize_array as jqa
from embodied_captioning_tpu.models.quantize import quantize_kv as jqkv
from embodied_captioning_tpu.ops.pallas import decode_attention as JDA
from embodied_captioning_tpu.ops.pallas.flash_attention import (
    flash_attention as j_flash,
)
from embodied_captioning_tpu_torch import kernels as K
from torch_parity import np32, t


def _bf16(rng, *shape, scale=1.0):
    return jnp.asarray(rng.standard_normal(shape) * scale, jnp.bfloat16)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_matches_single_block_kernel(causal):
    # T <= 512: the TPU single-block kernel, whose numerics the plain
    # version repeats (f32 scores, probabilities normalised then rounded to
    # bf16); tolerance 1e-2 = one bf16 ulp at |o| ~ 1
    rng = np.random.default_rng(0)
    q, k, v = (_bf16(rng, 2, 2, 65, 32) for _ in range(3))
    ref = j_flash(q, k, v, causal=causal, interpret=True)
    out = K.flash_attention_plain(t(q), t(k), t(v), causal=causal)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(np32(out), np32(ref), atol=1e-2, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_valid_len_matches_blocked_kernel(causal):
    # T > 512: the TPU blocked kernel (online softmax, normalised after the
    # bf16 PV product) with padded keys masked by valid_len; the plain
    # version normalises before rounding, so the tolerance is 3e-2 (a few
    # bf16 ulps at |o| ~ 1)
    rng = np.random.default_rng(1)
    q, k, v = (_bf16(rng, 1, 2, 640, 32) for _ in range(3))
    ref = j_flash(q, k, v, causal=causal, valid_len=600, interpret=True)
    out = K.flash_attention(t(q), t(k), t(v), causal=causal, valid_len=600)
    np.testing.assert_allclose(np32(out)[:, :, :600], np32(ref)[:, :, :600],
                               atol=3e-2, rtol=0)


@pytest.mark.parametrize("tt,pos", [(12, 0), (12, 5), (12, 11), (300, 0),
                                    (300, 150), (300, 299)])
def test_decode_self_attention_plain_mid_cache(tt, pos):
    # the plain version masks keys past pos over the whole cache, as the
    # TPU kernel does; the kernel reads only positions 0..pos, which gives
    # the same sums (a masked key's exp is +0). 300 positions are more than
    # one tile of the tiled kernel (96 keys at Dh 64, 128 at Dh 16). f32
    # outputs; tolerance 1e-5 covers summation order only
    rng = np.random.default_rng(2)
    b, h, dh = 3, 2, 16
    q = _bf16(rng, b, h, dh)
    kt = _bf16(rng, b, h, dh, tt)
    v = _bf16(rng, b, tt, h, dh)
    ref = JDA.decode_self_attention(q, kt, v, jnp.int32(pos), interpret=True)
    out = K.decode_self_attention(t(q), t(kt), t(v), pos)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(np32(out), np32(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("int8", [False, True])
def test_decode_cross_attention_plain(int8):
    rng = np.random.default_rng(3)
    b, h, dh, nk = 3, 2, 16, 20
    q = _bf16(rng, b, h, dh)
    kt = _bf16(rng, b, h, dh, nk)
    v = _bf16(rng, b, nk, h, dh)
    if int8:
        qk = jqkv(kt, v)
        args = (qk.kt, jnp.transpose(qk.v, (0, 2, 1, 3)), qk.kt_scale,
                qk.v_scale)
    else:
        args = (kt, jnp.transpose(v, (0, 2, 1, 3)), None, None)
    ref = JDA.decode_cross_attention(q, *args, interpret=True)
    out = K.decode_cross_attention(
        t(q), *(None if a is None else t(a) for a in args))
    np.testing.assert_allclose(np32(out), np32(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("int8", [False, True])
def test_decode_mlp_plain(int8):
    # bf16 output x + y with |x + y| < 8: tolerance 1/32 = one bf16 ulp
    # there (a summation-order flip of one rounding)
    rng = np.random.default_rng(4)
    d, f = 64, 256
    x = _bf16(rng, 8, d)
    g = jnp.asarray(1 + 0.1 * rng.standard_normal(d), jnp.float32)
    bb = jnp.asarray(0.1 * rng.standard_normal(d), jnp.float32)
    wfc = jnp.asarray(rng.standard_normal((d, f)) / math.sqrt(d), jnp.float32)
    wpj = jnp.asarray(rng.standard_normal((f, d)) / math.sqrt(f), jnp.float32)
    bfc = jnp.asarray(0.02 * rng.standard_normal(f), jnp.float32)
    bpj = jnp.asarray(0.02 * rng.standard_normal(d), jnp.float32)
    if int8:
        qf, qp = jqa(wfc), jqa(wpj)
        ws = (qf.q, qf.scale, qp.q, qp.scale)
    else:
        ws = (wfc, jnp.ones(f, jnp.float32), wpj, jnp.ones(d, jnp.float32))
    ref = JDA.decode_mlp(x, g, bb, ws[0], ws[1], bfc, ws[2], ws[3], bpj,
                         interpret=True)
    out = K.decode_mlp(t(x), t(g), t(bb), t(ws[0]), t(ws[1]), t(bfc),
                       t(ws[2]), t(ws[3]), t(bpj))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(np32(out), np32(ref), atol=1 / 32, rtol=0)
    assert np.mean(np32(out) == np32(ref)) > 0.99


def test_wrappers_take_the_plain_version_on_cpu_only():
    q = torch.randn(1, 1, 8, 32).bfloat16()
    before = dict(K.launches)
    out = K.flash_attention(q, q, q)
    assert torch.equal(out, K.flash_attention_plain(q, q, q))
    assert K.launches == before  # no kernel launched on the CPU
    with pytest.raises(ValueError, match="no kernel or plain version"):
        K.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))


# ---------------------------------------------------------------------------
# raycast and LayerNorm (the exploration-loop slice)
# ---------------------------------------------------------------------------

def _xla_raycast(box_min, box_max, valid, inv):
    """The XLA spelling of the visibility pass in the JAX package's
    envs/sim.render (numpy, float32): slab test, min and argmin."""
    t0 = box_min[None, None] * inv[:, :, None, :]
    t1 = box_max[None, None] * inv[:, :, None, :]
    t_near = np.max(np.minimum(t0, t1), axis=-1)
    t_far = np.min(np.maximum(t0, t1), axis=-1)
    hit = (t_near <= t_far) & (t_far > 1e-4) & valid[None, None]
    t_hit = np.where(hit, np.maximum(t_near, 1e-4), np.inf)
    return np.min(t_hit, axis=-1), np.argmin(t_hit, axis=-1)


def _adversarial_rays():
    """All-miss rays, an invalid box, a duplicate box (ties go to the
    first index) and zero ray components (clamped reciprocals)."""
    rng = np.random.default_rng(0)
    nb, h, w = 7, 16, 128
    box_min = rng.uniform(-4, 4, (nb, 3)).astype(np.float32)
    box_max = (box_min + rng.uniform(0.2, 2.0, (nb, 3))).astype(np.float32)
    box_min[3], box_max[3] = box_min[2], box_max[2]
    valid = np.ones((nb,), bool)
    valid[5] = False
    dirs = rng.standard_normal((h, w, 3)).astype(np.float32)
    dirs[0, :, :] = np.array([0.0, 0.0, 1.0])
    dirs[1, :, :] = np.array([0.0, 1.0, 0.0])
    inv = (1.0 / np.where(np.abs(dirs) < 1e-8,
                          np.where(dirs >= 0, 1e-8, -1e-8), dirs)
           ).astype(np.float32)
    return box_min, box_max, valid, inv


def _scene_rays():
    """A generated scene seen from its spawned agent, as the render builds
    the kernel's inputs (boxes translated by -origin)."""
    from embodied_captioning_tpu_torch.config import SensorConfig, SimConfig
    from embodied_captioning_tpu_torch.envs.sim import (
        RaycastSim, ray_directions)

    sim = RaycastSim(SimConfig(), SensorConfig(), seed=3, device="cpu")
    pose = torch.from_numpy(sim.agent.camera_matrix()).float()[None]
    origin, _, inv = ray_directions(pose, 48, 64, 79.0)
    s = sim.scene
    return ((s.box_min - origin).numpy(), (s.box_max - origin).numpy(),
            s.valid.numpy(), inv[0].numpy())


@pytest.mark.parametrize("rays", [_adversarial_rays, _scene_rays],
                         ids=["adversarial", "scene"])
def test_raycast_plain_equals_tpu_kernel_and_xla_spelling(rays):
    # exactly equal: the slab test is multiplies, min and max only, and
    # ties resolve to the first box in all three
    from embodied_captioning_tpu.ops.pallas.raycast import (
        raycast_minargmin as j_raycast)

    box_min, box_max, valid, inv = rays()
    ref_t, ref_best = _xla_raycast(box_min, box_max, valid, inv)
    if rays is _adversarial_rays:
        assert not np.isfinite(ref_t).all()      # some rays miss everything
        assert (ref_best[np.isfinite(ref_t)] != 5).all()
        assert (ref_best != 3).all()             # the duplicate never wins
    k_t, k_best = j_raycast(jnp.asarray(box_min), jnp.asarray(box_max),
                            jnp.asarray(valid), jnp.asarray(inv),
                            interpret=True)
    t_best, best = K.raycast_minargmin(t(box_min)[None], t(box_max)[None],
                                       t(valid)[None], t(inv)[None])
    assert t_best.dtype == torch.float32 and best.dtype == torch.int32
    for got_t, got_b in ((t_best[0].numpy(), best[0].numpy()),
                         (np.asarray(k_t), np.asarray(k_best))):
        np.testing.assert_array_equal(got_t, ref_t)
        np.testing.assert_array_equal(got_b, ref_best)


def test_raycast_plain_row_chunks_and_envs(monkeypatch):
    # the plain version's memory-bounding row chunks change nothing
    from embodied_captioning_tpu_torch.kernels import raycast as RC

    box_min, box_max, valid, inv = _adversarial_rays()
    args = [t(a)[None].repeat(2, *([1] * a.ndim))
            for a in (box_min, box_max, valid, inv)]
    args[2][1, :] = False                        # env 1: no valid box
    whole = RC.raycast_minargmin_plain(*args)
    monkeypatch.setattr(RC, "PLAIN_CHUNK_ELEMS", 128 * 7 * 3 * 5)
    chunked = RC.raycast_minargmin_plain(*args)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)
    assert torch.isinf(whole[0][1]).all() and (whole[1][1] == 0).all()


@pytest.mark.parametrize("shape", [(37, 128), (3, 65, 128)],
                         ids=["2d", "3d"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_layernorm_plain_two_pass_matches_tpu_kernel(shape, dtype):
    # the TPU kernel is two-pass; bf16 output within one bf16 ulp of |y| < 8
    # (1/32), f32 output within 1e-5 (summation order)
    from embodied_captioning_tpu.ops.pallas.layernorm import layernorm_nd

    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal(shape) * 1.5 + 0.3, dtype)
    g = jnp.asarray(1 + 0.1 * rng.standard_normal(shape[-1]), jnp.float32)
    b = jnp.asarray(0.1 * rng.standard_normal(shape[-1]), jnp.float32)
    ref = layernorm_nd(x, g, b, eps=1e-5, interpret=True)
    out = K.layernorm(t(x), t(g), t(b), 1e-5, two_pass=True)
    assert out.shape == tuple(shape) and str(out.dtype) == f"torch.{dtype}"
    atol = 1 / 32 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(np32(out), np32(ref), atol=atol, rtol=0)
    if dtype == "bfloat16":
        assert np.mean(np32(out) == np32(ref)) > 0.99


@pytest.mark.parametrize("dtype,out_dtype", [("bfloat16", None),
                                             ("bfloat16", "float32"),
                                             ("float32", None)])
def test_layernorm_default_mode_matches_jax_default_path(dtype, out_dtype):
    # `_layernorm_ref`: one-pass with the relative floor for bf16 input,
    # two-pass for f32; a near-constant row exercises the floor
    from embodied_captioning_tpu.models.common import _layernorm_ref

    rng = np.random.default_rng(6)
    xs = rng.standard_normal((5, 33, 96)) * 2.0 + 1.0
    xs[0, 0] = 3.0                                # a constant row
    xs[0, 1] = 300.0 + 0.01 * rng.standard_normal(96)
    x = jnp.asarray(xs, dtype)
    g = jnp.asarray(1 + 0.1 * rng.standard_normal(96), jnp.float32)
    b = jnp.asarray(0.1 * rng.standard_normal(96), jnp.float32)
    jo = jnp.dtype(out_dtype or dtype)
    ref = _layernorm_ref(x, g, b, 1e-5, jo)
    out = K.layernorm(t(x), t(g), t(b), 1e-5,
                      None if out_dtype is None else torch.float32)
    assert str(out.dtype) == f"torch.{out_dtype or dtype}"
    atol = 1 / 32 if (out_dtype or dtype) == "bfloat16" else 2e-5
    np.testing.assert_allclose(np32(out), np32(ref), atol=atol, rtol=1e-5)


def test_loop_kernel_wrappers_take_the_plain_version_on_cpu_only():
    before = dict(K.launches)
    x = torch.randn(4, 32)
    g, b = torch.ones(32), torch.zeros(32)
    assert torch.equal(K.layernorm(x, g, b), K.layernorm_plain(x, g, b))
    box_min, box_max, valid, inv = (t(a)[None] for a in _adversarial_rays())
    for a, p in zip(K.raycast_minargmin(box_min, box_max, valid, inv),
                    K.raycast_minargmin_plain(box_min, box_max, valid, inv)):
        assert torch.equal(a, p)
    assert K.launches == before and set(before) >= {"layernorm",
                                                    "raycast_minargmin"}
    with pytest.raises(ValueError, match="no kernel or plain version"):
        K.layernorm(x.to("meta"), g.to("meta"), b.to("meta"))
    with pytest.raises(ValueError, match="no kernel or plain version"):
        K.raycast_minargmin(box_min, box_max, valid, inv.to("meta"))


# ---------------------------------------------------------------------------
# whole-block decode kernels and the fused preprocess (caption generation)
# ---------------------------------------------------------------------------

def _proj_weights(rng, d, n, int8):
    """n (weight, scale, bias) triples as the TPU block kernels take them:
    [d, d] int8 with per-output-channel scales, or float with ones."""
    out = []
    for _ in range(n):
        w = jnp.asarray(rng.standard_normal((d, d)) / math.sqrt(d),
                        jnp.float32)
        bias = jnp.asarray(0.05 * rng.standard_normal(d), jnp.float32)
        if int8:
            q = jqa(w)
            out += [q.q, q.scale.astype(jnp.float32), bias]
        else:
            out += [w, jnp.ones(d, jnp.float32), bias]
    return out


@pytest.mark.parametrize("pos", [0, 5, 11])
@pytest.mark.parametrize("int8", [False, True])
def test_decode_self_block_plain(int8, pos):
    # bf16 outputs: the residual stream |x + y| < 8 within one bf16 ulp
    # there (1/32), the k/v of the current token (|k| < 4) within 1/64; the
    # sums run in another order, so a rounding flips on a few elements
    rng = np.random.default_rng(10)
    b, d, h, tt = 5, 64, 4, 12
    dh = d // h
    x = _bf16(rng, b, d)
    g = jnp.asarray(1 + 0.1 * rng.standard_normal(d), jnp.float32)
    bb = jnp.asarray(0.05 * rng.standard_normal(d), jnp.float32)
    ws = _proj_weights(rng, d, 4, int8)
    kc = _bf16(rng, b, h, dh, tt)
    vc = _bf16(rng, b, tt, h, dh)
    ref, k_cur, v_cur = JDA.decode_self_block(
        x, g, bb, *ws, kc, vc, jnp.int32(pos), heads=h, interpret=True)
    tkc, tvc = t(kc), t(vc)
    out, okc, ovc = K.decode_self_block(t(x), t(g), t(bb), *map(t, ws), tkc,
                                        tvc, pos, h)
    assert out.dtype == torch.bfloat16 and okc is tkc and ovc is tvc
    np.testing.assert_allclose(np32(out), np32(ref), atol=1 / 32, rtol=0)
    assert np.mean(np32(out) == np32(ref)) > 0.98
    # the caches: the current token written at `pos`, the rest untouched
    np.testing.assert_allclose(np32(okc[:, :, :, pos]),
                               np32(k_cur).reshape(b, h, dh), atol=1 / 64,
                               rtol=0)
    np.testing.assert_allclose(np32(ovc[:, pos]),
                               np32(v_cur).reshape(b, h, dh), atol=1 / 64,
                               rtol=0)
    keep = np.arange(tt) != pos
    np.testing.assert_array_equal(np32(okc)[..., keep], np32(kc)[..., keep])
    np.testing.assert_array_equal(np32(ovc)[:, keep], np32(vc)[:, keep])
    if pos == 0:
        # no live cache position: attention returns the current v exactly
        wo, so, bo = (t(a) for a in ws[9:])
        y = torch.matmul(ovc[:, 0].reshape(b, d).float(),
                         wo.to(torch.bfloat16).float()) * so + bo
        assert torch.equal(out, (t(x).float() + y).to(torch.bfloat16))


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("int8", [False, True])
def test_decode_cross_block_plain(int8, kv_int8):
    # two row blocks on the TPU side (block_b=4 of 8 rows); bf16 output
    # within one ulp of |x + y| < 8
    rng = np.random.default_rng(11)
    b, d, h, nk = 8, 64, 4, 24
    dh = d // h
    x = _bf16(rng, b, d)
    g = jnp.asarray(1 + 0.1 * rng.standard_normal(d), jnp.float32)
    bb = jnp.asarray(0.05 * rng.standard_normal(d), jnp.float32)
    ws = _proj_weights(rng, d, 2, int8)
    kt = _bf16(rng, b, h, dh, nk)
    v = _bf16(rng, b, nk, h, dh)
    if kv_int8:
        qk = jqkv(kt, v)
        kv = (qk.kt, jnp.transpose(qk.v, (0, 2, 1, 3)), qk.kt_scale,
              qk.v_scale)
    else:
        kv = (kt, jnp.transpose(v, (0, 2, 1, 3)), None, None)
    ref = JDA.decode_cross_block(x, g, bb, *ws, *kv, heads=h, block_b=4,
                                 interpret=True)
    out = K.decode_cross_block(
        t(x), t(g), t(bb), *map(t, ws),
        *(None if a is None else t(a) for a in kv), heads=h)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(np32(out), np32(ref), atol=1 / 32, rtol=0)
    assert np.mean(np32(out) == np32(ref)) > 0.98


@pytest.mark.parametrize("in_size,out_size,patch",
                         [(64, 64, 8), (40, 64, 8), (150, 224, 14),
                          (320, 224, 14), (224, 224, 16), (640, 224, 14)],
                         ids=["identity", "up40", "up150", "down320",
                              "identity224-patch16", "down640"])
def test_fused_preprocess_plain(in_size, out_size, patch):
    # against the TPU kernel, which resizes raw values and folds the
    # normalisation into one multiply-add (1e-4, the tolerance of the JAX
    # package's own test); against the JAX package's unfused
    # preprocess_for_vit, its default path (ROADMAP C.24): equal bit for
    # bit at 224 and the identity sizes, within 2^-21 at 64 (XLA's FMA
    # spelling there, see test_preprocess_for_vit_equals_jax_default_path);
    # against the port's own unfused ops, whose products sum in another
    # order, within 2e-6, and equal at the identity size
    from embodied_captioning_tpu.ops.image import (
        preprocess_for_vit as j_preprocess)
    from embodied_captioning_tpu.ops.pallas.preprocess import (
        fused_preprocess as j_fused)
    from embodied_captioning_tpu_torch.ops import image as TI

    rng = np.random.default_rng(12)
    img = (rng.random((2, in_size, in_size, 3)) * 255).astype(np.uint8)
    ref = np.stack([np.asarray(j_fused(jnp.asarray(im), out_size=out_size,
                                       patch=patch, interpret=True))
                    for im in img])
    out = K.fused_preprocess(t(img), out_size, patch)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(np32(out), ref, atol=1e-4, rtol=1e-4)
    want = np.asarray(j_preprocess(jnp.asarray(img), out_size, patch))
    np.testing.assert_allclose(np32(out), want, atol=2.0 ** -21, rtol=0)
    if out_size == 224 or in_size == out_size:
        np.testing.assert_array_equal(np32(out), want)
    assert torch.equal(TI.preprocess_for_vit(t(img), out_size, patch), out)
    # the port's unfused ops take the jitted JAX program's products with
    # the reciprocals of 255 and of std (ROADMAP C.10), the kernel the
    # IEEE divisions of the JAX package's eager path (C.24, C.50): at the
    # identity size the unfused ops equal the jitted JAX preprocess
    unfused = TI.patchify(TI.normalize(TI.resize_bilinear(
        TI.to_float(t(img)), out_size, out_size)), patch)
    if in_size == out_size:
        jitted = jax.jit(j_preprocess, static_argnums=(1, 2))(
            jnp.asarray(img), out_size, patch)
        np.testing.assert_array_equal(np32(unfused), np.asarray(jitted))
    np.testing.assert_allclose(np32(out), np32(unfused), atol=2e-6, rtol=0)


@pytest.mark.parametrize("out_size,in_size,patch",
                         [(64, 64, 8), (224, 224, 14), (64, 90, 8),
                          (224, 333, 14), (63, 50, 7), (128, 200, 8),
                          (113, 97, 113), (112, 97, 112), (48, 97, 8),
                          (49, 97, 7)])
def test_preprocess_for_vit_equals_jax_default_path(out_size, in_size,
                                                    patch):
    # ROADMAP C.24: the port's preprocess_for_vit (the fused kernel's plain
    # version on the CPU) against the JAX package's default path at
    # `python tests/torch_parity.py preprocess-diff`'s four cases (4
    # images) and on both sides of the sizes where XLA on the CPU changes
    # how it rounds the resize's dense weight product. Where XLA sums the
    # two taps as separate products (1-48 rows mod 64: 224, 112, 48; and
    # the identity sizes, whose weights are 0 and 1) the two are equal bit
    # for bit. Where it sums them in one FMA (0 or 49-63 rows mod 64), the
    # port's one spelling rounds once more in each pass: the tokens differ
    # by at most 2^-21, two float32 ulps of the largest tokens (|t| < 2.2)
    from embodied_captioning_tpu.ops.image import (
        preprocess_for_vit as j_preprocess)
    from embodied_captioning_tpu_torch.ops import image as TI

    imgs = np.random.default_rng(0).integers(
        0, 256, (4, in_size, in_size, 3), dtype=np.uint8)
    want = np.asarray(j_preprocess(jnp.asarray(imgs), out_size, patch))
    got = TI.preprocess_for_vit(torch.from_numpy(imgs), out_size, patch)
    np.testing.assert_allclose(got.numpy(), want, atol=2.0 ** -21, rtol=0)
    if out_size in (224, 112, 48) or in_size == out_size:
        np.testing.assert_array_equal(got.numpy(), want)


def test_generation_kernel_wrappers_take_the_plain_version_on_cpu_only():
    before = dict(K.launches)
    assert set(before) >= {"decode_self_block", "decode_cross_block",
                           "fused_preprocess"}
    img = torch.zeros(1, 16, 16, 3, dtype=torch.uint8)
    assert torch.equal(K.fused_preprocess(img, 16, 8),
                       K.fused_preprocess_plain(img, 16, 8))
    with pytest.raises(ValueError, match="multiple of the patch"):
        K.fused_preprocess(img, 20, 8)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        K.fused_preprocess(img.to("meta"), 16, 8)
    rng = np.random.default_rng(13)
    d, h = 32, 2
    x = t(_bf16(rng, 2, d))
    g, bb = torch.ones(d), torch.zeros(d)
    ws = [t(a) for a in _proj_weights(rng, d, 4, False)]
    kc, vc = torch.zeros(2, h, d // h, 4).bfloat16(), torch.zeros(
        2, 4, h, d // h).bfloat16()
    K.decode_self_block(x, g, bb, *ws, kc, vc, 1, h)
    K.decode_cross_block(x, g, bb, *ws[:6], kc, vc.permute(0, 2, 1, 3),
                         heads=h)
    assert K.launches == before  # no kernel launched on the CPU
    meta = [a.to("meta") for a in (x, g, bb, *ws, kc, vc)]
    with pytest.raises(ValueError, match="no kernel or plain version"):
        K.decode_self_block(*meta, 1, h)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        K.decode_cross_block(*meta[:9], meta[-2], meta[-1], heads=h)


# ---------------------------------------------------------------------------
# the decode MLP's launch plan (host-side logic of the split-K kernel)
# ---------------------------------------------------------------------------

# (D, F) of the presets' decoders: tiny, base, large
_MLP_WIDTHS = [(64, 256), (512, 2048), (768, 3072)]


@pytest.mark.parametrize("rows", [1, 2, 8, 16, 17, 64, 128])
@pytest.mark.parametrize("d,f", _MLP_WIDTHS)
def test_mlp_plan_covers_the_decode_shapes(rows, d, f):
    from embodied_captioning_tpu_torch.kernels.decode_attention import (
        MLP_FC_MAX_SLICE, MLP_FC_TILE, MLP_MAX_SLICE, MLP_MAX_SPLITS,
        MLP_TILE, SM_COUNT, mlp_plan)

    s_fc, s_pj = mlp_plan(rows, d, f)
    for k, s, most in ((d, s_fc, MLP_FC_MAX_SLICE), (f, s_pj, MLP_MAX_SLICE)):
        # a power of two up to the portable cluster size, slices that the
        # wgmma k-steps of 16 cover and that fit shared memory
        assert 1 <= s <= MLP_MAX_SPLITS and s & (s - 1) == 0
        assert k % (16 * s) == 0 and k // s <= most
    # fc: the most splits that keep its blocks within one an SM, where d
    # allows them
    fc_tiles = -(-f // MLP_FC_TILE)
    assert fc_tiles * s_fc <= SM_COUNT or d // (s_fc // 2 or 1) > (
        MLP_FC_MAX_SLICE)
    assert (fc_tiles * 2 * s_fc > SM_COUNT or s_fc == MLP_MAX_SPLITS
            or d % (32 * s_fc))
    # proj: the fewest splits that give every SM a block, where f allows it
    blocks = d // MLP_TILE * s_pj
    assert blocks >= SM_COUNT or s_pj == MLP_MAX_SPLITS or f % (32 * s_pj)
    assert s_pj == 1 or d // MLP_TILE * (s_pj // 2) < SM_COUNT
    if (d, f) == (768, 3072):
        # the serving shape: 96 fc blocks (24 column tiles of 128 x 4
        # slices of 192), 96 proj blocks (12 of 64 x 8 slices of 384)
        assert (s_fc, s_pj) == (4, 8)


@pytest.mark.parametrize("d,t,valid_len,kernel", [
    (64, 257, None, 5),    # ViT-L: 4 tiles and one key, S in registers
    (64, 272, None, 5),    # 4 tiles and 16 keys: the last that fits
    (64, 273, None, 0),    # one key more: two passes
    (64, 320, None, 0),
    (64, 640, None, 0),    # the blocked TPU kernel's length
    (64, 640, 250, 4),     # only the live keys count
    (64, 256, None, 4),
    (64, 65, None, 2),
    (64, 32, None, 1),     # the Q-Former's queries
    (64, 1, None, 1),
    (128, 16, None, 0),    # D = 128: always two passes
    (128, 640, None, 0),
    (8, 64, None, -1),     # the query decoder's heads: mma.sync
    (16, 64, None, -1),
    (32, 257, None, -1),   # MiniLM's and the large query decoder's
])
def test_flash_plan_routes_head_dims_and_lengths(d, t, valid_len, kernel):
    from embodied_captioning_tpu_torch.kernels.flash_attention import (
        flash_plan)

    assert flash_plan(d, t, valid_len) == kernel


@pytest.mark.parametrize("d", [4, 48, 96, 256])
def test_flash_plan_raises_on_head_dims_without_a_kernel(d):
    from embodied_captioning_tpu_torch.kernels.flash_attention import (
        flash_plan)

    with pytest.raises(ValueError, match="head dims"):
        flash_plan(d, 64)


def test_trace_script_marks_every_phase_of_the_decode_mlp():
    """scripts/trace_decode_mlp.py times the phases at the kernel's
    `// mark N:` lines: they are numbered 0, 1, ... and each becomes a
    store in the instrumented source."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts/trace_decode_mlp.py"
    spec = importlib.util.spec_from_file_location("trace_decode_mlp", path)
    tr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tr)
    phases = tr.phases(tr.SOURCE.read_text())
    assert sorted(phases) == list(range(11))
    src = tr.instrumented_source()
    assert not tr.MARK.search(src)
    for n in phases:
        assert f"TR({n});" in src


@pytest.mark.parametrize("rows,d,f", [(0, 768, 3072), (4, 48, 192),
                                      (4, 768, 3000), (4, 768, 8192),
                                      (4, 2048, 8192)])
def test_mlp_plan_raises_on_unsupported_shapes(rows, d, f):
    from embodied_captioning_tpu_torch.kernels.decode_attention import (
        mlp_plan)

    with pytest.raises(ValueError):
        mlp_plan(rows, d, f)


# ---------------------------------------------------------------------------
# the self block's launch plan (host-side logic of its split-K products)
# ---------------------------------------------------------------------------

# (D, heads) of the presets' decoders: tiny, base, large
_BLOCK_WIDTHS = [(64, 2), (512, 8), (768, 12)]


@pytest.mark.parametrize("rows", [1, 16, 17, 64])
@pytest.mark.parametrize("d,heads", _BLOCK_WIDTHS)
def test_self_block_plan_covers_the_decode_shapes(rows, d, heads):
    from embodied_captioning_tpu_torch.kernels.decode_attention import (
        MLP_COLS, MLP_MAX_SLICE, MLP_MAX_SPLITS, QKV_COLS, SM_COUNT,
        self_block_plan)

    s_qkv, s_out = self_block_plan(rows, d, heads, 30)
    # both products contract over D: q/k/v has 3D output columns in tiles
    # of 64, out D in tiles of 32
    for n, cols, s in ((3 * d, QKV_COLS, s_qkv), (d, MLP_COLS, s_out)):
        assert 1 <= s <= MLP_MAX_SPLITS and s & (s - 1) == 0
        assert d % (16 * s) == 0 and d // s <= MLP_MAX_SLICE
        assert n % cols == 0
        # the fewest splits that give every SM a block, where D allows it
        assert n // cols * s >= SM_COUNT or s == MLP_MAX_SPLITS or (
            d % (32 * s))
        assert s == 1 or n // cols * (s // 2) < SM_COUNT
    if (d, heads) == (768, 12):
        # the serving shape: 144 q/k/v blocks, 192 out blocks
        assert (s_qkv, s_out) == (4, 8)


@pytest.mark.parametrize("rows,d,heads", [(0, 768, 12), (4, 48, 2),
                                          (4, 96, 2), (4, 768, 5),
                                          (4, 768, 0), (4, 8192, 8)])
def test_self_block_plan_raises_on_unsupported_shapes(rows, d, heads):
    from embodied_captioning_tpu_torch.kernels.decode_attention import (
        self_block_plan)

    with pytest.raises(ValueError):
        self_block_plan(rows, d, heads, 30)


# ---------------------------------------------------------------------------
# the cross block's launch plan (host-side logic of its split-K products)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [1, 16, 17, 64])
@pytest.mark.parametrize("d,heads", _BLOCK_WIDTHS)
def test_cross_block_plan_covers_the_decode_shapes(rows, d, heads):
    from embodied_captioning_tpu_torch.kernels.decode_attention import (
        MLP_COLS, MLP_MAX_SLICE, MLP_MAX_SPLITS, SM_COUNT, cross_block_plan)

    s_q, s_out = cross_block_plan(rows, d, heads)
    # both products contract over D into D output columns in tiles of 32
    for s in (s_q, s_out):
        assert 1 <= s <= MLP_MAX_SPLITS and s & (s - 1) == 0
        assert d % (16 * s) == 0 and d // s <= MLP_MAX_SLICE
        # the fewest splits that give every SM a block, where D allows it
        assert d // MLP_COLS * s >= SM_COUNT or s == MLP_MAX_SPLITS or (
            d % (32 * s))
        assert s == 1 or d // MLP_COLS * (s // 2) < SM_COUNT
    if (d, heads) == (768, 12):
        # the serving shape: 192 blocks in each product
        assert (s_q, s_out) == (8, 8)


@pytest.mark.parametrize("rows,d,heads", [
    (0, 768, 12),     # no rows
    (4, 48, 2),       # not a multiple of 32
    (4, 40, 5),       # heads 8 wide, not a multiple of 32
    (4, 64, 16),      # heads 4 wide
    (4, 768, 128),    # heads 6 wide
    (4, 768, 5),      # heads do not divide D
    (4, 768, 0),      # no heads
    (4, 8192, 8)])    # heads 1024 wide, slices beyond 512
def test_cross_block_plan_raises_on_unsupported_shapes(rows, d, heads):
    from embodied_captioning_tpu_torch.kernels.decode_attention import (
        cross_block_plan)

    with pytest.raises(ValueError):
        cross_block_plan(rows, d, heads)


# ---------------------------------------------------------------------------
# the wrappers' launch path: what it refuses, as far as it is Python
# ---------------------------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card: it takes a wrapper's
    kernel branch, whose checks are Python, up to the launch."""

    @property
    def is_cuda(self):
        return True


def _on_card(x):
    return torch.Tensor._make_subclass(_OnCard, x)


def _layernorm_refusals():
    x = torch.randn(4, 32).bfloat16()
    g, b = torch.ones(32), torch.zeros(32)
    c = _on_card
    return {
        "x float16": ((c(x.half()), c(g), c(b)),
                      {"out_dtype": torch.bfloat16}, TypeError),
        "g float64": ((c(x), c(g.double()), c(b)), {}, TypeError),
        "g too short": ((c(x), c(torch.ones(31)), c(b)), {}, ValueError),
        "b strided": ((c(x), c(g), c(torch.zeros(32, 2)[:, 0])), {},
                      ValueError),
        "g on the CPU": ((c(x), g, c(b)), {}, ValueError),
        "out float16": ((c(x), c(g), c(b)), {"out_dtype": torch.float16},
                        TypeError),
    }


def test_cross_kernels_refuse_heads_they_do_not_take_before_launching():
    # heads 4 wide: the kernel branch raises before any launch (the route
    # in `block` never sends them there)
    c = _on_card
    q = c(torch.zeros(2, 16, 4).bfloat16())
    kt, v = c(torch.zeros(2, 16, 4, 8).bfloat16()), c(
        torch.zeros(2, 16, 8, 4).bfloat16())
    before = dict(K.launches)
    with pytest.raises(ValueError, match="decode_cross_attention takes"):
        K.decode_cross_attention(q, kt, v)
    x, g, b = c(torch.zeros(2, 64).bfloat16()), c(torch.ones(64)), c(
        torch.zeros(64))
    w, s_, bias = c(torch.zeros(64, 64).bfloat16()), c(torch.ones(64)), c(
        torch.zeros(64))
    with pytest.raises(ValueError, match="decode_cross_block takes"):
        K.decode_cross_block(x, g, b, w, s_, bias, w, s_, bias, kt, v,
                             heads=16)
    assert K.launches == before


def test_self_attention_refuses_heads_it_does_not_take_before_launching():
    # heads 4 and 12 wide, and a cache whose scores do not fit a block's
    # shared memory: the kernel branch raises before any launch (`mha`
    # never sends them there)
    c = _on_card
    before = dict(K.launches)
    for dh, tt in ((4, 8), (12, 8), (64, 50881)):
        q = c(torch.zeros(1, 1, dh).bfloat16())
        kt = c(torch.zeros(1, 1, dh, tt).bfloat16())
        v = c(torch.zeros(1, tt, 1, dh).bfloat16())
        with pytest.raises(ValueError, match="decode_self_attention takes"):
            K.decode_self_attention(q, kt, v, 0)
    assert K.launches == before


@pytest.mark.parametrize("case", list(_layernorm_refusals()))
def test_layernorm_kernel_branch_refuses_what_it_refused(case):
    args, kwargs, exc = _layernorm_refusals()[case]
    before = dict(K.launches)
    for _ in range(2):  # refused again: a failed check is not remembered
        with pytest.raises(exc):
            K.layernorm(*args, **kwargs)
    assert K.launches == before


def test_check_param_checks_each_tensor_once_and_again_after_a_change():
    from embodied_captioning_tpu_torch.kernels import _lib

    f32 = (torch.float32,)
    g = _on_card(torch.ones(32))
    _lib.check_param(g, "g", f32, (32,), align=4)
    key = id(g)
    assert _lib._valid_params[key][0]() is g
    # another check of the same tensor runs in full, and refuses
    with pytest.raises(ValueError, match="shape"):
        _lib.check_param(g, "g", f32, (16,), align=4)
    _lib.check_param(g, "g", f32, (32,), align=4)
    # a new storage is checked again
    g.set_(torch.ones(31))
    with pytest.raises(ValueError, match="shape"):
        _lib.check_param(g, "g", f32, (32,), align=4)
    _lib.check_param(g, "g", f32, (31,), align=4)
    # the record goes with the tensor
    del g
    assert key not in _lib._valid_params


# ---------------------------------------------------------------------------
# the LayerNorm backward's launch plan (kernels/layernorm.bwd_plan)
# ---------------------------------------------------------------------------

# (rows, d, x bytes, dy bytes): chip_smoke.py phase 2's shapes (the
# fine-tune step's at batch 8, the perceive batch's, the sentence encoder's,
# a bf16 x with a float32 cotangent), then tiny ones
_BWD_SHAPES = [(2056, 1024, 2, 2), (2048, 1024, 2, 2), (616, 768, 2, 2),
               (16448, 1024, 2, 2), (64, 768, 2, 2), (4096, 384, 4, 4),
               (64, 768, 2, 4), (37, 100, 2, 2), (37, 100, 4, 4),
               (1, 64, 2, 2), (3, 64, 4, 4), (8, 64, 2, 2), (65, 64, 4, 4),
               (257, 512, 2, 2), (9, 8, 2, 2), (1, 1024, 4, 2)]
# the fine-tune step's shapes, whose partials the plan keeps within 0.15
# of the function's own bytes
_FINETUNE_SHAPES = _BWD_SHAPES[:3]


def _bwd_rows_of_each_unit(plan, rows):
    """The rows each warp (register path: the grid's warps split the rows
    evenly into contiguous runs) or row group (generic path) takes, as the
    kernels index them."""
    if plan.route == "registers":
        w = plan.blocks * plan.warps
        return [range(u * rows // w, (u + 1) * rows // w) for u in range(w)]
    return [range(min(rows, u * plan.rows_per),
                  min(rows, (u + 1) * plan.rows_per))
            for u in range(plan.blocks)]


@pytest.mark.parametrize("slots", [30, 16, 1])
@pytest.mark.parametrize("rows,d,xb,dyb", _BWD_SHAPES)
def test_layernorm_bwd_plan_covers_every_row_once(rows, d, xb, dyb, slots):
    from embodied_captioning_tpu_torch.kernels.layernorm import (
        BWD_CLUSTER, BWD_FEW_WARPS, BWD_WARPS, bwd_plan)

    plan = bwd_plan(rows, d, xb, dyb, slots, 16)
    units = _bwd_rows_of_each_unit(plan, rows)
    taken = [r for unit in units for r in unit]
    assert sorted(taken) == list(range(rows))
    assert max(len(u) for u in units) == plan.rows_per
    # the scratch the kernels' contract asks for: a float32 row of dg and
    # db for each cluster past one (registers) or each row group (generic),
    # summed by a second launch
    if plan.route == "registers":
        assert plan.blocks % plan.cluster == 0
        clusters = plan.blocks // plan.cluster
        assert plan.partials == (clusters if clusters > 1 else 0)
        assert plan.launches == (2 if clusters > 1 else 1)
        if rows <= 8 * BWD_WARPS:
            # a few rows: one cluster of up to 16 blocks of 4 warps, a row
            # a warp
            assert (plan.warps, plan.cluster, plan.rows_per) == (
                BWD_FEW_WARPS, plan.blocks, 1)
            assert plan.blocks <= 16 and (plan.blocks - 1) * 4 < rows
        else:
            assert plan.warps == BWD_WARPS
            assert plan.cluster == BWD_CLUSTER
            # a persistent grid: every block resident at once; a row a
            # warp until the card is full, no cluster without rows
            assert clusters <= max(1, slots)
            assert (plan.rows_per == 1
                    or plan.blocks == max(1, slots) * BWD_CLUSTER)
            assert (plan.blocks - plan.cluster) * BWD_WARPS < rows
    else:
        assert plan.cluster == 1 and plan.partials == plan.blocks
        assert 1 <= plan.blocks <= min(rows, 256) and plan.launches == 2
        assert all(len(u) for u in units)
    assert plan.scratch_floats >= 2 * plan.partials * d


@pytest.mark.parametrize("rows,d,xb,dyb", _FINETUNE_SHAPES)
def test_layernorm_bwd_plan_keeps_partials_small_at_the_finetune_shapes(
        rows, d, xb, dyb):
    from embodied_captioning_tpu_torch.kernels.layernorm import bwd_plan

    for slots in (33, 30, 16):
        plan = bwd_plan(rows, d, xb, dyb, slots, 16)
        assert plan.route == "registers"
        # the partials written and read again, against x and dy read, dx
        # written, g read and dg, db written
        own = rows * d * (2 * xb + dyb) + 3 * d * 4
        assert 2 * 2 * plan.partials * d * 4 <= 0.15 * own


@pytest.mark.parametrize("rows,d,xb,dyb,aligned,route", [
    (37, 100, 2, 2, True, "generic"),      # d not a multiple of 8
    (4, 1032, 2, 2, True, "generic"),      # wider than 1024
    (4, 4096, 4, 4, True, "generic"),
    (64, 1024, 4, 4, True, "generic"),     # float32 x and dy past 768
    (64, 1024, 2, 2, False, "generic"),    # a pointer off 16 bytes
    (64, 768, 4, 4, True, "registers"),
    (64, 1024, 2, 4, True, "registers"),
    (64, 8, 4, 4, True, "registers"),
    (64, 1024, 2, 2, True, "registers")])
def test_layernorm_bwd_plan_routes(rows, d, xb, dyb, aligned, route):
    from embodied_captioning_tpu_torch.kernels.layernorm import (
        bwd_plan, bwd_vectors)

    plan = bwd_plan(rows, d, xb, dyb, 33, 16, aligned)
    assert plan.route == route
    assert plan.vectors == (bwd_vectors(d, xb, dyb) if aligned else 0)
    if route == "registers":
        assert plan.vectors == -(-d // 256)


@pytest.mark.parametrize("widest", [16, 12, 8, 1])
@pytest.mark.parametrize("rows", [1, 8, 33, 48, 64])
def test_layernorm_bwd_plan_caps_the_few_rows_cluster(rows, widest):
    # a few rows take one cluster of 4-warp blocks only as wide as the
    # card launches (`bwd_room`'s `widest`: fewer SMs free to a GPC, as on
    # a partitioned card); wider, they take the blocks of 8 warps in
    # clusters of BWD_CLUSTER that every row count past 64 takes, and
    # still cover every row once
    from embodied_captioning_tpu_torch.kernels.layernorm import (
        BWD_CLUSTER, BWD_FEW_WARPS, BWD_WARPS, bwd_plan)

    plan = bwd_plan(rows, 768, 2, 2, 30, widest)
    few = -(-rows // BWD_FEW_WARPS)
    assert plan.route == "registers" and plan.cluster <= max(widest, 4)
    if few <= widest:
        assert (plan.blocks, plan.cluster, plan.warps) == (few, few,
                                                           BWD_FEW_WARPS)
    else:
        assert (plan.cluster, plan.warps) == (BWD_CLUSTER, BWD_WARPS)
    units = _bwd_rows_of_each_unit(plan, rows)
    assert sorted(r for u in units for r in u) == list(range(rows))
    clusters = plan.blocks // plan.cluster
    assert plan.launches == (2 if clusters > 1 else 1)
    assert plan.scratch_floats >= 2 * plan.partials * 768
