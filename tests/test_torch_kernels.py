"""The port's kernel plain versions against the JAX package's Pallas kernels
(interpret mode on the CPU), and the wrappers' device dispatch."""

import math

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


def test_decode_self_attention_plain_mid_cache():
    # f32 outputs; tolerance 1e-5 covers summation order only
    rng = np.random.default_rng(2)
    b, h, dh, tt = 3, 2, 16, 12
    q = _bf16(rng, b, h, dh)
    kt = _bf16(rng, b, h, dh, tt)
    v = _bf16(rng, b, tt, h, dh)
    for pos in (0, 5, tt - 1):
        ref = JDA.decode_self_attention(q, kt, v, jnp.int32(pos),
                                        interpret=True)
        out = K.decode_self_attention(t(q), t(kt), t(v), pos)
        assert out.dtype == torch.float32
        np.testing.assert_allclose(np32(out), np32(ref), atol=1e-5,
                                   rtol=1e-5)


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
