"""The port's transformer building blocks against the JAX package's, with
the JAX kernel path on (ECAP_USE_PALLAS=1, Pallas in interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_captioning_tpu.models import common as JC
from embodied_captioning_tpu.models.quantize import quantize_params as jqp
from embodied_captioning_tpu_torch.models import common as TC
from embodied_captioning_tpu_torch.params import from_jax
from torch_parity import jax_kernel_path, np32, t

D, H = 64, 2


def _block_params(seed: int, cross: bool, int8: bool, d: int = D,
                  heads: int = H):
    p = JC.block_init(jax.random.PRNGKey(seed), d, heads, 4.0,
                      cross_dim=d if cross else None)
    return jqp(p, min_size=0) if int8 else p


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_layernorm_with_near_constant_row(dtype):
    # bf16: one-pass variance with the m1^2*3e-7 floor (row 0 is constant
    # and engages it); f32: two-pass. Tolerance: one ulp of the out dtype.
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 3, D)) * 3 + 1
    x[0, 0] = 100.0
    jx = jnp.asarray(x, dtype)
    p = {"g": jnp.asarray(1 + 0.1 * rng.standard_normal(D), jnp.float32),
         "b": jnp.asarray(0.1 * rng.standard_normal(D), jnp.float32)}
    ref = JC.layernorm(p, jx)
    out = TC.layernorm(from_jax(p, "cpu"), t(jx))
    assert out.dtype == t(jx).dtype
    tol = 2 ** -7 * 8 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(np32(out), np32(ref), atol=tol, rtol=0)
    assert np.all(np.isfinite(np32(out)))


def test_dense_int8_weights():
    # bf16 output, f32 accumulation over bf16-dequantized int8 weights;
    # tolerance one bf16 ulp at |y| < 4
    rng = np.random.default_rng(1)
    p = jqp({"w": jnp.asarray(rng.standard_normal((D, 128)) / 8, jnp.float32),
             "b": jnp.asarray(rng.standard_normal(128) * .1, jnp.float32)})
    x = jnp.asarray(rng.standard_normal((5, D)), jnp.float32)
    ref = JC.dense(p, x)
    out = TC.dense(from_jax(p, "cpu"), t(x))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(np32(out), np32(ref), atol=2 ** -6, rtol=0)


def test_mha_uncached_through_flash():
    rng = np.random.default_rng(2)
    p = JC.mha_init(jax.random.PRNGKey(0), D, H)
    x = jnp.asarray(rng.standard_normal((2, 70, D)), jnp.bfloat16)
    with jax_kernel_path():
        ref, _ = JC.mha(p, x, H)
    out, _ = TC.mha(from_jax(p, "cpu"), t(x), H)
    # bf16 [2,70,64] through q/k/v/o products and attention: 2 ulps at 1
    np.testing.assert_allclose(np32(out), np32(ref), atol=2 ** -6, rtol=0)


def test_mha_masked_and_cross_plain_attention():
    # masked self-attention (the sentence encoder's) and cross-attention
    # over a feature map (the attentional pooler's) take the plain path
    rng = np.random.default_rng(3)
    p = JC.mha_init(jax.random.PRNGKey(1), D, H)
    x = jnp.asarray(rng.standard_normal((2, 9, D)), jnp.float32)
    kv = jnp.asarray(rng.standard_normal((2, 13, D)), jnp.bfloat16)
    mask = jnp.asarray(rng.random((2, 1, 1, 9)) > 0.3).at[:, :, :, 0].set(
        True)
    tp = from_jax(p, "cpu")
    with jax_kernel_path():
        ref_m, _ = JC.mha(p, x, H, mask=mask)
        ref_c, _ = JC.mha(p, x, H, kv=kv)
    out_m, _ = TC.mha(tp, t(x), H, mask=t(mask))
    out_c, _ = TC.mha(tp, t(x), H, kv=t(kv))
    np.testing.assert_allclose(np32(out_m), np32(ref_m), atol=2 ** -6, rtol=0)
    np.testing.assert_allclose(np32(out_c), np32(ref_c), atol=2 ** -6, rtol=0)


def test_mha_cached_mid_cache():
    rng = np.random.default_rng(4)
    b, tmax, pos = 3, 10, 4
    p = JC.mha_init(jax.random.PRNGKey(2), D, H)
    k0 = jnp.asarray(rng.standard_normal((b, H, D // H, tmax)), jnp.bfloat16)
    v0 = jnp.asarray(rng.standard_normal((b, tmax, H, D // H)), jnp.bfloat16)
    x = jnp.asarray(rng.standard_normal((b, 1, D)), jnp.bfloat16)
    with jax_kernel_path():
        ref, rc = JC.mha(p, x, H, cache=JC.KVCache(k0, v0, jnp.int32(pos)))
    tcache = TC.KVCache(t(k0), t(v0), pos)
    out, oc = TC.mha(from_jax(p, "cpu"), t(x), H, cache=tcache)
    assert oc.index == int(rc.index) == pos + 1
    np.testing.assert_array_equal(np32(oc.k), np32(rc.k))
    np.testing.assert_array_equal(np32(oc.v), np32(rc.v))
    np.testing.assert_allclose(np32(out), np32(ref), atol=2 ** -6, rtol=0)


@pytest.mark.parametrize("int8", [False, True])
def test_precompute_kv_layouts(int8):
    rng = np.random.default_rng(5)
    p = _block_params(3, cross=True, int8=int8)["xattn"]
    src = jnp.asarray(rng.standard_normal((2, 11, D)), jnp.bfloat16)
    with jax_kernel_path():
        ref = JC.precompute_kv(p, src, H)
    out = TC.precompute_kv(from_jax(p, "cpu"), t(src), H)
    assert len(out) == len(ref)  # (kt, v) or (kt, kt_scale, v, v_scale)
    for a, b in zip(out, ref):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(np32(a), np32(b), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("int8", [False, True])
def test_block_decode_step(int8):
    # one cached decode step through a multimodal block on the route of
    # separate calls (decode_blocks=False; the JAX package without
    # ECAP_PALLAS_BLOCKS): self-attention kernel, cross-attention kernel
    # over precomputed K/V, fused decode MLP
    rng = np.random.default_rng(6)
    b, tmax, pos = 3, 8, 2
    p = _block_params(4, cross=True, int8=int8)
    img = jnp.asarray(rng.standard_normal((b, 11, D)), jnp.bfloat16)
    k0 = jnp.asarray(rng.standard_normal((b, H, D // H, tmax)), jnp.bfloat16)
    v0 = jnp.asarray(rng.standard_normal((b, tmax, H, D // H)), jnp.bfloat16)
    x = jnp.asarray(rng.standard_normal((b, 1, D)), jnp.bfloat16)
    with jax_kernel_path():
        ckv = JC.precompute_kv(p["xattn"], img, H)
        ref, rc = JC.block(p, x, H, cache=JC.KVCache(k0, v0, jnp.int32(pos)),
                           cross_kv=ckv)
    tp = from_jax(p, "cpu")
    out, oc = TC.block(tp, t(x), H, cache=TC.KVCache(t(k0), t(v0), pos),
                       cross_kv=TC.precompute_kv(tp["xattn"], t(img), H),
                       decode_blocks=False)
    assert out.dtype == torch.bfloat16 and oc.index == pos + 1
    np.testing.assert_allclose(np32(oc.k), np32(rc.k), atol=2 ** -6, rtol=0)
    # residual stream |x| < 8: two bf16 ulps there
    np.testing.assert_allclose(np32(out), np32(ref), atol=2 ** -4, rtol=0)


# (width, heads): the tiny preset's, where every sublayer fuses; a width
# the self block does not take (not a multiple of 64), whose cross block
# and MLP still fuse; heads 4 wide, which neither block kernel nor either
# decode attention kernel takes (the JAX dispatchers refuse them too)
_ROUTE_SHAPES = {
    (64, 2): ["decode_self_block", "decode_cross_block", "decode_mlp"],
    (96, 2): ["decode_self_attention", "decode_cross_block", "decode_mlp"],
    (64, 16): ["decode_mlp"],
}


@pytest.mark.parametrize("d,heads,int8,pos", [
    pytest.param(d, heads, int8, pos, id=("" if (d, heads) == (D, H) else
                                          f"{d}x{heads}-") + f"{int8}-{pos}")
    for d, heads in _ROUTE_SHAPES for int8 in (False, True) for pos in (0, 2)])
def test_block_decode_step_block_route(d, heads, int8, pos, monkeypatch):
    # the same step on the default route (decode_blocks=True) against the
    # JAX block with ECAP_USE_PALLAS=1 and ECAP_PALLAS_BLOCKS=1: one
    # self-block kernel, one cross-block kernel, the fused decode MLP, each
    # where its kernel takes the shape (`decode_route`), the route of
    # separate calls elsewhere. `block` is not jitted, so the variables are
    # read on each call.
    from embodied_captioning_tpu_torch import kernels as K

    rng = np.random.default_rng(8)
    b, tmax = 3, 8
    p = _block_params(6, cross=True, int8=int8, d=d, heads=heads)
    img = jnp.asarray(rng.standard_normal((b, 11, d)), jnp.bfloat16)
    k0 = jnp.asarray(rng.standard_normal((b, heads, d // heads, tmax)),
                     jnp.bfloat16)
    v0 = jnp.asarray(rng.standard_normal((b, tmax, heads, d // heads)),
                     jnp.bfloat16)
    x = jnp.asarray(rng.standard_normal((b, 1, d)), jnp.bfloat16)
    with jax_kernel_path(blocks=True):
        ckv = JC.precompute_kv(p["xattn"], img, heads)
        ref, rc = JC.block(p, x, heads,
                           cache=JC.KVCache(k0, v0, jnp.int32(pos)),
                           cross_kv=ckv)
    tp = from_jax(p, "cpu")
    called = []
    for name in ("decode_self_block", "decode_cross_block", "decode_mlp",
                 "decode_self_attention", "decode_cross_attention"):
        fn = getattr(TC, name)
        monkeypatch.setattr(TC, name, lambda *a, _f=fn, _n=name, **k: (
            called.append(_n), _f(*a, **k))[1])
    tcache = TC.KVCache(t(k0), t(v0), pos)
    out, oc = TC.block(tp, t(x), heads, cache=tcache,
                       cross_kv=TC.precompute_kv(tp["xattn"], t(img), heads))
    assert called == _ROUTE_SHAPES[d, heads]
    assert out.dtype == torch.bfloat16 and oc.index == pos + 1
    assert oc.k is tcache.k and oc.v is tcache.v       # written in place
    # the cache: the current token's k, v (|k| < 4: one bf16 ulp) at `pos`
    np.testing.assert_allclose(np32(oc.k), np32(rc.k), atol=2 ** -6, rtol=0)
    np.testing.assert_allclose(np32(oc.v), np32(rc.v), atol=2 ** -6, rtol=0)
    if "decode_self_block" in called:
        # the same arithmetic as the JAX self block; at 96 wide the JAX
        # package fuses the sublayer and the port does not (its q/k/v
        # product takes widths a multiple of 64), so int8 weights are
        # scaled before the product there and a k rounds differently
        assert np.mean(np32(oc.k) == np32(rc.k)) > 0.99
    # residual stream |x| < 8: two bf16 ulps there
    np.testing.assert_allclose(np32(out), np32(ref), atol=2 ** -4, rtol=0)
    # a masked or multi-token call does not take the block kernels
    called.clear()
    TC.block(tp, t(x).repeat(1, 2, 1), heads,
             cache=TC.KVCache(t(k0), t(v0), pos))
    assert not called
    assert K.launches["decode_self_block"] == 0


@pytest.mark.parametrize("decode_blocks", [True, False])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("pos", [0, 5, 7])
def test_a_step_with_heads_four_wide_takes_the_reference_route(
        pos, int8, decode_blocks, monkeypatch):
    # 64 wide, 16 heads of 4: the JAX dispatchers refuse both block kernels
    # and both decode attention kernels (they take heads a multiple of 8
    # wide), so the reference runs both attentions as XLA ops with bf16
    # scores and probabilities, then the fused decode MLP. The port takes
    # the same route on either of its decode routes: plain ops with the
    # causal cache mask, no decode attention kernel. Tolerance: one bf16
    # ulp of the residual stream (|x| < 8: 2^-5), half the block-route
    # test's, with at least 99% of the outputs bit-equal (all of them on
    # these seeds when the test was written); the cache exactly.
    rng = np.random.default_rng(10 + pos)
    b, tmax, d, heads = 3, 8, 64, 16
    p = _block_params(6, cross=True, int8=int8, d=d, heads=heads)
    img = jnp.asarray(rng.standard_normal((b, 11, d)), jnp.bfloat16)
    k0 = jnp.asarray(rng.standard_normal((b, heads, d // heads, tmax)),
                     jnp.bfloat16)
    v0 = jnp.asarray(rng.standard_normal((b, tmax, heads, d // heads)),
                     jnp.bfloat16)
    x = jnp.asarray(rng.standard_normal((b, 1, d)), jnp.bfloat16)
    with jax_kernel_path(blocks=decode_blocks):
        ckv = JC.precompute_kv(p["xattn"], img, heads)
        ref, rc = JC.block(p, x, heads,
                           cache=JC.KVCache(k0, v0, jnp.int32(pos)),
                           cross_kv=ckv)
    tp = from_jax(p, "cpu")
    called = []
    for name in ("decode_self_block", "decode_cross_block", "decode_mlp",
                 "decode_self_attention", "decode_cross_attention"):
        fn = getattr(TC, name)
        monkeypatch.setattr(TC, name, lambda *a, _f=fn, _n=name, **k: (
            called.append(_n), _f(*a, **k))[1])
    out, oc = TC.block(tp, t(x), heads, cache=TC.KVCache(t(k0), t(v0), pos),
                       cross_kv=TC.precompute_kv(tp["xattn"], t(img), heads),
                       decode_blocks=decode_blocks)
    assert called == ["decode_mlp"]
    np.testing.assert_array_equal(np32(oc.k), np32(rc.k))
    np.testing.assert_array_equal(np32(oc.v), np32(rc.v))
    np.testing.assert_allclose(np32(out), np32(ref), atol=2 ** -5, rtol=0)
    assert np.mean(np32(out) == np32(ref)) > 0.99


@pytest.mark.parametrize("int8", [False, True])
def test_mha_cached_multi_token(int8):
    # four new tokens against a part-filled cache: written at index ..
    # index+3, query i sees keys <= index + i (plain ops in both packages);
    # then the same over precomputed cross K/V (int8 K/V with int8 weights)
    rng = np.random.default_rng(9)
    b, tmax, pos, tq = 3, 12, 5, 4
    p = _block_params(7, cross=True, int8=int8)
    k0 = jnp.asarray(rng.standard_normal((b, H, D // H, tmax)), jnp.bfloat16)
    v0 = jnp.asarray(rng.standard_normal((b, tmax, H, D // H)), jnp.bfloat16)
    x = jnp.asarray(rng.standard_normal((b, tq, D)), jnp.bfloat16)
    img = jnp.asarray(rng.standard_normal((b, 11, D)), jnp.bfloat16)
    with jax_kernel_path():
        ref, rc = JC.mha(p["attn"], x, H,
                         cache=JC.KVCache(k0, v0, jnp.int32(pos)))
        ckv = JC.precompute_kv(p["xattn"], img, H)
        ref_x, _ = JC.mha(p["xattn"], x, H, kv_precomputed=ckv)
    tp = from_jax(p, "cpu")
    out, oc = TC.mha(tp["attn"], t(x), H, cache=TC.KVCache(t(k0), t(v0), pos))
    assert oc.index == int(rc.index) == pos + tq
    np.testing.assert_array_equal(np32(oc.k), np32(rc.k))
    np.testing.assert_array_equal(np32(oc.v), np32(rc.v))
    np.testing.assert_allclose(np32(out), np32(ref), atol=2 ** -6, rtol=0)
    # causal inside the new block: the first query's output equals a
    # one-token call at the same index
    one, _ = TC.mha(tp["attn"], t(x)[:, :1], H,
                    cache=TC.KVCache(t(k0), t(v0), pos))
    np.testing.assert_allclose(np32(out[:, :1]), np32(one), atol=2 ** -6,
                               rtol=0)
    out_x, _ = TC.mha(tp["xattn"], t(x), H,
                      kv_precomputed=TC.precompute_kv(tp["xattn"], t(img), H))
    np.testing.assert_allclose(np32(out_x), np32(ref_x), atol=2 ** -6, rtol=0)


def test_block_post_ln_with_mask():
    rng = np.random.default_rng(7)
    p = _block_params(5, cross=False, int8=False)
    x = jnp.asarray(rng.standard_normal((2, 9, D)), jnp.float32)
    mask = jnp.ones((2, 1, 1, 9), bool).at[1, :, :, 6:].set(False)
    with jax_kernel_path():
        ref = JC.block_post_ln(p, x, H, mask=mask)
    out = TC.block_post_ln(from_jax(p, "cpu"), t(x), H, mask=t(mask))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(np32(out), np32(ref), atol=2e-2, rtol=0)
