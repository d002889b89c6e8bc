"""Which fused kernels a one-token decode step takes (`decode_route`),
sublayer by sublayer: each kernel where its plan takes the shape, the
route of separate calls elsewhere, as the JAX package's `maybe_decode_*`
dispatchers fall back to XLA where their kernels refuse a shape."""

import pytest
import torch

from embodied_captioning_tpu_torch.kernels import decode_attention as DA
from embodied_captioning_tpu_torch.models import common as TC

# (D, heads, MLP width) of the presets' decoders: tiny, base, large
_PRESETS = [(64, 2, 256), (512, 8, 2048), (768, 12, 3072)]
# the longest self-attention cache a preset decodes: captions of at most
# 77 tokens
_CACHE = 77


@pytest.mark.parametrize("rows", [1, 16, 17, 64])
@pytest.mark.parametrize("d,heads,f", _PRESETS)
def test_every_sublayer_fuses_at_the_presets(d, heads, f, rows):
    assert DA.mlp_fits(rows, d, f)
    assert DA.self_block_fits(rows, d, heads, _CACHE)
    assert DA.cross_block_fits(rows, d, heads)
    assert DA.cross_attention_fits(d // heads)
    assert TC.decode_route(rows, d, heads, f, _CACHE, True) == (
        TC.DecodeRoute(self_block=True, cross_block=True, mlp=True))
    # the route of separate calls keeps the fused MLP
    assert TC.decode_route(rows, d, heads, f, _CACHE, False) == (
        TC.DecodeRoute(self_block=False, cross_block=False, mlp=True))


@pytest.mark.parametrize("t,fits", [(77, True), (839, True), (840, False),
                                    (4096, False)])
def test_the_self_block_takes_caches_its_shared_memory_holds(t, fits):
    # the large preset's width, 12 heads of 64: the self block's attention
    # launch holds a head's whole K and V cache in shared memory, 276 bytes
    # a position (csrc/decode_block.cu, `self_attn_smem`), so 839 positions
    # fit in 232,448 bytes and 840 do not. Beyond that the sublayer runs as
    # separate calls, whose `decode_self_attention` holds only f32 scores;
    # the cross block and the MLP stay fused
    assert DA.self_attn_smem(64, t) == 768 + 276 * t
    assert DA.self_block_fits(64, 768, 12, t) == fits
    if not fits:
        with pytest.raises(ValueError, match="shared memory"):
            DA.self_block_plan(64, 768, 12, t)
    assert TC.decode_route(64, 768, 12, 3072, t, True) == TC.DecodeRoute(
        self_block=fits, cross_block=True, mlp=True)


def test_a_width_the_self_block_refuses_falls_back_alone():
    # 96 wide, 2 heads of 48: the q/k/v product takes widths a multiple of
    # 64; the cross block (tiles of 32 columns) and the MLP take it
    assert not DA.self_block_fits(3, 96, 2, 8)
    with pytest.raises(ValueError):
        DA.self_block_plan(3, 96, 2, 8)
    assert DA.cross_block_plan(3, 96, 2) == (2, 2)
    assert TC.decode_route(3, 96, 2, 384, 8, True) == TC.DecodeRoute(
        self_block=False, cross_block=True, mlp=True)


def test_heads_four_wide_fall_back_in_both_blocks():
    # 64 wide, 16 heads of 4: the attention launches take heads a multiple
    # of 8 wide (the JAX dispatchers refuse them too); the MLP fuses
    assert not DA.self_block_fits(3, 64, 16, 8)
    assert not DA.cross_block_fits(3, 64, 16)
    assert not DA.cross_attention_fits(4)
    assert TC.decode_route(3, 64, 16, 256, 8, True) == TC.DecodeRoute(
        self_block=False, cross_block=False, mlp=True)


def test_an_mlp_wider_than_its_layernorm_launch_falls_back():
    # D = 1056: a multiple of 32, but the MLP's LayerNorm launch holds a
    # row of at most 1024 in registers
    assert not DA.mlp_fits(4, 1056, 4224)
    with pytest.raises(ValueError):
        DA.mlp_plan(4, 1056, 4224)
    assert not TC.decode_route(4, 1056, 8, 4224, 8, True).mlp


@pytest.mark.parametrize("dh", [8, 32, 48, 64, 128, 256, 512, 1024, 4096])
def test_cross_attention_takes_heads_the_reference_takes(dh):
    # the JAX dispatcher gates the cross attention on a head width that is
    # a multiple of 8 and nothing else: no limit on the cross keys
    assert DA.cross_attention_fits(dh)
    assert not DA.cross_attention_fits(dh + 4)
    # four heads: past dh 1024 the q product's slices of 4 dh / 8 are
    # longer than 512
    assert DA.cross_block_fits(4, 4 * dh, 4) == (dh <= 1024)


@pytest.mark.parametrize("dh,fits", [(4, False), (12, False), (8, True),
                                     (64, True)])
def test_self_attention_takes_heads_the_reference_takes(dh, fits):
    # the JAX dispatcher gates the decode self-attention on a head width
    # that is a multiple of 8; at the caches a preset decodes the gate is
    # the whole of it
    assert DA.self_attention_fits(dh, _CACHE) == fits
    assert DA.self_attention_fits(dh, 1) == fits


@pytest.mark.parametrize("t,fits", [(839, True), (840, True), (50880, True),
                                    (50881, False)])
def test_the_self_attention_takes_caches_its_scores_fit(t, fits):
    # 12 heads of 64: up to 839 positions the head's whole cache fits the
    # whole-head kernel's shared memory (`self_attn_smem`, as in the self
    # block); beyond it the tiled kernel keeps two tiles of 96 keys and 4
    # bytes of score a position (csrc/attention.cuh, `self_tiled_smem`), so
    # 50880 positions fit in 232,448 bytes and 50881 do not
    assert DA.self_attn_tile_keys(64) == 96
    assert DA.self_attn_tiled_smem(64, t) == 28928 + 4 * t
    assert (DA.self_attn_smem(64, t) <= DA.MAX_SMEM) == (t <= 839)
    assert DA.self_attention_fits(64, t) == fits
    # heads wider than the tiled kernel's PV takes: the whole-head kernel's
    # caches only
    assert DA.self_attention_fits(520, 8)
    assert not DA.self_attention_fits(520, 200)


def test_cross_attention_refuses_heads_beyond_its_widest():
    assert not DA.cross_attention_fits(DA.CROSS_MAX_DH + 8)
    assert not DA.cross_attention_fits(0)


def _one_token_block(d, heads, int8):
    """A multimodal block, a one-token step's input, a cache and cross
    K/V at width d with `heads` heads, from a seeded generator."""
    from embodied_captioning_tpu_torch.models.quantize import (
        quantize_params)

    g = torch.Generator().manual_seed(d + heads)
    p = TC.block_init(g, d, 4.0, "cpu", cross_dim=d)
    if int8:
        p = quantize_params(p, min_size=0)
    dh = d // heads
    x = torch.randn(3, 1, d, generator=g).bfloat16()
    cache = TC.KVCache(torch.randn(3, heads, dh, 8, generator=g).bfloat16(),
                       torch.randn(3, 8, heads, dh, generator=g).bfloat16(),
                       2)
    img = torch.randn(3, 12, d, generator=g).bfloat16()
    return p, x, cache, TC.precompute_kv(p["xattn"], img, heads)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("decode_blocks", [True, False])
@pytest.mark.parametrize("d,heads", [(64, 2), (96, 2), (64, 16)])
def test_block_calls_the_kernels_its_route_names(d, heads, decode_blocks,
                                                 int8, monkeypatch):
    p, x, cache, ckv = _one_token_block(d, heads, int8)
    route = TC.decode_route(3, d, heads, 4 * d, cache.k.shape[-1],
                            decode_blocks)
    called = []
    for name in ("decode_self_block", "decode_cross_block", "decode_mlp",
                 "decode_self_attention", "decode_cross_attention"):
        fn = getattr(TC, name)
        monkeypatch.setattr(TC, name, lambda *a, _f=fn, _n=name, **k: (
            called.append(_n), _f(*a, **k))[1])
    out, _ = TC.block(p, x, heads, cache=cache, cross_kv=ckv,
                      decode_blocks=decode_blocks)
    want = (["decode_self_block"] if route.self_block
            else ["decode_self_attention"]
            if DA.self_attention_fits(d // heads, cache.k.shape[-1]) else [])
    if route.cross_block:
        want.append("decode_cross_block")
    elif DA.cross_attention_fits(d // heads):
        want.append("decode_cross_attention")
    want.append("decode_mlp")
    assert called == want
    assert out.shape == x.shape and torch.isfinite(out.float()).all()


@pytest.mark.parametrize("t,self_block", [(1566, True), (1567, False)])
def test_a_cache_too_long_for_the_self_block_runs_as_separate_calls(
        t, self_block, monkeypatch):
    # 64 wide, 2 heads of 32: the self block holds 148 bytes a position,
    # so 1566 positions fit its shared memory and 1567 do not. Past that
    # the self-attention sublayer runs as LayerNorm, projections and
    # `decode_self_attention`, and gives the block's answer: outputs
    # within 1/16 (bf16 of |x + y| < 8; the block keeps q in f32), the
    # cache's new entries within 1/32 (|k|, |v| < 4)
    p, x, _, ckv = _one_token_block(64, 2, False)
    g = torch.Generator().manual_seed(t)
    pos = t - 60
    kc = torch.randn(3, 2, 32, t, generator=g).bfloat16()
    vc = torch.randn(3, t, 2, 32, generator=g).bfloat16()
    called = []
    for name in ("decode_self_block", "decode_self_attention"):
        fn = getattr(TC, name)
        monkeypatch.setattr(TC, name, lambda *a, _f=fn, _n=name, **k: (
            called.append(_n), _f(*a, **k))[1])
    assert DA.self_block_fits(3, 64, 2, t) == self_block
    out, oc = TC.block(p, x, 2, cache=TC.KVCache(kc.clone(), vc.clone(), pos),
                       cross_kv=ckv)
    assert called == ["decode_self_block" if self_block
                      else "decode_self_attention"]
    assert oc.index == pos + 1
    # the self block's twin on the same step, then the same cross and MLP
    # sublayers
    ref_x, ref_c = TC._decode_self_block(
        p["attn"], p["ln1"], x, TC.KVCache(kc.clone(), vc.clone(), pos), 2)
    ref = TC._decode_cross_block(p["xattn"], p["ln_x"], ref_x, ckv, 2)
    ref = TC._decode_mlp_block(p["mlp"], p["ln2"], ref)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=1 / 16, rtol=0)
    torch.testing.assert_close(oc.k.float(), ref_c.k.float(), atol=1 / 32,
                               rtol=0)
    torch.testing.assert_close(oc.v.float(), ref_c.v.float(), atol=1 / 32,
                               rtol=0)
