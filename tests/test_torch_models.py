"""The port's ViT image encoder and sentence encoder against the JAX
package's (tiny widths), with the JAX kernel path on."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from embodied_captioning_tpu.config import CaptionerConfig as JCapCfg
from embodied_captioning_tpu.config import SentenceEncoderConfig as JSeCfg
from embodied_captioning_tpu.models import common as JC
from embodied_captioning_tpu.models import sbert as JSB
from embodied_captioning_tpu.models import vit as JV
from embodied_captioning_tpu_torch.config import CaptionerConfig as TCapCfg
from embodied_captioning_tpu_torch.config import (
    SentenceEncoderConfig as TSeCfg,
)
from embodied_captioning_tpu_torch.models import sbert as TSB
from embodied_captioning_tpu_torch.models import vit as TV
from embodied_captioning_tpu_torch.params import from_jax
from torch_parity import jax_kernel_path, np32, t


@pytest.mark.parametrize("coca_exact", [False, True])
def test_encode_image(coca_exact):
    # native ordering (transformer -> ln_post -> pool -> pool_ln) and the
    # CoCa-exact ordering (LayerNorm on queries and context before the
    # pool, ln_post after it, pooled[:, 1:] to the decoder)
    jc, tc = JCapCfg.tiny().vision, TCapCfg.tiny().vision
    p = JV.init_vit(jax.random.PRNGKey(0), jc)
    if coca_exact:
        p["pool_ln_q"] = JC.layernorm_init(jc.width)
        p["pool_ln_k"] = JC.layernorm_init(jc.width)
    rng = np.random.default_rng(0)
    imgs = jnp.asarray((rng.random((3, 80, 80, 3)) * 255).astype(np.uint8))
    with jax_kernel_path():
        ref_pool, ref_g = JV.encode_image(p, imgs, jc)
    pool, g = TV.encode_image(from_jax(p, "cpu"), t(imgs), tc)
    assert tuple(pool.shape) == ref_pool.shape
    # bf16 pooled tokens after 2 blocks: 2 ulps at |x| < 4; the global
    # embedding is f32 and L2-normalised
    np.testing.assert_allclose(np32(pool), np32(ref_pool), atol=2 ** -5,
                               rtol=0)
    np.testing.assert_allclose(np32(g), np32(ref_g), atol=1e-2, rtol=0)


@pytest.mark.parametrize("post_ln", [False, True])
def test_encode_tokens(post_ln):
    jc = dataclasses.replace(JSeCfg.tiny(), post_ln=post_ln)
    tc = dataclasses.replace(TSeCfg.tiny(), post_ln=post_ln)
    p = JSB.init_sentence_encoder(jax.random.PRNGKey(1), jc)
    rng = np.random.default_rng(1)
    tokens = rng.integers(3, 1024, (4, jc.max_len)).astype(np.int32)
    tokens[:, 9:] = 0  # PAD tail, masked and left out of the mean
    tokens[3, 4:] = 0
    with jax_kernel_path():
        ref = JSB.encode_tokens(p, jnp.asarray(tokens), jc)
    out = TSB.encode_tokens(from_jax(p, "cpu"), t(tokens), tc)
    cos = np.sum(np32(out) * np32(ref), 1)  # both L2-normalised
    assert cos.min() > 0.9999, cos
