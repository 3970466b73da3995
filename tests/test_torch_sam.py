"""The port's SAM against the JAX package's, on the tiny preset with the same
weights (carried by ``from_jax_params``) and the same numpy inputs: the
image encoder (windowed and global blocks, with and without window padding),
the prompt encoder, the two-way transformer and the mask decoder; plus the
ConvTranspose tap flip and the LayerNorm eps values.

Tolerance: f32 on the CPU on both sides, differing in summation order:
1e-4 absolute on O(1) activations and mask logits.
"""

import dataclasses

import flax.linen as nn
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from interactvlm_tpu.config import sam_tiny as jax_sam_tiny
from interactvlm_tpu.models.sam.sam import Sam as JaxSam
from interactvlm_tpu.models.sam.transformer import (
    TwoWayTransformer as JaxTwoWay,
)
from interactvlm_tpu_torch.config import sam_tiny
from interactvlm_tpu_torch.models.sam.sam import Sam
from interactvlm_tpu_torch.utils.weights import _conv_transpose, from_jax_params

TOL = 1e-4


def numpy_tree(params):
    return jax.tree.map(np.asarray, nn.meta.unbox(params))


def build(window_size):
    rng = np.random.default_rng(window_size)
    jcfg = dataclasses.replace(jax_sam_tiny(), window_size=window_size)
    tcfg = dataclasses.replace(sam_tiny(), window_size=window_size)
    px = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    txt = rng.standard_normal((2, 3, 32)).astype(np.float32)
    jm = JaxSam(jcfg)
    params = jm.init(jax.random.PRNGKey(window_size), jnp.asarray(px),
                     jnp.asarray(txt))
    # rel-pos tables init to zero: give them values so the bias is exercised
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: (x + 0.3 * jax.random.normal(jax.random.PRNGKey(7), x.shape)
                      if "rel_pos" in jax.tree_util.keystr(p) else x), params)
    tm = Sam(tcfg, device="cpu")
    missing, unexpected = tm.load_state_dict(
        from_jax_params(numpy_tree(params)["params"]), strict=False)
    assert not unexpected
    assert all(k.startswith("prompt_encoder.mask_downscaling.") for k in missing)
    return jm, params, tm, px, txt


@pytest.fixture(scope="module", params=[2, 3], ids=["window2", "window3-padded"])
def sam(request):
    return build(request.param)


def test_encoder_matches_jax(sam):
    jm, params, tm, px, _ = sam
    want = jm.apply(params, jnp.asarray(px), method=JaxSam.encode_image)
    with torch.inference_mode():
        got = tm.encode_image(torch.from_numpy(px))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_prompt_encoder_matches_jax(sam):
    jm, params, tm, _, txt = sam
    (js, jd), jpe = jm.apply(
        params, jnp.asarray(txt),
        method=lambda m, t: (m.prompt_encoder(text_embeds=t),
                             m.prompt_encoder.get_dense_pe()))
    with torch.inference_mode():
        ts, td = tm.prompt_encoder(torch.from_numpy(txt))
        tpe = tm.prompt_encoder.get_dense_pe()
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(td.detach().numpy(), np.asarray(jd))
    np.testing.assert_allclose(tpe.numpy(), np.asarray(jpe), atol=1e-5)


def test_two_way_transformer_matches_jax(sam):
    jm, params, tm, _, txt = sam
    cfg = tm.config
    rng = np.random.default_rng(11)
    src = rng.standard_normal((2, 4, 4, 32)).astype(np.float32)
    pe = rng.standard_normal((2, 4, 4, 32)).astype(np.float32)
    jt = JaxTwoWay(cfg.decoder_depth, cfg.prompt_embed_dim,
                   cfg.decoder_num_heads, cfg.decoder_mlp_dim)
    jq, jk = jt.apply(
        {"params": params["params"]["mask_decoder"]["transformer"]},
        jnp.asarray(src), jnp.asarray(pe), jnp.asarray(txt))
    with torch.inference_mode():
        tq, tk = tm.mask_decoder.transformer(
            torch.from_numpy(src), torch.from_numpy(pe), torch.from_numpy(txt))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=TOL, rtol=TOL)


def test_decode_masks_matches_jax(sam):
    jm, params, tm, px, txt = sam
    emb = jm.apply(params, jnp.asarray(px), method=JaxSam.encode_image)
    jmask, jiou = jm.apply(params, emb, jnp.asarray(txt),
                           method=JaxSam.decode_masks)
    with torch.inference_mode():
        tmask, tiou = tm.decode_masks(torch.from_numpy(np.array(emb)),
                                      torch.from_numpy(txt))
    assert tmask.dtype == torch.float32 and tmask.shape == (2, 1, 16, 16)
    np.testing.assert_allclose(tmask.numpy(), np.asarray(jmask), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(tiou.numpy(), np.asarray(jiou), atol=TOL,
                               rtol=TOL)


def test_conv_transpose_tap_flip():
    """A flax ConvTranspose kernel carried into torch's (in, out, kh, kw)
    layout with its taps flipped back computes the same upsampling."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 5, 5, 6)).astype(np.float32)
    conv = nn.ConvTranspose(4, (2, 2), strides=(2, 2))
    params = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(
        lambda a: a + jax.random.normal(jax.random.PRNGKey(1), a.shape), params)
    want = conv.apply(params, jnp.asarray(x))
    sd = {}
    _conv_transpose(numpy_tree(params)["params"], "", sd)
    tconv = torch.nn.ConvTranspose2d(6, 4, 2, stride=2)
    tconv.load_state_dict(sd)
    got = tconv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    # the flip matters: without it the taps land on the wrong pixels
    assert not np.allclose(sd["weight"].numpy(),
                           sd["weight"].numpy()[:, :, ::-1, ::-1])


def test_layernorm_eps_values(sam):
    """SAM's encoder, neck, decoder upscaling and two-way transformer norms
    all use 1e-6 (the JAX package's value); at a small activation scale the
    1e-5 torch default would visibly differ from flax's LayerNorm."""
    _, _, tm, _, _ = sam
    eps = {n: m.eps for n, m in tm.named_modules()
           if isinstance(m, torch.nn.LayerNorm)}
    assert eps and set(eps.values()) == {1e-6}, eps
    rng = np.random.default_rng(13)
    h = (rng.standard_normal((3, 32)) * 3e-3).astype(np.float32)
    want = nn.LayerNorm().apply(
        {"params": {"scale": np.ones(32, np.float32),
                    "bias": np.zeros(32, np.float32)}}, jnp.asarray(h))
    norm = torch.nn.LayerNorm(
        32, eps=tm.mask_decoder.transformer.norm_final_attn.eps)
    with torch.no_grad():
        got = norm(torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
    loose = torch.nn.functional.layer_norm(torch.from_numpy(h), (32,),
                                           eps=1e-5).numpy()
    assert np.abs(loose - np.asarray(want)).max() > 1e-2
