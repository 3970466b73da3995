"""The port's LLaVA layer and greedy generation against the JAX package's,
on the tiny presets with the same weights and numpy inputs.

Tolerance: f32 on the CPU on both sides (CLIP, projector and LLaMA differ
only in summation order): 1e-4 absolute on hidden states and logits;
generated ids must be identical.
"""

import flax.linen as nn
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from interactvlm_tpu.config import clip_tiny as jax_clip_tiny
from interactvlm_tpu.config import llama_tiny as jax_llama_tiny
from interactvlm_tpu.models import llava as jax_llava
from interactvlm_tpu.models.clip_vit import CLIPVisionTower as JaxCLIP
from interactvlm_tpu.models.generate import greedy_generate as jax_generate
from interactvlm_tpu_torch.config import clip_tiny, llama_tiny
from interactvlm_tpu_torch.models import llava
from interactvlm_tpu_torch.models.clip_vit import CLIPVisionTower
from interactvlm_tpu_torch.models.generate import greedy_generate
from interactvlm_tpu_torch.utils.weights import from_jax_params

TOL = 1e-4


def numpy_tree(params):
    return jax.tree.map(np.asarray, nn.meta.unbox(params))


def make_inputs(seed=0, B=2, L=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, 500, (B, L))
    ids[:, 1] = -200  # IMAGE_TOKEN_INDEX
    mask = np.ones((B, L), np.int32)
    mask[1, 8:] = 0
    px = rng.standard_normal((B, 28, 28, 3)).astype(np.float32)
    return ids, mask, px


@pytest.fixture(scope="module")
def models():
    ids, _, px = make_inputs()
    jm = jax_llava.LlavaModel(jax_llama_tiny(), jax_clip_tiny())
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(ids), jnp.asarray(px))
    tm = llava.LlavaModel(llama_tiny(), clip_tiny(), device="cpu")
    tm.load_state_dict(from_jax_params(numpy_tree(params)["params"]))
    return jm, params, tm


def test_clip_tower_matches_jax():
    rng = np.random.default_rng(3)
    px = rng.standard_normal((2, 28, 28, 3)).astype(np.float32)
    jm = JaxCLIP(jax_clip_tiny())
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(px))
    tm = CLIPVisionTower(clip_tiny(), device="cpu")
    tm.load_state_dict(from_jax_params(numpy_tree(params)["params"]))
    assert tm.vision_model.pre_layrnorm.eps == 1e-5
    want = jm.apply(params, jnp.asarray(px))
    got = tm(torch.from_numpy(px))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)


def test_splice_helpers_match_jax():
    ids, mask, _ = make_inputs(4)
    ids[0, 1] = 7  # a row without an image keeps a masked dummy tail
    jidx, jpatch, jpos, jhas = jax_llava.splice_indices(jnp.asarray(ids), 4)
    tidx, tpatch, tpos, thas = llava.splice_indices(torch.from_numpy(ids), 4)
    for a, b in ((tidx, jidx), (tpatch, jpatch), (tpos, jpos), (thas, jhas)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    vals = np.arange(2 * 12 * 3, dtype=np.float32).reshape(2, 12, 3)
    pv = -np.ones((2, 4, 3), np.float32)
    np.testing.assert_array_equal(
        llava.splice_sequences(torch.from_numpy(vals), torch.from_numpy(pv),
                               tidx, tpatch).numpy(),
        np.asarray(jax_llava.splice_sequences(jnp.asarray(vals),
                                              jnp.asarray(pv), jidx, jpatch)))
    np.testing.assert_array_equal(
        llava.splice_scalar(torch.from_numpy(mask), tidx, tpatch, 1).numpy(),
        np.asarray(jax_llava.splice_scalar(jnp.asarray(mask), jidx, jpatch, 1)))
    sp = np.asarray([[1, 5, 9, 500, 2], [500, 3, 500, 4, 4]])
    np.testing.assert_array_equal(
        llava.seg_predictor_mask(torch.from_numpy(sp), [500]).numpy(),
        np.asarray(jax_llava.seg_predictor_mask(jnp.asarray(sp), [500])))


def test_prefill_and_decode_step_match_jax(models):
    jm, params, tm = models
    ids, mask, px = make_inputs(5)
    Lp = 12 - 1 + 4
    out_j = jm.apply(params, jnp.asarray(ids), jnp.asarray(px), Lp + 2,
                     attn_mask=jnp.asarray(mask),
                     method=jax_llava.LlavaModel.prefill)
    with torch.inference_mode():
        out_t = tm.prefill(torch.from_numpy(ids), torch.from_numpy(px), Lp + 2,
                           torch.from_numpy(mask))
    for i in (0, 1, 5):  # last logits, prompt hidden, last hidden
        np.testing.assert_allclose(out_t[i].numpy(), np.asarray(out_j[i]),
                                   atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(out_t[3].numpy(), np.asarray(out_j[3]))
    np.testing.assert_array_equal(out_t[4].numpy(), np.asarray(out_j[4]))
    tok = np.asarray([3, 9], np.int32)
    pos = np.asarray(out_j[4])
    lj, hj, _ = jm.apply(params, jnp.asarray(tok), jnp.asarray(pos), out_j[2],
                         method=jax_llava.LlavaModel.decode_step)
    with torch.inference_mode():
        lt, ht, _ = tm.decode_step(torch.from_numpy(tok),
                                   torch.from_numpy(pos.copy()), out_t[2])
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("eos_id", [-1, None])
def test_greedy_generate_matches_jax(models, eos_id):
    """Identical ids; close step hiddens. ``eos_id=None`` picks a token the
    model emits, so the eos handling (eos after stop, zeroed hiddens) runs."""
    jm, params, tm = models
    ids, mask, px = make_inputs(6)
    T = 5
    ref = jax_generate(jm, params, jnp.asarray(ids), jnp.asarray(px),
                       max_new_tokens=T, eos_id=-1, attn_mask=jnp.asarray(mask))
    if eos_id is None:
        eos_id = int(np.asarray(ref["generated_ids"])[0, 1])
        ref = jax_generate(jm, params, jnp.asarray(ids), jnp.asarray(px),
                           max_new_tokens=T, eos_id=eos_id,
                           attn_mask=jnp.asarray(mask))
    got = greedy_generate(tm, torch.from_numpy(ids), torch.from_numpy(px),
                          max_new_tokens=T, eos_id=eos_id,
                          attn_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got["generated_ids"].numpy(),
                                  np.asarray(ref["generated_ids"]))
    np.testing.assert_allclose(got["step_hidden"].numpy(),
                               np.asarray(ref["step_hidden"]), atol=TOL,
                               rtol=TOL)
    np.testing.assert_array_equal(got["prompt_len"].numpy(),
                                  np.asarray(ref["prompt_len"]))
