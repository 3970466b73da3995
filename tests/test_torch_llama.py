"""The port's LLaMA against the JAX package's, on the tiny preset with the
same weights (carried by ``from_jax_params``) and the same numpy inputs.

Tolerance: f32 on the CPU on both sides, differing in summation order
through two layers and the lm_head: 1e-4 absolute on logits of O(1).
"""

import dataclasses

import flax.linen as nn
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from interactvlm_tpu.config import llama_tiny as jax_llama_tiny
from interactvlm_tpu.models.llama import (
    LlamaForCausalLM as JaxLlama,
    init_kv_cache as jax_init_kv_cache,
)
from interactvlm_tpu_torch.config import llama_tiny
from interactvlm_tpu_torch.models.llama import (
    LlamaForCausalLM,
    RMSNorm,
    apply_rope,
    init_kv_cache,
    rope_cos_sin,
)
from interactvlm_tpu_torch.utils.weights import from_jax_params

TOL = 1e-4


def numpy_tree(params):
    return jax.tree.map(np.asarray, nn.meta.unbox(params))


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    ids = jnp.asarray(rng.integers(1, 500, (2, 12)), jnp.int32)
    jm = JaxLlama(jax_llama_tiny())
    params = jm.init(jax.random.PRNGKey(0), ids)
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    tm.load_state_dict(from_jax_params(numpy_tree(params)["params"]))
    return jm, params, tm


def test_state_dict_keys_are_hf_names(models):
    _, _, tm = models
    keys = set(tm.state_dict())
    assert "model.layers.1.self_attn.q_proj.weight" in keys
    assert "model.layers.0.post_attention_layernorm.weight" in keys
    assert {"model.embed_tokens.weight", "model.norm.weight",
            "lm_head.weight"} <= keys


@pytest.mark.parametrize("ragged", [False, True])
def test_logits_match_jax(models, ragged):
    jm, params, tm = models
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 500, (2, 12))
    mask = np.ones((2, 12), np.int32)
    if ragged:
        mask[1, 7:] = 0
    want_logits, want_h = jm.apply(params, jnp.asarray(ids, jnp.int32),
                                   jnp.asarray(mask))
    got_logits, got_h = tm(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got_h.detach().numpy(), np.asarray(want_h),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got_logits.detach().numpy(),
                               np.asarray(want_logits), atol=TOL, rtol=TOL)


def test_prefill_then_decode_match_jax(models):
    """Fresh-cache prefill of a right-padded chunk, then dense-cache decode
    steps (the -1e9 masked cache form with the key-validity row)."""
    jm, params, tm = models
    cfg = jm.config
    rng = np.random.default_rng(2)
    B, L, T = 2, 10, 3
    emb = rng.standard_normal((B, L, cfg.hidden_size)).astype(np.float32)
    mask = np.ones((B, L), np.int32)
    mask[0, 6:] = 0
    pos = np.broadcast_to(np.arange(L), (B, L))
    jc = jax_init_kv_cache(cfg, B, L + T)
    tc = init_kv_cache(llama_tiny(), B, L + T, "cpu")
    jl, jh, jc = jm.apply(params, jnp.asarray(emb), jnp.asarray(pos),
                          jnp.asarray(mask), jc, True,
                          method=JaxLlama.forward_embeds)
    with torch.inference_mode():
        tl, th, tc = tm.forward_embeds(torch.from_numpy(emb),
                                       torch.from_numpy(pos.copy()),
                                       torch.from_numpy(mask), tc, True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    p = mask.sum(1)
    for t in range(T):
        e = rng.standard_normal((B, 1, cfg.hidden_size)).astype(np.float32)
        pp = (p + t)[:, None]
        jl, jh, jc = jm.apply(params, jnp.asarray(e), jnp.asarray(pp),
                              caches=jc, method=JaxLlama.forward_embeds)
        with torch.inference_mode():
            tl, th, tc = tm.forward_embeds(torch.from_numpy(e),
                                           torch.from_numpy(pp), caches=tc)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
    assert tc[0]["index"] == L + T
    np.testing.assert_array_equal(tc[0]["valid"].numpy(),
                                  np.asarray(jc[0]["valid"]))


def test_rmsnorm_and_rope_match_jax():
    from interactvlm_tpu.models.llama import (
        RMSNorm as JaxRMSNorm,
        apply_rope as jax_apply_rope,
        rope_cos_sin as jax_rope_cos_sin,
    )

    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 5))
    jc, js = jax_rope_cos_sin(jnp.asarray(pos), 16, 10000.0)
    tc, ts = rope_cos_sin(torch.from_numpy(pos), 16, 10000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(
        apply_rope(torch.from_numpy(x), tc, ts).numpy(),
        np.asarray(jax_apply_rope(jnp.asarray(x), jc, js)), atol=1e-5)
    h = rng.standard_normal((3, 16)).astype(np.float32) * 5
    w = rng.standard_normal(16).astype(np.float32)
    want = JaxRMSNorm(1e-6).apply({"params": {"weight": w}}, jnp.asarray(h))
    norm = RMSNorm(16, 1e-6, torch.float32, "cpu")
    norm.weight.data = torch.from_numpy(w)
    np.testing.assert_allclose(norm(torch.from_numpy(h)).detach().numpy(),
                               np.asarray(want), atol=1e-5)


def test_padded_vocab_columns_are_masked():
    cfg = dataclasses.replace(llama_tiny(), vocab_size=500)  # padded to 512
    tm = LlamaForCausalLM(cfg, device="cpu")
    logits = tm.logits(torch.randn(2, 3, cfg.hidden_size))
    assert (logits[..., 500:] == -1e30).all()
    assert torch.isfinite(logits[..., :500]).all()
