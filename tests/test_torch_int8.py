"""The port's int8 serving path against the JAX package's, on the CPU with
tiny presets: int8 LLaMA weights with the int8 KV cache, the int8 SAM
encoder with either GELU, and ``evaluate_batch(kv_cache="int8")`` with both.
Both packages run the same converted weights (the JAX converters'
output, carried by ``from_jax_params``) on the same numpy inputs.

On the CPU both run the JAX package's CPU path: the int8 composition
(quantize each row of x, an exact int32 product, rescale), then bias and
GELU. Tolerance: f32 on both sides; the float parts differ in summation
order, so an activation can sit an ulp away from its twin, and where that
straddles a rounding tie of the per-row quantization, one int8 value of x
moves by one step. Logits and hidden states are held to 1e-4, encoder
features and mask logits to 1e-4 of their largest magnitude, contacts to
1e-5; generated ids must be identical.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interactvlm_tpu.config import interactvlm_tiny as jax_tiny
from interactvlm_tpu.config import llama_tiny as jax_llama_tiny
from interactvlm_tpu.config import sam_tiny as jax_sam_tiny
from interactvlm_tpu.eval.evaluate import evaluate_batch as jax_evaluate
from interactvlm_tpu.models.interactvlm import InteractVLM as JaxIVLM
from interactvlm_tpu.models.llama import LlamaForCausalLM as JaxLlama
from interactvlm_tpu.models.sam.sam import Sam as JaxSam
from interactvlm_tpu.ops.quant import init_kv_cache_int8 as jax_init_int8
from interactvlm_tpu.utils.testing import greedy_decode_lm, make_synthetic_batch
from interactvlm_tpu.utils.weights import (
    int8_sam_encoder_params,
    int8_serving_params,
)
from interactvlm_tpu_torch.config import (
    interactvlm_tiny,
    llama_tiny,
    sam_tiny,
)
from interactvlm_tpu_torch.eval.evaluate import evaluate_batch
from interactvlm_tpu_torch.models.interactvlm import InteractVLM
from interactvlm_tpu_torch.models.layers import (
    Int4Linear,
    Int8Linear,
    Int8LoraLinear,
)
from interactvlm_tpu_torch.models.llama import LlamaForCausalLM
from interactvlm_tpu_torch.models.sam.image_encoder import ImageEncoderViT
from interactvlm_tpu_torch.models.sam.sam import Sam
from interactvlm_tpu_torch.ops.quant import init_kv_cache_int8
from interactvlm_tpu_torch.utils.weights import from_jax_params, init_params

TOL = 1e-4
MASK, T = 32, 4


def numpy_tree(params):
    return jax.tree.map(np.array, nn.meta.unbox(params))


# ------------------------------------------------------------------ LLaMA
@pytest.fixture(scope="module", params=[4, 2], ids=["mha", "gqa"])
def llama(request):
    """A dense JAX LLaMA converted by ``int8_serving_params``; ``gqa`` has
    two kv heads for four query heads."""
    kv = request.param
    rng = np.random.default_rng(0)
    ids = jnp.asarray(rng.integers(1, 500, (2, 12)), jnp.int32)
    jdense = dataclasses.replace(jax_llama_tiny(), num_kv_heads=kv)
    tree = int8_serving_params(numpy_tree(
        JaxLlama(jdense).init(jax.random.PRNGKey(0), ids))["params"])
    jcfg = dataclasses.replace(jdense, weights_int8=True)
    tm = LlamaForCausalLM(dataclasses.replace(
        llama_tiny(weights_int8=True), num_kv_heads=kv), device="cpu")
    tm.load_state_dict(from_jax_params(tree))
    return JaxLlama(jcfg), {"params": tree}, tm


def test_llama_int8_layers_and_keys(llama):
    _, _, tm = llama
    sd = tm.state_dict()
    q = sd["model.layers.0.self_attn.q_proj.weight"]
    assert q.dtype == torch.int8 and q.shape == (64, 64)
    assert sd["model.layers.1.mlp.down_proj.weight_scale"].shape == (64,)
    assert isinstance(tm.lm_head, Int8Linear)
    assert tm.model.embed_tokens.weight.dtype == torch.float32


@pytest.mark.parametrize("ragged", [False, True])
def test_llama_int8_logits_match_jax(llama, ragged):
    jm, params, tm = llama
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 500, (2, 12))
    mask = np.ones((2, 12), np.int32)
    if ragged:
        mask[1, 7:] = 0
    want_logits, want_h = jm.apply(params, jnp.asarray(ids, jnp.int32),
                                   jnp.asarray(mask))
    with torch.inference_mode():
        got_logits, got_h = tm(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=TOL, rtol=TOL)


def _port_greedy(tm, ids, caches, total):
    """``greedy_decode_lm`` of the JAX package's test utilities, in torch."""
    B, L0 = ids.shape
    pos = torch.arange(L0)[None].expand(B, L0)
    logits, _, caches = tm.forward_embeds(tm.embed(ids), pos, None, caches)
    tok = logits[:, -1].argmax(-1)
    out = [tok]
    for t in range(L0, total):
        logits, _, caches = tm.forward_embeds(
            tm.embed(tok[:, None]), torch.full((B, 1), t), None, caches)
        tok = logits[:, -1].argmax(-1)
        out.append(tok)
    return torch.stack(out, 1), caches


def test_llama_int8_greedy_ids_with_int8_cache_match_jax(llama):
    jm, params, tm = llama
    rng = np.random.default_rng(2)
    ids = rng.integers(1, 500, (2, 6))
    want = greedy_decode_lm(jm, params, jnp.asarray(ids, jnp.int32),
                            jax_init_int8(jm.config, 2, 16), total_steps=16)
    with torch.inference_mode():
        got, caches = _port_greedy(
            tm, torch.from_numpy(ids),
            init_kv_cache_int8(tm.config, 2, 16, "cpu"), 16)
    np.testing.assert_array_equal(got.numpy(), want)
    assert caches[0]["index"] == 16 and caches[0]["k"].dtype == torch.int8
    assert (caches[1]["valid"] == 1).all()


def test_qlora_and_int4_models_build_with_their_layers():
    """QLoRA (LoRA over the int8 base) and int4 build: the layer types,
    parameter names and dtypes of the JAX package's ``LoraDense(int8=True)``
    and ``Int4Dense``; LoRA over the bf16/f32 base as before."""
    q = LlamaForCausalLM(llama_tiny(weights_int8=True, lora_rank=8),
                         device="cpu")
    attn = q.model.layers[0].self_attn
    assert isinstance(attn.q_proj, Int8LoraLinear)
    assert isinstance(attn.v_proj, Int8LoraLinear)
    assert type(attn.k_proj) is Int8Linear
    sd = q.state_dict()
    p = "model.layers.0.self_attn.v_proj."
    assert sd[p + "weight"].dtype == torch.int8
    assert sd[p + "weight_scale"].dtype == torch.float32
    assert sd[p + "lora_A.weight"].shape == (8, 64)
    assert sd[p + "lora_B.weight"].shape == (64, 8)
    assert sd["lm_head.weight"].dtype == torch.float32  # trains
    i4 = LlamaForCausalLM(llama_tiny(weights_int4=True), device="cpu")
    sd = i4.state_dict()
    assert sd["model.layers.1.mlp.up_proj.weight_q4"].shape == (128, 32)
    assert sd["model.layers.1.mlp.up_proj.weight_q4"].dtype == torch.int8
    assert sd["model.layers.1.mlp.up_proj.weight_rf"].shape == (64,)
    assert sd["lm_head.weight_scale"].dtype == torch.float32
    assert isinstance(i4.lm_head, Int4Linear)
    m = LlamaForCausalLM(llama_tiny(lora_rank=8), device="cpu")
    assert m.model.layers[0].self_attn.q_proj.lora_A.weight.shape == (8, 64)


def test_int4_linear_and_raw_kernel_wrappers_raise_under_grad():
    """The int4 layer serves only, and kernel 6's wrappers called directly
    have no backward: under grad they raise rather than cut the gradient.
    The int8 layer takes the straight-through gradient instead."""
    from interactvlm_tpu_torch.ops import int8_matmul as Q

    x = torch.randn(3, 64, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        Int4Linear(64, 16, dtype=torch.float32)(x)
    w = torch.ones(8, 64, dtype=torch.int8)
    for call in (lambda: Q.int8_matmul_fused(x, w, torch.ones(8)),
                 lambda: Q.quantize_rows(x),
                 lambda: Q.int8_gemm(w[:3], x[:, :1], w, torch.ones(8))):
        with pytest.raises(RuntimeError, match="no backward"):
            call()
    lin = Int8Linear(64, 8, dtype=torch.float32)
    lin.weight.data.fill_(1)
    lin(x).sum().backward()
    assert x.grad is not None and lin.weight.grad is None


def test_init_params_draws_int8_weights_the_jax_way():
    tm = init_params(LlamaForCausalLM(llama_tiny(weights_int8=True),
                                      device="cpu"),
                     torch.Generator().manual_seed(0))
    w = tm.model.layers[0].mlp.down_proj
    assert w.weight.dtype == torch.int8
    assert int(w.weight.min()) >= -127 and int(w.weight.max()) <= 127
    assert int(w.weight.min()) < -100 and int(w.weight.max()) > 100
    torch.testing.assert_close(
        w.weight_scale, torch.full((64,), 1.0 / (127.0 * 128 ** 0.5)))


# ------------------------------------------------------------------- SAM
@pytest.fixture(scope="module", params=[False, True], ids=["gelu", "tanh"])
def sam(request):
    """A dense tiny JAX SAM whose encoder ``int8_sam_encoder_params``
    converts; the rel-pos tables get values so the bias is exercised."""
    approx = request.param
    rng = np.random.default_rng(5)
    px = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    txt = rng.standard_normal((2, 3, 32)).astype(np.float32)
    params = JaxSam(jax_sam_tiny(gelu_approx=approx)).init(
        jax.random.PRNGKey(3), jnp.asarray(px), jnp.asarray(txt))
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: (x + 0.3 * jax.random.normal(jax.random.PRNGKey(7),
                                                  x.shape)
                      if "rel_pos" in jax.tree_util.keystr(p) else x), params)
    tree = numpy_tree(params)["params"]
    tree["image_encoder"] = int8_sam_encoder_params(tree["image_encoder"])
    jm = JaxSam(jax_sam_tiny(gelu_approx=approx, weights_int8=True))
    tm = Sam(sam_tiny(gelu_approx=approx, weights_int8=True), device="cpu")
    missing, unexpected = tm.load_state_dict(from_jax_params(tree),
                                             strict=False)
    assert not unexpected
    assert all(k.startswith("prompt_encoder.mask_downscaling.")
               for k in missing)
    return jm, {"params": tree}, tm, px


def test_sam_int8_encoder_matches_jax(sam):
    jm, params, tm, px = sam
    enc = tm.image_encoder
    assert isinstance(enc, ImageEncoderViT)
    lin1 = enc.blocks[0].mlp.lin1
    assert isinstance(lin1, Int8Linear) and lin1.bias.dtype == torch.float32
    assert lin1.activation == ("gelu_tanh" if tm.config.gelu_approx else "gelu")
    want = np.asarray(jm.apply(params, jnp.asarray(px),
                               method=JaxSam.encode_image))
    with torch.inference_mode():
        got = tm.encode_image(torch.from_numpy(px)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max(),
                               rtol=0)


# -------------------------------------------------------------- pipeline
def force_seg_token(tree, seg):
    """As in ``test_torch_pipeline.py``: every row emits [SEG]."""
    p = tree["params"]["llava"]
    p["lm"]["model"]["embed_tokens"]["embedding"][:, 0] = 30.0
    p["mm_projector"]["bias"][0] = 30.0
    p["lm"]["lm_head"]["kernel"][0, seg] = 5.0
    return tree


def to_int8(tree):
    p = tree["params"]
    p["llava"]["lm"] = int8_serving_params(p["llava"]["lm"])
    p["sam"]["image_encoder"] = int8_sam_encoder_params(
        p["sam"]["image_encoder"])
    return tree


@pytest.fixture(scope="module")
def pipeline():
    jdense = jax_tiny()
    batch = make_synthetic_batch(jdense, B=2, L=12, mask_size=MASK)
    tree = numpy_tree(JaxIVLM(jdense).init(jax.random.PRNGKey(0), batch))
    tree = to_int8(force_seg_token(tree, jdense.seg_token_idx))
    jcfg = dataclasses.replace(
        jdense, llama=jax_llama_tiny(weights_int8=True),
        sam=jax_sam_tiny(weights_int8=True))
    tcfg = interactvlm_tiny(llama=llama_tiny(weights_int8=True),
                            sam=sam_tiny(weights_int8=True))
    tm = InteractVLM(tcfg, device="cpu")
    missing, unexpected = tm.load_state_dict(from_jax_params(tree),
                                             strict=False)
    assert not unexpected
    assert all("mask_downscaling" in k for k in missing)
    return jcfg, JaxIVLM(jcfg), batch, tree, tm


@pytest.mark.parametrize("cached", [False, True], ids=["streaming", "cached"])
def test_evaluate_batch_int8_matches_jax(pipeline, cached):
    jcfg, jm, batch, tree, tm = pipeline
    maps = {"p2v": batch["human_p2v"], "bary": batch["human_bary"],
            "num_vertices": jcfg.num_human_vertices}
    jemb = temb = None
    if cached:
        jemb = jm.apply(tree, batch["sam_images"][:1],
                        method=JaxIVLM.encode_sam_images)
        with torch.inference_mode():
            temb = tm.encode_sam_images(
                torch.from_numpy(np.array(batch["sam_images"][:1])))
    want = jax_evaluate(jm, tree, batch, jcfg, MASK, "hcontact",
                        max_new_tokens=T, human_maps=maps, kv_cache="int8",
                        cached_image_emb=jemb)
    got = evaluate_batch(tm, {k: np.array(v) for k, v in batch.items()},
                         MASK, "hcontact", max_new_tokens=T,
                         human_maps={k: np.array(v) for k, v in maps.items()},
                         kv_cache="int8", cached_image_emb=temb)
    np.testing.assert_array_equal(got["generated_ids"].numpy(),
                                  want["generated_ids"])
    assert bool(got["has_seg"].all())
    scale = np.abs(want["pred_masks"]).max()
    assert scale > 0
    np.testing.assert_allclose(got["pred_masks"].numpy(), want["pred_masks"],
                               atol=TOL * scale, rtol=0)
    np.testing.assert_allclose(got["pred_contact_3d"].numpy(),
                               want["pred_contact_3d"], atol=1e-5)
