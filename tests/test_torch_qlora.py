"""QLoRA training and int4 serving in the port against the JAX package, on
the CPU with tiny presets.

QLoRA: ``interactvlm_tiny`` with a frozen int8 LLaMA base and LoRA on q/v
(``weights_int8=True, lora_rank=4``), the JAX package's weights carried
across by ``from_jax_params`` (LoRA B drawn non-zero first, so that A has a
gradient). The int8 base runs the JAX package's CPU composition on both
sides, differentiated by the straight-through estimator. Checked: the
losses of ``forward_train``, the trainable set against the JAX mask, the
gradient of every trainable, three optimizer steps of ``TrainStep``
against ``make_train_step``, and that no int8 parameter takes a gradient
or moves. Tolerances: those of ``tests/test_torch_train.py`` (losses 1e-5
relative, gradients 1e-3 of their leaf's largest magnitude plus 1e-3
relative with norms 1e-4, parameters after three steps 2e-3 of lr where
the gradient is above its noise).

int4: the converters byte for byte against the JAX package's (scales and
row factors within two f32 ulps, see ``_assert_same``); a tiny int4
LLaMA's logits within 1e-4 (as the int8 serving tests: f32 on both sides)
and its greedy ids equal, with a dense and an int8 KV cache.
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
from interactvlm_tpu.models.interactvlm import InteractVLM as JaxIVLM
from interactvlm_tpu.models.llama import LlamaForCausalLM as JaxLlama
from interactvlm_tpu.ops.quant import init_kv_cache_int8 as jax_init_int8
from interactvlm_tpu.parallel.mesh import create_mesh
from interactvlm_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from interactvlm_tpu.train.optimizer import trainable_mask as jax_trainable_mask
from interactvlm_tpu.train.train_step import create_sharded_state, make_train_step
from interactvlm_tpu.utils.testing import greedy_decode_lm
from interactvlm_tpu.utils.testing import make_synthetic_batch as jax_batch
from interactvlm_tpu.utils.weights import (
    int4_serving_params,
    qlora_training_params,
)
from interactvlm_tpu_torch.config import interactvlm_tiny, llama_tiny
from interactvlm_tpu_torch.models.interactvlm import InteractVLM
from interactvlm_tpu_torch.models.layers import (
    Int4Linear,
    Int8Linear,
    Int8LoraLinear,
)
from interactvlm_tpu_torch.models.llama import LlamaForCausalLM
from interactvlm_tpu_torch.ops.quant import init_kv_cache_int8
from interactvlm_tpu_torch.train.optimizer import (
    apply_trainable_mask,
    cast_frozen_params,
    make_optimizer,
    quantized_params,
)
from interactvlm_tpu_torch.train.train_step import TrainStep
from interactvlm_tpu_torch.utils.testing import make_synthetic_batch
from interactvlm_tpu_torch.utils.weights import (
    from_jax_params,
    init_params,
    int4_serving_state_dict,
    qlora_training_state_dict,
)

MASK, RANK, LR = 32, 4, 1e-3
NOISE = 1e-7  # as in test_torch_train: a gradient zero in exact arithmetic
LOSS_KEYS = ("loss", "ce_loss", "mask_bce_loss", "mask_dice_loss",
             "mask_l2_loss", "mask_loss", "hC_loss", "oA_loss", "oC_loss")
TOL = 1e-4


def _np(tree):
    return jax.tree.map(np.array, nn.meta.unbox(tree))


def _no_float0(grads, params):
    """allow_int gives the int8 kernels float0 cotangents: make them zeros
    of the kernel's own dtype, as the JAX train step does."""
    return jax.tree.map(
        lambda g, p: np.zeros(p.shape, p.dtype)
        if g.dtype == jax.dtypes.float0 else np.asarray(g), grads, params)


def _set_lora_b(tree, rng):
    for name, layer in tree["params"]["llava"]["lm"]["model"].items():
        if name.startswith("layer_"):
            for proj in ("q_proj", "v_proj"):
                b = layer["self_attn"][proj]["lora_b"]
                b[...] = rng.standard_normal(b.shape).astype(np.float32) * 0.05
    return tree


def _port(tree, cfg):
    tm = InteractVLM(cfg, device="cpu")
    missing, unexpected = tm.load_state_dict(from_jax_params(tree),
                                             strict=False)
    assert not unexpected and all("mask_downscaling" in k for k in missing)
    return tm


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_tiny(llama=jax_llama_tiny(lora_rank=RANK, weights_int8=True))
    tcfg = interactvlm_tiny(llama=llama_tiny(lora_rank=RANK,
                                             weights_int8=True))
    jb = jax_batch(jcfg, B=2, L=12, mask_size=MASK)
    jm = JaxIVLM(jcfg)
    tree = _set_lora_b(_np(jm.init(jax.random.PRNGKey(0), jb)),
                       np.random.default_rng(0))
    mask = jax_trainable_mask(tree)

    def loss_fn(train, frozen):
        merged = jax.tree.map(lambda t, f, m: t if m else f, train,
                              jax.lax.stop_gradient(frozen), mask)
        out = jm.apply(merged, jb)
        return out["loss"], out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True, allow_int=True))(tree, tree)
    return dict(jcfg=jcfg, tcfg=tcfg, jm=jm, tree=tree, mask=mask, jb=jb,
                out=jax.tree.map(np.asarray, out),
                grads=_no_float0(grads, tree),
                tb=make_synthetic_batch(tcfg, B=2, L=12, mask_size=MASK,
                                        device="cpu"))


def test_qlora_layers_names_and_dtypes(setup):
    tm = _port(setup["tree"], setup["tcfg"])
    lm = tm.llava.lm
    attn = lm.model.layers[0].self_attn
    for proj in (attn.q_proj, attn.v_proj):
        assert isinstance(proj, Int8LoraLinear)
        assert proj.weight.dtype == torch.int8
        assert proj.lora_A.weight.shape == (RANK, 64)
    assert type(attn.k_proj) is Int8Linear
    assert type(lm.model.layers[1].mlp.down_proj) is Int8Linear
    assert type(lm.lm_head) is not Int8Linear  # trains, in the compute dtype
    sd = tm.state_dict()
    p = "llava.lm.model.layers.0.self_attn.q_proj."
    for leaf in ("weight", "weight_scale", "lora_A.weight", "lora_B.weight"):
        assert p + leaf in sd, leaf
    assert sd[p + "weight_scale"].dtype == torch.float32


def test_qlora_forward_train_matches_jax(setup):
    tm = _port(setup["tree"], setup["tcfg"])
    got = tm(setup["tb"])
    want = setup["out"]
    for k in LOSS_KEYS:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["pred_masks"].detach().numpy(),
                               want["pred_masks"], rtol=1e-4, atol=1e-4)


def test_qlora_trainables_are_the_jax_masks(setup):
    tm = _port(setup["tree"], setup["tcfg"])
    port = apply_trainable_mask(tm)
    as_arrays = jax.tree.map(lambda m, p: np.full(p.shape, m, np.int8),
                             setup["mask"], setup["tree"])
    jax_names = {k for k, v in from_jax_params(as_arrays).items()
                 if bool((v != 0).all())}
    assert {k for k, v in port.items() if v} == jax_names
    kinds = {k.rsplit(".", 2)[-2] if "lora" in k else k.split(".")[0]
             for k in jax_names}
    assert {"lora_A", "lora_B", "text_hidden_fcs", "sam"} <= kinds
    assert "llava.lm.lm_head.weight" in jax_names
    assert "llava.lm.model.embed_tokens.weight" in jax_names
    assert not any(k.endswith(("weight_scale",)) for k in jax_names)
    quantized = quantized_params(tm)
    assert len(quantized) == 2 * 7 * 2  # weight and scale of 7 a layer
    for name, p in tm.named_parameters():
        assert p.requires_grad == port[name]
        if name in quantized:
            assert not p.requires_grad


def test_qlora_cast_leaves_the_int8_base_alone(setup):
    tm = _port(setup["tree"], setup["tcfg"])
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    cast_frozen_params(tm, torch.bfloat16, min_size=1)
    for n in quantized_params(tm):
        p = dict(tm.named_parameters())[n]
        assert p.dtype == before[n].dtype and torch.equal(p, before[n]), n
    assert tm.llava.lm.lm_head.weight.dtype == torch.float32  # trainable


def test_qlora_gradients_of_every_trainable_match_jax(setup):
    tm = _port(setup["tree"], setup["tcfg"])
    mask = apply_trainable_mask(tm)
    tm(setup["tb"])["loss"].backward()
    want = from_jax_params(setup["grads"])
    floor = NOISE * max(np.abs(w.float().numpy()).max()
                        for w in want.values())
    checked = 0
    for n, p in tm.named_parameters():
        if not mask[n]:
            assert p.grad is None, n  # the int8 base and the frozen towers
            continue
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        w = want[n].numpy()
        scale = np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3 * scale + floor,
                                   err_msg=n)
        if scale > floor:
            np.testing.assert_allclose(np.linalg.norm(g), np.linalg.norm(w),
                                       rtol=1e-4, err_msg=n)
            checked += 1
    # LoRA A and B of q and v in both layers reach the loss through the
    # straight-through gradient of the layers above them
    assert sum("lora_A" in n for n, p in tm.named_parameters()
               if p.grad is not None and p.grad.abs().sum() > 0) == 4
    assert checked > 20


def test_qlora_three_optimizer_steps_match_jax(setup):
    jm, tree, jb = setup["jm"], setup["tree"], setup["jb"]
    mesh = create_mesh(n_data=1, n_model=1, devices=jax.devices()[:1])
    tx, _ = jax_make_optimizer(lr=LR, warmup_steps=0, total_steps=50,
                               mask=jax_trainable_mask)
    with mesh:
        state, shardings = create_sharded_state(jm, tx, jb, mesh)
        state = state.replace(params=jax.tree.map(jnp.asarray, tree),
                              opt_state=tx.init(tree))
        step = make_train_step(jm, tx, mesh, shardings, jb, donate=False)
        jmetrics = []
        for _ in range(3):
            state, m = step(state, jb)
            jmetrics.append(jax.tree.map(float, m))
    want_params = from_jax_params(_np(state.params))

    tm = _port(tree, setup["tcfg"])
    init_port = {n: p.detach().clone() for n, p in tm.named_parameters()}
    opt, sched = make_optimizer(tm, lr=LR, warmup_steps=0, total_steps=50)
    train = TrainStep(tm, opt, sched)
    for i in range(3):
        m = train(setup["tb"])
        for k in ("loss", "ce_loss", "mask_loss", "hC_loss", "oA_loss",
                  "grad_norm"):
            np.testing.assert_allclose(m[k].item(), jmetrics[i][k],
                                       rtol=1e-4, err_msg=f"step {i} {k}")
        assert m["skipped_nonfinite"].item() == 0.0
    assert train.step == 3 and int(state.step) == 3
    grads = from_jax_params(setup["grads"])
    floor = NOISE * max(np.abs(g.float().numpy()).max()
                        for g in grads.values())
    init = from_jax_params(tree)
    moved = 0
    for n, p in tm.named_parameters():
        if n not in want_params:  # the unused mask-downscaling convs
            assert not p.requires_grad and torch.equal(p, init_port[n]), n
            continue
        got, want = p.detach().numpy(), want_params[n].numpy()
        if not p.requires_grad:  # the int8 base too: bit for bit
            assert got.dtype == want.dtype, n
            np.testing.assert_array_equal(got, want, err_msg=n)
            continue
        g = np.abs(grads[n].numpy())
        sure = g > max(1e-3 * g.max(), floor)
        np.testing.assert_allclose(got[sure], want[sure], rtol=0,
                                   atol=2e-3 * LR, err_msg=n)
        moved += int((np.abs(got - init[n].numpy())[sure] > 0.5 * LR).any())
    assert moved > 20


# ------------------------------------------------------------ converters
def _llama_tree(cfg):
    ids = jnp.asarray(np.random.default_rng(0).integers(1, 500, (2, 12)),
                      jnp.int32)
    return _np(JaxLlama(cfg).init(jax.random.PRNGKey(0), ids))["params"]


def _assert_same(got, want, n_quantized):
    """int8 bytes and every other entry equal; int4 column scales and row
    factors within two f32 ulps: the row factor is a mean over the N
    columns in f32, which XLA and torch sum in different orders (one ulp
    apart on about half the rows of a 64-column weight; the bytes agree
    unless a value then lands within an ulp of a rounding boundary)."""
    assert set(got) == set(want)
    assert sum(t.dtype == torch.int8 for t in want.values()) == n_quantized
    for key, t in want.items():
        if t.dtype == torch.int8 or key.endswith(("weight_scale",
                                                   "weight_rf")):
            assert got[key].dtype == t.dtype, key
        if key.endswith(("weight_rf", "weight_scale")) and \
                key.replace("weight_scale", "weight_rf") in want:
            np.testing.assert_allclose(got[key].numpy(), t.numpy(),
                                       rtol=2 ** -22, atol=0, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key].float().numpy(),
                                          t.float().numpy(), err_msg=key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qlora_training_state_dict_gives_the_jax_bytes(dtype):
    tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, dtype)),
                        _llama_tree(jax_llama_tiny(lora_rank=RANK)))
    port_sd = {k: v.to(getattr(torch, dtype))
               for k, v in from_jax_params(tree).items()}
    got = qlora_training_state_dict(port_sd)
    want = from_jax_params(qlora_training_params(tree))
    _assert_same(got, want, 7 * jax_llama_tiny().num_layers)
    assert got["lm_head.weight"].is_floating_point()
    tm = LlamaForCausalLM(llama_tiny(lora_rank=RANK, weights_int8=True),
                          device="cpu")
    tm.load_state_dict(got)  # the QLoRA model's own layout


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("inter", [128, 256])  # 256: group row factors
def test_int4_serving_state_dict_gives_the_jax_bytes(dtype, inter):
    cfg = dataclasses.replace(jax_llama_tiny(), intermediate_size=inter)
    tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, dtype)),
                        _llama_tree(cfg))
    port_sd = {k: v.to(getattr(torch, dtype))
               for k, v in from_jax_params(tree).items()}
    got = int4_serving_state_dict(port_sd)
    want = from_jax_params(int4_serving_params(tree))
    _assert_same(got, want, 7 * cfg.num_layers + 1)
    rf = got["model.layers.0.mlp.down_proj.weight_rf"]
    assert rf.shape == (inter,) and bool((rf != 1).any()) == (inter >= 256)


# ------------------------------------------------------------ int4 LLaMA
@pytest.fixture(scope="module", params=[4, 2], ids=["mha", "gqa"])
def llama4(request):
    """A dense JAX LLaMA converted by ``int4_serving_params`` (down_proj's
    K = 256 takes group row factors); ``gqa`` has two kv heads."""
    kv = request.param
    jdense = dataclasses.replace(jax_llama_tiny(), num_kv_heads=kv,
                                 intermediate_size=256)
    tree = int4_serving_params(_llama_tree(jdense))
    jcfg = dataclasses.replace(jdense, weights_int4=True)
    tm = LlamaForCausalLM(dataclasses.replace(
        llama_tiny(weights_int4=True), num_kv_heads=kv,
        intermediate_size=256), device="cpu")
    tm.load_state_dict(from_jax_params(tree))
    return JaxLlama(jcfg), {"params": tree}, tm


def test_int4_layers_names_and_dtypes(llama4):
    _, _, tm = llama4
    sd = tm.state_dict()
    q = sd["model.layers.0.self_attn.q_proj.weight_q4"]
    assert q.dtype == torch.int8 and q.shape == (64, 32)
    assert sd["model.layers.1.mlp.down_proj.weight_rf"].shape == (256,)
    assert sd["model.layers.1.mlp.down_proj.weight_scale"].dtype == \
        torch.float32
    assert isinstance(tm.lm_head, Int4Linear)
    assert isinstance(tm.model.layers[0].mlp.gate_proj, Int4Linear)
    # int4 takes precedence over int8, as in the JAX package
    both = LlamaForCausalLM(llama_tiny(weights_int4=True, weights_int8=True),
                            device="cpu")
    assert isinstance(both.model.layers[0].self_attn.k_proj, Int4Linear)


@pytest.mark.parametrize("ragged", [False, True])
def test_int4_llama_logits_match_jax(llama4, ragged):
    jm, params, tm = llama4
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


def test_int4_llama_greedy_ids_match_jax(llama4):
    from interactvlm_tpu.models.llama import init_kv_cache as jax_init
    from interactvlm_tpu_torch.models.llama import init_kv_cache

    jm, params, tm = llama4
    ids = np.random.default_rng(2).integers(1, 500, (2, 6))
    for jcache, tcache in (
            (jax_init(jm.config, 2, 16), init_kv_cache(tm.config, 2, 16,
                                                       "cpu")),
            (jax_init_int8(jm.config, 2, 16),
             init_kv_cache_int8(tm.config, 2, 16, "cpu"))):
        want = greedy_decode_lm(jm, params, jnp.asarray(ids, jnp.int32),
                                jcache, total_steps=16)
        with torch.inference_mode():
            got, _ = _port_greedy(tm, torch.from_numpy(ids), tcache, 16)
        np.testing.assert_array_equal(got.numpy(), want)


def test_init_params_draws_int4_weights_the_jax_way():
    tm = init_params(LlamaForCausalLM(llama_tiny(weights_int4=True),
                                      device="cpu"),
                     torch.Generator().manual_seed(0))
    w = tm.model.layers[0].mlp.down_proj
    assert w.weight_q4.dtype == torch.int8 and w.weight_q4.shape == (64, 64)
    assert int(w.weight_q4.min()) >= -127 and int(w.weight_q4.max()) <= 127
    assert int(w.weight_q4.min()) < -100 and int(w.weight_q4.max()) > 100
    torch.testing.assert_close(w.weight_scale,
                               torch.full((64,), 1.0 / (7.0 * 128 ** 0.5)))
    torch.testing.assert_close(w.weight_rf, torch.ones(128))
    q = init_params(LlamaForCausalLM(llama_tiny(weights_int8=True,
                                                lora_rank=RANK),
                                     device="cpu"),
                    torch.Generator().manual_seed(0))
    proj = q.model.layers[0].self_attn.q_proj
    assert proj.weight.dtype == torch.int8 and int(proj.weight.max()) > 100
    assert not proj.lora_B.weight.any() and proj.lora_A.weight.std() > 0.01
