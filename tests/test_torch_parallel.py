"""The port's multi-card layer against the JAX package's, on the CPU: the
partition table, the ZeRO and batch sharding rules, the collectives, the
row-parallel int8 and int4 linears, the tensor-parallel greedy decode and
the memory budgets.

The ranks are gloo processes on the CPU (``parallel/launch.py:spawn``:
one thread each, a ``file://`` rendezvous in a fresh temporary directory,
so concurrent test workers never share a port). The JAX side runs on the
8-device virtual CPU mesh of ``tests/conftest.py``; the 13B layout is
checked by ``jax.eval_shape`` with no compile, as ``tests/test_tp_shapes.py``
does.

Tolerances: specs, bytes and tokens exactly; the row-parallel quantized
rows byte for byte and their scales exactly; the row-parallel products
within 1e-6 relative of the unsharded JAX composition (the f32 partial sums
add in another order); budgets exactly.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from interactvlm_tpu import config as JCFG
from interactvlm_tpu.config import interactvlm_tiny as jax_ivlm_tiny
from interactvlm_tpu.config import llama_13b as jax_llama_13b
from interactvlm_tpu.config import llama_tiny as jax_llama_tiny
from interactvlm_tpu.models.interactvlm import InteractVLM as JaxIVLM
from interactvlm_tpu.models.llama import LlamaForCausalLM as JaxLlama
from interactvlm_tpu.models.llama import init_kv_cache as jax_init_kv
from interactvlm_tpu.ops.quant import init_kv_cache_int8 as jax_init_kv8
from interactvlm_tpu.ops.quant import int4_matmul as jax_int4_matmul
from interactvlm_tpu.ops.quant import int8_matmul as jax_int8_matmul
from interactvlm_tpu.ops.quant import quantize_int4 as jax_quantize_int4
from interactvlm_tpu.ops.quant import quantize_int8 as jax_quantize_int8
from interactvlm_tpu.parallel import collectives as JC
from interactvlm_tpu.parallel.mesh import LOGICAL_RULES
from interactvlm_tpu.parallel.mesh import create_mesh as jax_mesh
from interactvlm_tpu.train.optimizer import make_optimizer as jax_make_opt
from interactvlm_tpu.train.optimizer import trainable_mask as jax_mask
from interactvlm_tpu.train.train_step import (
    batch_shardings,
    opt_state_shardings,
    zero_shard_leaf,
)
from interactvlm_tpu.utils import memory as JM
from interactvlm_tpu.utils.testing import greedy_decode_lm as jax_greedy
from interactvlm_tpu.utils.testing import make_synthetic_batch as jax_batch
from interactvlm_tpu.utils.weights import int8_serving_params
from interactvlm_tpu_torch import config as TC
from interactvlm_tpu_torch.models.interactvlm import InteractVLM
from interactvlm_tpu_torch.models.llama import LlamaForCausalLM
from interactvlm_tpu_torch.parallel import mesh as M
from interactvlm_tpu_torch.parallel.launch import spawn
from interactvlm_tpu_torch.train.optimizer import trainable_mask
from interactvlm_tpu_torch.train.train_step import (
    batch_specs,
    opt_state_specs,
    zero_shard_spec,
)
from interactvlm_tpu_torch.utils import memory as TM
from interactvlm_tpu_torch.utils.testing import make_synthetic_batch
from interactvlm_tpu_torch.utils.weights import from_jax_params, init_params

from tests import torch_ranks as R

LEAF = {"kernel": "weight", "kernel_q": "weight", "kernel_q4": "weight_q4",
        "kernel_scale": "weight_scale", "kernel_rf": "weight_rf",
        "lora_a": "lora_A.weight", "lora_b": "lora_B.weight",
        "embedding": "weight", "weight": "weight"}


def port_name(path) -> str:
    """A JAX LLaMA leaf's path -> the port's parameter name."""
    keys = [getattr(k, "key", None) for k in path]
    keys = [k for k in keys if k not in (None, "params", "base")]
    out = []
    for k in keys[:-1]:
        out += ["layers", k[6:]] if k.startswith("layer_") else [k]
    return ".".join(out + [LEAF[keys[-1]]])


def _spec(s, ndim):
    s = tuple(s)
    return s + (None,) * (ndim - len(s))


def jax_param_specs(abs_vars):
    """{port name: (JAX shape, JAX mesh spec)} of a LLaMA's boxed tree."""
    specs = nn.get_partition_spec(abs_vars)
    rules = dict(LOGICAL_RULES)
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    shapes = dict(jax.tree_util.tree_flatten_with_path(
        nn.meta.unbox(abs_vars))[0])
    for path, spec in flat:
        shape = shapes[path].shape
        mesh_spec = tuple(rules.get(a) if a is not None else None
                          for a in spec)
        out[port_name(path)] = (shape, _spec(mesh_spec, len(shape)))
    return out


VARIANTS = {"bf16": {}, "lora": dict(lora_rank=4),
            "int8": dict(weights_int8=True), "int4": dict(weights_int4=True),
            "qlora": dict(weights_int8=True, lora_rank=4)}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_partition_table_gives_the_jax_specs(variant):
    """Every LLaMA leaf: the port's spec in the JAX layout is what
    ``nn.get_partition_spec`` gives, and the torch layout holds it on the
    flipped dim of an (out, in) weight; the names cover the port model's
    state dict exactly."""
    kw = VARIANTS[variant]
    abs_vars = jax.eval_shape(JaxLlama(jax_llama_tiny(**kw)).init,
                              jax.random.PRNGKey(0),
                              jnp.zeros((2, 8), jnp.int32))
    want = jax_param_specs(abs_vars)
    tm = LlamaForCausalLM(TC.llama_tiny(**kw), device="cpu")
    sd = tm.state_dict()
    assert set(want) == set(sd)
    for name, (jshape, jspec) in want.items():
        t = sd[name]
        assert M.jax_shape(name, t.shape) == tuple(jshape), name
        assert M.jax_spec(name, len(jshape)) == jspec, name
        assert M.param_spec(name, t.dim()) == M.to_torch_spec(
            name, jspec, t.dim()), name
    # the (out, in) flip: q_proj splits its rows (heads), o_proj and
    # down_proj their columns, the tables their vocabulary rows
    layer = "model.layers.0."
    weight = "weight_q4" if kw.get("weights_int4") else "weight"
    assert M.sharded_dim(layer + "self_attn.q_proj." + weight, 2) == 0
    assert M.sharded_dim(layer + "self_attn.o_proj." + weight, 2) == 1
    assert M.sharded_dim(layer + "mlp.down_proj." + weight, 2) == 1
    assert M.sharded_dim("model.embed_tokens.weight", 2) == 0
    if kw.get("lora_rank"):
        assert M.sharded_dim(layer + "self_attn.q_proj.lora_A.weight",
                             2) is None
        assert M.sharded_dim(layer + "self_attn.v_proj.lora_B.weight",
                             2) == 0
    if kw.get("weights_int8") or kw.get("weights_int4"):
        assert M.param_spec(layer + "mlp.up_proj.weight_scale", 1) == (
            "model",)
        assert M.param_spec(layer + "mlp.down_proj.weight_scale", 1) == (
            None,)
    if kw.get("weights_int4"):
        assert M.param_spec(layer + "mlp.down_proj.weight_rf", 1) == (
            "model",)
        assert M.param_spec(layer + "mlp.up_proj.weight_rf", 1) == (None,)


def test_only_the_llama_is_sharded_in_the_composite_model():
    """The JAX InteractVLM annotates its LLaMA alone (CLIP's own
    ``layers.N.self_attn.q_proj`` included among the unannotated); the
    port's table matches no other parameter."""
    jcfg = jax_ivlm_tiny(llama=jax_llama_tiny(lora_rank=4))
    abs_vars = jax.eval_shape(JaxIVLM(jcfg).init, jax.random.PRNGKey(0),
                              jax_batch(jcfg, B=2, mask_size=16))
    specs = nn.get_partition_spec(abs_vars)
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    annotated = {jax.tree_util.keystr(p) for p, s in leaves if any(s)}
    assert annotated and all("['lm']" in p for p in annotated)
    tm_names = [n for n, _ in InteractVLM(
        TC.interactvlm_tiny(llama=TC.llama_tiny(lora_rank=4)),
        device="cpu").named_parameters()]
    table = {n for n in tm_names if M.logical_axes(n) is not None}
    assert table == {n for n in tm_names if n.startswith("llava.lm.")}
    assert any("vision_tower" in n and "q_proj" in n for n in tm_names)


def _moment_specs(tx, abs_params, mesh, shardings):
    """{port name: JAX spec} of the Adam mu leaves."""
    opt_sh = opt_state_shardings(tx, abs_params, mesh,
                                 param_shardings=shardings)
    out = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(opt_sh)[0]:
        names = [getattr(k, "name", None) for k in path]
        if "mu" not in names:
            continue
        rest = path[names.index("mu") + 1:]
        out[port_name(rest)] = tuple(sh.spec)
    return out


@pytest.mark.parametrize("scale", ["tiny", "13b"])
@pytest.mark.parametrize("n_data,n_model", [(2, 2), (4, 2)])
def test_zero_and_moment_specs_match_jax(scale, n_data, n_model):
    """The trainer's masked AdamW: each trainable's moment spec from
    ``opt_state_specs`` is ``opt_state_shardings``'s, at the tiny LoRA
    LLaMA and at LLaMA-13B's shapes (``jax.eval_shape``, the real
    tokenizer length 32003); ``zero_shard_spec`` is ``zero_shard_leaf``."""
    make = jax_llama_tiny if scale == "tiny" else jax_llama_13b
    cfg = make(lora_rank=8, vocab_size=32003) if scale == "13b" else make(
        lora_rank=4)
    abs_vars = jax.eval_shape(JaxLlama(cfg).init, jax.random.PRNGKey(0),
                              jnp.zeros((2, 8), jnp.int32))
    mesh = jax_mesh(n_data, n_model, devices=jax.devices()[:n_data * n_model])
    shardings = nn.meta.unbox(nn.logical_to_mesh_sharding(
        nn.get_partition_spec(abs_vars), mesh, list(LOGICAL_RULES)))
    params = nn.meta.unbox(abs_vars)
    # the freeze policy of a LLaMA inside the composite model (its base
    # frozen, LoRA and the tables trained)
    tx, _ = jax_make_opt(mask=lambda p: jax_mask({"lm": p})["lm"])
    want = _moment_specs(tx, params, mesh, shardings)
    shapes = {port_name(p): leaf.shape for p, leaf in
              jax.tree_util.tree_flatten_with_path(params)[0]}
    mask = {n: m for n, m in zip(shapes, trainable_mask(
        "lm." + n for n in shapes).values())}
    assert {n for n, m in mask.items() if m} == set(want)
    full = {n: torch.empty(M.jax_shape(n, s)[::-1] if M.logical_axes(
        n) and M.logical_axes(n)[1] == M.KERNEL else s, device="meta")
            for n, s in shapes.items() if mask[n]}
    got = opt_state_specs(full, n_data)
    for name, spec in want.items():
        ndim = full[name].dim()
        assert got[name] == M.to_torch_spec(name, _spec(spec, len(
            shapes[name])), ndim), name
    assert any("data" in s for s in got.values())
    for shape in [(4096,), (100, 64), (3, 5, 4096), (7, 9), (2 ** 14,),
                  (32003, 8), (6, 4096)]:
        sd = jax.ShapeDtypeStruct(shape, jnp.float32)
        assert zero_shard_spec(shape, n_data) == _spec(
            zero_shard_leaf(sd, mesh).spec, len(shape)), shape


@pytest.mark.parametrize("n_data,B", [(2, 4), (4, 4), (2, 3)])
def test_batch_specs_match_jax(n_data, B):
    jcfg = jax_ivlm_tiny(max_seg_tokens=2)
    jb = jax_batch(jcfg, B=B, mask_size=16)
    mesh = jax_mesh(n_data, 2, devices=jax.devices()[:n_data * 2])
    want = {k: _spec(s.spec, 1)[:1] for k, s in
            batch_shardings(jb, mesh).items()}
    tb = make_synthetic_batch(TC.interactvlm_tiny(max_seg_tokens=2), B=B,
                              mask_size=16, device="cpu")
    got = {k: _spec(s, 1)[:1] for k, s in batch_specs(tb, n_data).items()}
    assert got == want


def test_collectives_on_four_ranks_match_jax():
    """The six collectives (and the MAX all-reduce) over four gloo ranks
    against the JAX ones over four devices of the data axis; the bucketed
    in-place sum of a gradient's leaves against the sums."""
    res = spawn(R.collectives, 4)
    mesh = jax_mesh(n_data=4, n_model=1, devices=jax.devices()[:4])
    x = jnp.arange(8.0).reshape(4, 2)
    want = dict(sum=np.asarray(JC.all_reduce_sum(x, mesh)),
                mean=np.asarray(JC.all_reduce_mean(x, mesh)),
                gather=np.asarray(JC.all_gather_batch(x, mesh)),
                scatter=np.asarray(JC.psum_scatter(x, mesh)),
                ring=np.asarray(JC.ppermute_ring(x, mesh, shift=1)))
    for r, got in enumerate(res):
        np.testing.assert_array_equal(got["sum"].numpy(), want["sum"])
        np.testing.assert_array_equal(got["mean"].numpy(), want["mean"])
        np.testing.assert_array_equal(got["gather"].numpy(), want["gather"])
        np.testing.assert_array_equal(got["scatter"].numpy()[0],
                                      want["scatter"][r])
        np.testing.assert_array_equal(got["ring"].numpy()[0],
                                      want["ring"][r])
        np.testing.assert_array_equal(got["max"].numpy()[0], [6.0, 7.0])
        assert got["host"] == [0, 1, 2, 3]
        for leaf, total in zip(got["coalesced"], (10.0, 12.0, 60.0, 8.0)):
            np.testing.assert_array_equal(leaf.numpy(), total)
        assert got["coalesced"][3].dtype == torch.float64
    assert len(JC.host_gather(np.ones(3))) == 1


def test_row_parallel_int8_and_int4_equal_the_unsharded_composition():
    """On 1 x 2: each rank's slice of a row quantizes to the unsharded
    row's int8 bytes and scale (the absmax all-reduced over ``model``), for
    x and for x times the int4 row factor; the summed products equal the
    JAX package's ``int8_matmul`` and ``int4_matmul`` on the whole rows."""
    rng = np.random.default_rng(0)
    Mr, K, N = 6, 256, 40
    x = rng.standard_normal((Mr, K)).astype(np.float32)
    x[1, :9] = [127.0, 2.5, 3.5, -2.5, 0.5, 1.5, -0.5, 126.5, -127.0]
    x[2, K // 2:] *= 8.0  # the row's absmax on the second rank's slice
    w = rng.standard_normal((K, N)).astype(np.float32)
    wq, ws = jax_quantize_int8(jnp.asarray(w), axis=0)
    packed, cs, rf = jax_quantize_int4(jnp.asarray(w), group=64)
    res = spawn(R.row_parallel, 2, n_model=2, args=(
        torch.from_numpy(x), torch.from_numpy(np.asarray(wq).T.copy()),
        torch.from_numpy(np.asarray(ws)[0].copy()),
        torch.from_numpy(np.asarray(packed).T.copy()),
        torch.from_numpy(np.asarray(cs)[0].copy()),
        torch.from_numpy(np.asarray(rf).copy())))
    q8, s8 = jax_quantize_int8(jnp.asarray(x))
    q4, s4 = jax_quantize_int8(jnp.asarray(x) * rf)
    y8 = np.asarray(jax_int8_matmul(jnp.asarray(x), wq, ws, jnp.float32))
    y4 = np.asarray(jax_int4_matmul(jnp.asarray(x), packed, cs, rf,
                                    jnp.float32))
    half = K // 2
    for i, got in enumerate(res):
        cols = slice(i * half, (i + 1) * half)
        np.testing.assert_array_equal(got["q8"].numpy(), np.asarray(q8)[:, cols])
        np.testing.assert_array_equal(got["s8"].numpy(), np.asarray(s8))
        np.testing.assert_array_equal(got["q4"].numpy(), np.asarray(q4)[:, cols])
        np.testing.assert_array_equal(got["s4"].numpy(), np.asarray(s4))
        np.testing.assert_allclose(got["y8"].numpy(), y8, rtol=1e-6,
                                   atol=1e-6 * np.abs(y8).max())
        np.testing.assert_allclose(got["y4"].numpy(), y4, rtol=1e-6,
                                   atol=1e-6 * np.abs(y4).max())
    assert not np.array_equal(np.asarray(q8)[2, :half],
                              np.asarray(jax_quantize_int8(
                                  jnp.asarray(x[:, :half]))[0])[2])


@pytest.mark.parametrize("kind", ["dense", "int8"])
def test_tensor_parallel_greedy_decode_gives_the_jax_tokens(kind):
    """A 1 x 2 greedy decode of the tiny LLaMA (dense with a dense cache;
    int8 weights, row-parallel o/down projections quantizing with the
    whole row's scale, and an int8 cache) gives the JAX package's
    ``greedy_decode_lm`` tokens on the same weights."""
    rng = np.random.default_rng(2)
    ids = rng.integers(1, 500, (2, 6))
    jcfg = jax_llama_tiny()
    tree = jax.tree.map(np.array, nn.meta.unbox(JaxLlama(jcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(ids, jnp.int32))))["params"]
    tcfg = TC.llama_tiny()
    cache = jax_init_kv(jcfg, 2, 16)
    if kind == "int8":
        tree = int8_serving_params(tree)
        jcfg = dataclasses.replace(jcfg, weights_int8=True)
        tcfg = TC.llama_tiny(weights_int8=True)
        cache = jax_init_kv8(jcfg, 2, 16)
    want = jax_greedy(JaxLlama(jcfg), {"params": tree},
                      jnp.asarray(ids, jnp.int32), cache, total_steps=16)
    res = spawn(R.decode, 2, n_model=2, args=(
        tcfg, from_jax_params(tree), torch.from_numpy(ids), 16,
        "int8" if kind == "int8" else "dense"))
    for got in res:
        np.testing.assert_array_equal(got, want)


def _live_bytes(model):
    return sum(p.numel() * p.element_size() for p in model.parameters())


def test_memory_budgets_equal_the_jax_bytes():
    """Every budget function gives the JAX function's bytes, at the tiny
    preset and at full scale, on each layout; capacity is the card's."""
    for name in ("interactvlm_tiny", "interactvlm_13b"):
        j, t = getattr(JCFG, name)(), getattr(TC, name)()
        for tp in (1, 2, 4):
            assert JM.llama_param_bytes(j.llama, tp) == TM.llama_param_bytes(
                t.llama, tp)
            for kv in ("int8", "dense"):
                assert JM.kv_cache_bytes(j.llama, 8, 351, kv, tp) == \
                    TM.kv_cache_bytes(t.llama, 8, 351, kv, tp)
                assert JM.serving_budget(j, 8, 351, 4, 64, kv, tp).components \
                    == TM.serving_budget(t, 8, 351, 4, 64, kv, tp).components
                assert JM.cached_serving_budget(
                    j, 32, 351, 4, 64, kv, tp).components == \
                    TM.cached_serving_budget(
                        t, 32, 351, 4, 64, kv, tp).components
        for nd, nm in ((1, 1), (2, 1), (1, 2), (2, 2), (4, 2)):
            assert JM.training_budget(j, 8, 4, 512, nd, nm).components == \
                TM.training_budget(t, 8, 4, 512, nd, nm).components
        assert JM.trainable_param_count(j) == TM.trainable_param_count(t)
        assert JM.sam_param_bytes(j.sam) == TM.sam_param_bytes(t.sam)
        assert JM.clip_param_bytes(j.clip) == TM.clip_param_bytes(t.clip)
    for kw in ({}, dict(weights_int8=True)):
        jq = jax_llama_tiny(lora_rank=8, **kw)
        tq = TC.llama_tiny(lora_rank=8, **kw)
        assert JM.llama_param_bytes(jq) == TM.llama_param_bytes(tq)
    assert TM.device_capacity() == TM.H100_80GB_BYTES  # no card here
    assert TM.serving_budget(TC.interactvlm_tiny(), 2, 64, 4, 16).fits()


def test_tiny_budgets_hold_the_live_port_parameters():
    """The analytic LLaMA bytes hold the live port model's parameters
    within the JAX package's own bound for its live tree (15 %,
    ``tests/test_memory_budget.py``), and a model rank's share is the
    whole's over the model ranks (the replicated norms and tables aside)."""
    cfg = TC.llama_tiny(dtype=torch.float32)
    model = LlamaForCausalLM(cfg, device="cpu")
    live = _live_bytes(model)
    est = TM.llama_param_bytes(cfg)
    assert abs(est - live) / live < 0.15, (est, live)
    sd = model.state_dict()
    split = sum(v.numel() * v.element_size() for k, v in sd.items()
                if M.sharded_dim(k, v.dim()) is not None)
    for n in (2, 4):
        local = sum(M.shard_tensor(k, v, n, 0).numel() * v.element_size()
                    for k, v in sd.items())
        assert local == live - split + split // n
    init_params(model, torch.Generator().manual_seed(0))
