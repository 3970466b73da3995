"""``bench_torch.py``, the port's twin of ``bench.py``, against ``bench.py``
on the CPU.

- Its sphere and FLOP count equal ``bench.py``'s ``_sphere`` and
  ``_flops_per_image``, loaded from ``bench.py``'s source with ``ast`` so
  that its module-level ``jax.config`` updates never run here.
- Its e2e step (streaming and cached, ``BENCH_LIFT`` lowres and full) equals
  the JAX composition ``bench.py:397-454`` runs, on tiny f32 presets with
  the same weights (carried by ``from_jax_params``) and the same numpy
  inputs: the lifted contacts within 1e-5 absolute, the low-res mask logits
  within 1e-4 absolute and relative (the limits of
  ``tests/test_torch_pipeline.py``: f32 on both sides, summation order).
  The LLaMA's weights are nudged so that each row's first [SEG] comes
  after step 0, so the seg-hidden gather is exercised.
- ``main(device="cpu")`` prints ``bench.py``'s record (its keys and metric
  string for the knobs, from ``bench.py``'s source), with ``mfu`` 0.0, and
  writes no file; ``BENCH_MODE=train`` delegates to the port's training-step
  probe with ``bench.py``'s defaults and no PROBE_OUT.
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interactvlm_tpu import config as JC
from interactvlm_tpu.geometry.lift import (
    lift_multiview_soft_gather as jax_gather_lift,
)
from interactvlm_tpu.models.generate import greedy_generate as jax_generate
from interactvlm_tpu.models.interactvlm import InteractVLM as JaxIVLM
from interactvlm_tpu.models.llava import IMAGE_TOKEN_INDEX, LlavaModel
from interactvlm_tpu_torch.models.interactvlm import InteractVLM
from interactvlm_tpu_torch.utils.weights import from_jax_params

import bench_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "bench.py")
B, V, L_TEXT, T, MASK = 2, 4, 12, 6, 64


def bench_tree():
    with open(BENCH) as f:
        return ast.parse(f.read(), BENCH)


def bench_functions(*names):
    """``bench.py``'s module-level functions ``names``, executed alone."""
    defs = [n for n in bench_tree().body
            if isinstance(n, ast.FunctionDef) and n.name in names]
    assert sorted(d.name for d in defs) == sorted(names)
    ns = {"np": np}
    exec(compile(ast.Module(body=defs, type_ignores=[]), BENCH, "exec"), ns)
    return ns


def bench_record():
    """From ``bench.py:main``: the record's first keys, the keys of its
    three ``record.update`` calls in source order (uncached; cached; the
    streaming-only headline) and the ``metric`` expression."""
    main = next(n for n in bench_tree().body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    base = metric = None
    updates = []
    for node in ast.walk(main):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and getattr(node.targets[0], "id", None) == "record"):
            base = {k.value for k in node.value.keys}
            metric = node.value.values[0]
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "update"
                and getattr(node.func.value, "id", None) == "record"):
            updates.append((node.lineno,
                            {k.value for k in node.args[0].keys}))
    assert base and len(updates) == 3
    return base, [keys for _, keys in sorted(updates)], metric


def expected_keys(streaming, cached):
    base, (uncached, with_cache, headline), _ = bench_record()
    return base | (uncached if streaming else set()) | (
        with_cache if cached else headline)


def expected_metric(k, cached):
    """``bench.py``'s metric string for the knobs ``k``."""
    _, _, expr = bench_record()
    ns = dict(llama_size=k.llama, wq=k.wq, sam_size=k.sam,
              sam_int8=k.sam_int8, V=k.views, B=k.batch, T=k.decode_tokens,
              cached_ips=1.0 if cached else None, Bc=k.cache_batch)
    return eval(compile(ast.Expression(expr), BENCH, "eval"), ns)


def test_sphere_is_bench_py_s():
    want_v, want_f = bench_functions("_sphere")["_sphere"]()
    got_v, got_f = bench_torch.sphere()
    assert len(want_v) == 4722
    np.testing.assert_array_equal(np.asarray(got_v), want_v)
    np.testing.assert_array_equal(np.asarray(got_f), want_f)


def jax_config(llama):
    """``bench.py:268-316``'s JAX configuration for BENCH_LLAMA=``llama``
    at its chip defaults (at tiny: its CPU defaults)."""
    if llama == "tiny":
        sam = dataclasses.replace(JC.sam_vit_b(), img_size=256,
                                  encoder_depth=2,
                                  encoder_global_attn_indexes=(1,))
        lcfg, ccfg = JC.llama_tiny(), JC.clip_tiny()
    else:
        lcfg = {"7b": JC.llama_7b, "13b": JC.llama_13b}[llama](remat=False,
                                                              weights_int8=True)
        ccfg, sam = JC.clip_vit_l_14(), JC.sam_vit_h(gelu_approx=True,
                                                     weights_int8=True)
    return JC.InteractVLMConfig(
        llama=lcfg, clip=ccfg, sam=sam,
        seg_token_idx=min(lcfg.vocab_size - 1, 32000),
        img_emb_len=ccfg.num_patches - 1, multiview_channels=V,
        out_dim=sam.prompt_embed_dim)


@pytest.mark.parametrize("llama", ["7b", "13b", "tiny"])
@pytest.mark.parametrize("include_sam", [True, False])
def test_flops_per_image_is_bench_py_s(llama, include_sam):
    fns = bench_functions("_llama_matmul_params", "_flops_per_image")
    on_card = llama != "tiny"
    k = bench_torch.read_knobs(on_card, {"BENCH_LLAMA": llama})
    cfg = bench_torch.build_config(k, on_card)
    jcfg = jax_config(llama)
    Lp = L_TEXT - 1 + jcfg.clip.num_patches
    want = fns["_flops_per_image"](jcfg, V, Lp, 32, 1024,
                                   include_sam=include_sam)
    got = bench_torch.flops_per_image(cfg, V, Lp, 32,
                                      include_sam=include_sam)
    assert got == want


def numpy_tree(params):
    return jax.tree.map(np.array, nn.meta.unbox(params))


@pytest.fixture(scope="module")
def reference():
    """The tiny JAX models, their port twin on the same weights, the
    inputs, the twin's lift maps at MASK^2, and the JAX composition's
    (lifted, low-res logits) for the four cases."""
    k = bench_torch.read_knobs(False, {
        "BENCH_LLAMA": "tiny", "BENCH_SAM": "tiny", "BENCH_BATCH": str(B),
        "BENCH_DECODE_TOKENS": str(T), "BENCH_PROMPT": str(L_TEXT)})
    cfg = bench_torch.build_config(k, False)
    f32 = jnp.float32
    lc, cc, sc = (JC.llama_tiny(dtype=f32), JC.clip_tiny(dtype=f32),
                  JC.sam_tiny(dtype=f32))
    seg = min(lc.vocab_size - 1, 32000)
    jcfg = JC.InteractVLMConfig(llama=lc, clip=cc, sam=sc, seg_token_idx=seg,
                                img_emb_len=cc.num_patches - 1,
                                multiview_channels=V,
                                out_dim=sc.prompt_embed_dim)
    assert cfg.seg_token_idx == seg and cfg.sam.img_size == sc.img_size

    rng = np.random.default_rng(0)
    ids = rng.integers(4, min(lc.vocab_size, 30000), (B, L_TEXT))
    ids[:, 1] = IMAGE_TOKEN_INDEX
    ids = ids.astype(np.int32)
    mask = np.ones((B, L_TEXT), np.int32)
    clip_px = rng.standard_normal(
        (B, cc.image_size, cc.image_size, 3)).astype(np.float32)
    sam_px = rng.standard_normal(
        (B, V, sc.img_size, sc.img_size, 3)).astype(np.float32)
    cams = np.broadcast_to(rng.standard_normal((V, 5)).astype(np.float32),
                           (B, V, 5)).copy()

    llava, ivlm = LlavaModel(lc, cc), JaxIVLM(jcfg)
    key = jax.random.PRNGKey(0)
    # the inits and the streaming tail jitted, as bench.py runs them (its
    # eager form costs this file half a minute of JAX dispatch)
    lp = numpy_tree(jax.jit(llava.init)(key, ids, clip_px))
    gen = dict(max_new_tokens=T, eos_id=-1, attn_mask=mask,
               kv_cache="dense")
    # the token row 0 emits at step 1 gets a large channel 0, which the
    # lm_head reads as [SEG]: each row's first [SEG] then comes later
    token = int(np.asarray(jax_generate(llava, lp, ids, clip_px,
                                        **gen)["generated_ids"])[0, 1])
    lp["params"]["lm"]["model"]["embed_tokens"]["embedding"][token, 0] = 30.0
    lp["params"]["lm"]["lm_head"]["kernel"][0, seg] = 5.0
    tp = numpy_tree(jax.jit(lambda *a: ivlm.init(
        *a, MASK, method=JaxIVLM.masks_from_seg_hidden))(
        key, np.zeros((1, lc.hidden_size), np.float32),
        np.full((1,), seg, np.int32), sam_px[:1], cams[:1]))

    model = InteractVLM(cfg, device="cpu")
    missing, unexpected = model.load_state_dict(
        from_jax_params({"params": {"llava": lp["params"],
                                    **tp["params"]}}), strict=False)
    assert not unexpected and all("mask_downscaling" in n for n in missing)
    model.eval().requires_grad_(False)
    _, _, gidx, gw, _ = bench_torch.lift_maps(
        MASK, torch.device("cpu"), mesh=bench_torch.sphere(),
        max_k=bench_torch.MAX_K, views=V)

    g = jax_generate(llava, lp, ids, clip_px, **gen)
    gen_ids = g["generated_ids"]
    first = jnp.argmax(gen_ids == seg, axis=1)
    assert bool((first > 0).all()) and bool((gen_ids == seg).any(1).all())
    seg_hidden = jnp.take_along_axis(g["step_hidden"],
                                     first[:, None, None], axis=1)[:, 0]
    token_id = jnp.full((B,), seg, jnp.int32)
    emb = ivlm.apply(tp, sam_px[:1], method=JaxIVLM.encode_sam_images)
    want = {}
    for cached in (False, True):
        low = jax.jit(lambda *a: ivlm.apply(
            *a, method=(JaxIVLM.low_res_masks_from_image_emb if cached
                        else JaxIVLM.low_res_masks_from_seg_hidden)))(
            tp, seg_hidden, token_id, emb if cached else sam_px, cams)
        for lowres in (True, False):
            full = (jax.image.resize(low, (*low.shape[:2], MASK, MASK),
                                     method="bilinear") if lowres else
                    ivlm.apply(tp, low, MASK,
                               method=JaxIVLM.upsample_masks))
            lifted = jax.vmap(lambda m: jax_gather_lift(
                m, jnp.asarray(gidx.numpy()), jnp.asarray(gw.numpy())))(full)
            want[cached, lowres] = (
                np.asarray(lifted + (gen_ids.sum() * 1e-12)), np.asarray(low))
    inputs = {n: torch.from_numpy(x) for n, x in (
        ("ids", ids.astype(np.int64)), ("mask", mask), ("clip_px", clip_px),
        ("sam_px", sam_px), ("cams", cams))}
    return model, inputs, gidx, gw, want


@pytest.mark.parametrize("cached", [False, True], ids=["streaming", "cached"])
@pytest.mark.parametrize("lowres", [True, False], ids=["lowres", "full"])
def test_e2e_step_matches_bench_py_s_jax_composition(reference, cached,
                                                     lowres):
    model, x, gidx, gw, want = reference
    with torch.inference_mode():
        view = (model.encode_sam_images(x["sam_px"][:1]) if cached
                else x["sam_px"])
        lifted, low = bench_torch.e2e(
            model, x["ids"], x["mask"], x["clip_px"], view, x["cams"], gidx,
            gw, cached=cached, T=T, kv_cache="dense", mask_size=MASK,
            lift_lowres=lowres)
    want_lifted, want_low = want[cached, lowres]
    assert lifted.shape == (B, len(bench_torch.sphere()[0]))
    np.testing.assert_allclose(low.numpy(), want_low, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(lifted.numpy(), want_lifted, atol=1e-5)
    assert np.abs(want_low).max() > 0 and want_lifted.max() > 0


@pytest.fixture
def bench_env(monkeypatch):
    """No BENCH_* or PROBE_* setting of the caller's."""
    for name in list(os.environ):
        if name.startswith(("BENCH_", "PROBE_")):
            monkeypatch.delenv(name)
    return monkeypatch


def root_files():
    return {e.name: e.stat().st_mtime_ns for e in os.scandir(REPO)}


@pytest.mark.parametrize("knobs,streaming,cached", [
    ({}, True, True),
    ({"BENCH_STREAMING": "0"}, False, True),
    ({"BENCH_CACHE_VIEWS": "0"}, True, False),
], ids=["defaults", "cached_only", "streaming_only"])
def test_main_on_cpu_prints_bench_py_s_record(bench_env, capsys, knobs,
                                              streaming, cached):
    for name, value in {"BENCH_ITERS": "1", "BENCH_REPEATS": "1",
                        **knobs}.items():
        bench_env.setenv(name, value)
    before = root_files()
    assert bench_torch.main(device="cpu") == 0
    out, err = capsys.readouterr()
    record = json.loads(out.strip().splitlines()[-1])
    assert set(record) == expected_keys(streaming, cached)
    k = bench_torch.read_knobs(False)
    assert record["metric"] == expected_metric(k, cached)
    assert record["mfu"] == 0.0 and record.get("uncached_mfu", 0.0) == 0.0
    assert record["value"] > 0 and np.isfinite(record["flops_per_image"])
    assert record["kv_cache"] == "dense"
    assert f"[bench] lift: {bench_torch.LIFT_NOTE}" in err
    for mode, ran in (("streaming", streaming), ("cached", cached)):
        assert (bench_torch.LAUNCH_LINE.format(mode) + "{}" in err) == ran
    assert "legs(ms/batch of 2" in err
    assert root_files() == before


@pytest.mark.parametrize("env,want", [
    ({}, {"PROBE_LLAMA": "7b", "PROBE_INT8": "1", "PROBE_B": "2"}),
    ({"BENCH_BATCH": "4"},
     {"PROBE_LLAMA": "7b", "PROBE_INT8": "1", "PROBE_B": "4"}),
    ({"BENCH_BATCH": "4", "PROBE_LLAMA": "tiny", "PROBE_INT8": "0",
      "PROBE_B": "1", "PROBE_OUT": "/elsewhere/train.json"},
     {"PROBE_LLAMA": "tiny", "PROBE_INT8": "0", "PROBE_B": "1",
      "PROBE_OUT": "/elsewhere/train.json"}),
], ids=["defaults", "batch", "caller_probe_knobs"])
def test_train_mode_delegates_to_the_training_step_probe(bench_env, env,
                                                         want):
    calls = []

    def call(cmd, env=None, cwd=None):
        calls.append((cmd, env, cwd))
        return 3

    bench_env.setattr(subprocess, "call", call)
    for name, value in {"BENCH_MODE": "train", **env}.items():
        bench_env.setenv(name, value)
    assert bench_torch.main() == 3
    (cmd, got_env, cwd), = calls
    assert cmd == [sys.executable, "-m",
                   "interactvlm_tpu_torch.probes.train_step"]
    assert cwd == REPO
    assert {n: v for n, v in got_env.items() if n.startswith("PROBE_")} \
        == want
