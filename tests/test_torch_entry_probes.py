"""The entry probes' twins, the low-res lift, SAM without its rel-pos bias,
the padded flash route and the launcher twins, on the CPU.

- ``geometry/lift.py:lift_multiview_soft_gather_lowres`` against the JAX
  function (within 1e-6: f32 on both sides, the same taps) and against the
  port's resize-then-gather (within 1e-5, ``tests/test_geometry.py``'s
  tolerance for the JAX pair).
- The SAM encoder with ``use_rel_pos=False`` against the JAX encoder
  built with the JAX probe's ``use_rel_pos=False`` attention (tiny preset,
  f32, within 1e-4: ``tests/test_torch_sam.py``'s tolerance).
- ``flash_attention`` at head dim 80 (zero-padded to 128, the SAM global
  blocks' route without the bias) against ``attention_plain``, output and
  gradients within 1e-5 (f32 on CPU tensors: the kernel's plain version).
- Every probe twin's ``main`` runs every variant at tiny sizes on the CPU,
  raises on an unknown variant and on a failing one, and defaults to the
  GPU; the int4 probe's error report equals the JAX script's function on
  the same Gaussian weights, exactly.
- Each launcher twin's ``python -m`` lines are its original's with the
  module renamed, and the port CLI's parser gives the JAX CLI's values on
  them (every flag of every preset exists, with the JAX default); the
  ``synthetic-smoke`` preset runs end to end with ``--device cpu``.
- The launch counters and the card-busy reader that the probes and
  ``chip_smoke.py`` share (``probes/common.py``): counts exactly, the
  union of spans exactly.
"""

import argparse
import ast
import dataclasses
import functools
import inspect
import os
import re
import shlex
import subprocess
import time

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from interactvlm_tpu.config import sam_tiny as jax_sam_tiny
from interactvlm_tpu.geometry import lift as JL
from interactvlm_tpu.models.sam import image_encoder as jax_ie
from interactvlm_tpu.models.sam.sam import Sam as JaxSam
from interactvlm_tpu_torch.config import llama_tiny, sam_tiny
from interactvlm_tpu_torch.geometry import lift as TL
from interactvlm_tpu_torch.geometry.rasterizer import uv_sphere
from interactvlm_tpu_torch.models.sam import image_encoder as port_ie
from interactvlm_tpu_torch.models.sam.sam import Sam
from interactvlm_tpu_torch.ops.attention import attention_plain
from interactvlm_tpu_torch.ops.flash_attention import (
    flash_attention,
    padded_head_dim,
)
from interactvlm_tpu_torch.probes import data as data_probe
from interactvlm_tpu_torch.probes import decode as decode_probe
from interactvlm_tpu_torch.probes import int4 as int4_probe
from interactvlm_tpu_torch.probes import int8 as int8_probe
from interactvlm_tpu_torch.probes import lift as lift_probe
from interactvlm_tpu_torch.probes import sam as sam_probe
from interactvlm_tpu_torch.probes import train_step as train_step_probe
from interactvlm_tpu_torch.utils.weights import from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIFT_JAX_TOL = 1e-6
LIFT_RESIZE_TOL = 1e-5
SAM_TOL = 1e-4
ATTN_TOL = 1e-5


# ----------------------------------------------------------------- the lift
@pytest.mark.parametrize("shape", [((3, 64, 64), (16, 16), 50),
                                   ((2, 48, 40), (10, 14), 30)],
                         ids=["square", "non-integer-scale"])
def test_lowres_gather_lift_matches_jax_and_resize_then_gather(shape):
    (V, H, W), (h, w), N = shape
    rng = np.random.default_rng(1)
    p2v = rng.integers(-1, N, (V, H, W, 3)).astype(np.int32)
    bary = rng.dirichlet([1, 1, 1], (V, H, W)).astype(np.float32)
    low = rng.normal(size=(V, h, w)).astype(np.float32) * 6
    idx, wg = TL.build_gather_maps(p2v, bary, N)
    want = np.asarray(JL.lift_multiview_soft_gather_lowres(
        jnp.asarray(low), jnp.asarray(idx), jnp.asarray(wg), (H, W)))
    got = TL.lift_multiview_soft_gather_lowres(
        torch.from_numpy(low), torch.from_numpy(idx), torch.from_numpy(wg),
        (H, W))
    assert got.dtype == torch.float32 and got.shape == (N,)
    np.testing.assert_allclose(got.numpy(), want, atol=LIFT_JAX_TOL, rtol=0)
    full = F.interpolate(torch.from_numpy(low)[None], size=(H, W),
                         mode="bilinear", align_corners=False)[0]
    resized = TL.lift_multiview_soft_gather(full, torch.from_numpy(idx),
                                            torch.from_numpy(wg))
    np.testing.assert_allclose(got.numpy(), resized.numpy(),
                               atol=LIFT_RESIZE_TOL, rtol=0)


# ------------------------------------------------ SAM without rel-pos bias
def test_sam_encoder_without_rel_pos_matches_jax(monkeypatch):
    monkeypatch.setattr(jax_ie, "Attention", functools.partial(
        jax_ie.Attention, use_rel_pos=False))
    rng = np.random.default_rng(0)
    jcfg = dataclasses.replace(jax_sam_tiny(), window_size=3)
    tcfg = dataclasses.replace(sam_tiny(), window_size=3, use_rel_pos=False)
    px = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    txt = rng.standard_normal((2, 3, 32)).astype(np.float32)
    jm = JaxSam(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(px),
                              jnp.asarray(txt))
    tree = jax.tree.map(np.asarray, nn.meta.unbox(params))
    assert not any("rel_pos" in jax.tree_util.keystr(p) for p, _ in
                   jax.tree_util.tree_leaves_with_path(tree))
    tm = Sam(tcfg, device="cpu")
    assert not any("rel_pos" in n for n, _ in tm.named_parameters())
    missing, unexpected = tm.load_state_dict(
        from_jax_params(tree["params"]), strict=False)
    assert not unexpected
    assert all(k.startswith("prompt_encoder.mask_downscaling.")
               for k in missing)
    want = jax.jit(functools.partial(jm.apply, method=JaxSam.encode_image))(
        params, jnp.asarray(px))
    with torch.inference_mode():
        got = tm.encode_image(torch.from_numpy(px))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SAM_TOL,
                               rtol=SAM_TOL)


def test_identity_attention_is_qkv_then_proj():
    cfg = dataclasses.replace(sam_tiny(), identity_attention=True)
    attn = port_ie.Attention(cfg.encoder_embed_dim, 2, (4, 4), torch.float32,
                             "cpu", identity=True)
    assert not hasattr(attn, "rel_pos_h")
    x = torch.randn(2, 4, 4, cfg.encoder_embed_dim)
    want = attn.proj(attn.qkv(x)[..., :cfg.encoder_embed_dim])
    torch.testing.assert_close(attn(x), want)


# -------------------------------------------------- the padded flash route
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_at_head_dim_80_pads_to_128(causal):
    assert padded_head_dim(80) == 128 and padded_head_dim(64) == 64
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 3, 40, 80, generator=gen, requires_grad=True)
               for _ in range(3))
    out = flash_attention(q, k, v, causal=causal)
    want = attention_plain(q, k, v, causal=causal)
    assert out.shape == (2, 3, 40, 80)
    torch.testing.assert_close(out, want, atol=ATTN_TOL, rtol=ATTN_TOL)
    g = torch.randn_like(out)
    got = torch.autograd.grad(out, (q, k, v), g)
    ref = torch.autograd.grad(want, (q, k, v), g)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=ATTN_TOL, rtol=ATTN_TOL)


# --------------------------------------------------------- the probe twins
def _tiny_llama():
    return dataclasses.replace(llama_tiny(), num_layers=2)


RUNS = {
    "sam": lambda: sam_probe.main(list(sam_probe.VARIANTS), device="cpu",
                                  B=2, S=64, iters=1, base=sam_tiny()),
    "int8": lambda: int8_probe.main(device="cpu", M=48, iters=1),
    "int4": lambda: int4_probe.main(list(int4_probe.VARIANTS), device="cpu",
                                    B=8, iters=1, H=256, I=256, layers=1),
    "decode": lambda: decode_probe.main(
        list(decode_probe.VARIANTS), device="cpu", B=2, Lk=24, idx=20,
        iters=1, config=_tiny_llama()),
    "lift": lambda: lift_probe.main(device="cpu", B=2, H=64, iters=1,
                                    mesh=uv_sphere(12, 16)),
}


@pytest.mark.parametrize("probe", sorted(RUNS))
def test_probe_runs_every_variant_on_the_cpu(probe):
    res = RUNS[probe]()
    if probe == "int8":
        assert set(res) == set(int8_probe.SHAPES)
        assert all(set(r) == set(int8_probe.VARIANTS) for r in res.values())
    elif probe == "int4":
        assert all(f"{v}_ms" in res for v in int4_probe.VARIANTS)
        assert res["rel_rmse_int8_perchan"] < res["rel_rmse_int4_g128"]
    elif probe == "lift":
        assert set(lift_probe.VARIANTS) <= set(res)
        assert res["lowres_vs_resize_gather"] <= LIFT_RESIZE_TOL
        assert res["resize_scatter"]["max_abs_diff_vs_scatter"] == 0.0
    else:
        mod = {"sam": sam_probe, "decode": decode_probe}[probe]
        assert set(res) == set(mod.VARIANTS)
        assert all(np.isfinite(r["ms"]) for r in res.values())


def test_data_probe_reads_a_port_tree_serial_and_threaded(tmp_path):
    res = data_probe.main(["1", "2"], device="cpu", size=64, n_images=2,
                          n_batches=1, B=2, root=str(tmp_path / "tree"))
    assert res["decoder"] in ("native", "pil") and res["tree_s"] > 0
    for w in (1, 2):
        assert res[w]["s_per_batch"] > 0
        assert sum(res[w]["loads"].values()) > 0


def test_data_probe_times_and_counts_its_own_decodes(tmp_path, monkeypatch):
    """The race the probe once had, forced: the warm collate held while
    the look-ahead threads decode ahead, and every item started late. The
    timed loop must still see each of its samples decoded (non-empty
    loads) and spend at least one item's delay a batch."""
    from interactvlm_tpu_torch.data import collate as collate_mod
    from interactvlm_tpu_torch.data import datasets

    delay, hold = 0.1, 0.4
    get, collate = datasets.HContactDataset.__getitem__, collate_mod.collate

    def late_item(self, i):
        time.sleep(delay)
        return get(self, i)

    def held_warm_collate(samples, *args, **kwargs):
        if len(samples) == 1:  # the probe's warm collate
            time.sleep(hold)
        return collate(samples, *args, **kwargs)

    monkeypatch.setattr(datasets.HContactDataset, "__getitem__", late_item)
    monkeypatch.setattr(collate_mod, "collate", held_warm_collate)
    res = data_probe.main(["1", "2"], device="cpu", size=64, n_images=2,
                          n_batches=1, B=2, root=str(tmp_path / "tree"))
    for w in (1, 2):
        assert sum(res[w]["loads"].values()) > 0, res[w]
        assert res[w]["s_per_batch"] >= delay, res[w]


@pytest.mark.parametrize("env", [
    {},
    {"PROBE_INT8": "1", "PROBE_SAM_INT8": "1", "PROBE_ACCUM": "2",
     "PROBE_LEGS": "1", "PROBE_LEG_STEPS": "1"},
], ids=["lora", "qlora-samint8-accum-legs"])
def test_train_step_probe_prints_its_record(monkeypatch, capsys, env,
                                            tmp_path):
    out = tmp_path / "record.json"
    for k, v in dict(env, PROBE_LLAMA="tiny", PROBE_MASK="64",
                     PROBE_TEXT="20", PROBE_REPEATS="1", PROBE_STEPS="1",
                     PROBE_OUT=str(out)).items():
        monkeypatch.setenv(k, v)
    rec = train_step_probe.main(device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    import json

    assert json.loads(line) == rec == json.loads(out.read_text())
    assert rec["value"] > 0 and np.isfinite(rec["final_loss"])
    assert rec["budget_fits"] and rec["seq_len"] == 275
    assert ("legs" in rec) == ("PROBE_LEGS" in env)


UNKNOWN = {
    "sam": lambda: sam_probe.main(["nope"], device="cpu"),
    "int8": lambda: int8_probe.main(["nope"], device="cpu"),
    "int4": lambda: int4_probe.main(["nope"], device="cpu"),
    "decode": lambda: decode_probe.main(["nope"], device="cpu"),
    "lift": lambda: lift_probe.main(["nope"], device="cpu"),
    "data": lambda: data_probe.main(["0"], device="cpu"),
    "train_step": lambda: train_step_probe.main(["nope"], device="cpu"),
}


@pytest.mark.parametrize("probe", sorted(UNKNOWN))
def test_probe_raises_on_an_unknown_variant(probe):
    with pytest.raises(ValueError):
        UNKNOWN[probe]()


def _nan(*a, **k):
    raise_or = a[0] if a and torch.is_tensor(a[0]) else None
    shape = (1,) if raise_or is None else raise_or.shape[:-1] + (1,)
    return torch.full(shape, float("nan"))


def _boom(*a, **k):
    raise RuntimeError("boom")


FAILING = {
    "sam": (port_ie.ImageEncoderViT, "forward",
            lambda self, x: torch.full((1,), float("nan")),
            lambda: sam_probe.main(["full"], device="cpu", B=1, S=64,
                                   iters=1, base=sam_tiny())),
    "int8": (int8_probe, "int8_matmul_fused", _nan,
             lambda: int8_probe.main(["proj"], device="cpu", M=16, iters=1,
                                     names=("pallas",))),
    "int4": (int4_probe, "int8_matmul_fused", _nan,
             lambda: int4_probe.main(["int8"], device="cpu", B=8, iters=1,
                                     H=256, I=512, layers=1)),
    "decode": (decode_probe, "_int8_cache_attention", _nan,
               lambda: decode_probe.main(["attn_int8"], device="cpu", B=2,
                                         Lk=24, idx=20, iters=1,
                                         config=_tiny_llama())),
    "lift": (lift_probe, "lift_multiview_soft_gather_lowres", _boom,
             lambda: lift_probe.main(["vmap_lowres"], device="cpu", B=1,
                                     H=32, iters=1, mesh=uv_sphere(6, 8))),
    "train_step": (train_step_probe, "reset_peak", _boom,
                   lambda: train_step_probe.main(device="cpu")),
}


@pytest.mark.parametrize("probe", sorted(FAILING) + ["data"])
def test_probe_raises_on_a_failing_variant(probe, monkeypatch, tmp_path):
    monkeypatch.setenv("PROBE_LLAMA", "tiny")
    monkeypatch.setenv("PROBE_MASK", "64")
    monkeypatch.setenv("PROBE_TEXT", "20")
    if probe == "data":
        from interactvlm_tpu_torch.data import datasets as TD

        monkeypatch.setattr(TD.HContactDataset, "plan", _boom)
        with pytest.raises(RuntimeError, match="boom"):
            data_probe.main(["1"], device="cpu", size=32, n_images=1,
                            n_batches=1, B=1, root=str(tmp_path / "t"))
        return
    target, attr, bad, run = FAILING[probe]
    monkeypatch.setattr(target, attr, bad)
    with pytest.raises(RuntimeError, match="non-finite|boom"):
        run()


@pytest.mark.parametrize("probe", [sam_probe, int8_probe, int4_probe,
                                   decode_probe, lift_probe, data_probe,
                                   train_step_probe],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_probe_defaults_to_the_gpu(probe):
    assert inspect.signature(probe.main).parameters["device"].default == \
        "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            probe.main({data_probe: ["1"], train_step_probe: None}.get(
                probe, ["x"]))


def test_launch_counters_cover_every_kernel_and_reset(monkeypatch):
    """``probes/common.py`` keeps the one list of counted wrappers: every
    kernel of ``chip_smoke.py``'s line is in it, ``read_launches`` gives
    each count and each route's, ``reset_launches`` zeroes them all, and
    ``launches_since`` keeps the kernels that launched only."""
    import chip_smoke
    from interactvlm_tpu_torch.probes import common as C

    assert (set(chip_smoke.KERNELS) | {"int8_gemm", "int4_gemm"}
            == set(C.WRAPPERS))
    for n, w in C.WRAPPERS.items():
        monkeypatch.setattr(w, "launches", 3)
    for w in C.ROUTES.values():
        for r in w.route_launches:
            monkeypatch.setitem(w.route_launches, r, 2)
    before = C.launch_counts()
    C.WRAPPERS["int8_matmul"].launches += 1
    C.ROUTES["int8_routes"].route_launches["one_launch"] += 1
    assert C.launches_since(before) == {"int8_matmul": 1,
                                        "int8_one_launch": 1}
    got = C.read_launches()
    assert got["int8_matmul"] == 4 and got["int8_gemm"] == 3
    assert got["int8_routes"] == {"one_launch": 3, "two_pass": 2}
    C.reset_launches()
    assert all(not v if not isinstance(v, dict) else not any(v.values())
               for v in C.read_launches().values())


def test_card_busy_is_the_union_of_spans_and_none_on_the_cpu():
    """The busy reader counts overlapping spans once; on the CPU it reads
    nothing, and the host's issue time is within the wall time."""
    from interactvlm_tpu_torch.probes import common as C

    evs = [("a", 0, 10), ("b", 5, 10), ("c", 30, 5), ("d", 31, 2)]
    assert C.busy_ns(evs) == 20 and C.busy_ns([]) == 0
    cpu = torch.device("cpu")
    assert C.device_busy_ms(lambda: None, cpu) is None
    issue, wall = C.issue_and_wall_ms(lambda: torch.ones(4).sum(), cpu)
    assert 0 <= issue <= wall


def test_int4_error_report_equals_the_jax_script():
    """The JAX script's ``quant_error_group128`` (read from its source, so
    the script's module-level JAX set-up does not run here) against the
    twin's, on the same seeded Gaussian weights at LLaMA-7B's width."""
    path = os.path.join(REPO, "scripts", "int4_probe.py")
    src = open(path).read()
    fn = next(n for n in ast.parse(src).body if isinstance(
        n, ast.FunctionDef) and n.name == "quant_error_group128")
    ns = {"np": np, "H": 4096, "B": 8, "GROUP": 128}
    exec(compile(ast.Module([fn], []), path, "exec"), ns)
    assert int4_probe.quant_error_group128(4096, 8) == \
        ns["quant_error_group128"]()


# ------------------------------------------------------- the launcher twins
def _commands(path):
    """The ``python -m`` command lines of a launcher, continuation lines
    joined, as token lists."""
    text = open(path).read().replace("\\\n", " ")
    return [shlex.split(line.strip()) for line in text.splitlines()
            if line.strip().startswith("python -m")]


class _Parsed(Exception):
    pass


def _parse(main, argv, monkeypatch):
    """The namespace ``main(argv)`` parses, without running the rest."""
    orig = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        raise _Parsed(orig(self, args, namespace))

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        try:
            main(argv)
        except _Parsed as e:
            return vars(e.args[0])
    raise AssertionError(f"{main} parsed nothing")


# each launcher's "$..." words, and the extra arguments "$@" stands for
PLACEHOLDERS = {
    "$RUN_DIR": "runs/x", "$1": "in", "$2": "out", "${3:-hcontact}":
    "hcontact", "$RECIPE": "damon",
}
EXTRA = {"datagen": ["--root", "r", "--contact_pkl", "c.pkl"],
         "train": ["--batch_size", "4"]}
CLIS = {
    "train": ("interactvlm_tpu.train.train", "interactvlm_tpu_torch.train.train"),
    "eval": ("interactvlm_tpu.eval.evaluate",
             "interactvlm_tpu_torch.eval.evaluate"),
    "demo": ("interactvlm_tpu.demo.run_demo",
             "interactvlm_tpu_torch.demo.run_demo"),
    "optim": ("interactvlm_tpu.fit.data_io", "interactvlm_tpu_torch.fit.data_io"),
    "datagen": ("interactvlm_tpu.datagen.__main__",
                "interactvlm_tpu_torch.datagen.__main__"),
    "prepare_weights": ("interactvlm_tpu.train.export",
                        "interactvlm_tpu_torch.train.export"),
}


@pytest.mark.parametrize("name", sorted(CLIS))
def test_launcher_twin_keeps_its_original_presets(name, monkeypatch):
    import importlib

    orig = _commands(os.path.join(REPO, "scripts", f"run_{name}.sh"))
    twin = _commands(os.path.join(REPO, "scripts", f"run_{name}_torch.sh"))
    assert len(twin) == len(orig) > 0
    jmain = importlib.import_module(CLIS[name][0]).main
    tmain = importlib.import_module(CLIS[name][1]).main
    for o, t in zip(orig, twin):
        # word for word, the module renamed
        assert t == [re.sub(r"^interactvlm_tpu\.", "interactvlm_tpu_torch.",
                            w) for w in o]
        argv = []
        for w in t[3:]:
            if w.startswith("$@") or w.startswith("${@"):
                argv += EXTRA.get(name, [])
            else:
                argv.append(PLACEHOLDERS.get(w, w))
        want = _parse(jmain, argv, monkeypatch)
        got = _parse(tmain, argv, monkeypatch)
        shared = set(want) & set(got)
        assert set(want) - {"distributed"} <= set(got), set(want) - set(got)
        assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
        if "device" in got:
            assert got["device"] == "cuda"


def test_run_train_torch_synthetic_smoke_on_the_cpu(tmp_path):
    res = subprocess.run(
        ["bash", os.path.join("scripts", "run_train_torch.sh"),
         "synthetic-smoke", "--device", "cpu", "--log_base_dir",
         str(tmp_path), "--no_tensorboard"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert os.path.isdir(tmp_path / "ivlm_tpu")
