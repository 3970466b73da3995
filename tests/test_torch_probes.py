"""The port's three probes (``interactvlm_tpu_torch/probes/``) against the
JAX package's, on the CPU: the plain version of the tensor-core rate loop
against ``scripts/mxu_probe.py``'s Pallas kernel and of the window copy
against ``scripts/winattn_probe.py``'s, both in interpret mode; the chained
matmuls of the slice (the two-pass int8 form and the bf16 GELU form) against
the JAX package's public functions on the same weights; and each probe's
entry point at tiny sizes.

Tolerances:
- the rate loop: int8 products exactly (int32 wraps; the f32 sums of
  integers stay below 2^24 here, so they are exact too); bf16 and f32
  within 1e-5 of the largest output: both sum f32 products in another
  order.
- the copy: bit for bit.
- the chain, two iterations of two matmuls each. The two-pass int8 form:
  the port's x_scale divides by 127 where the XLA-compiled JAX function
  multiplies by its reciprocal (one f32 ulp apart), which can move a bf16
  output by one rounding step and, through the next quantization, one int8
  step of an activation: each element within 2^-6 of its magnitude plus
  2^-6 of the output's RMS, the RMS error within 2^-8 of the RMS. The bf16
  GELU form: the JAX erf polynomial against erf and the f32 summation order
  move bf16 outputs by a rounding step, which the next matmul carries: the
  same limits.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from interactvlm_tpu.ops import sam_attention as jsa
from interactvlm_tpu.ops.int8_matmul import (
    int8_matmul_prequant as jax_prequant,
)
from interactvlm_tpu.ops.int8_matmul import quantize_rows as jax_quantize_rows
from interactvlm_tpu.ops.quant import quantize_int8 as jax_quantize_int8
from interactvlm_tpu.ops.serving_matmul import fused_dense as jax_fused_dense
from interactvlm_tpu_torch.ops import sam_attention as sa
from interactvlm_tpu_torch.ops.mxu import (
    COMBOS,
    TILES,
    loop_slices,
    mxu_loop,
    mxu_loop_plain,
    tile_count,
)
from interactvlm_tpu_torch.probes import chain, mxu, winattn
from interactvlm_tpu_torch.utils.weights import (
    int8_weight_from_jax,
    linear_weight_from_jax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAIN_RTOL, CHAIN_ATOL_OF_RMS, CHAIN_RMS = 2.0 ** -6, 2.0 ** -6, 2.0 ** -8


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("in_dtype,acc_dtype", [
    ("bfloat16", "float32"), ("int8", "int32"), ("int8", "float32"),
    ("float32", "float32")])
def test_mxu_loop_plain_matches_the_pallas_probe_kernel(in_dtype, acc_dtype):
    mp = _script("mxu_probe")
    M, K, N, loops = mp.M, mp.K, mp.N, 3
    rng = np.random.default_rng(0)
    if in_dtype == "int8":
        x = rng.integers(-127, 128, (M, K)).astype(np.int8)
        w = rng.integers(-127, 128, (K, N)).astype(np.int8)
    else:
        x = np.array(jnp.asarray(rng.standard_normal((M, K)), in_dtype)
                     .astype(jnp.float32))
        w = np.array(jnp.asarray(rng.standard_normal((K, N)), in_dtype)
                     .astype(jnp.float32))
    jdt = jnp.dtype(in_dtype)
    want = np.asarray(pl.pallas_call(
        functools.partial(mp._kernel, acc_dtype=jnp.dtype(acc_dtype),
                          loops=loops),
        out_shape=jax.ShapeDtypeStruct((M, N), jnp.float32),
        interpret=True)(jnp.asarray(x, jdt), jnp.asarray(w, jdt)))
    tdt = getattr(torch, in_dtype)
    tx = torch.from_numpy(x).to(tdt)
    tw = torch.from_numpy(np.ascontiguousarray(w.T)).to(tdt)
    got = mxu_loop_plain(tx, tw, loops, getattr(torch, acc_dtype))
    assert got.dtype == torch.float32 and got.shape == (M, N)
    if in_dtype == "int8":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert torch.equal(mxu_loop(tx, tw, loops, getattr(torch, acc_dtype)), got)


def test_mxu_loop_plain_wraps_int32_sums():
    """int32 accumulation wraps as two's complement, as on the card."""
    x = torch.full((1, 128), 127, dtype=torch.int8)
    w = torch.full((1, 128), 127, dtype=torch.int8)
    loops = 2000  # 127^2 * 128 * 2000 = 4.13e9 > 2^31
    exact = 127 * 127 * 128 * loops
    want = (exact + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert mxu_loop_plain(x, w, loops, torch.int32).item() == float(want)
    assert mxu_loop_plain(x, w, loops, torch.float32).item() > 2 ** 31


@pytest.mark.parametrize("combo,M,N,tiles", [
    (0, 512, 1280, 20),  # the probe's shape in 128 x 256 tiles
    (1, 512, 1280, 20),
    (2, 512, 1280, 40),  # 128 x 128: two int32 sets beside the f32 sums
    (3, 512, 1280, 160),  # the f32 kernel's 64 x 64
    (0, 200, 328, 4),  # ragged edges take a whole tile each
    (2, 70, 136, 2),
])
def test_tile_count_by_combination(combo, M, N, tiles):
    """The rate loop's output tiles, whose count sets how many slices the
    loops split into: every combination in ``COMBOS`` has its tile."""
    assert set(TILES) == set(COMBOS.values())
    assert tile_count(combo, M, N) == tiles
    assert (tiles * loop_slices(tiles, 2048, 132)) % 132 == 0


def test_loop_slices_even_out_the_sms():
    """512 x 1280 on 64 x 64 tiles is 160 tiles: 33 slices give 5280
    blocks, 40 on each of 132 SMs; never more slices than loops."""
    assert loop_slices(160, 2048, 132) == 33
    assert (160 * loop_slices(160, 2048, 132)) % 132 == 0
    assert loop_slices(160, 5, 132) == 5
    assert loop_slices(1320, 2048, 132) == 1


def test_window_copy_matches_the_pallas_copy():
    """``scripts/winattn_probe.py:123-140``, rebuilt: the copy over q, k and
    v padded to the TPU kernel's (224, 128) tiles, sliced back."""
    BW, nH, L, D, Lg, Dp = 2, 16, 196, 80, 224, 128
    rng = np.random.default_rng(1)
    q, k, v = (jnp.asarray(rng.standard_normal((BW, nH, L, D)), jnp.bfloat16)
               for _ in range(3))

    def _copy(q_ref, k_ref, v_ref, o_ref):
        o_ref[...] = q_ref[...]

    spec = pl.BlockSpec((1, nH, Lg, Dp), lambda b: (b, 0, 0, 0),
                        memory_space=pltpu.VMEM)
    padded = [jsa._pad_to(jsa._pad_to(t, Lg, 2), Dp, 3) for t in (q, k, v)]
    want = pl.pallas_call(
        _copy, grid=(BW,), in_specs=[spec] * 3, out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((BW, nH, Lg, Dp), q.dtype),
        interpret=True)(*padded)[:, :, :L, :D]
    tq, tk, tv = (torch.from_numpy(np.array(t.astype(jnp.float32))).to(
        torch.bfloat16).reshape(BW * nH, L, D) for t in (q, k, v))
    got = sa.window_copy(tq, tk, tv)
    assert got.data_ptr() != tq.data_ptr()
    np.testing.assert_array_equal(
        got.float().reshape(BW, nH, L, D).numpy(),
        np.asarray(want.astype(jnp.float32)))


def _chain_weights(K, N, seed=2):
    """Seeded numpy weights at the probe's scales (a non-zero bias), in the
    JAX layout and carried into the port's by ``utils/weights.py``."""
    rng = np.random.default_rng(seed)
    w1 = jnp.asarray(rng.standard_normal((K, N)) * K ** -0.5, jnp.bfloat16)
    w2 = jnp.asarray(rng.standard_normal((N, K)) * N ** -0.5, jnp.bfloat16)
    b1 = jnp.asarray(rng.standard_normal(N) * 0.1, jnp.bfloat16)
    w1q, w1s = jax_quantize_int8(w1.astype(jnp.float32), axis=0)
    w2q, w2s = jax_quantize_int8(w2.astype(jnp.float32), axis=0)
    jw = dict(w1=w1, w2=w2, b1=b1, w1q=w1q, w1s=w1s, w2q=w2q, w2s=w2s)
    tw = chain.ChainWeights(
        linear_weight_from_jax(w1, torch.bfloat16),
        linear_weight_from_jax(w2, torch.bfloat16),
        torch.from_numpy(np.array(b1.astype(jnp.float32))).bfloat16(),
        *int8_weight_from_jax(w1q, w1s), *int8_weight_from_jax(w2q, w2s))
    return jw, tw


def _jax_step(name, w):
    if name == "pallas_int8_pre":
        def step(x):
            y = jax_prequant(*jax_quantize_rows(x, interpret=True), w["w1q"],
                             w["w1s"], interpret=True)
            return jax_prequant(*jax_quantize_rows(y, interpret=True),
                                w["w2q"], w["w2s"], interpret=True)
    else:
        def step(x):
            y = jax_fused_dense(x, w["w1"], b=w["b1"], activation="gelu",
                                interpret=True)
            return jax_fused_dense(y, w["w2"], interpret=True)
    return step


@pytest.mark.parametrize("name", ["pallas_int8_pre", "pallas_gelu"])
def test_chain_slice_matches_the_jax_package(name):
    """Two iterations of the chain at M=64, K=256, N=512 through the port
    (its plain versions) and through the JAX package's kernels."""
    M, K, N, iters = 64, 256, 512, 2
    jw, tw = _chain_weights(K, N)
    x0 = jnp.asarray(np.random.default_rng(3).standard_normal((M, K)),
                     jnp.bfloat16)
    want = x0
    for _ in range(iters):
        want = _jax_step(name, jw)(want).astype(jnp.bfloat16)
    want = np.asarray(want.astype(jnp.float32))
    tx0 = torch.from_numpy(np.array(x0.astype(jnp.float32))).bfloat16()
    got = chain.run_chain(chain.steps(tw)[name], tx0, iters)
    assert got.dtype == torch.bfloat16 and got.shape == (M, K)
    got = got.float().numpy()
    rms = np.sqrt(np.mean(want ** 2))
    err = np.abs(got - want)
    assert np.all(err <= CHAIN_RTOL * np.abs(want) + CHAIN_ATOL_OF_RMS * rms)
    assert np.sqrt(np.mean(err ** 2)) <= CHAIN_RMS * rms


def test_chain_int8_forms_agree_in_the_port():
    """The fused int8 kernel and the two-pass form give the same bits
    without a bias or an activation."""
    _, tw = _chain_weights(256, 512)
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(64, 256, generator=gen).bfloat16()
    fns = chain.steps(tw)
    assert torch.equal(chain.run_chain(fns["pallas_int8"], x, 2),
                       chain.run_chain(fns["pallas_int8_pre"], x, 2))


def test_chain_main_runs_every_variant_on_the_cpu():
    res = chain.main(list(chain.VARIANTS), device="cpu", M=64, K=256, N=512,
                     iters=2)
    assert list(res) == list(chain.VARIANTS)
    for r in res.values():
        assert r["ms_per_matmul"] > 0 and np.isfinite(r["tflops"])
        assert all(n == 0 for n in r["launches"].values())  # CPU: no kernel
    assert set(res["pallas_int8_pre"]["launches"]) == {
        "quantize_rows", "int8_matmul_prequant"}


def test_mxu_main_runs_every_combination_on_the_cpu():
    res = mxu.main(device="cpu", loops=4, shape=(64, 128, 64))
    assert list(res) == [c[0] for c in mxu.COMBOS]


def test_winattn_main_runs_every_variant_on_the_cpu():
    res = winattn.main(list(winattn.VARIANTS), device="cpu", bw=1, iters=2,
                       global_batch=1, global_side=8)
    assert list(res) == list(winattn.VARIANTS)
    assert res["kernel_copy"]["launches"] == {"window_copy": 0}
    assert res["global_plain"]["launches"] == {"flash_forward": 0}


def _boom(*args, **kwargs):
    raise RuntimeError("boom")


@pytest.mark.parametrize("probe", ["chain", "mxu", "winattn"])
def test_probes_raise_on_a_failing_variant(probe, monkeypatch):
    if probe == "chain":
        monkeypatch.setattr(chain, "fused_dense", _boom)
        run = functools.partial(chain.main, ["xla_bf16", "pallas_bf16"],
                                device="cpu", M=32, K=64, N=64, iters=1)
    elif probe == "mxu":
        monkeypatch.setattr(mxu, "mxu_loop", _boom)
        run = functools.partial(mxu.main, device="cpu", loops=4,
                                shape=(64, 128, 64))
    else:
        monkeypatch.setattr(sa, "window_copy", _boom)
        run = functools.partial(winattn.main, ["kernel_copy"], device="cpu",
                                bw=1, iters=1, global_batch=1, global_side=8)
    with pytest.raises(RuntimeError, match="boom"):
        run()


def test_probes_raise_on_non_finite_output_and_unknown_variants(monkeypatch):
    monkeypatch.setattr(chain, "fused_dense",
                        lambda x, w, *a, **k: torch.full(
                            (*x.shape[:-1], w.shape[0]), float("nan"),
                            dtype=x.dtype))
    with pytest.raises(RuntimeError, match="non-finite"):
        chain.main(["pallas_bf16"], device="cpu", M=32, K=64, N=64, iters=1)
    with pytest.raises(ValueError, match="unknown"):
        chain.main(["pallas_bf17"], device="cpu", M=32, K=64, N=64, iters=1)
    with pytest.raises(ValueError, match="unknown"):
        winattn.main(["kernels"], device="cpu", bw=1, iters=1)


@pytest.mark.parametrize("run", [
    lambda: chain.main(["xla_bf16"], M=32, K=64, N=64, iters=1),
    lambda: mxu.main(loops=4, shape=(64, 128, 64)),
    lambda: winattn.main(["xla"], bw=1, iters=1),
], ids=["chain", "mxu", "winattn"])
def test_probes_default_to_the_gpu(run):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        run()


def test_kernel_variants_edit_the_current_sources():
    """Every knock-out of the window kernel's variant probe still finds each
    text it edits exactly once in the sources it would build."""
    from interactvlm_tpu_torch.probes import kernel_variants as kv

    for name in kv.VARIANTS:
        edited = kv.edited_sources(name)
        assert set(edited) == set(kv.VARIANTS[name])
