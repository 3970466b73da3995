"""The port's int8 quantization against the JAX package's, on the CPU: the
quantizer, the int8 matmul composition, the fused kernel's plain version
against the Pallas kernel in interpret mode, the int8 KV cache append, and
the int8 serving converters.

Tolerances, with the reason for each:
- quantize_int8, the cache append and the converters: exact (the same f32
  arithmetic, round half to even on both sides);
- int8_matmul: 1e-6 of the output's largest magnitude (an exact int32 sum
  on both sides, the same f32 rescale; only the f32 rounding of a product
  may differ);
- the fused plain version against the Pallas kernel: f32 outputs within
  1e-5 of the largest magnitude (the Pallas GELU is an erf polynomial
  within 1.5e-7 of ``torch.erf``, times |x| / 2); bf16 outputs within one
  bf16 rounding step (2^-7 of the value) plus that, since an f32 result one
  ulp apart can round to neighbouring bf16 values.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interactvlm_tpu.config import llama_tiny as jax_llama_tiny
from interactvlm_tpu.config import sam_tiny as jax_sam_tiny
from interactvlm_tpu.models.llama import LlamaForCausalLM as JaxLlama
from interactvlm_tpu.models.sam.sam import Sam as JaxSam
from interactvlm_tpu.ops import quant as jq
from interactvlm_tpu.ops.int8_matmul import int8_matmul_fused as jax_fused
from interactvlm_tpu.utils.weights import (
    int8_sam_encoder_params,
    int8_serving_params,
)
from interactvlm_tpu_torch.config import llama_tiny
from interactvlm_tpu_torch.ops import quant as tq
from interactvlm_tpu_torch.ops.int8_matmul import (
    int8_matmul_fused,
    int8_matmul_fused_plain,
)
from interactvlm_tpu_torch.utils.weights import (
    from_jax_params,
    int8_sam_encoder_state_dict,
    int8_serving_state_dict,
)

BF16_STEP = 2.0 ** -7


def _bf16_exact(a):
    """f32 values that bf16 holds exactly, so both packages see one input."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _tie_rows(rng, K):
    """Rows whose amax is 127, so scale = 1 and x / scale = x: the halves
    (2.5 -> 2, 3.5 -> 4, -2.5 -> -2, 0.5 -> 0) show the rounding rule."""
    x = rng.uniform(-100, 100, (3, K)).astype(np.float32)
    x[:, 0] = 127.0
    x[:, 1:9] = [2.5, 3.5, -2.5, -3.5, 0.5, 1.5, -0.5, 126.5]
    x[2] = 0.0  # a zero row: the scale floor, q = 0
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [-1, 0])
def test_quantize_int8_is_byte_identical(dtype, axis):
    rng = np.random.default_rng(0)
    x = np.concatenate([_tie_rows(rng, 64),
                        rng.standard_normal((5, 64)).astype(np.float32) * 3])
    x = _bf16_exact(x)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jqv, js = jq.quantize_int8(jx, axis=axis)
    tqv, ts = tq.quantize_int8(tx, axis=axis)
    assert tqv.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if axis == -1:
        assert tqv[0, 1:9].tolist() == [2, 4, -2, -4, 0, 2, 0, 126]
        assert (tqv[2] == 0).all() and ts[2, 0] == np.float32(1e-8) / 127
    np.testing.assert_allclose(
        tq.dequantize_int8(tqv, ts).numpy(),
        np.asarray(jq.dequantize_int8(jqv, js)), rtol=0, atol=0)


def test_exact_div_rounds_once():
    """``127.0 / x`` in torch is reciprocal(x) * 127, two roundings, and
    misses IEEE division (numpy's, XLA's, the kernel's) on about a quarter
    of f32 values; ``exact_div`` matches it on all of them."""
    rng = np.random.default_rng(6)
    a = (np.abs(rng.standard_normal(100_000)) * 5 + 1e-3).astype(np.float32)
    t = torch.from_numpy(a)
    np.testing.assert_array_equal(tq.exact_div(127.0, t).numpy(),
                                  np.float32(127) / a)
    np.testing.assert_array_equal(tq.exact_div(t, 127.0).numpy(),
                                  a / np.float32(127))
    assert ((127.0 / t).numpy() != np.float32(127) / a).mean() > 0.1


@pytest.mark.parametrize("lead", [(6,), (2, 5)])
def test_int8_matmul_matches_jax(lead):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(lead + (96,)).astype(np.float32)
    w = rng.standard_normal((96, 40)).astype(np.float32)
    wq, ws = jq.quantize_int8(jnp.asarray(w), axis=0)
    want = np.asarray(jq.int8_matmul(jnp.asarray(x), wq, ws, jnp.float32))
    got = tq.int8_matmul(torch.from_numpy(x),
                         torch.from_numpy(np.asarray(wq).T.copy()),
                         torch.from_numpy(np.asarray(ws)[0].copy()), torch.float32)
    assert got.shape == lead + (40,)
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 1e-6 * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ["none", "gelu", "gelu_tanh"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_fused_plain_matches_pallas_interpret(dtype, activation, with_bias):
    """39 rows (not a multiple of the Pallas row block, which pads to it),
    one of them zero: it must write act(bias)."""
    rng = np.random.default_rng(2)
    K, N = 256, 128
    x = _bf16_exact(rng.standard_normal((3, 13, K)).astype(np.float32) * 2)
    x[0, 0] = 0.0
    w = rng.standard_normal((K, N)).astype(np.float32) * K ** -0.5
    bias = rng.standard_normal(N).astype(np.float32) if with_bias else None
    wq, ws = jq.quantize_int8(jnp.asarray(w), axis=0)
    jdt = jnp.dtype(dtype)
    want = np.asarray(jax_fused(
        jnp.asarray(x, jdt), wq, ws, dtype=jdt, activation=activation,
        bias=None if bias is None else jnp.asarray(bias),
        interpret=True)).astype(np.float32)
    tdt = getattr(torch, dtype)
    tb = None if bias is None else torch.from_numpy(bias)
    args = (torch.from_numpy(x).to(tdt),
            torch.from_numpy(np.asarray(wq).T.copy()),
            torch.from_numpy(np.asarray(ws)[0].copy()), tb, activation)
    got = int8_matmul_fused_plain(*args)
    assert got.dtype == tdt and got.shape == (3, 13, N)
    # on a CPU tensor the wrapper is the plain version, and launches nothing
    before = int8_matmul_fused.launches
    torch.testing.assert_close(int8_matmul_fused(*args), got, rtol=0, atol=0)
    assert int8_matmul_fused.launches == before
    got = got.float().numpy()
    scale = np.abs(want).max()
    limit = 1e-5 * scale + (BF16_STEP * np.abs(want) if dtype == "bfloat16"
                            else 0.0)
    err = np.abs(got - want)
    assert (err <= limit).all(), (err.max(), scale)
    zero_row = np.asarray(int8_matmul_fused_plain(
        torch.zeros(1, K), args[1], args[2], tb, activation))[0]
    np.testing.assert_allclose(got[0, 0], zero_row, rtol=0,
                               atol=BF16_STEP * np.abs(zero_row).max())
    assert np.isfinite(got).all()


def test_append_kv_cache_int8_matches_jax_exactly():
    """A prompt chunk, then two single-token steps, written at the cursor."""
    cfg = llama_tiny()
    jcfg = jax_llama_tiny()
    rng = np.random.default_rng(3)
    B, Lmax = 2, 9
    jc = jq.init_kv_cache_int8(jcfg, B, Lmax)[0]
    tc = tq.init_kv_cache_int8(cfg, B, Lmax, "cpu")[0]
    for L in (5, 1, 1):
        k, v = (rng.standard_normal((B, L, cfg.num_kv_heads, cfg.head_dim))
                .astype(np.float32) * 3 for _ in range(2))
        jc = jq.append_kv_cache_int8(jc, jnp.asarray(k), jnp.asarray(v))
        same = tq.append_kv_cache_int8(tc, torch.from_numpy(k),
                                       torch.from_numpy(v))
        assert same is tc  # written in place
    assert tc["index"] == int(jc["index"]) == 7
    for name in ("k", "v", "k_scale", "v_scale"):
        assert tc[name].dtype == getattr(torch, str(np.asarray(jc[name]).dtype))
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))


def _unbox(params):
    return jax.tree.map(np.asarray, nn.meta.unbox(params))


def _jax_tree(part):
    if part == "llama":
        return JaxLlama(jax_llama_tiny()).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    return JaxSam(jax_sam_tiny()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((1, 3, 32)))


def _convert_jax(part, tree):
    if part == "llama":
        return int8_serving_params(tree)
    return {**tree, "image_encoder": int8_sam_encoder_params(
        tree["image_encoder"])}


def _convert_port(part, sd):
    if part == "llama":
        return int8_serving_state_dict(sd)
    enc = {k: v for k, v in sd.items() if k.startswith("image_encoder.")}
    return {**sd, **int8_sam_encoder_state_dict(enc)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("part", ["llama", "sam"])
def test_converters_give_the_jax_bytes(part, dtype):
    """The port's converter on a port state dict gives what
    ``from_jax_params`` makes of the JAX converter's int8 tree: the same
    int8 bytes (in the (out, in) layout), the same f32 scales, and every
    other entry unchanged."""
    tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, dtype)),
                        _unbox(_jax_tree(part))["params"])
    port_sd = {k: v.to(getattr(torch, dtype))
               for k, v in from_jax_params(tree).items()}
    got = _convert_port(part, port_sd)
    want = from_jax_params(_convert_jax(part, tree))
    assert set(got) == set(want)
    n_int8 = (7 * jax_llama_tiny().num_layers + 1 if part == "llama"
              else 4 * jax_sam_tiny().encoder_depth)
    assert sum(t.dtype == torch.int8 for t in want.values()) == n_int8
    for key, t in want.items():
        if t.dtype == torch.int8 or key.endswith("weight_scale"):
            assert got[key].dtype == t.dtype, key
        np.testing.assert_array_equal(got[key].float().numpy(),
                                      t.float().numpy(), err_msg=key)


# ------------------------------------------------------------------ int4
# Tolerances: the int4 bytes exact, scales and row factors within two f32
# ulps (the row factor's mean over the columns is summed in another order
# than XLA's); unpack exact, and dequantize on the same inputs; int4_matmul
# within 1e-6 of the output's largest magnitude, as int8_matmul (an exact
# integer sum on both sides, the same f32 rescale).


def _int4_weight(rng, K, N, rows_scaled=True):
    """A (K, N) weight with structured row energies (so the group row
    factors differ from 1), as bf16-exact f32."""
    w = rng.standard_normal((K, N)).astype(np.float32)
    if rows_scaled:
        w *= np.exp(rng.standard_normal((K, 1))).astype(np.float32)
    return _bf16_exact(w)


@pytest.mark.parametrize("K,N", [(64, 24), (256, 40), (512, 136)])
def test_quantize_int4_is_byte_identical(K, N):
    rng = np.random.default_rng(K)
    w = _int4_weight(rng, K, N)
    jq4, js, jrf = jq.quantize_int4(jnp.asarray(w))
    tq4, ts, trf = tq.quantize_int4(torch.from_numpy(w.T.copy()))
    assert tq4.dtype == torch.int8 and tq4.shape == (N, K // 2)
    np.testing.assert_array_equal(tq4.numpy(), np.asarray(jq4).T)
    # the group row factor is an f32 mean over the N columns, summed by XLA
    # and torch in different orders: within two ulps, and the column
    # scales with it
    np.testing.assert_allclose(ts.numpy(), np.asarray(js)[0], rtol=2 ** -22,
                               atol=0)
    np.testing.assert_allclose(trf.numpy(), np.asarray(jrf), rtol=2 ** -22,
                               atol=0)
    assert (K >= 256) == bool((trf != 1).any())  # group factors where K allows
    lo, hi = tq.unpack_int4(tq4)
    jlo, jhi = jq.unpack_int4(jq4)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo).T)
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi).T)
    assert int(min(lo.min(), hi.min())) == -7  # symmetric: amax maps to 7
    assert int(max(lo.max(), hi.max())) == 7
    np.testing.assert_allclose(
        tq.dequantize_int4(tq4, ts, trf).numpy(),
        np.asarray(jq.dequantize_int4(jq4, js, jrf)).T, rtol=2 ** -21, atol=0)
    # on the same bytes and scales, dequantize is exact
    np.testing.assert_array_equal(
        tq.dequantize_int4(tq4, torch.from_numpy(np.asarray(js)[0].copy()),
                           torch.from_numpy(np.asarray(jrf).copy())).numpy(),
        np.asarray(jq.dequantize_int4(jq4, js, jrf)).T)


def test_unpack_int4_covers_every_byte():
    packed = torch.arange(-128, 128, dtype=torch.int8)[None]
    lo, hi = tq.unpack_int4(packed)
    jlo, jhi = jq.unpack_int4(jnp.asarray(packed.numpy().T))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo).T)
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi).T)


@pytest.mark.parametrize("lead,K", [((6,), 256), ((2, 5), 64)])
def test_int4_matmul_matches_jax(lead, K):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(lead + (K,)).astype(np.float32)
    jq4, js, jrf = jq.quantize_int4(jnp.asarray(_int4_weight(rng, K, 40)))
    for dtype in ("float32", "bfloat16"):
        want = np.asarray(jq.int4_matmul(jnp.asarray(x, dtype), jq4, js, jrf,
                                         getattr(jnp, dtype)), np.float32)
        got = tq.int4_matmul(torch.from_numpy(x).to(getattr(torch, dtype)),
                             torch.from_numpy(np.asarray(jq4).T.copy()),
                             torch.from_numpy(np.asarray(js)[0].copy()),
                             torch.from_numpy(np.asarray(jrf).copy()),
                             getattr(torch, dtype))
        assert got.shape == lead + (40,) and got.dtype == getattr(torch, dtype)
        scale = np.abs(want).max()
        # bf16 outputs: one rounding step of the value where the f32
        # results straddle a bf16 boundary
        tol = (1e-6 * scale if dtype == "float32"
               else BF16_STEP * np.abs(want) + 1e-6 * scale)
        assert np.all(np.abs(got.float().numpy() - want) <= tol)


def test_int4_matmul_refuses_grad():
    x = torch.randn(3, 64, requires_grad=True)
    q4, s, rf = tq.quantize_int4(torch.randn(8, 64))
    with pytest.raises(RuntimeError, match="no backward"):
        tq.int4_matmul(x, q4, s, rf)
    with torch.no_grad():
        assert tq.int4_matmul(x, q4, s, rf).shape == (3, 8)


# ------------------------------------------------------------------- STE
# The straight-through int8 matmul against the JAX custom_vjp: forward
# within 1e-6 of the output's largest magnitude (as int8_matmul), dx within
# 1e-6 relative (bf16 products exact in f32 on both sides; only the f32
# summation order differs).


@pytest.mark.parametrize("lead", [(5,), (2, 3)])
def test_int8_ste_forward_and_input_grad_match_jax(lead):
    rng = np.random.default_rng(3)
    K, N = 96, 40
    x = rng.standard_normal(lead + (K,)).astype(np.float32)
    g = rng.standard_normal(lead + (N,)).astype(np.float32)
    wq, ws = jq.quantize_int8(jnp.asarray(rng.standard_normal((K, N)),
                                          jnp.float32), axis=0)

    def f(xx):
        return jnp.sum(jq.int8_matmul(xx, wq, ws, jnp.float32) * g)

    want_y = np.asarray(jq.int8_matmul(jnp.asarray(x), wq, ws, jnp.float32))
    want_dx = np.asarray(jax.grad(f)(jnp.asarray(x)))
    tw = torch.from_numpy(np.asarray(wq).T.copy())
    ts = torch.from_numpy(np.asarray(ws)[0].copy())
    tx = torch.from_numpy(x).requires_grad_()
    y = tq.int8_matmul_ste(tx, tw, ts, torch.float32)
    assert y.grad_fn is not None
    (y * torch.from_numpy(g)).sum().backward()
    assert np.abs(y.detach().numpy() - want_y).max() <= 1e-6 * np.abs(
        want_y).max()
    np.testing.assert_allclose(tx.grad.numpy(), want_dx, rtol=1e-6,
                               atol=1e-6 * np.abs(want_dx).max())
    assert not tw.requires_grad and tw.grad is None
    # without grad the forward alone runs, and gives the same values
    with torch.no_grad():
        np.testing.assert_array_equal(
            tq.int8_matmul_ste(tx, tw, ts, torch.float32).numpy(),
            y.detach().numpy())


def test_int8_ste_grad_keeps_the_input_dtype():
    """dx comes back in x's dtype from an f32 product (a bf16 matmul
    would round it first)."""
    rng = np.random.default_rng(4)
    wq, ws = tq.quantize_int8(torch.from_numpy(
        rng.standard_normal((16, 64)).astype(np.float32)), axis=-1)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rng.standard_normal((3, 64)).astype(
            np.float32)).to(dtype).requires_grad_()
        tq.int8_matmul_ste(x, wq, ws[:, 0], dtype).sum().backward()
        assert x.grad.dtype == dtype
        g = torch.ones(3, 16)
        want = tq.ste_input_grad(g, wq, ws[:, 0], torch.float32)
        np.testing.assert_allclose(x.grad.float().numpy(), want.numpy(),
                                   rtol=2 ** -8 if dtype != torch.float32
                                   else 0)
