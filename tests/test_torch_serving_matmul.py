"""The plain versions of the port's two-pass int8 kernels (``quantize_rows``,
``int8_matmul_prequant``) and of its bf16 serving matmul (``fused_dense``)
against the JAX package's Pallas kernels, run in interpret mode on the CPU,
on the same numpy inputs.

Tolerances:
- ``quantize_rows``: the int8 values byte for byte. Both take the absmax
  in x's own type, divide 127 by it in IEEE f32, multiply, and round half to
  even. The scale amax / 127 is IEEE division in the port (as in the fused
  kernel 6, so that the two-pass form gives the fused kernel's bits), while
  the JAX function, compiled by XLA, multiplies by the f32 reciprocal of the
  constant 127: the scales agree within one f32 ulp, and the port's equal
  numpy's IEEE division exactly.
- ``int8_matmul_prequant`` without an activation: bit for bit. The int32
  sum is exact on both sides, and (f32(acc) * x_scale) * w_scale rounds
  the same two products. With a GELU, the JAX kernel's erf polynomial is
  within 1.5e-7 of erf, so an f32 output is held to 1e-6 of its magnitude
  plus 1e-6, and a bf16 output, where that difference can move a value
  across a rounding boundary, to one bf16 step (2^-7 of its magnitude)
  plus 1e-6.
- ``fused_dense``: f32 products of bf16 inputs, summed in another order,
  then the bias, the GELU (polynomial against erf) and one rounding to
  bf16: one bf16 step, 2^-7 of the magnitude, plus 1e-5 for sums that
  cancel to near zero, where the f32 summation order shows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interactvlm_tpu.ops.int8_matmul import (
    int8_matmul_prequant as jax_prequant,
)
from interactvlm_tpu.ops.int8_matmul import quantize_rows as jax_quantize_rows
from interactvlm_tpu.ops.quant import quantize_int8 as jax_quantize_int8
from interactvlm_tpu.ops.serving_matmul import fused_dense as jax_fused_dense
from interactvlm_tpu_torch.ops.int8_matmul import (
    int8_matmul_prequant,
    int8_matmul_prequant_plain,
    quantize_rows,
    quantize_rows_plain,
)
from interactvlm_tpu_torch.ops.serving_matmul import (
    fused_dense,
    fused_dense_plain,
)
from interactvlm_tpu_torch.utils.weights import (
    int8_weight_from_jax,
    linear_weight_from_jax,
)

BF16_STEP = 2.0 ** -7
TIES = [127.0, 2.5, 3.5, -2.5, 0.5, 1.5, -0.5, 126.5, -127.0]


def _rows(M, K, dtype, seed=0):
    """Seeded rows with a zero row and a row of exact rounding ties (amax
    127, so x * 127 / amax = x)."""
    x = np.random.default_rng(seed).standard_normal((M, K)).astype(np.float32)
    x[0] = 0.0
    x[1] = 0.0
    x[1, :len(TIES)] = TIES
    jx = jnp.asarray(x, dtype)
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


@pytest.mark.parametrize("M,K,dtype", [
    (40, 256, jnp.bfloat16),
    (40, 256, jnp.float32),
    (300, 1280, jnp.bfloat16),
])
def test_quantize_rows_plain_matches_jax_bytes(M, K, dtype):
    jx, tx = _rows(M, K, dtype)
    want_q, want_s = jax_quantize_rows(jx, interpret=True)
    got_q, got_s = quantize_rows_plain(tx)
    assert got_q.dtype == torch.int8 and got_s.shape == (M, 1)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    amax = np.abs(np.asarray(jx.astype(jnp.float32))).max(1, keepdims=True)
    np.testing.assert_array_equal(
        got_s.numpy(), np.maximum(amax, np.float32(1e-8)) / np.float32(127))
    np.testing.assert_array_max_ulp(got_s.numpy(), np.asarray(want_s), 1)
    assert got_q[1, :len(TIES)].tolist() == [127, 2, 4, -2, 0, 2, 0, 126, -127]
    assert not got_q[0].any() and got_s[0].item() == np.float32(1e-8) / 127
    # the dispatching wrapper takes the plain version on a CPU tensor
    q2, s2 = quantize_rows(tx)
    assert torch.equal(q2, got_q) and torch.equal(s2, got_s)


def _int8_operands(M, K, N, seed=1):
    jx, _ = _rows(M, K, jnp.bfloat16, seed)
    xq, xs = jax_quantize_rows(jx, interpret=True)
    w = np.random.default_rng(seed + 1).standard_normal((K, N)).astype(
        np.float32) * K ** -0.5
    wq, ws = jax_quantize_int8(jnp.asarray(w), axis=0)
    return (xq, xs, wq, ws), (
        torch.from_numpy(np.array(xq)), torch.from_numpy(np.array(xs)),
        *int8_weight_from_jax(wq, ws))


@pytest.mark.parametrize("activation", ["none", "gelu", "gelu_tanh"])
@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_int8_matmul_prequant_plain_matches_jax(activation, dtype):
    jargs, targs = _int8_operands(40, 256, 384)
    want = np.asarray(jax_prequant(*jargs, dtype=dtype, activation=activation,
                                   interpret=True).astype(jnp.float32))
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    got = int8_matmul_prequant_plain(*targs, tdtype, activation)
    assert got.dtype == tdtype and got.shape == (40, 384)
    got = got.float().numpy()
    if activation == "none":
        np.testing.assert_array_equal(got, want)
    else:
        rtol = BF16_STEP if dtype == jnp.bfloat16 else 1e-6
        assert np.all(np.abs(got - want) <= rtol * np.abs(want) + 1e-6)
    assert torch.equal(int8_matmul_prequant(*targs, tdtype, activation),
                       int8_matmul_prequant_plain(*targs, tdtype, activation))


@pytest.mark.parametrize("K", [256, 5120])  # one K block; K split in two
@pytest.mark.parametrize("with_bias,activation", [
    (False, "none"), (True, "gelu"), (True, "gelu_tanh")])
def test_fused_dense_plain_matches_jax(K, with_bias, activation):
    M, N = 64, 256
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((M, K)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((K, N)) * K ** -0.5, jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal(N) * 0.5, jnp.bfloat16)
    want = np.asarray(jax_fused_dense(
        x, w, b if with_bias else None, activation, interpret=True).astype(
            jnp.float32))
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    tw = linear_weight_from_jax(w, torch.bfloat16)
    tb = (torch.from_numpy(np.array(b.astype(jnp.float32))).to(torch.bfloat16)
          if with_bias else None)
    got = fused_dense_plain(tx, tw, tb, activation)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    got = got.float().numpy()
    assert np.all(np.abs(got - want) <= BF16_STEP * np.abs(want) + 1e-5)
    assert torch.equal(fused_dense(tx, tw, tb, activation),
                       fused_dense_plain(tx, tw, tb, activation))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_two_pass_int8_gives_the_fused_kernels_bits(dtype):
    """quantize_rows + int8_matmul_prequant computes what int8_matmul_fused
    computes without a bias: the same quantization of x, the same exact
    sum and the same two rounded products."""
    from interactvlm_tpu_torch.ops.int8_matmul import int8_matmul_fused

    _, (xq, xs, wq, ws) = _int8_operands(40, 256, 384)
    _, x = _rows(40, 256, jnp.bfloat16 if dtype == torch.bfloat16
                 else jnp.float32, 1)
    two_pass = int8_matmul_prequant(*quantize_rows(x), wq, ws, dtype, "gelu")
    assert torch.equal(two_pass, int8_matmul_fused(x, wq, ws,
                                                   activation="gelu"))


def test_fused_dense_keeps_leading_dims_and_output_dtype():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 5, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((24, 64)).astype(np.float32))
    out = fused_dense(x.bfloat16(), w.bfloat16(), dtype=torch.float32)
    assert out.shape == (2, 5, 24) and out.dtype == torch.float32
    want = x.bfloat16().float().reshape(10, 64) @ w.bfloat16().float().t()
    assert torch.allclose(out.reshape(10, 24), want, rtol=1e-5, atol=1e-5)


def test_weight_layouts_carry_the_jax_bytes():
    """A JAX (K, N) bf16 kernel becomes (N, K) exactly; a JAX int8 (K, N)
    with (1, N) scales becomes int8 (N, K) with (N,) scales, same bytes."""
    rng = np.random.default_rng(4)
    w = jnp.asarray(rng.standard_normal((96, 40)), jnp.bfloat16)
    tw = linear_weight_from_jax(w, torch.bfloat16)
    assert tw.shape == (40, 96) and tw.dtype == torch.bfloat16
    np.testing.assert_array_equal(tw.float().numpy(),
                                  np.asarray(w.astype(jnp.float32)).T)
    wq, ws = jax_quantize_int8(w.astype(jnp.float32), axis=0)
    tq, ts = int8_weight_from_jax(wq, ws)
    assert tq.shape == (40, 96) and ts.shape == (40,)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(wq).T)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(ws)[0])
    with pytest.raises(ValueError, match="int8"):
        int8_weight_from_jax(np.zeros((4, 4), np.int16), ws[:, :4])


def test_forward_only_wrappers_raise_under_grad():
    x = torch.randn(8, 32, requires_grad=True)
    w = torch.randn(16, 32)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_dense(x, w)
    with pytest.raises(RuntimeError, match="no backward"):
        quantize_rows(x)
