"""The two-pass route of the port's fused int8 matmul on the CPU: the row
quantize's plain version then the int8 GEMM's (``quantize_rows_plain``, then
``int8_gemm`` on CPU tensors, which is ``int8_matmul_prequant_plain`` with a
bias), against the fused kernel's plain version and against the JAX
package's Pallas kernel in interpret mode; and the choice of route by rows.

Tolerances:
- against ``int8_matmul_fused_plain``: bit for bit. Both take the absmax in
  x's own type, divide in IEEE f32, round half to even, sum exactly, and
  round (acc * x_scale) * w_scale + bias and the activation alike in f32.
- against the JAX ``int8_matmul_fused(..., interpret=True)``: the int8
  bytes agree, but XLA compiles the kernel's amax / 127 into a multiply by
  the f32 reciprocal of 127, so its x_scale sits up to one f32 ulp from the
  port's IEEE division, and its GELU is an erf polynomial within 1.5e-7 of
  erf. f32 outputs within 1e-5 of the output's largest magnitude; bf16
  outputs within one bf16 step (2^-7 of the value) more, since results an
  ulp apart can round to neighbouring bf16 values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interactvlm_tpu.ops import quant as jq
from interactvlm_tpu.ops.int8_matmul import int8_matmul_fused as jax_fused
from interactvlm_tpu_torch.ops import int8_matmul as Q

BF16_STEP = 2.0 ** -7
TIES = [127.0, 2.5, 3.5, -2.5, 0.5, 1.5, -0.5, 126.5, -127.0]


def _x(rng, M, K):
    """Rows from the generator in values bf16 holds exactly, a zero row and
    a row of rounding ties (amax 127)."""
    x = rng.standard_normal((M, K)).astype(np.float32) * 2
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    x[0] = 0.0
    x[1] = 0.0
    x[1, :len(TIES)] = TIES
    return x


def _two_pass(x, w_q, w_scale, bias, activation, out_dtype):
    x_q, x_scale = Q.quantize_rows_plain(x)
    return Q.int8_gemm(x_q, x_scale, w_q, w_scale, bias, activation,
                       out_dtype)


@pytest.mark.parametrize("in_dtype,out_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16), (torch.float32, torch.float32)])
@pytest.mark.parametrize("activation", ["none", "gelu", "gelu_tanh"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_two_pass_plain_gives_the_fused_plain_bits(in_dtype, out_dtype,
                                                   activation, with_bias):
    """M = 39 and N = 136 are ragged against the GEMM's 128-row and
    256-column tiles, K = 160 against its 128-byte chunks."""
    rng = np.random.default_rng(0)
    M, K, N = 39, 160, 136
    x = torch.from_numpy(_x(rng, M, K)).to(in_dtype)
    w_q = torch.from_numpy(rng.integers(-127, 128, (N, K), dtype=np.int8))
    w_scale = torch.from_numpy(
        rng.uniform(0.5, 1.5, N).astype(np.float32) / (127 * K ** 0.5))
    bias = (torch.from_numpy(rng.standard_normal(N).astype(np.float32))
            if with_bias else None)
    got = _two_pass(x, w_q, w_scale, bias, activation, out_dtype)
    want = Q.int8_matmul_fused_plain(x, w_q, w_scale, bias, activation,
                                     out_dtype)
    assert got.dtype == out_dtype and got.shape == (M, N)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ["none", "gelu", "gelu_tanh"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_two_pass_plain_matches_pallas_interpret(dtype, activation,
                                                 with_bias):
    """39 rows (not a multiple of the Pallas row block), with a zero row and
    rounding ties; the JAX kernel wants K and N multiples of 128."""
    rng = np.random.default_rng(1)
    M, K, N = 39, 256, 128
    x = _x(rng, M, K)
    w = rng.standard_normal((K, N)).astype(np.float32) * K ** -0.5
    bias = rng.standard_normal(N).astype(np.float32) if with_bias else None
    wq, ws = jq.quantize_int8(jnp.asarray(w), axis=0)
    jdt = jnp.dtype(dtype)
    want = np.asarray(jax_fused(
        jnp.asarray(x, jdt), wq, ws, dtype=jdt, activation=activation,
        bias=None if bias is None else jnp.asarray(bias),
        interpret=True)).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = _two_pass(torch.from_numpy(x).to(tdt),
                    torch.from_numpy(np.asarray(wq).T.copy()),
                    torch.from_numpy(np.asarray(ws)[0].copy()),
                    None if bias is None else torch.from_numpy(bias),
                    activation, tdt).float().numpy()
    scale = np.abs(want).max()
    limit = 1e-5 * scale + (BF16_STEP * np.abs(want) if dtype == "bfloat16"
                            else 0.0)
    err = np.abs(got - want)
    assert (err <= limit).all(), (err.max(), scale)


def test_route_by_rows_over_the_main_path_shapes():
    """Every decode and lm_head shape of the 7B-int8 path keeps the
    one-launch kernel; every SAM encoder and prefill shape, and the chain
    probe's, takes the two passes."""
    import chip_smoke

    path_cases = [c for c in chip_smoke.INT8_CASES if c[-1] is not None]
    assert len(path_cases) == 20
    for what, M, K, *_ in path_cases:
        one = "decode" in what or "lm_head" in what
        assert Q.int8_route(M, K) == ("one_launch" if one else "two_pass"), what
    assert Q.int8_route(chip_smoke.CHAIN_M) == "two_pass"
    assert Q.int8_route(Q.ONE_LAUNCH_MAX_ROWS) == "one_launch"
    assert Q.int8_route(Q.ONE_LAUNCH_MAX_ROWS + 1) == "two_pass"
    # past the K whose quantized slice the one-launch kernel can hold, the
    # two passes take any rows
    assert Q.int8_route(8, Q.ONE_LAUNCH_MAX_K) == "one_launch"
    assert Q.int8_route(8, Q.ONE_LAUNCH_MAX_K + 32) == "two_pass"


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(_x(rng, 40, 64))
    w_q = torch.from_numpy(rng.integers(-127, 128, (24, 64), dtype=np.int8))
    w_scale = torch.full((24,), 1e-3)
    before = (Q.int8_matmul_fused.launches,
              dict(Q.int8_matmul_fused.route_launches),
              Q.quantize_rows.launches, Q.int8_gemm.launches)
    Q.int8_matmul_fused(x, w_q, w_scale)
    _two_pass(x, w_q, w_scale, None, "none", torch.float32)
    assert (Q.int8_matmul_fused.launches,
            dict(Q.int8_matmul_fused.route_launches),
            Q.quantize_rows.launches, Q.int8_gemm.launches) == before


def _int8_case_ks():
    import chip_smoke

    return sorted({c[2] for c in chip_smoke.INT8_CASES})


@pytest.mark.parametrize("K", _int8_case_ks() + [32, 96, 128, 1152, 13824,
                                                 Q.ONE_LAUNCH_MAX_K])
def test_one_launch_plan_covers_k_in_whole_chunks(K):
    """The one-launch kernel's K split, at every K of ``chip_smoke.py``'s
    int8 cases and at the edges: at most 8 CTAs, each a non-empty run of
    whole 128-value chunks, together every chunk once and in order."""
    cluster, slices = Q.one_launch_plan(K)
    n = -(-K // Q.K_CHUNK)
    assert 1 <= cluster <= Q.MAX_CLUSTER and cluster == len(slices)
    assert cluster == min(Q.MAX_CLUSTER, n)
    assert slices[0][0] == 0 and slices[-1][1] == n
    for (lo, hi), (lo2, _) in zip(slices, slices[1:] + ((n, n),)):
        assert lo < hi == lo2
    # the last chunk is the only one K may cut short
    assert (n - 1) * Q.K_CHUNK < K <= n * Q.K_CHUNK
    # the slices the kernel keeps in shared memory: at most 31 chunks
    assert max(hi - lo for lo, hi in slices) <= 31


@pytest.mark.parametrize("M", [1, 8, 17, 32])
@pytest.mark.parametrize("split", ["plan", "random", "reversed"])
def test_split_k_partial_sums_give_the_fused_plain_bits(M, split):
    """What the one-launch kernel rests on: each CTA of the cluster takes
    the absmax and the int32 products of its own K slice only; the row
    absmax is the max of the slices' maxima and the sum the sum of their
    int32 partial sums, in whatever order the CTAs meet. For the plan's
    slices, a random partition into whole 32-value pieces and the plan's
    slices summed in reverse, the kernel's arithmetic (the epilogue in the
    TPU kernel's order) gives ``int8_matmul_fused_plain``'s bits."""
    rng = np.random.default_rng(3 + M)
    K, N = 11008, 136
    x = torch.from_numpy(_x(rng, max(M, 2), K)[-M:]).to(torch.bfloat16)
    w_q = torch.from_numpy(rng.integers(-127, 128, (N, K), dtype=np.int8))
    w_scale = torch.from_numpy(
        rng.uniform(0.5, 1.5, N).astype(np.float32) / (127 * K ** 0.5))
    bias = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
    _, plan = Q.one_launch_plan(K)
    bounds = [(lo * Q.K_CHUNK, min(hi * Q.K_CHUNK, K)) for lo, hi in plan]
    if split == "random":
        cuts = np.sort(rng.choice(np.arange(1, K // 32), 7, replace=False))
        edges = [0, *(32 * cuts).tolist(), K]
        bounds = list(zip(edges, edges[1:]))
        rng.shuffle(bounds)
    elif split == "reversed":
        bounds = bounds[::-1]
    amax = torch.zeros(M, 1)
    for lo, hi in bounds:
        amax = torch.maximum(amax, x[:, lo:hi].abs().amax(-1, keepdim=True)
                             .float())
    amax = amax.clamp_min(1e-8)
    x_scale, inv = Q.exact_div(amax, 127.0), Q.exact_div(127.0, amax)
    xq = torch.clamp(torch.round(x.float() * inv), -127, 127).long()
    acc = torch.zeros(M, N, dtype=torch.int32)
    for lo, hi in bounds:
        acc += (xq[:, lo:hi] @ w_q[:, lo:hi].long().t()).to(torch.int32)
    out = Q.apply_activation(
        acc.float() * x_scale * w_scale + bias, "gelu_tanh").to(torch.bfloat16)
    want = Q.int8_matmul_fused_plain(x, w_q, w_scale, bias, "gelu_tanh")
    assert torch.equal(out, want)
