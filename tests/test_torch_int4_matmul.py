"""The port's int4 matmul (``ops/int4_matmul.py``) on the CPU: its plain
version, which both card routes must give bit for bit, against the JAX
package's ``int4_matmul`` and against the arithmetic of the route the card
took before it (the unpack, then kernel 6 on f32 x * rf), written out here
in numpy; the two-pass route's plain passes (kernel 7 with the row factor,
then the int4 GEMM's plain version), the given-scale row quantize with the
row factor, and the choice of route by shape.

Tolerances:
- against the numpy arithmetic of the unpack route, and between the
  port's plain forms: bit for bit. Each forms f32 x * rf rounded once,
  takes the absmax in f32, divides 127 / amax and amax / 127 in IEEE f32,
  rounds half to even, sums exactly and rounds (f32(acc) * x_scale) *
  col_scale in f32.
- against the JAX ``int4_matmul``: the kernel quantizes with
  x * (127 / amax) where the JAX package divides x / (amax / 127), so an
  element whose two products fall on opposite sides of a rounding tie
  quantizes one int8 step apart (``tests/test_torch_quant.py``'s int4
  rule, as for kernel 6). Each output element is held to the sum, over
  the elements of its row that the two rules round apart, of |w| x_scale
  col_scale (computed here from both rules), plus 1e-6 of the output's
  largest magnitude for the f32 rescale; bf16 outputs one bf16 step
  (2^-7 of the value) more.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interactvlm_tpu.ops import quant as jq
from interactvlm_tpu_torch.ops import int4_matmul as Q4
from interactvlm_tpu_torch.ops import int8_matmul as Q
from interactvlm_tpu_torch.ops import quant as QT

BF16_STEP = 2.0 ** -7
TIES = [127.0, 2.5, 3.5, -2.5, 0.5, 1.5, -0.5, 126.5, -127.0]


def _inputs(rng, M, K, N, flat):
    """bf16-exact rows (a zero row and a row of rounding ties, amax 127,
    where M allows), a packed weight of random bytes (every nibble value
    -8..7 in both halves), per-column scales and a row factor: one value
    per group of 128 columns, or flat ones."""
    x = rng.standard_normal((M, K)).astype(np.float32) * 2
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    if M > 1:
        x[0] = 0.0
        x[1] = 0.0
        x[1, :len(TIES)] = TIES
    packed = rng.integers(-128, 128, (N, K // 2), dtype=np.int8)
    cs = (rng.uniform(0.5, 1.5, N) / (7 * K ** 0.5)).astype(np.float32)
    if flat:
        rf = np.ones(K, np.float32)
    else:
        rf = np.repeat(rng.uniform(0.5, 2.0, K // 128), 128).astype(np.float32)
        rf[:128] = 1.0  # the ties stay ties
    return x, packed, cs, rf


def _nibbles(packed):
    """numpy's unpack: (N, K) int64, columns [0, K/2) the low nibbles."""
    p = packed.astype(np.int64) & 0xFF
    lo, hi = p & 0xF, p >> 4
    return np.concatenate([np.where(lo > 7, lo - 16, lo),
                           np.where(hi > 7, hi - 16, hi)], axis=1)


def _unpack_route(x, packed, cs, rf):
    """The unpack route's arithmetic in numpy: f32 products, the absmax,
    IEEE f32 divisions, half-to-even rounding, an exact integer sum, the
    f32 rescale. Returns (out f32, xq, x_scale)."""
    xr = x.astype(np.float32) * rf
    amax = np.maximum(np.abs(xr).max(-1, keepdims=True), np.float32(1e-8))
    inv = np.float32(127.0) / amax
    xs = amax / np.float32(127.0)
    xq = np.clip(np.rint(xr * inv), -127, 127).astype(np.int64)
    acc = xq @ _nibbles(packed).T
    return (acc.astype(np.float32) * xs) * cs, xq, xs


CASES = [(1, 256, 128, False), (8, 256, 128, False), (39, 256, 128, False),
         (1, 160, 136, True), (8, 160, 136, True), (39, 160, 136, True)]


@pytest.mark.parametrize("M,K,N,flat", CASES)
def test_plain_is_the_unpack_routes_arithmetic(M, K, N, flat):
    """``int4_matmul_fused_plain``, the CPU wrapper and the two-pass plain
    passes give the numpy unpack route's bits, for bf16 and f32 x and both
    output types."""
    rng = np.random.default_rng(M * K)
    x, packed, cs, rf = _inputs(rng, M, K, N, flat)
    want, xq_want, xs_want = _unpack_route(x, packed, cs, rf)
    tp, tcs, trf = (torch.from_numpy(a) for a in (packed, cs, rf))
    for xdt in (torch.bfloat16, torch.float32):
        tx = torch.from_numpy(x).to(xdt)
        for odt in (torch.bfloat16, torch.float32):
            exp = torch.from_numpy(want).to(odt)
            got = Q4.int4_matmul_fused_plain(tx, tp, tcs, trf, odt)
            assert got.dtype == odt and torch.equal(got, exp)
            assert torch.equal(Q4.int4_matmul_fused(tx, tp, tcs, trf, odt),
                               exp)
            xq, xs = Q.quantize_rows(tx, trf)
            assert torch.equal(xq, torch.from_numpy(xq_want).to(torch.int8))
            assert torch.equal(xs, torch.from_numpy(xs_want))
            assert torch.equal(Q4.int4_gemm(xq, xs, tp, tcs, odt), exp)
        # the old card route's plain arithmetic: kernel 6's plain version
        # on f32 x * rf and the unpacked weight
        assert torch.equal(
            Q.int8_matmul_fused_plain(tx.float() * trf, Q4.unpacked(tp), tcs,
                                      out_dtype=torch.float32),
            torch.from_numpy(want))


@pytest.mark.parametrize("M,K,N,flat", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_int4_matmul(M, K, N, flat, dtype):
    """Against the JAX package's composition on the same bytes, scales and
    row factor, within the tie rule of the module docstring."""
    rng = np.random.default_rng(M + K)
    x, packed, cs, rf = _inputs(rng, M, K, N, flat)
    want = np.asarray(jq.int4_matmul(
        jnp.asarray(x, dtype), jnp.asarray(packed.T), jnp.asarray(cs[None]),
        jnp.asarray(rf), getattr(jnp, dtype)), np.float32)
    tdt = getattr(torch, dtype)
    got = Q4.int4_matmul_fused_plain(
        torch.from_numpy(x).to(tdt), torch.from_numpy(packed),
        torch.from_numpy(cs), torch.from_numpy(rf), tdt)
    assert got.dtype == tdt and got.shape == (M, N)
    # where the two rules round apart: x * (127 / amax) against
    # x / (amax / 127), both on the f32 products
    xr = x.astype(np.float32) * rf
    amax = np.maximum(np.abs(xr).max(-1, keepdims=True), np.float32(1e-8))
    xs = amax / np.float32(127.0)
    q_mul = np.clip(np.rint(xr * (np.float32(127.0) / amax)), -127, 127)
    q_div = np.clip(np.rint(xr / xs), -127, 127)
    dq = np.abs(q_mul - q_div)
    assert dq.max() <= 1
    ties = (dq @ np.abs(_nibbles(packed)).T) * xs * cs
    tol = ties + 1e-6 * np.abs(want).max()
    if dtype == "bfloat16":
        tol = tol + BF16_STEP * np.abs(want)
    assert np.all(np.abs(got.float().numpy() - want) <= tol)
    if M > 1:  # the ties row: amax 127, so both rules scale by exactly 1
        assert dq[1].max() == 0


@pytest.mark.parametrize("M,K", [(8, 2048), (39, 160)])
def test_given_scale_quantize_with_the_row_factor(M, K):
    """Kernel 7's given-scale route with the row factor quantizes x * rf
    with the given absmax: the plain route's bytes on f32 x * rf, and the
    plain route's own where the given absmax is the row's."""
    rng = np.random.default_rng(K)
    x, _, _, rf = _inputs(rng, M, K, 8, K % 128 != 0)
    tx, trf = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(rf)
    xr = tx.float() * trf
    own = xr.abs().amax(-1)
    for amax in (own, own * 1.5):
        q, s = Q.quantize_rows_given(tx, amax, trf)
        q2, s2 = Q.quantize_rows_given_plain(xr, amax)
        assert torch.equal(q, q2) and torch.equal(s, s2)
    q, s = Q.quantize_rows_given(tx, own, trf)
    q3, s3 = Q.quantize_rows(tx, trf)
    assert torch.equal(q, q3) and torch.equal(s, s3)


def test_route_by_shape_matches_kernel_6s_on_the_path():
    """Decode and the lm_head (8 or 32 rows) take the one launch, the
    prefill (2552 rows) two passes, as kernel 6 routes the int8 path's
    calls; K past the int4 one-launch limit takes two passes; the one
    launch splits the packed bytes over the cluster."""
    for M, K in [(8, 4096), (8, 11008), (32, 4096), (32, 11008),
                 (2552, 4096), (2552, 11008), (33, 160), (1, 160)]:
        assert Q4.int4_route(M, K) == Q.int8_route(M, K)
    assert Q4.int4_route(8, Q4.ONE_LAUNCH_MAX_K) == "one_launch"
    assert Q4.int4_route(8, Q4.ONE_LAUNCH_MAX_K + 32) == "two_pass"
    assert Q.one_launch_plan(11008 // 2)[0] == 8
    assert Q.one_launch_plan(160 // 2)[0] == 1


def test_cpu_tensors_count_no_launch_and_refuse_grad():
    """On CPU tensors every wrapper takes its plain version and counts
    nothing; under grad the int4 matmul raises, as it has no backward."""
    rng = np.random.default_rng(3)
    x, packed, cs, rf = (torch.from_numpy(a)
                         for a in _inputs(rng, 8, 256, 128, False))
    counts = (Q4.int4_matmul_fused.launches, Q4.int4_gemm.launches,
              Q.quantize_rows.launches, dict(Q4.int4_matmul_fused
                                             .route_launches))
    out = QT.int4_matmul(x, packed, cs, rf, torch.float32)
    Q4.int4_matmul_fused(x, packed, cs, rf)
    Q4.int4_gemm(*Q.quantize_rows(x, rf), packed, cs)
    assert counts == (Q4.int4_matmul_fused.launches, Q4.int4_gemm.launches,
                      Q.quantize_rows.launches,
                      dict(Q4.int4_matmul_fused.route_launches))
    assert out.shape == (8, 128)
    with pytest.raises(RuntimeError, match="no backward"):
        Q4.int4_matmul_fused(x.requires_grad_(), packed, cs, rf)


H100_SMS = 132
# LLaMA-7B's decode linears (K, N): q/k/v/o, gate/up, down, the lm_head,
# and the row-parallel down on one of 2 model ranks
DECODE_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000),
                 (5504, 4096)]


@pytest.mark.parametrize("M", [1, 8, 31, 32])
@pytest.mark.parametrize("K,N", DECODE_SHAPES + [(160, 136)])
def test_decode_plan_takes_every_chunk_once_in_one_wave(M, K, N):
    """The decode kernel's plan on an H100: its CTAs split the packed
    chunks of each column block so that every chunk is taken once and
    every CTA takes one; no more clusters than the card holds at once (one
    CTA an SM); the slice and at least 4 ring stages fit a block's shared
    memory; and the plan's modelled time is the least of every split's."""
    cluster, clusters, stages = Q4.decode_plan(M, N, K)
    nch, blocks = -(-(K // 2) // 128), -(-N // 128)
    slices = [(r * nch // cluster, (r + 1) * nch // cluster)
              for r in range(cluster)]
    assert [c for lo, hi in slices for c in range(lo, hi)] == list(range(nch))
    assert all(hi > lo for lo, hi in slices)
    assert 1 <= cluster <= Q.MAX_CLUSTER and 1 <= clusters <= blocks
    assert clusters <= Q4.H100_CLUSTERS[cluster - 1]
    assert cluster * clusters <= H100_SMS
    chunks = -(-nch // cluster)
    assert Q4.DECODE_MIN_STAGES <= stages <= Q4.DECODE_MAX_STAGES
    rows = Q4.padded_rows(M)
    assert Q4.decode_smem_bytes(rows, chunks, stages) <= Q4.H100_SMEM
    t0, tb, tc, tcr, ts, tsr = Q4.DECODE_COST

    def modelled(cs, n):
        ch, rounds, r = -(-nch // cs), -(-blocks // n), rows // 8
        return (t0 + rounds * tb + rounds * ch * (tc + r * tcr)
                + ch * (ts + r * tsr))

    fits = [cs for cs in range(1, min(8, nch) + 1)
            if Q4.decode_smem_bytes(rows, -(-nch // cs), 4) <= Q4.H100_SMEM]
    assert modelled(cluster, clusters) <= min(
        modelled(cs, min(blocks, Q4.H100_CLUSTERS[cs - 1])) for cs in fits)


def test_decode_plan_edges():
    """The 7B shapes' plans (the fastest splits of an H100 sweep); the
    route's edges: 32 rows and ONE_LAUNCH_MAX_K are the decode kernel's,
    where a plan exists at every row count, and past them none is needed;
    a smaller card gets fewer CTAs."""
    assert Q4.decode_plan(8, 4096, 4096)[:2] == (6, 17)
    assert Q4.decode_plan(8, 11008, 4096)[:2] == (4, 30)
    assert Q4.decode_plan(8, 32000, 4096)[:2] == (2, 66)
    assert Q4.decode_plan(32, 4096, 11008)[:2] == (8, 15)
    assert Q4.int4_route(32, 4096) == "one_launch"
    assert Q4.int4_route(33, 4096) == "two_pass"
    K = Q4.ONE_LAUNCH_MAX_K
    for M in (1, 8, 16, 32):  # and LLaMA-13B's widest K
        Q4.decode_plan(M, 4096, K)
        Q4.decode_plan(M, 5120, 13824)
    assert Q4.int4_route(32, K + 32) == "two_pass"
    with pytest.raises(ValueError, match="no decode split"):
        Q4.decode_plan(32, 4096, K + 512)
    small = (16, 8, 5, 4, 3, 2, 2, 2)  # a card of 16 SMs
    cluster, clusters, _ = Q4.decode_plan(8, 11008, 4096, small)
    assert clusters <= small[cluster - 1] and cluster * clusters <= 16
