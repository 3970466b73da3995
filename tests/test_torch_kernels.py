"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here but the one of the C launcher's binding needs a CUDA device
and skips without one; the file imports no JAX, so it runs on a machine that
has only PyTorch (``--noconftest`` skips ``tests/conftest.py``, which sets up
JAX):

    python -m pytest --noconftest tests/test_torch_kernels.py

Tolerance: the kernels and the plain versions both take bf16 inputs and
accumulate in f32, but round the probabilities to bf16 at different points
(the kernel against its running maximum, the plain version against the row
maximum) and write bf16 outputs, whose rounding step is up to 2^-8 of the
value. So each element is held to 4e-3 + 2e-2 of the plain value's
magnitude (the absolute part covers outputs near zero; 2e-2 for the window
kernel, whose plain version rounds the normalised probabilities, as the TPU
window kernel does, where the CUDA kernel rounds them against its running
maximum: over 196 keys with the rel-pos bias the softmax is peaked, and one
weight's rounding step moves an output by up to ~2^-6), and the RMS error
over the output to 1e-2 of the plain output's RMS, which a systematic error
of a percent fails even where every element passes. The logsumexp is f32 on
both sides and differs only in summation order, so 1e-3.

The flash backward kernels (dq; dk and dv) against ``flash_backward_plain``:
both recompute the probabilities from the same logsumexp in f32 and round P
and dS to bf16 as the operands of their products, so they differ by the
order of f32 sums, by a rounding step of P or dS where that order moves a
value across a bf16 rounding boundary, and by the bf16 rounding of the
output. Gradients have no fixed scale, so each element is held to 2e-2 of
the plain gradient's RMS plus 2e-2 of its own magnitude, and the RMS error
to 1e-2 of the plain RMS; rows that see no key must give exact zeros.
Against autograd through the f32 plain attention, which rounds neither P nor
dS, the rounding error accumulates over up to L terms in the key rows that
many queries see (measured on the card: worst element 3.3 % of the RMS in
the first key row at L = 512): there each element is held to 5e-2 of the
RMS.

The int8 matmul kernel and its plain version share the quantization of x
and an exact integer sum, and round the rescale, bias and activation alike
in f32 (erff on the card, torch.erf in the plain version): each element is
held to one bf16 rounding step, 2^-7 of its magnitude, plus 1e-6 of the
output's largest magnitude for the GELU near zero. The same holds for the
two-pass form (row quantize, then the pre-quantized matmul or the wgmma
GEMM, which is the fused matmul's route above 32 rows): the quantize is
held byte for byte, the matmul bit for bit without an activation.

The int4 matmul (the decode kernel; kernel 7 with the row factor, then the
int4 GEMM) shares its plain version's arithmetic, an
exact integer sum and no activation: bit for bit against the plain version
and against the unpack route the card took before it (the unpacked weight
and kernel 6 on f32 x * rf), on both routes and in the row-parallel form.

The bf16 serving matmul sums f32 products of bf16 inputs in another order
than the plain version's f32 matmul, then rounds once to bf16: each element
within 2^-7 of its magnitude plus 1e-3 of the output's RMS (sums that cancel
to near zero), and the RMS error within 2^-8 of the RMS. The rate-probe
loop: int8 products exactly (int32 wraps; f32 sums of integers below 2^24
are exact), bf16 and f32 within 1e-5 of the largest output. The window
copy: bit for bit.
"""

import numpy as np
import pytest
import torch

from interactvlm_tpu_torch.ops import flash_attention as F
from interactvlm_tpu_torch.ops import int4_matmul as Q4
from interactvlm_tpu_torch.ops import int8_matmul as Q
from interactvlm_tpu_torch.ops import mxu as X
from interactvlm_tpu_torch.ops import sam_attention as S
from interactvlm_tpu_torch.ops import serving_matmul as D

ATOL, WINDOW_ATOL, RTOL, RMS_TOL = 4e-3, 2e-2, 2e-2, 1e-2
LSE_TOL = 1e-3
GRAD_ATOL_OF_RMS, AUTOGRAD_ATOL_OF_RMS = 2e-2, 5e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bf16(rng, shape, dev, scale=1.0):
    x = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(dev, torch.bfloat16)


def _close(got, want, atol=ATOL):
    g, w = got.float(), want.float()
    err = (g - w).abs()
    rms = (err.square().mean() / w.square().mean().clamp_min(1e-30)).sqrt()
    return bool((err <= atol + RTOL * w.abs()).all()) and rms.item() <= RMS_TOL


@pytest.mark.parametrize("B,H,Lq,Lk,D,causal,lens", [
    (2, 3, 319, 319, 128, True, (319, 200)),  # LLaMA prefill, ragged rows
    (4, 8, 300, 9, 16, False, None),  # SAM image -> token, Lk = 9
    (1, 2, 70, 130, 64, True, None),  # Lq < Lk: bottom-right offset
    (2, 2, 100, 100, 32, True, (0, 37)),  # row 0 sees no key
    (1, 2, 4096, 4096, 128, False, None),  # window probe global_plain
    # head dim 128 runs the wgmma/TMA kernel: ragged Lq against its 128-row
    # blocks, Lk != Lq, rows that see no key, kv lengths 0, 1 and full
    (2, 2, 1, 200, 128, True, (200, 1)),
    (1, 3, 63, 150, 128, True, None),
    (3, 2, 129, 129, 128, True, (0, 1, 129)),
    (2, 2, 300, 129, 128, True, None),  # causal Lq > Lk: 171 rows blind
    (2, 2, 319, 500, 128, False, (500, 77)),
    (1, 1, 4096, 300, 128, True, (257,)),
    # head dim 16 runs the wgmma/TMA kernel of flash_fwd_d16_sm90.cuh: key
    # tiles of 16 (Lk 1, 9), 32 (17), 112 x 3 (300), 128 x 4 (512) and
    # 112 x 5 (513), Lq = 300 ragged against its 128-row query tiles,
    # causal with Lq != Lk both ways, kv lengths 0, 1 and full
    (2, 3, 300, 1, 16, False, None),
    (2, 2, 300, 17, 16, False, None),
    (1, 2, 300, 512, 16, False, None),
    (1, 2, 300, 513, 16, False, None),
    (2, 2, 200, 300, 16, True, None),
    (2, 2, 300, 129, 16, True, None),  # 171 rows see no key
    (3, 2, 129, 129, 16, True, (0, 1, 129)),
    (2, 2, 300, 300, 16, False, (300, 1)),
])
def test_flash_kernel_matches_plain(dev, B, H, Lq, Lk, D, causal, lens):
    rng = np.random.default_rng(0)
    q = _bf16(rng, (B, H, Lq, D), dev)
    k, v = _bf16(rng, (B, H, Lk, D), dev), _bf16(rng, (B, H, Lk, D), dev)
    kv = None if lens is None else torch.tensor(lens, device=dev)
    before = F.flash_forward.launches
    routes = dict(F.flash_forward.route_launches)
    o, lse = F.flash_forward(q, k, v, causal, None, kv)
    torch.cuda.synchronize()
    assert F.flash_forward.launches == before + 1
    route = F.fwd_route(D)
    assert F.flash_forward.route_launches == {
        r: n + (r == route) for r, n in routes.items()}
    o2, lse2 = F.flash_forward_plain(q, k, v, causal, None, kv)
    assert _close(o, o2)
    assert (lse - lse2).abs().max().item() < LSE_TOL
    # rows that see no key: exact zeros and logsumexp 0
    blind = ~F._visible(B, Lq, Lk, causal, kv, dev).any(-1).expand(B, H, Lq)
    assert bool((o.float()[blind] == 0).all())
    assert bool((lse.reshape(B, H, Lq)[blind] == 0).all())


@pytest.mark.parametrize("B,H,L,causal", [
    (2, 16, 4096, False),  # SAM ViT-H's global block without rel-pos
    (1, 3, 300, True),  # ragged against the 128-row blocks, causal
])
def test_flash_kernel_at_head_dim_80_padded_to_128(dev, B, H, L, causal):
    """``flash_attention`` zero-pads head dim 80 to 128, launches kernel 1
    once, and agrees with the plain version on the unpadded inputs."""
    rng = np.random.default_rng(10)
    q, k, v = (_bf16(rng, (B, H, L, 80), dev) for _ in range(3))
    before = F.flash_forward.launches
    o = F.flash_attention(q, k, v, causal, 80 ** -0.5)
    torch.cuda.synchronize()
    assert F.flash_forward.launches == before + 1
    assert o.shape == (B, H, L, 80) and o.dtype == torch.bfloat16
    o2, _ = F.flash_forward_plain(q, k, v, causal, 80 ** -0.5)
    assert _close(o, o2)


@pytest.mark.parametrize("causal,lens", [(False, None), (True, (300, 5))])
def test_d16_kernel_on_projection_views_equals_contiguous_copies(dev, causal,
                                                                 lens):
    """The head-dim-16 kernel reads q, k and v as the (B, H, L, 16) head
    views of (B, L, H * 16) projections, in place, and gives o as a view
    whose transpose back to tokens is contiguous: bit for bit its call on
    contiguous copies (one arithmetic, other addresses), on the route the
    dispatch counts."""
    rng = np.random.default_rng(12)
    B, H, Lq, Lk = 2, 8, 4096, 300

    def views(L):
        return _bf16(rng, (B, L, H * 16), dev).view(B, L, H, 16).transpose(
            1, 2)

    q, k, v = views(Lq), views(Lk), views(Lk)
    kv = None if lens is None else torch.tensor(lens, device=dev)
    before = F.flash_forward.route_launches["sm90_d16"]
    o, lse = F.flash_forward(q, k, v, causal, None, kv)
    o2, lse2 = F.flash_forward(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal, None, kv)
    torch.cuda.synchronize()
    assert F.flash_forward.route_launches["sm90_d16"] == before + 2
    assert o.shape == (B, H, Lq, 16) and o.transpose(1, 2).is_contiguous()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert _close(o, F.flash_forward_plain(q, k, v, causal, None, kv)[0])


@pytest.mark.parametrize("Lk,causal,lens", [(9, False, None),
                                             (300, True, (300, 17))])
def test_d16_kernel_plans_move_no_bit(dev, Lk, causal, lens):
    """The head-dim-16 kernel's CTA plan (query tiles and heads a CTA)
    changes which CTA computes a row, not how: every plan gives the
    default plan's bits."""
    rng = np.random.default_rng(13)
    B, H, Lq = 2, 8, 700
    q = _bf16(rng, (B, H, Lq, 16), dev)
    k, v = _bf16(rng, (B, H, Lk, 16), dev), _bf16(rng, (B, H, Lk, 16), dev)
    kv = None if lens is None else torch.tensor(lens, device=dev)
    o, lse = F.flash_forward(q, k, v, causal, None, kv)
    # eight heads' K and V at Lk = 300 do not fit beside their query ring
    for plan in [(1, 1), (2, 2), (0, 4), (3, 8 if Lk == 9 else 4), (6, 1)]:
        o2, lse2 = F.flash_forward(q, k, v, causal, None, kv, plan)
        torch.cuda.synchronize()
        assert torch.equal(o, o2) and torch.equal(lse, lse2), plan


def test_sam_global_attention_without_rel_pos_reaches_kernel_1(dev):
    """The SAM encoder's ``use_rel_pos=False`` global blocks (4096 queries,
    head dim 80) go to kernel 1 through ``dot_product_attention``; its 14 x
    14 windows (196 queries) stay on the plain attention."""
    from interactvlm_tpu_torch.ops.attention import (
        attention_plain,
        dot_product_attention,
    )

    rng = np.random.default_rng(11)
    q, k, v = (_bf16(rng, (1, 16, 4096, 80), dev) for _ in range(3))
    before = F.flash_forward.launches
    o = dot_product_attention(q, k, v, scale=80 ** -0.5)
    w = (_bf16(rng, (25, 16, 196, 80), dev) for _ in range(3))
    ow = dot_product_attention(*w, scale=80 ** -0.5)
    torch.cuda.synchronize()
    assert F.flash_forward.launches == before + 1
    assert _close(o, attention_plain(q, k, v, scale=80 ** -0.5))
    assert ow.shape == (25, 16, 196, 80)


def _grad_close(got, want, atol_of_rms=GRAD_ATOL_OF_RMS):
    g, w = got.float(), want.float()
    err = (g - w).abs()
    rms = w.square().mean().sqrt().clamp_min(1e-30)
    ok = bool((err <= atol_of_rms * rms + RTOL * w.abs()).all())
    return ok and (err.square().mean().sqrt() / rms).item() <= RMS_TOL


@pytest.mark.parametrize("B,H,Lq,Lk,D,causal,lens", [
    (2, 4, 512, 512, 128, True, (512, 300)),  # LLaMA-13B training, ragged
    (2, 8, 4096, 9, 16, False, None),  # SAM decoder image -> token
    (1, 2, 70, 130, 64, True, None),  # causal, Lq < Lk
    (1, 2, 130, 70, 32, True, (70,)),  # causal, Lq > Lk: 60 rows see no key
    (2, 2, 100, 100, 32, True, (0, 37)),  # row 0 sees no key at all
    # the mma.sync dk/dv kernel's split query walk at Lk <= 64: Lq not a
    # multiple of a split's 512 rows; causal with Lq > Lk, where the first
    # split's queries see no key
    (1, 4, 1000, 9, 16, False, None),
    (2, 2, 700, 40, 32, True, (40, 33)),
    # head dim 16 runs the wgmma/TMA kernels of flash_bwd_d16_sm90.cuh: the
    # one pass at Lk <= 16 (Lk 9; Lk 1 in the test below), the two kernels
    # past it (17: one 32-key tile; 130: three of 48; 520: nine of 64, more
    # than one dk/dv CTA; 1100: eighteen of 64, past the resident K/V
    # budget, so the dq kernel streams K and V through its ring), Lq off
    # the 128-row tiles, causal with Lq != Lk both ways (rows that see no
    # key), kv lengths 0 and 1, an odd head count (one head a CTA of the
    # one pass)
    (1, 3, 257, 9, 16, True, None),  # causal Lq > Lk: 248 rows blind
    (3, 4, 200, 9, 16, False, (0, 1, 9)),
    (1, 2, 300, 17, 16, True, None),
    (2, 2, 70, 130, 16, True, (130, 1)),
    (1, 2, 200, 130, 16, False, (0,)),
    (1, 2, 1000, 520, 16, False, (520,)),
    (1, 2, 300, 1100, 16, False, None),
    (2, 2, 300, 1100, 16, True, (1100, 700)),
    # head dim 128 runs the wgmma/TMA kernels: causal Lq < Lk, causal
    # Lq > Lk with rows that see no key, kv lengths 0, 1 and full, Lq and Lk
    # off the 128-row blocks and 64-row tiles, one (batch, head)
    (1, 3, 70, 200, 128, True, None),
    (2, 2, 300, 129, 128, True, None),
    (3, 2, 129, 129, 128, True, (0, 1, 129)),
    (2, 2, 319, 500, 128, False, (500, 77)),
    (1, 1, 200, 200, 128, True, None),
])
def test_flash_backward_kernels_match_plain(dev, B, H, Lq, Lk, D, causal,
                                            lens):
    rng = np.random.default_rng(7)
    q, do = _bf16(rng, (B, H, Lq, D), dev), _bf16(rng, (B, H, Lq, D), dev)
    k, v = _bf16(rng, (B, H, Lk, D), dev), _bf16(rng, (B, H, Lk, D), dev)
    kv = None if lens is None else torch.tensor(lens, device=dev)
    o, lse = F.flash_forward(q, k, v, causal, None, kv)
    n_dq, n_dkv = F.flash_bwd_dq.launches, F.flash_bwd_dkv.launches
    routes = (dict(F.flash_bwd_dq.route_launches),
              dict(F.flash_bwd_dkv.route_launches))
    got = F.flash_backward(q, k, v, o, lse, do, causal, None, kv)
    torch.cuda.synchronize()
    assert (F.flash_bwd_dq.launches, F.flash_bwd_dkv.launches) == (
        n_dq + 1, n_dkv + 1)
    route = F.bwd_route(D)
    for before, after in zip(routes, (F.flash_bwd_dq.route_launches,
                                      F.flash_bwd_dkv.route_launches)):
        assert after == {r: n + (r == route) for r, n in before.items()}
    want = F.flash_backward_plain(q, k, v, o, lse, do, causal, None, kv)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        assert _grad_close(g, w), name
    # rows that see no key: zero dq; keys no row sees: zero dk and dv
    r = torch.arange(Lq, device=dev)
    c = torch.arange(Lk, device=dev)
    kvl = (torch.tensor(lens, device=dev) if lens is not None
           else torch.full((B,), Lk, device=dev))
    vis = (c[None, None, :] < kvl[:, None, None]).expand(B, Lq, Lk)
    if causal:
        vis = vis & (c[None, :] <= r[:, None] + Lk - Lq)[None]
    blind_rows = ~vis.any(-1)  # (B, Lq)
    unseen_keys = ~vis.any(-2)  # (B, Lk)
    assert bool((got[0].float()[blind_rows[:, None].expand(B, H, Lq)] == 0).all())
    for g in got[1:]:
        assert bool((g.float()[unseen_keys[:, None].expand(B, H, Lk)] == 0).all())


@pytest.mark.parametrize("B,H,Lq,Lk,lens", [
    (2, 2, 300, 1, None),  # one key tile of 16 with 15 keys masked
    (2, 4, 200, 9, (0, 1)),  # kv lengths 0 and 1
])
def test_flash_backward_at_head_dim_16_where_rows_see_one_key(dev, B, H, Lq,
                                                             Lk, lens):
    """Rows that see exactly one key: there P = 1, o is that key's v up to
    the forward's bf16 rounding, and dS = P (dP - D) is 0 but for
    dO (v - o) and the f32 rounding of the two dot products dP and D, so dq,
    and dk of a key only such rows see, are rounding noise on both sides,
    and the comparison above, relative to the plain gradient's RMS, would
    hold noise to noise. Here dv is held to the plain version as above, and
    dq and dk on both sides to 2^-6 of their natural scale: per row
    scale sum_d |dO o| max |k| for dq (|dS| <= 2^-8 sum_d |dO| |v| plus
    the dot products' f32 rounding, 32 2^-24 of the same sum), per key
    scale sum_r sum_d |dO o| max |q| for dk."""
    rng = np.random.default_rng(13)

    def heads(L):
        return _bf16(rng, (B, L, H, 16), dev).transpose(1, 2)

    q, do, k, v = heads(Lq), heads(Lq), heads(Lk), heads(Lk)
    kv = None if lens is None else torch.tensor(lens, device=dev)
    o, lse = F.flash_forward(q, k, v, False, None, kv)
    got = F.flash_backward(q, k, v, o, lse, do, False, None, kv)
    want = F.flash_backward_plain(q, k, v, o, lse, do, False, None, kv)
    torch.cuda.synchronize()
    assert _grad_close(got[2], want[2]), "dv"
    scale = 16 ** -0.5
    row = scale * (do.float() * o.float()).abs().sum(-1)  # (B, H, Lq)
    dq_lim = 2.0 ** -6 * row * k.float().abs().amax((-1, -2))[..., None]
    dk_lim = 2.0 ** -6 * (row * q.float().abs().amax(-1)).sum(-1)  # (B, H)
    for side in (got, want):
        assert bool((side[0].float().abs().amax(-1) <= dq_lim).all()), "dq"
        assert bool((side[1].float().abs().amax((-1, -2)) <= dk_lim).all()), \
            "dk"
        assert all(bool(torch.isfinite(g).all()) for g in side)


@pytest.mark.parametrize("B,H,Lq,Lk,D,causal,lens", [
    (2, 4, 512, 512, 128, True, (512, 300)),
    (1, 3, 300, 129, 128, True, (0,)),  # rows that see no key still get D
    # head dim 16 writes D where it takes two kernels (past 16 keys; the
    # one pass at the SAM decoder's Lk = 9 keeps D inside it)
    (2, 8, 4096, 40, 16, False, None),
    (1, 2, 130, 70, 32, True, (70,)),
])
def test_flash_bwd_dq_writes_the_row_sum(dev, B, H, Lq, Lk, D, causal, lens):
    """The dq kernel's D = rowsum(dO O) against the f32 torch rowsum of the
    same bf16 inputs: each bf16 product is exact in f32, so the two differ
    only in the order of their additions, each element within 2 D 2^-24
    of the sum of its terms' magnitudes (the bound for any two orders); and
    its dq is the dq of the whole backward."""
    rng = np.random.default_rng(11)
    q, do = _bf16(rng, (B, H, Lq, D), dev), _bf16(rng, (B, H, Lq, D), dev)
    k, v = _bf16(rng, (B, H, Lk, D), dev), _bf16(rng, (B, H, Lk, D), dev)
    kv = None if lens is None else torch.tensor(lens, device=dev,
                                                dtype=torch.int32)
    o, lse = F.flash_forward(q, k, v, causal, None, kv)
    dq, dsum = F.flash_bwd_dq(q, k, v, do, o, lse, causal, D ** -0.5, kv)
    torch.cuda.synchronize()
    assert dsum.shape == (B * H, Lq) and dsum.dtype == torch.float32
    prod = do.float() * o.float()
    want = prod.sum(-1).reshape(B * H, Lq)
    limit = 2 * D * 2.0 ** -24 * prod.abs().sum(-1).reshape(B * H, Lq)
    assert bool(torch.isfinite(dsum).all())
    assert bool(((dsum - want).abs() <= limit).all())
    assert torch.equal(dq, F.flash_backward(q, k, v, o, lse, do, causal,
                                            None, kv)[0])


@pytest.mark.parametrize("B,H,Lq,Lk,causal,lens", [
    (32, 8, 4096, 9, False, None),  # the SAM decoder's image -> token
    (2, 8, 4096, 512, False, None),  # the fusion's image -> LLaVA
    (2, 2, 300, 9, True, (9, 1)),
])
def test_flash_backward_at_head_dim_16_reads_and_writes_views(dev, B, H, Lq,
                                                              Lk, causal,
                                                              lens):
    """The head-dim-16 route on the projections' views: q, k, v and dO as
    (B, H, L, 16) views of (B, L, H, 16) tensors and o the forward's view
    give the bits of the same call on contiguous copies; dq, dk and dv are
    views whose transpose back to tokens is contiguous; only the route's
    kernels launch, each once."""
    rng = np.random.default_rng(12)

    def heads(L):
        return _bf16(rng, (B, L, H, 16), dev).transpose(1, 2)

    q, do = heads(Lq), heads(Lq)
    k, v = heads(Lk), heads(Lk)
    kv = None if lens is None else torch.tensor(lens, device=dev)
    o, lse = F.flash_forward(q, k, v, causal, None, kv)
    before = (dict(F.flash_bwd_dq.route_launches),
              dict(F.flash_bwd_dkv.route_launches))
    got = F.flash_backward(q, k, v, o, lse, do, causal, None, kv)
    torch.cuda.synchronize()
    for b, a in zip(before, (F.flash_bwd_dq.route_launches,
                             F.flash_bwd_dkv.route_launches)):
        assert a == {r: n + (r == "sm90_d16") for r, n in b.items()}
    flat = F.flash_backward(*(t.contiguous() for t in (q, k, v, o)), lse,
                            do.contiguous(), causal, None, kv)
    want = F.flash_backward_plain(q, k, v, o, lse, do, causal, None, kv)
    for name, g, f, w in zip(("dq", "dk", "dv"), got, flat, want):
        assert g.transpose(1, 2).is_contiguous(), name
        assert torch.equal(g, f), name
        assert _grad_close(g, w), name


def test_flash_backward_at_head_dim_16_alternating_key_lengths(dev):
    """One kernel at two shared-memory sizes in turn (the dq kernel keeps 2
    key tiles of 64 resident at Lk = 128, 8 at 512): each call launches
    (a kernel's shared-memory limit is raised, never lowered) and matches
    the plain version."""
    rng = np.random.default_rng(14)
    for Lk in (512, 128, 512):
        q, do = (_bf16(rng, (1, 300, 2, 16), dev).transpose(1, 2)
                 for _ in range(2))
        k, v = (_bf16(rng, (1, Lk, 2, 16), dev).transpose(1, 2)
                for _ in range(2))
        o, lse = F.flash_forward(q, k, v)
        got = F.flash_backward(q, k, v, o, lse, do)
        want = F.flash_backward_plain(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert _grad_close(g, w), (Lk, name)


def _units(got, ref):
    """Distance of a gradient from a reference in ``_grad_close``'s units:
    the worst element over its limit, and the RMS error over the RMS."""
    g, r = got.double(), ref.double()
    err = (g - r).abs()
    rms = r.square().mean().sqrt().clamp_min(1e-30)
    return ((err / (GRAD_ATOL_OF_RMS * rms + RTOL * r.abs())).max().item(),
            (err.square().mean().sqrt() / rms).item())


@pytest.mark.parametrize("seed", [1, 2])
def test_flash_backward_kernels_match_plain_at_the_training_shape(dev, seed):
    """The LLaMA-13B training shape whole (B=8, H=40, L=512, D=128, causal,
    the training batch's kv lengths). Here the per-element limit of the
    test above is at the noise floor: an f32 ulp of S or dP that moves a P
    or dS across a bf16 rounding boundary moves a dQ or dK element that
    cancels to near zero by more than the limit (this test's draws fail it
    for dk), while the plain version itself, which rounds P and dS as the
    kernels do, lies 1.4-4x that limit from the exact gradient on some
    element of every draw (chip_ab.py bwd_draws on an H100). So the kernels
    are held to the exact gradient (the plain version in f64): no further
    from it than the plain version, within 1 %, worst element and RMS; and
    to the plain version in RMS as above."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(8, 40, 512, 128, generator=gen, device=dev
                               ).to(torch.bfloat16) for _ in range(4))
    kv = torch.tensor((455, 384) + (512,) * 6, device=dev)
    o, lse = F.flash_forward(q, k, v, True, None, kv)
    got = F.flash_backward(q, k, v, o, lse, do, True, None, kv)
    want = F.flash_backward_plain(q, k, v, o, lse, do, True, None, kv)
    exact = F.flash_backward_plain(*(t.double() for t in (q, k, v, o, lse,
                                                          do)), True, None, kv)
    for name, g, w, e in zip(("dq", "dk", "dv"), got, want, exact):
        assert bool(torch.isfinite(g).all()), name
        (g_worst, g_rms), (w_worst, w_rms) = _units(g, e), _units(w, e)
        assert g_worst <= 1.01 * w_worst, (name, g_worst, w_worst)
        assert g_rms <= 1.01 * w_rms, (name, g_rms, w_rms)
        assert _units(g, w)[1] <= RMS_TOL, name


@pytest.mark.parametrize("D", [64, 128])
def test_flash_autograd_matches_plain_autograd(dev, D):
    """Under grad the CUDA flash call carries a gradient (no silent cut),
    and it agrees with autograd through the plain attention with the
    equivalent bias; at D = 128 the forward is the wgmma kernel, whose lse
    the backward kernels read."""
    from interactvlm_tpu_torch.ops.attention import attention_plain

    rng = np.random.default_rng(8)
    B, H, L = 2, 4, 300
    lens = torch.tensor([300, 211], device=dev)
    leaves = [_bf16(rng, (B, H, L, D), dev).requires_grad_() for _ in range(3)]
    out = F.flash_attention(*leaves, causal=True, kv_lengths=lens)
    assert out.grad_fn is not None
    w = torch.from_numpy(rng.standard_normal((B, H, L, D)).astype(np.float32)
                         ).to(dev)
    got = torch.autograd.grad((out.float() * w).sum(), leaves)
    bias = torch.where(torch.arange(L, device=dev)[None, :] < lens[:, None],
                       0.0, -1e9)[:, None, None, :]
    ref = [t.detach().float().requires_grad_() for t in leaves]
    want = torch.autograd.grad(
        (attention_plain(*ref, bias=bias, causal=True) * w).sum(), ref)
    for g, r in zip(got, want):
        assert _grad_close(g, r, AUTOGRAD_ATOL_OF_RMS)


def test_flash_backward_refuses_what_the_kernels_do_not_take(dev):
    rng = np.random.default_rng(9)
    q = _bf16(rng, (1, 2, 64, 16), dev)
    o, lse = F.flash_forward(q, q, q)
    with pytest.raises(ValueError, match="bfloat16"):
        F.flash_backward(q, q, q, o, lse, q.float())
    with pytest.raises(ValueError, match="lse"):
        F.flash_backward(q, q, q, o, lse[:1], q)
    # head dim 16 reads views, but with unit stride on the head dim only
    with pytest.raises(ValueError, match="unit on the last dim"):
        F.flash_backward(q, q, q, o, lse, q.transpose(2, 3).contiguous()
                         .transpose(2, 3))
    q32 = _bf16(rng, (1, 2, 64, 32), dev)
    o32, lse32 = F.flash_forward(q32, q32, q32)
    with pytest.raises(ValueError, match="contiguous"):
        F.flash_backward(q32, q32, q32, o32, lse32, q32.transpose(2, 3)
                         .contiguous().transpose(2, 3))
    q48 = _bf16(rng, (1, 2, 64, 48), dev)
    with pytest.raises(ValueError, match="head dim"):
        F.flash_backward(q48, q48, q48, q48, lse, q48)


def test_fusion_attention_launches_the_flash_kernels_at_full_width(dev):
    """The fusion head in bf16 on a 64 x 64 SAM grid (Lq = 4096 >= 512,
    D = 16, Lk = 300 LLaVA positions, none masked): its attention launches
    the flash forward once, on the head-dim-16 wgmma route, and its
    backward both backward kernels once, on that route too (the dq kernel
    and the dk/dv kernel past 16 keys), with no fallback to the plain
    attention; outputs and every parameter's gradient are finite."""
    from interactvlm_tpu_torch.models.components import LLaVASAMFusion

    torch.manual_seed(0)
    m = LLaVASAMFusion(256, 5120, torch.bfloat16, dev)
    rng = np.random.default_rng(10)
    sam = _bf16(rng, (2, 64, 64, 256), dev)
    llava = _bf16(rng, (2, 300, 5120), dev)
    before = (F.flash_forward.launches, F.flash_bwd_dq.launches,
              F.flash_bwd_dkv.launches)
    routes = [dict(w.route_launches) for w in (
        F.flash_forward, F.flash_bwd_dq, F.flash_bwd_dkv)]
    out = m(sam, llava)
    out.float().square().mean().backward()
    torch.cuda.synchronize()
    assert (F.flash_forward.launches, F.flash_bwd_dq.launches,
            F.flash_bwd_dkv.launches) == tuple(b + 1 for b in before)
    for w, b in zip((F.flash_forward, F.flash_bwd_dq, F.flash_bwd_dkv),
                    routes):
        assert w.route_launches == {r: n + (r == "sm90_d16")
                                    for r, n in b.items()}
    assert bool(torch.isfinite(out).all())
    for n, p in m.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), n


def test_forward_only_kernels_raise_under_grad(dev):
    """The window, rel-pos and int8 kernels have no backward: under grad
    they raise instead of returning a tensor without a gradient."""
    rng = np.random.default_rng(10)
    q = _bf16(rng, (2, 196, 80), dev).requires_grad_()
    f = _bf16(rng, (2, 28, 196), dev)
    with pytest.raises(RuntimeError, match="no backward"):
        S.window_attention(q, q, q, f, (14, 14))
    g = _bf16(rng, (2, 1024, 80), dev).requires_grad_()
    rh, rw = _bf16(rng, (2, 32, 1024), dev), _bf16(rng, (2, 1024, 32), dev)
    with pytest.raises(RuntimeError, match="no backward"):
        S.rel_attention(g, g, g, rh, rw, (32, 32))
    w, scale = _int8_weight(rng, 64, 128, dev)
    x = _bf16(rng, (4, 128), dev).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        Q.int8_matmul_fused(x, w, scale)
    with torch.no_grad():
        assert S.window_attention(q, q, q, f, (14, 14)).shape == q.shape


def test_window_kernel_matches_plain(dev):
    rng = np.random.default_rng(1)
    R, hw, D = 40, (14, 14), 80
    q, k, v = (_bf16(rng, (R, 196, D), dev) for _ in range(3))
    f = _bf16(rng, (R, 28, 196), dev, 0.5)
    before = S.window_attention.launches
    out = S.window_attention(q, k, v, f, hw)
    torch.cuda.synchronize()
    assert S.window_attention.launches == before + 1
    assert _close(out, S.window_attention_plain(q, k, v, f, hw), WINDOW_ATOL)


def _qkv_views(rng, BW, nH, L, D, dev):
    """q, k, v (BW, nH, L, D) as the SAM encoder's qkv linear leaves them:
    permuted views of one (BW, L, 3 nH D) tensor."""
    qkv = _bf16(rng, (BW, L, 3 * nH * D), dev)
    return qkv.view(BW, L, 3, nH, D).permute(2, 0, 3, 1, 4).unbind(0)


@pytest.mark.parametrize("BW,nH,hw", [
    (4, 16, (14, 14)),  # R = 64 rows of ViT-H's window block
    (3, 5, (7, 7)),  # one query tile; key slots past W and grid rows past H
    (2, 3, (9, 13)),  # ragged both ways, two query tiles
    (2, 4, (16, 16)),  # the 256-slot, one-stage variant
])
def test_window_sm90_route_matches_plain(dev, BW, nH, hw):
    """The wgmma + TMA window kernel on strided q/k/v views (as the qkv
    linear leaves them) against the plain version on the same views; its
    output is a view of (BW, L, nH, D) storage, and contiguous copies of
    the inputs give the same bits."""
    rng = np.random.default_rng(30)
    (H, W), D = hw, 80
    L = H * W
    q, k, v = _qkv_views(rng, BW, nH, L, D, dev)
    f = _bf16(rng, (BW * nH, H + W, L), dev, 0.5)
    assert S.window_route(D, hw) == "sm90"
    before = dict(S.window_attention.route_launches)
    out = S.window_attention(q, k, v, f, hw)
    torch.cuda.synchronize()
    assert S.window_attention.route_launches == {
        r: n + (r == "sm90") for r, n in before.items()}
    assert out.shape == q.shape and out.transpose(1, 2).is_contiguous()
    assert _close(out, S.window_attention_plain(q, k, v, f, hw), WINDOW_ATOL)
    rows = [t.contiguous() for t in (q, k, v)]
    assert torch.equal(S.window_attention(*rows, f, hw), out)


@pytest.mark.parametrize("D,hw", [(64, (14, 14)), (80, (17, 17))])
def test_window_mma_route_matches_plain(dev, D, hw):
    """Head dims other than 80, and windows past 16 x 16, stay on the
    mma.sync kernel, which takes contiguous rows."""
    rng = np.random.default_rng(31)
    H, W = hw
    R, L = 6, H * W
    q, k, v = (_bf16(rng, (R, L, D), dev) for _ in range(3))
    f = _bf16(rng, (R, H + W, L), dev, 0.5)
    assert S.window_route(D, hw) == "mma"
    before = dict(S.window_attention.route_launches)
    out = S.window_attention(q, k, v, f, hw)
    torch.cuda.synchronize()
    assert S.window_attention.route_launches == {
        r: n + (r == "mma") for r, n in before.items()}
    assert _close(out, S.window_attention_plain(q, k, v, f, hw), WINDOW_ATOL)
    with pytest.raises(ValueError, match="contiguous"):
        S.window_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k,
                           v, f, hw)


def test_window_sm90_route_refuses_misaligned_views(dev):
    """The TMA route reads views in place: a head dim that is not unit
    stride or a stride off 16 bytes raises."""
    rng = np.random.default_rng(32)
    q = _bf16(rng, (2, 196, 2 * 80 + 8), dev)[:, :, 8:88]  # 16-byte offset
    f = _bf16(rng, (2, 28, 196), dev)
    S.window_attention(q, q, q, f, (14, 14))  # 16-byte steps are fine
    odd = _bf16(rng, (2, 196, 84), dev)[:, :, :80]  # rows 168 bytes apart
    with pytest.raises(ValueError, match="strides"):
        S.window_attention(odd, odd, odd, f, (14, 14))


@pytest.mark.parametrize("side", [32, 64])
def test_global_kernel_matches_plain(dev, side):
    rng = np.random.default_rng(2)
    R, L, D = 2, side * side, 80
    q, k, v = (_bf16(rng, (R, L, D), dev) for _ in range(3))
    rh = _bf16(rng, (R, side, L), dev, 0.5)
    rw = _bf16(rng, (R, L, side), dev, 0.5)
    before = S.rel_attention.launches
    out = S.rel_attention(q, k, v, rh, rw, (side, side))
    torch.cuda.synchronize()
    assert S.rel_attention.launches == before + 1
    want = S.rel_attention_plain(q, k, v, rh, rw, (side, side))
    assert _close(out, want)


@pytest.mark.parametrize("R,hw,D", [
    (2, (25, 40), 80),  # L = 1000, no multiple of 64, and W != 64
    (3, (64, 64), 80),  # an odd head count on the ViT-H grid
    (1, (3, 64), 80),  # W = 64 with 3 key tiles; half the row block past L
    (2, (5, 7), 80),  # one key tile, 29 keys masked, 93 rows past L
    (2, (32, 32), 64),  # the mma.sync route still serves the other dims
])
def test_global_kernel_routes_match_plain(dev, R, hw, D):
    """Each head dim on the route rel_route names, held to the plain
    version at the ragged edges of the wgmma kernel's tiles."""
    rng = np.random.default_rng(20)
    H, W = hw
    L = H * W
    q, k, v = (_bf16(rng, (R, L, D), dev) for _ in range(3))
    rh = _bf16(rng, (R, H, L), dev, 0.5)
    rw = _bf16(rng, (R, L, W), dev, 0.5)
    route = S.rel_route(D)
    before = dict(S.rel_attention.route_launches)
    out = S.rel_attention(q, k, v, rh, rw, hw)
    torch.cuda.synchronize()
    assert S.rel_attention.route_launches == {
        r: n + (r == route) for r, n in before.items()}
    assert _close(out, S.rel_attention_plain(q, k, v, rh, rw, hw))


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """A CUDA tensor reaches the kernel or the call raises: no fallback."""
    rng = np.random.default_rng(3)
    q = _bf16(rng, (1, 2, 64, 16), dev)
    with pytest.raises(ValueError, match="bfloat16"):
        F.flash_forward(q.float(), q.float(), q.float())
    with pytest.raises(ValueError, match="head dim"):
        F.flash_forward(*(_bf16(rng, (1, 2, 64, 48), dev),) * 3)
    # head dim 16 reads views, but only with unit stride on the head dim;
    # the other head dims take contiguous tensors
    with pytest.raises(ValueError, match="unit"):
        t = q.transpose(2, 3).contiguous().transpose(2, 3)
        F.flash_forward(t, t, t)
    with pytest.raises(ValueError, match="contiguous"):
        t = _bf16(rng, (1, 2, 32, 64), dev).transpose(2, 3)
        F.flash_forward(t, t, t)
    with pytest.raises(ValueError, match="positive"):
        F.flash_forward(q, q, q, False, -0.25)


def test_launch_binds_each_c_function_once():
    """The wrapper's C launcher is looked up and typed at its first launch
    only (the int8 path launches thousands of times a batch); a nonzero
    return raises with the library's error string. Runs without a card:
    the library is a stand-in."""
    from interactvlm_tpu_torch.ops import _cuda

    class Fn:
        def __call__(self, *args):
            return args[0]

    class Lib:
        lookups = 0

        def __getattr__(self, attr):
            type(self).lookups += 1
            if attr.endswith("_error_string"):
                return lambda code: b"stand-in error"
            return Fn()

    _cuda._loaded["standin"] = Lib()
    try:
        for _ in range(5):
            _cuda.launch("standin", "ivlm_standin", [], 0)
        assert Lib.lookups == 1
        with pytest.raises(RuntimeError, match="stand-in error"):
            _cuda.launch("standin", "ivlm_standin", [], 7)
    finally:
        _cuda._loaded.pop("standin")
        _cuda._bound.pop(("standin", "ivlm_standin"))


def _int8_weight(rng, N, K, dev):
    w = torch.from_numpy(rng.integers(-127, 128, (N, K), dtype=np.int8)).to(dev)
    scale = torch.from_numpy(
        rng.uniform(0.5, 1.5, N).astype(np.float32) / (127 * K ** 0.5)).to(dev)
    return w, scale


@pytest.mark.parametrize("M,K,N,dtype,with_bias,act", [
    (8, 4096, 4096, torch.bfloat16, False, "none"),  # LLaMA-7B decode
    (32, 4096, 11008, torch.bfloat16, False, "none"),  # cached decode
    (2552, 4096, 11008, torch.bfloat16, False, "none"),  # 7B prefill
    (6272, 1280, 5120, torch.bfloat16, True, "gelu_tanh"),  # SAM lin1
    (3000, 1280, 3840, torch.bfloat16, True, "gelu"),  # SAM qkv, exact GELU
    (3000, 1280, 5120, torch.bfloat16, False, "gelu"),  # chain int8_gelu
    (39, 64, 96, torch.float32, True, "gelu"),  # tiny f32 preset, K % 64
    # the one-launch route at decode down and the lm_head, every row count
    # from one to the threshold
    *[(M, K, N, torch.bfloat16, False, "none")
      for K, N in ((11008, 4096), (4096, 32000)) for M in (1, 8, 17, 32)],
    # K ragged against the cluster's slices, N against the column block
    (32, 160, 136, torch.float32, True, "gelu_tanh"),
    # the largest K the one-launch kernel takes (its slices fill shared
    # memory), f32 x
    (32, Q.ONE_LAUNCH_MAX_K, 136, torch.float32, False, "none"),
])
def test_int8_kernel_matches_plain(dev, M, K, N, dtype, with_bias, act):
    """The fused int8 matmul on either route against its plain version (bit
    for bit without an activation, within one bf16 step with one), and
    against the two-pass kernels on the same quantized rows: the one-launch
    kernel sums the same int32 products and rounds the same epilogue, so
    without an activation it gives kernel 8's bits (without a bias) and the
    int8 GEMM's (with one)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(
        dev, dtype)
    if M > 1:
        x[0] = 0.0  # a zero row writes act(bias)
        x[1, :9] = torch.tensor([127.0, 2.5, 3.5, -2.5, 0.5, 1.5, -0.5, 126.5,
                                 -127.0])  # rounding ties
    w, scale = _int8_weight(rng, N, K, dev)
    bias = (torch.from_numpy(rng.standard_normal(N).astype(np.float32)).to(dev)
            if with_bias else None)
    before = Q.int8_matmul_fused.launches
    out = Q.int8_matmul_fused(x, w, scale, bias, act)
    torch.cuda.synchronize()
    assert Q.int8_matmul_fused.launches == before + 1
    assert out.dtype == dtype and out.shape == (M, N)
    want = Q.int8_matmul_fused_plain(x, w, scale, bias, act).float()
    if act == "none":  # the same f32 operations in the same order
        assert torch.equal(out.float(), want)
        xq, xs = Q.quantize_rows(x)
        two = (Q.int8_gemm(xq, xs, w, scale, bias, act, dtype)
               if with_bias else
               Q.int8_matmul_prequant(xq, xs, w, scale, dtype, act))
        assert torch.equal(out, two)
    err = (out.float() - want).abs()
    limit = 2.0 ** -7 * want.abs() + 1e-6 * want.abs().max()
    assert bool((err <= limit).all()), err.max().item()
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("M", [Q.ONE_LAUNCH_MAX_ROWS, Q.ONE_LAUNCH_MAX_ROWS + 1])
@pytest.mark.parametrize("K,N", [(32, 8), (160, 136), (5120, 11008),
                                 (160, 11008), (5120, 136)])
def test_int8_routes_meet_at_the_threshold(dev, M, K, N):
    """Both routes of the fused int8 matmul at the rows where they meet,
    with N ragged against the GEMM's tile and K against its 128-byte chunk:
    each launches what its route names and gives the plain version's bits
    (no activation) or its rounding (tanh GELU, f32 out)."""
    rng = np.random.default_rng(16)
    x = _ties_rows(rng, M, K, dev, torch.bfloat16)
    w, scale = _int8_weight(rng, N, K, dev)
    bias = torch.from_numpy(rng.standard_normal(N).astype(np.float32)).to(dev)
    route = Q.int8_route(M, K)
    assert route == ("one_launch" if M <= 32 else "two_pass")
    for act, dtype in (("none", torch.bfloat16), ("gelu_tanh", torch.float32)):
        counts = (dict(Q.int8_matmul_fused.route_launches),
                  Q.quantize_rows.launches, Q.int8_gemm.launches)
        out = Q.int8_matmul_fused(x, w, scale, bias, act, dtype)
        torch.cuda.synchronize()
        two = route == "two_pass"
        assert Q.int8_matmul_fused.route_launches[route] == counts[0][route] + 1
        assert (Q.quantize_rows.launches, Q.int8_gemm.launches) == (
            counts[1] + two, counts[2] + two)
        want = Q.int8_matmul_fused_plain(x, w, scale, bias, act, dtype)
        assert out.dtype == dtype and out.shape == (M, N)
        if act == "none":
            assert torch.equal(out, want)
        err = (out.float() - want.float()).abs()
        limit = 2.0 ** -7 * want.float().abs() + 1e-6 * want.float().abs().max()
        assert bool((err <= limit).all()), err.max().item()


@pytest.mark.parametrize("M,K,N,with_bias,act,dtype", [
    (3000, 1280, 3840, True, "none", torch.bfloat16),  # SAM qkv
    (2552, 4096, 4096, False, "none", torch.bfloat16),  # 7B prefill q/k/v/o
    (300, 5120, 1280, True, "gelu", torch.float32),
    (129, 160, 136, True, "gelu_tanh", torch.bfloat16),
])
def test_int8_gemm_kernel_matches_plain(dev, M, K, N, with_bias, act, dtype):
    """The wgmma GEMM against its plain version: bit for bit without an
    activation, within one bf16 step with one."""
    rng = np.random.default_rng(17)
    xq, xs = Q.quantize_rows(_ties_rows(rng, M, K, dev, torch.bfloat16))
    w, scale = _int8_weight(rng, N, K, dev)
    bias = (torch.from_numpy(rng.standard_normal(N).astype(np.float32)).to(dev)
            if with_bias else None)
    before = Q.int8_gemm.launches
    out = Q.int8_gemm(xq, xs, w, scale, bias, act, dtype)
    torch.cuda.synchronize()
    assert Q.int8_gemm.launches == before + 1
    want = Q.int8_matmul_prequant_plain(xq, xs, w, scale, dtype, act, bias)
    assert out.dtype == dtype and out.shape == (M, N)
    if act == "none":
        assert torch.equal(out, want)
    err = (out.float() - want.float()).abs()
    limit = 2.0 ** -7 * want.float().abs() + 1e-6 * want.float().abs().max()
    assert bool((err <= limit).all()), err.max().item()


def test_quantize_on_the_card_gives_the_cpu_bytes(dev):
    """The int8 KV cache quantizes on the card: its scales and bytes must be
    those of the CPU (and so of the JAX package), with no reciprocal
    shortcut in the division by 127."""
    from interactvlm_tpu_torch.ops.quant import quantize_int8

    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((4096, 128)).astype(np.float32))
    q_cpu, s_cpu = quantize_int8(x)
    q_dev, s_dev = quantize_int8(x.to(dev))
    assert torch.equal(s_dev.cpu(), s_cpu)
    assert torch.equal(q_dev.cpu(), q_cpu)


@pytest.mark.parametrize("M", [2, 40])  # the one-launch and two-pass routes
def test_int8_kernel_rounds_half_to_even(dev, M):
    """W = I with unit scales returns x's quantized values exactly: with
    amax 127 (x_scale 1) the halves must land on even integers (``roundf``
    would not)."""
    x = torch.zeros(M, 32, device=dev)
    x[:, :9] = torch.tensor([127.0, 2.5, 3.5, -2.5, -3.5, 0.5, 1.5, -0.5,
                             126.5])
    w = torch.eye(32, device=dev).to(torch.int8)
    scale = torch.ones(32, device=dev)
    before = dict(Q.int8_matmul_fused.route_launches)
    out = Q.int8_matmul_fused(x, w, scale)
    route = Q.int8_route(M)
    assert Q.int8_matmul_fused.route_launches[route] == before[route] + 1
    for row in out.tolist():
        assert row[:9] == [127, 2, 4, -2, -4, 0, 2, 0, 126]


def test_int8_wrapper_refuses_what_the_kernel_does_not_take(dev):
    rng = np.random.default_rng(5)
    w, scale = _int8_weight(rng, 64, 80, dev)
    x = torch.randn(4, 80, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 32"):
        Q.int8_matmul_fused(x, w, scale)
    w, scale = _int8_weight(rng, 64, 128, dev)
    x = torch.randn(128, 4, device=dev, dtype=torch.bfloat16).t()
    with pytest.raises(ValueError, match="contiguous"):
        Q.int8_matmul_fused(x, w, scale)
    with pytest.raises(ValueError, match="CUDA"):
        Q.int8_matmul_fused(x.contiguous(), w.cpu(), scale)
    with pytest.raises(ValueError, match="float16"):
        Q.int8_matmul_fused(x.contiguous().half(), w, scale)


def _ties_rows(rng, M, K, dev, dtype):
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(
        dev, dtype)
    x[0] = 0.0  # a zero row: scale 1e-8 / 127, all zeros
    x[1] = 0.0
    x[1, :9] = torch.tensor([127.0, 2.5, 3.5, -2.5, 0.5, 1.5, -0.5, 126.5,
                             -127.0])  # rounding ties
    return x


@pytest.mark.parametrize("M,K,dtype", [
    (32768, 1280, torch.bfloat16),  # the chain probe's activations
    (3000, 5120, torch.bfloat16),  # its hidden activations
    (40, 264, torch.float32),
    (5, 16384, torch.bfloat16),  # a row read twice
])
def test_quantize_rows_kernel_matches_plain(dev, M, K, dtype):
    x = _ties_rows(np.random.default_rng(11), M, K, dev, dtype)
    before = Q.quantize_rows.launches
    q, s = Q.quantize_rows(x)
    torch.cuda.synchronize()
    assert Q.quantize_rows.launches == before + 1
    q2, s2 = Q.quantize_rows_plain(x)
    assert torch.equal(q, q2) and torch.equal(s, s2)
    assert q[1, :9].tolist() == [127, 2, 4, -2, 0, 2, 0, 126, -127]


@pytest.mark.parametrize("M,K,N,dtype,act", [
    (3000, 1280, 5120, torch.bfloat16, "none"),
    (3000, 1280, 5120, torch.bfloat16, "gelu"),
    (257, 5120, 1280, torch.bfloat16, "none"),
    (40, 256, 384, torch.float32, "gelu_tanh"),
])
def test_int8_prequant_kernel_matches_plain(dev, M, K, N, dtype, act):
    rng = np.random.default_rng(12)
    x = _ties_rows(rng, M, K, dev, torch.bfloat16)
    xq, xs = Q.quantize_rows(x)
    w, scale = _int8_weight(rng, N, K, dev)
    before = Q.int8_matmul_prequant.launches
    out = Q.int8_matmul_prequant(xq, xs, w, scale, dtype, act)
    torch.cuda.synchronize()
    assert Q.int8_matmul_prequant.launches == before + 1
    assert out.dtype == dtype and out.shape == (M, N)
    want = Q.int8_matmul_prequant_plain(xq, xs, w, scale, dtype, act).float()
    if act == "none":
        assert torch.equal(out.float(), want)
    err = (out.float() - want).abs()
    limit = 2.0 ** -7 * want.abs() + 1e-6 * want.abs().max()
    assert bool((err <= limit).all())
    # it is the wgmma GEMM with no bias, bit for bit
    assert torch.equal(out, Q.int8_gemm(xq, xs, w, scale, None, act, dtype))
    # the two-pass form gives the fused kernel's bits
    fused = Q.int8_matmul_fused(x, w, scale, None, act, dtype)
    assert torch.equal(Q.int8_matmul_prequant(xq, xs, w, scale, dtype, act),
                       fused)


@pytest.mark.parametrize("lead,K,N,with_bias,act,dtype", [
    ((3000,), 1280, 5120, True, "gelu", torch.bfloat16),  # ViT-H lin1
    ((257,), 5120, 1280, False, "none", torch.bfloat16),  # ViT-H lin2
    ((40,), 264, 392, True, "gelu_tanh", torch.float32),  # ragged tiles
    ((2, 5), 64, 24, False, "none", torch.bfloat16),
    # more 128 x 256 tiles (32 x 20) than SMs: the persistent CTAs loop
    ((4096,), 1280, 5120, True, "gelu", torch.bfloat16),
    # fewer than 64 rows and 256 columns, K ragged against the 64-value chunk
    ((33,), 200, 136, True, "none", torch.float32),
])
def test_fused_dense_kernel_matches_plain(dev, lead, K, N, with_bias, act,
                                          dtype):
    rng = np.random.default_rng(13)
    x = _bf16(rng, lead + (K,), dev)
    w = _bf16(rng, (N, K), dev, K ** -0.5)
    b = _bf16(rng, (N,), dev, 0.5) if with_bias else None
    before = D.fused_dense.launches
    out = D.fused_dense(x, w, b, act, dtype)
    torch.cuda.synchronize()
    assert D.fused_dense.launches == before + 1
    assert out.dtype == dtype and out.shape == lead + (N,)
    want = D.fused_dense_plain(x, w, b, act, dtype).float()
    err = (out.float() - want).abs()
    rms = want.square().mean().sqrt()
    assert bool((err <= 2.0 ** -7 * want.abs() + 1e-3 * rms).all())
    assert (err.square().mean().sqrt() / rms).item() <= 2.0 ** -8


@pytest.mark.parametrize("in_dtype,acc_dtype", [
    (torch.bfloat16, torch.float32), (torch.int8, torch.int32),
    (torch.int8, torch.float32), (torch.float32, torch.float32)])
@pytest.mark.parametrize("shape,loops", [((512, 1280, 1280), 4),
                                         ((64, 256, 128), 3),
                                         ((512, 1280, 1280), 1)])
def test_mxu_kernel_matches_plain(dev, in_dtype, acc_dtype, shape, loops):
    from interactvlm_tpu_torch.probes.mxu import make_inputs

    x, w = make_inputs(in_dtype, shape, dev)
    before = X.mxu_loop.launches
    out = X.mxu_loop(x, w, loops, acc_dtype)
    torch.cuda.synchronize()
    assert X.mxu_loop.launches == before + 1
    want = X.mxu_loop_plain(x, w, loops, acc_dtype)
    assert out.dtype == torch.float32 and out.shape == want.shape
    if in_dtype == torch.int8:
        assert torch.equal(out, want)
    else:
        err = (out - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("in_dtype,acc_dtype", [
    (torch.bfloat16, torch.float32), (torch.int8, torch.int32),
    (torch.int8, torch.float32)])
@pytest.mark.parametrize("shape,loops", [((200, 384, 328), 4),
                                         ((70, 128, 136), 1),
                                         ((64, 256, 128), 7)])
def test_mxu_wgmma_kernel_ragged_tiles(dev, in_dtype, acc_dtype, shape,
                                       loops):
    """The wgmma combinations at M and N off their 128 x 256 (128 x 128)
    tiles, zero-filled past the edge, and at an odd loop count (combination
    2 alternates two int32 sets a loop)."""
    from interactvlm_tpu_torch.probes.mxu import make_inputs

    x, w = make_inputs(in_dtype, shape, dev)
    out = X.mxu_loop(x, w, loops, acc_dtype)
    torch.cuda.synchronize()
    want = X.mxu_loop_plain(x, w, loops, acc_dtype)
    if in_dtype == torch.int8:
        assert torch.equal(out, want)
    else:
        err = (out - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("R,L,D", [(3200, 196, 80), (3, 100, 16)])
def test_window_copy_kernel_is_a_copy(dev, R, L, D):
    rng = np.random.default_rng(14)
    q, k, v = (_bf16(rng, (R, L, D), dev) for _ in range(3))
    before = S.window_copy.launches
    out = S.window_copy(q, k, v)
    torch.cuda.synchronize()
    assert S.window_copy.launches == before + 1
    assert out.data_ptr() != q.data_ptr() and torch.equal(out, q)


def test_probe_kernels_refuse_what_they_do_not_take(dev):
    rng = np.random.default_rng(15)
    x = _bf16(rng, (16, 64), dev)
    with pytest.raises(RuntimeError, match="no backward"):
        D.fused_dense(x.clone().requires_grad_(), x)
    with pytest.raises(ValueError, match="multiples of 8"):
        D.fused_dense(_bf16(rng, (16, 60), dev), _bf16(rng, (16, 60), dev))
    with pytest.raises(ValueError, match="contiguous"):
        D.fused_dense(x.t().contiguous().t(), x)
    with pytest.raises(ValueError, match="multiple of 8"):
        Q.quantize_rows(_bf16(rng, (4, 60), dev))
    xq, xs = Q.quantize_rows(x)
    w, scale = _int8_weight(rng, 16, 64, dev)
    with pytest.raises(ValueError, match="scales"):
        Q.int8_matmul_prequant(xq, xs[:8], w, scale)
    with pytest.raises(ValueError, match="multiples of 64"):
        X.mxu_loop(x.float(), x.float(), 2)  # the f32 kernel's 64 x 64 tiles
    with pytest.raises(ValueError, match="128 bytes"):
        X.mxu_loop(_bf16(rng, (16, 72), dev), _bf16(rng, (16, 72), dev), 2)
    with pytest.raises(ValueError, match="no kernel"):
        X.mxu_loop(x, x, 2, torch.int32)
    with pytest.raises(ValueError, match="shapes"):
        S.window_copy(x[None], x[None], x[None, :8])


# ------------------------------------------------ QLoRA, int4, lift maps
# The straight-through int8 matmul (kernel 6 forward, a bf16 GEMM with an
# f32 output backward) and int4_matmul (the int4 kernels) against their
# plain versions on the CPU. Forward: the kernel and the plain
# version share the quantization and the exact integer sum, so each element
# within one bf16 step plus 1e-6 of the largest (as the int8 cases above).
# dx: bf16 products exact in f32 on both sides, f32 sums in another order,
# then x's dtype: within 1e-5 of the largest magnitude in f32, one bf16
# step more in bf16.


@pytest.mark.parametrize("M,K,N,dtype", [
    (8, 512, 384, torch.bfloat16),  # one launch
    (1024, 4096, 4096, torch.bfloat16),  # the 7B QLoRA step's q/k/v/o
    (512, 11008, 4096, torch.bfloat16),  # its down projection
    (40, 64, 96, torch.float32),  # the tiny f32 preset, two passes
])
def test_int8_ste_on_the_card_matches_the_cpu(dev, M, K, N, dtype):
    from interactvlm_tpu_torch.ops import quant as QT

    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(
        dev, dtype).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((M, N)).astype(np.float32)).to(
        dev, dtype)
    w, scale = _int8_weight(rng, N, K, dev)
    before = Q.int8_matmul_fused.launches
    y = QT.int8_matmul_ste(x, w, scale, dtype)
    y.backward(g)
    torch.cuda.synchronize()
    assert Q.int8_matmul_fused.launches == before + 1
    assert y.dtype == dtype and x.grad.dtype == dtype and w.grad is None
    want = Q.int8_matmul_fused_plain(x.detach().cpu(), w.cpu(), scale.cpu(),
                                     out_dtype=dtype).float()
    err = (y.detach().float().cpu() - want).abs()
    assert bool((err <= 2.0 ** -7 * want.abs()
                 + 1e-6 * want.abs().max()).all()), err.max().item()
    want_dx = QT.ste_input_grad(g.cpu(), w.cpu(), scale.cpu(),
                                torch.float32)
    err = (x.grad.float().cpu() - want_dx).abs()
    step = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    assert bool((err <= step * want_dx.abs()
                 + 1e-5 * want_dx.abs().max()).all()), err.max().item()


@pytest.mark.parametrize("M,K,N", [(8, 4096, 4096), (32, 11008, 4096),
                                   (40, 4096, 11008), (512, 4096, 4096)])
def test_int4_matmul_on_the_card_matches_plain(dev, M, K, N):
    """The int4 kernels on both routes (the route its rows pick, counted by
    the int4 wrapper), through ``int4_matmul`` as ``Int4Linear`` calls it,
    against the plain version on the CPU on the same inputs."""
    from interactvlm_tpu_torch.ops import quant as QT

    rng = np.random.default_rng(22)
    w = torch.from_numpy(rng.standard_normal((N, K)).astype(np.float32))
    w *= torch.from_numpy(np.exp(rng.standard_normal(K)).astype(np.float32))
    q4, cs, rf = QT.quantize_int4(w)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(
        torch.bfloat16)
    routes = dict(Q4.int4_matmul_fused.route_launches)
    with torch.no_grad():
        got = QT.int4_matmul(x.to(dev), q4.to(dev), cs.to(dev), rf.to(dev))
    torch.cuda.synchronize()
    route = Q4.int4_route(M, K)
    assert Q4.int4_matmul_fused.route_launches[route] == routes[route] + 1
    want = Q4.int4_matmul_fused_plain(x, q4, cs, rf, torch.bfloat16).float()
    err = (got.float().cpu() - want).abs()
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert bool((err <= 2.0 ** -7 * want.abs()
                 + 1e-6 * want.abs().max()).all()), err.max().item()


def _int4_inputs(rng, M, K, N, dev, xdt, flat=False):
    """Rows with a zero row and rounding ties (``_ties_rows``; one random
    row where M is 1), a packed
    weight of random bytes (every nibble value in both halves), scales and
    a row factor (1 on the ties' columns, so that they stay ties)."""
    x = (_ties_rows(rng, M, K, dev, xdt) if M > 1 else torch.from_numpy(
        rng.standard_normal((M, K)).astype(np.float32)).to(dev, xdt))
    packed = torch.from_numpy(rng.integers(-128, 128, (N, K // 2),
                                           dtype=np.int8)).to(dev)
    cs = torch.from_numpy(rng.uniform(0.5, 1.5, N).astype(np.float32)
                          / (7 * K ** 0.5)).to(dev)
    rf = (np.ones(K, np.float32) if flat
          else rng.uniform(0.5, 1.5, K).astype(np.float32))
    rf[:9] = 1.0
    return x, packed, cs, torch.from_numpy(rf).to(dev)


BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("M,K,N,xdt,odt,flat", [
    # the decode kernel: the route's row counts, a chunk tail (K = 160),
    # K / 2 = 5504 (43 chunks, ragged against every cluster but 1), N ragged
    # against the 128-column blocks (136), both x and output types
    (1, 160, 136, F32, F32, True),
    (1, 256, 128, F32, F32, False),
    (1, 4096, 4096, BF, BF, False),
    (8, 4096, 4096, BF, BF, False),  # 7B decode q/k/v/o
    (8, 4096, 4096, F32, F32, False),
    (8, 4096, 11008, BF, BF, False),  # gate/up
    (8, 11008, 4096, BF, BF, False),  # down
    (8, 11008, 136, F32, BF, False),
    (8, 4096, 32000, BF, BF, False),  # lm_head
    (31, 11008, 136, BF, F32, False),
    (31, 160, 136, F32, BF, True),
    (32, 4096, 4096, BF, BF, False),  # the cached batch
    (32, 4096, 11008, BF, BF, False),
    (32, 11008, 4096, BF, F32, False),
    (32, 4096, 32000, BF, BF, False),
    (32, 160, 136, BF, F32, True),
    # above 32 rows: kernel 7 with the row factor, then the int4 GEMM
    (33, 256, 264, F32, F32, False),
    (33, 11008, 136, BF, BF, False),
    (39, 160, 136, BF, BF, True),
    (39, 4096, 4096, F32, BF, False),
    (2552, 4096, 4096, BF, BF, False),  # 7B prefill
    (2552, 4096, 11008, BF, BF, False),
    (2552, 11008, 4096, BF, F32, False),
])
def test_int4_kernel_matches_plain_and_the_unpack_route(dev, M, K, N, xdt,
                                                        odt, flat):
    """Both routes bit for bit against the plain version and against the
    unpack route on the card, rows 0 and 1 a zero row and rounding ties
    (``_ties_rows``) where M allows."""
    rng = np.random.default_rng(M + K + N)
    x, packed, cs, rf = _int4_inputs(rng, M, K, N, dev, xdt, flat)
    before = dict(Q4.int4_matmul_fused.route_launches)
    got = Q4.int4_matmul_fused(x, packed, cs, rf, odt)
    torch.cuda.synchronize()
    route = Q4.int4_route(M, K)
    assert Q4.int4_matmul_fused.route_launches[route] == before[route] + 1
    assert got.dtype == odt and got.shape == (M, N)
    assert torch.equal(got, Q4.int4_matmul_fused_plain(x, packed, cs, rf,
                                                       odt))
    assert torch.equal(got, Q4.int4_matmul_unpack_route(x, packed, cs, rf,
                                                        odt))


@pytest.mark.parametrize("M,K,N", [(8, 4096, 4096), (32, 11008, 4096),
                                   (5, 160, 136)])
def test_int4_decode_gives_one_result_for_every_plan(dev, M, K, N):
    """The decode kernel's bits do not depend on its split: every cluster
    size and cluster count gives the plain version's bits; a split whose
    slice leaves no room for the ring raises (no fallback)."""
    rng = np.random.default_rng(M * N)
    x, packed, cs, rf = _int4_inputs(rng, M, K, N, dev, BF)
    want = Q4.int4_matmul_fused_plain(x, packed, cs, rf, BF)
    nch = -(-(K // 2) // 128)
    for cluster in sorted({1, 2, 3, min(8, nch), nch} & set(range(1, 9))):
        if cluster > nch:
            continue
        for clusters in (1, 5, 132):
            try:
                got = Q4.int4_decode(x, packed, cs, rf, BF,
                                     (cluster, clusters))
            except RuntimeError:
                # only a split whose slice does not fit may refuse
                rows = Q4.padded_rows(M)
                assert Q4.decode_smem_bytes(
                    rows, -(-nch // cluster), Q4.DECODE_MIN_STAGES) \
                    > Q4.H100_SMEM
                continue
            torch.cuda.synchronize()
            assert torch.equal(got, want), (cluster, clusters)


def test_int4_cuda_inputs_the_kernels_refuse_raise(dev):
    """No fallback: an input a kernel cannot take raises on the card."""
    rng = np.random.default_rng(5)
    x, packed, cs, rf = _int4_inputs(rng, 8, 256, 136, dev, BF)
    with pytest.raises(ValueError, match="multiple"):
        Q4.int4_matmul_fused(x[:, :240].contiguous(), packed[:, :120]
                             .contiguous(), cs, rf[:240].contiguous())
    with pytest.raises(ValueError, match="bf16 or f32"):
        Q4.int4_matmul_fused(x.half(), packed, cs, rf)
    with pytest.raises(ValueError, match="contiguous"):
        Q4.int4_matmul_fused(x.t().contiguous().t(), packed, cs, rf)
    with pytest.raises(RuntimeError, match="launch failed"):
        Q4.int4_decode(x, packed, cs, rf, BF, (9, 1))  # no such cluster
    xq, xs = Q.quantize_rows(x, rf)
    with pytest.raises(ValueError, match="multiple"):
        Q4.int4_gemm(xq[:, :240].contiguous(), xs, packed[:, :120]
                     .contiguous(), cs)


@pytest.mark.parametrize("M,K,N", [(8, 5504, 4096), (2552, 2048, 4096)])
def test_int4_row_parallel_partial_matches_plain(dev, M, K, N):
    """The row-parallel int4 linear's partial on one rank (7B down at
    decode and o_proj at prefill, K halved): kernel 7's given-scale route
    with the row factor, then the int4 GEMM to f32, bit for bit against
    the plain versions and the unpack route."""
    rng = np.random.default_rng(M + K)
    x, packed, cs, rf = _int4_inputs(rng, M, K, N, dev, torch.bfloat16)
    amax = ((x.float() * rf).abs().amax(-1) * 1.5).contiguous()
    xq, xs = Q.quantize_rows_given(x, amax, rf)
    got = Q4.int4_gemm(xq, xs, packed, cs, torch.float32)
    torch.cuda.synchronize()
    pq, ps = Q.quantize_rows_given_plain(x, amax, rf)
    assert torch.equal(xq, pq) and torch.equal(xs, ps)
    assert torch.equal(got, Q4.int4_gemm_plain(pq, ps, packed, cs,
                                               torch.float32))
    oq, os_ = Q.quantize_rows_given((x.float() * rf).contiguous(), amax)
    assert torch.equal(got, Q.int8_gemm(oq, os_, Q4.unpacked(packed), cs,
                                        dtype=torch.float32))


@pytest.mark.parametrize("M,K,dtype", [(8, 4096, torch.bfloat16),
                                       (2552, 11008, torch.bfloat16),
                                       (40, 264, torch.float32),
                                       (5, 16384, torch.bfloat16)])
def test_quantize_rows_with_row_factor_matches_plain(dev, M, K, dtype):
    """Kernel 7 with the row factor: bit for bit its plain version, which is
    the plain route on f32 x * rf."""
    rng = np.random.default_rng(M)
    x = _ties_rows(rng, M, K, dev, dtype)
    rf = torch.from_numpy(rng.uniform(0.5, 1.5, K).astype(np.float32)).to(dev)
    q, s = Q.quantize_rows(x, rf)
    torch.cuda.synchronize()
    q2, s2 = Q.quantize_rows_plain(x, rf)
    assert torch.equal(q, q2) and torch.equal(s, s2)
    q3, s3 = Q.quantize_rows((x.float() * rf).contiguous())
    assert torch.equal(q, q3) and torch.equal(s, s3)


@pytest.mark.parametrize("size", [128, 1024])
def test_build_lift_maps_on_the_card_equals_the_cpu(dev, size):
    """The same torch operations on both devices, each rounded as IEEE
    prescribes, the cameras on the host: ids exact, barycentrics within
    1e-6."""
    from interactvlm_tpu_torch.geometry import rasterizer as R
    from interactvlm_tpu_torch.geometry.views import HUMAN_VIEWS

    verts, faces = R.uv_sphere(83, 84)
    cams = HUMAN_VIEWS["4MV-Z_Vitru_mv2"].cam_params()[:4]
    win = max(R.pick_window(verts, faces, c, size) for c in cams)
    card = R.build_lift_maps(verts, faces, cams, size, win, device=dev)
    cpu = R.build_lift_maps(verts, faces, cams, size, win, device="cpu")
    assert all(t.is_cuda for t in card)
    assert torch.equal(card[0].cpu(), cpu[0])
    assert torch.equal(card[2].cpu(), cpu[2])
    assert (card[1].cpu() - cpu[1]).abs().max().item() <= 1e-6
    assert 0.3 < (cpu[2] < 0).float().mean().item() < 0.8


# --- tensor parallelism's shapes and kernel 7's given-scale route ---------
@pytest.mark.parametrize("M,K,N", [
    (8, 4096, 5504), (2552, 4096, 5504),  # 7B gate / up, N halved over 2
    (8, 5504, 4096), (2552, 5504, 4096),  # 7B down, K halved over 2
    (8, 5120, 6912), (8, 6912, 5120),  # 13B MLP over 2
])
def test_int8_kernel_at_the_tensor_parallel_shapes(dev, M, K, N):
    """Kernel 6 on a model rank's half of a 7B or 13B MLP weight, on the
    route its rows pick: bit for bit against its plain version."""
    rng = np.random.default_rng(21)
    x = _ties_rows(rng, M, K, dev, torch.bfloat16)
    w, scale = _int8_weight(rng, N, K, dev)
    before = Q.int8_matmul_fused.launches
    out = Q.int8_matmul_fused(x, w, scale)
    torch.cuda.synchronize()
    assert Q.int8_matmul_fused.launches == before + 1
    assert torch.equal(out, Q.int8_matmul_fused_plain(x, w, scale))


@pytest.mark.parametrize("M,K,dtype", [
    (8, 5504, torch.bfloat16),  # 7B down at decode, K halved
    (2552, 5504, torch.bfloat16),  # 7B down at prefill
    (512, 2560, torch.bfloat16),  # 13B o_proj, heads halved
    (40, 264, torch.float32),  # an int4 layer's f32 x * rf
    (5, 16384, torch.bfloat16),  # a row read twice
])
def test_quantize_rows_given_kernel_matches_plain(dev, M, K, dtype):
    """Kernel 7's given-scale route (a row-parallel linear's slice of each
    row, quantized with the whole row's absmax) against its plain version,
    bit for bit, and against the plain route where the given absmax is the
    slice's own."""
    x = _ties_rows(np.random.default_rng(12), M, K, dev, dtype)
    own = x.abs().amax(-1).float()
    whole = own * torch.linspace(1.0, 3.0, M, device=dev)  # rows reach wider
    whole[0] = 0.0  # a zero row keeps the 1e-8 floor
    for amax in (own, whole):
        before = Q.quantize_rows_given.launches
        q, s = Q.quantize_rows_given(x, amax.contiguous())
        torch.cuda.synchronize()
        assert Q.quantize_rows_given.launches == before + 1
        q2, s2 = Q.quantize_rows_given_plain(x, amax)
        assert torch.equal(q, q2) and torch.equal(s, s2)
    q, s = Q.quantize_rows_given(x, own.contiguous())
    q3, s3 = Q.quantize_rows(x)
    assert torch.equal(q, q3) and torch.equal(s, s3)
