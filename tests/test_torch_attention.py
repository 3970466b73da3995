"""The port's attention: each kernel's plain PyTorch version against the JAX
package's Pallas kernel in interpret mode, and the dispatch's routing of
CPU tensors.

Tolerance: the comparisons run in f32 on both sides and differ only in
summation order and in the online-softmax rescaling of the Pallas kernels,
so 2e-5 absolute on O(1) outputs. The CUDA kernels are held against these
plain versions on the card in ``test_torch_kernels.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from interactvlm_tpu.models.sam.image_encoder import (
    decomposed_rel_pos_bias as jax_rel_bias,
)
from interactvlm_tpu.ops.attention import _xla_attention
from interactvlm_tpu.ops.flash_attention import _flash_forward
from interactvlm_tpu.ops.sam_attention import (
    fused_rel_attention as jax_fused_rel,
    fused_window_attention as jax_fused_window,
)
from interactvlm_tpu_torch.ops import flash_attention as F
from interactvlm_tpu_torch.ops import sam_attention as S
from interactvlm_tpu_torch.ops.attention import (
    attention_plain,
    dot_product_attention,
)

TOL = 2e-5


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize(
    "B,H,Lq,Lk,D,causal,lens",
    [
        (2, 2, 128, 128, 16, False, None),
        (1, 2, 200, 200, 128, True, None),
        (1, 2, 64, 192, 16, True, None),  # Lq != Lk: bottom-right offset
        (2, 2, 160, 160, 128, True, (160, 57)),  # per-row kv lengths
        (2, 1, 96, 96, 16, False, (0, 40)),  # row 0 sees no key
        # head dim 16 against the wgmma kernel's tiles: Lq ragged against
        # its 128-row query tiles at the SAM decoder's Lk = 9; a kv length
        # past four 128-key tiles
        (2, 2, 130, 9, 16, False, None),
        (1, 2, 64, 520, 16, False, (520,)),
    ],
)
def test_flash_plain_matches_pallas_interpret(B, H, Lq, Lk, D, causal, lens):
    rng = np.random.default_rng(0)
    q, k, v = _rand(rng, (B, H, Lq, D)), _rand(rng, (B, H, Lk, D)), _rand(
        rng, (B, H, Lk, D))
    kv = None if lens is None else np.asarray(lens, np.int32)
    want_o, want_lse = _flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, None, True,
        None if kv is None else jnp.asarray(kv))
    got_o, got_lse = F.flash_forward_plain(
        _t(q), _t(k), _t(v), causal, None, None if kv is None else _t(kv))
    want_o = np.asarray(want_o)
    want_lse = np.asarray(want_lse)[:, :Lq, 0].reshape(B, H, Lq)
    got_o, got_lse = got_o.numpy(), got_lse.numpy().reshape(B, H, Lq)
    seen = np.ones(B, bool) if kv is None else kv > 0
    np.testing.assert_allclose(got_o[seen], want_o[seen], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got_lse[seen], want_lse[seen], atol=1e-4,
                               rtol=TOL)
    # a row that sees no key gives 0 (the Pallas kernel's -1e30 fill
    # averages its block-padded values there instead)
    assert (got_o[~seen] == 0).all() and (got_lse[~seen] == 0).all()


def test_window_plain_matches_pallas_interpret():
    rng = np.random.default_rng(1)
    H = W = 14
    BW, nH, D = 2, 2, 80
    q, k, v = (_rand(rng, (BW, nH, H * W, D)) for _ in range(3))
    rh, rw = _rand(rng, (2 * H - 1, D), 0.5), _rand(rng, (2 * W - 1, D), 0.5)
    want = jax_fused_window(*(jnp.asarray(x) for x in (q, k, v, rh, rw)),
                            (H, W), interpret=True)
    got = S.fused_window_attention(*(_t(x) for x in (q, k, v, rh, rw)), (H, W))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_global_plain_matches_pallas_interpret():
    rng = np.random.default_rng(2)
    H = W = 16
    B, nH, D = 1, 2, 80
    q, k, v = (_rand(rng, (B, nH, H * W, D)) for _ in range(3))
    rh, rw = _rand(rng, (2 * H - 1, D), 0.5), _rand(rng, (2 * W - 1, D), 0.5)
    want = jax_fused_rel(*(jnp.asarray(x) for x in (q, k, v, rh, rw)),
                         (H, W), interpret=True)
    got = S.fused_rel_attention(*(_t(x) for x in (q, k, v, rh, rw)), (H, W))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("causal,use_bias", [(True, False), (False, True)])
def test_attention_plain_matches_xla_path(causal, use_bias):
    """``attention_plain`` is ``_xla_attention``: causal fill aligned
    bottom-right (Lq < Lk), additive bias."""
    rng = np.random.default_rng(3)
    q, k, v = (_rand(rng, (2, 2, 24, 16)), _rand(rng, (2, 2, 40, 16)),
               _rand(rng, (2, 2, 40, 16)))
    bias = _rand(rng, (2, 1, 24, 40)) if use_bias else None
    want = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          None if bias is None else jnp.asarray(bias), causal)
    got = attention_plain(_t(q), _t(k), _t(v),
                          None if bias is None else _t(bias), causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_sam_rel_bias_matches_jax():
    rng = np.random.default_rng(4)
    q = _rand(rng, (2, 2, 6 * 5, 8))
    rh, rw = _rand(rng, (11, 8)), _rand(rng, (9, 8))
    from interactvlm_tpu_torch.models.sam.image_encoder import (
        decomposed_rel_pos_bias,
    )

    want = jax_rel_bias(jnp.asarray(q), jnp.asarray(rh), jnp.asarray(rw), (6, 5))
    got = decomposed_rel_pos_bias(_t(q), _t(rh), _t(rw), (6, 5))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    # the stacked factors the window kernel takes rebuild the same bias
    k, v = _t(_rand(rng, q.shape)), _t(_rand(rng, q.shape))
    np.testing.assert_allclose(
        S.fused_window_attention(_t(q), k, v, _t(rh), _t(rw), (6, 5)).numpy(),
        dot_product_attention(_t(q), k, v, bias=got, scale=8 ** -0.5).numpy(),
        atol=TOL, rtol=TOL)


def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor never reaches a kernel: each wrapper returns its plain
    version's result and its launch count does not move, and the dispatch
    sends even a flash-eligible call (no bias, Lq >= 512) to the plain
    attention."""
    rng = np.random.default_rng(5)
    counts = (F.flash_forward.launches, S.window_attention.launches,
              S.rel_attention.launches)
    q, k, v = (_t(_rand(rng, (1, 1, 512, 16))) for _ in range(3))
    assert torch.equal(dot_product_attention(q, k, v, causal=True),
                       attention_plain(q, k, v, causal=True))
    o, lse = F.flash_forward(q, k, v, True)
    o2, lse2 = F.flash_forward_plain(q, k, v, True)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)

    R, H, W, D = 3, 4, 4, 16
    q, k, v = (_t(_rand(rng, (R, H * W, D))) for _ in range(3))
    f = _t(_rand(rng, (R, H + W, H * W)))
    assert torch.equal(S.window_attention(q, k, v, f, (H, W)),
                       S.window_attention_plain(q, k, v, f, (H, W)))
    rh, rw = _t(_rand(rng, (R, H, H * W))), _t(_rand(rng, (R, H * W, W)))
    assert torch.equal(S.rel_attention(q, k, v, rh, rw, (H, W)),
                       S.rel_attention_plain(q, k, v, rh, rw, (H, W)))
    assert counts == (F.flash_forward.launches, S.window_attention.launches,
                      S.rel_attention.launches)


@pytest.mark.parametrize("D,route", [(80, "sm90"), (16, "mma"), (32, "mma"),
                                     (64, "mma")])
def test_rel_route_by_head_dim(D, route):
    """The global kernel's route follows the head dim alone: the wgmma +
    TMA kernel at ViT-H's 80, the mma.sync kernel at the tiny presets'
    widths; a CPU call moves no route's count."""
    assert S.rel_route(D) == route and route in S.REL_ROUTES
    rng = np.random.default_rng(6)
    H, W = 4, 4
    q, k, v = (_t(_rand(rng, (1, H * W, D))) for _ in range(3))
    rh, rw = _t(_rand(rng, (1, H, H * W))), _t(_rand(rng, (1, H * W, W)))
    before = dict(S.rel_attention.route_launches)
    S.rel_attention(q, k, v, rh, rw, (H, W))
    assert S.rel_attention.route_launches == before


@pytest.mark.parametrize("D,hw,route", [
    (80, (14, 14), "sm90"),  # ViT-H's windows
    (80, (7, 7), "sm90"),
    (80, (9, 13), "sm90"),
    (80, (16, 16), "sm90"),  # L = 256, the largest square window it takes
    (80, (17, 17), "mma"),
    (80, (8, 32), "mma"),  # L = 256, but a side past its 16 key slots
    (64, (14, 14), "mma"),  # ViT-B/L's head dim
    (16, (4, 4), "mma"),  # the tiny presets
    (32, (14, 14), "mma"),
])
def test_window_route_by_head_dim_and_window(D, hw, route):
    """The window kernel's route follows the shape alone: the wgmma + TMA
    kernel at ViT-H's head dim 80 for windows up to 16 x 16, the mma.sync
    kernel otherwise; a CPU call moves no route's count."""
    assert S.window_route(D, hw) == route and route in S.WINDOW_ROUTES
    rng = np.random.default_rng(7)
    H, W = hw
    q, k, v = (_t(_rand(rng, (1, 2, H * W, D))) for _ in range(3))
    f = _t(_rand(rng, (2, H + W, H * W)))
    before = dict(S.window_attention.route_launches)
    S.window_attention(q, k, v, f, hw)
    assert S.window_attention.route_launches == before


def _qkv_views(qkv, nH, D):
    """q, k, v (BW, nH, L, D) as the SAM encoder's qkv linear leaves them:
    permuted views of one (BW, L, 3 nH D) tensor."""
    BW, L = qkv.shape[:2]
    return qkv.view(BW, L, 3, nH, D).permute(2, 0, 3, 1, 4).unbind(0)


@pytest.mark.parametrize("hw", [(14, 14), (9, 13)])
def test_window_plain_on_qkv_views_matches_pallas_interpret(hw):
    """The plain window version on strided (BW, nH, L, D) views cut from one
    qkv tensor, the layout the sm90 route reads in place, against the JAX
    ``fused_window_attention`` in interpret mode on the same values (TOL:
    f32 on both sides)."""
    rng = np.random.default_rng(8)
    (H, W), BW, nH, D = hw, 2, 3, 80
    L = H * W
    qkv = _rand(rng, (BW, L, 3 * nH * D))
    rh, rw = _rand(rng, (2 * H - 1, D), 0.5), _rand(rng, (2 * W - 1, D), 0.5)
    q, k, v = _qkv_views(_t(qkv), nH, D)
    assert not q.is_contiguous()
    f = S.window_factors(q, _t(rh), _t(rw), hw)
    got = S.window_attention_plain(q, k, v, f, hw)
    jq, jk, jv = (np.ascontiguousarray(t.numpy()) for t in (q, k, v))
    want = jax_fused_window(*(jnp.asarray(x) for x in (jq, jk, jv, rh, rw)),
                            hw, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_fused_window_attention_on_views_equals_contiguous_copies():
    """``fused_window_attention`` passes q, k and v to the sm90 route as
    the views they are; the result equals the call on contiguous copies."""
    rng = np.random.default_rng(9)
    (H, W), BW, nH, D = (14, 14), 2, 4, 80
    qkv = _t(_rand(rng, (BW, H * W, 3 * nH * D)))
    rh, rw = _t(_rand(rng, (2 * H - 1, D), 0.5)), _t(_rand(rng, (2 * W - 1, D),
                                                          0.5))
    views = _qkv_views(qkv, nH, D)
    got = S.fused_window_attention(*views, rh, rw, (H, W))
    want = S.fused_window_attention(*(t.contiguous() for t in views), rh, rw,
                                    (H, W))
    assert got.shape == (BW, nH, H * W, D)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                               rtol=1e-6)


def _head_views(x, H):
    """(B, H, L, D) views of a (B, L, H * D) tensor: the head split of a
    projection's output, as the SAM decoder and the fusion pass it."""
    B, L, HD = x.shape
    return x.view(B, L, H, HD // H).transpose(1, 2)


@pytest.mark.parametrize("causal,lens", [(False, None), (True, (70, 0))])
def test_flash_plain_on_head_views_equals_contiguous_copies(causal, lens):
    """The plain flash version on permuted (B, L, H, D) views, the layout
    the head-dim-16 kernel reads in place, equals its call on contiguous
    copies."""
    rng = np.random.default_rng(11)
    B, H, Lq, Lk = 2, 4, 90, 70
    q = _head_views(_t(_rand(rng, (B, Lq, H * 16))), H)
    k = _head_views(_t(_rand(rng, (B, Lk, H * 16))), H)
    v = _head_views(_t(_rand(rng, (B, Lk, H * 16))), H)
    assert not q.is_contiguous() and q.stride(-1) == 1
    kv = None if lens is None else torch.tensor(lens)
    got = F.flash_forward_plain(q, k, v, causal, None, kv)
    want = F.flash_forward_plain(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal, None, kv)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6,
                                   rtol=1e-6)


@pytest.mark.parametrize("Lk,width,tiles", [
    (1, 16, 1), (9, 16, 1), (16, 16, 1), (17, 32, 1), (128, 128, 1),
    (256, 128, 2), (257, 96, 3), (512, 128, 4), (513, 112, 5),
])
def test_d16_route_and_key_tiles(Lk, width, tiles):
    """Head dim 16 takes the wgmma + TMA kernel, whose key tiles are the
    fewest of at most 128 keys, each a multiple of 16 wide that covers
    Lk; the other head dims keep their routes."""
    assert F.fwd_route(16) == "sm90_d16"
    assert F.d16_key_tiles(16, Lk) == (width, tiles)
    assert width % 16 == 0 and width <= F.D16_MAX_KEY_WIDTH
    assert (tiles - 1) * width < Lk <= tiles * width


@pytest.mark.parametrize("D,route", [(128, "sm90"), (32, "mma"), (64, "mma"),
                                     (80, None), (48, None)])
def test_other_head_dims_refuse_the_d16_key_tiling(D, route):
    """The key tiling is the head-dim-16 kernel's alone; a head dim no
    kernel takes has no route; a CPU call moves no route's count."""
    with pytest.raises(ValueError, match="head dim"):
        F.d16_key_tiles(D, 9)
    if route is None:
        with pytest.raises(ValueError, match="head dim"):
            F.fwd_route(D)
    else:
        assert F.fwd_route(D) == route and route in F.FWD_ROUTES
    before = dict(F.flash_forward.route_launches)
    rng = np.random.default_rng(12)
    q = _t(_rand(rng, (1, 1, 8, 16)))
    F.flash_forward(q, q, q)
    assert F.flash_forward.route_launches == before


def test_dot_product_attention_on_head_views_matches_xla_path():
    """``dot_product_attention`` on the CPU, given head views of
    projections (the SAM decoder's image -> token call at a tiny size, Lq
    past the flash threshold), gives the JAX package's ``_xla_attention``
    on the same values."""
    rng = np.random.default_rng(13)
    B, H, Lq, Lk = 2, 2, 520, 9
    q = _head_views(_t(_rand(rng, (B, Lq, H * 16))), H)
    k = _head_views(_t(_rand(rng, (B, Lk, H * 16))), H)
    v = _head_views(_t(_rand(rng, (B, Lk, H * 16))), H)
    got = dot_product_attention(q, k, v)
    want = _xla_attention(*(jnp.asarray(t.contiguous().numpy())
                            for t in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
