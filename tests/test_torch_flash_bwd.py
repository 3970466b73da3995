"""The flash-attention backward of the port on the CPU: the plain version of
kernels 4 and 5 (``flash_backward_plain``) against the JAX package's
``_flash_backward`` run in interpret mode, and the autograd Function
against autograd through the plain attention.

Tolerance: both sides run in f32 and recompute the probabilities from the
same logsumexp, so they differ in summation order only: 3e-3 absolute, the
JAX package's own gradient tolerance (``tests/test_flash_attention.py``).
Against autograd through ``attention_plain`` the forward differs as well
(online against one-pass softmax), still in f32: 3e-3 too.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from interactvlm_tpu.ops.flash_attention import _flash_backward, _flash_forward
from interactvlm_tpu_torch.ops import flash_attention as F
from interactvlm_tpu_torch.ops.attention import attention_plain

TOL = 3e-3


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("B,H,Lq,Lk,D,causal,lens", [
    (2, 2, 384, 384, 64, True, (384, 250)),  # three 128-blocks, ragged
    (2, 2, 384, 384, 64, False, (384, 250)),
    (1, 2, 130, 9, 16, False, None),  # the SAM decoder's Lk = 9, D = 16
    (1, 2, 64, 192, 32, True, None),  # causal Lq < Lk: bottom-right
    (1, 2, 1000, 9, 16, False, None),  # Lk = 9, Lq off the dk/dv split
    (1, 2, 200, 130, 128, True, (130,)),  # the sm90 route's head dim
])
def test_plain_backward_matches_pallas_interpret(B, H, Lq, Lk, D, causal,
                                                 lens):
    rng = np.random.default_rng(0)
    q, do = _rand(rng, (B, H, Lq, D)), _rand(rng, (B, H, Lq, D))
    k, v = _rand(rng, (B, H, Lk, D)), _rand(rng, (B, H, Lk, D))
    kv = None if lens is None else jnp.asarray(lens, jnp.int32)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    o, lse = _flash_forward(jq, jk, jv, causal, None, True, kv)
    want = _flash_backward(jq, jk, jv, o, lse, kv, jdo, causal, None, True)
    lse_rows = np.array(lse)[:, :Lq, 0]  # lane-broadcast -> (B*H, Lq)
    got = F.flash_backward_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(np.array(o)), torch.from_numpy(lse_rows),
        torch.from_numpy(do), causal, None,
        None if lens is None else torch.tensor(lens))
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        err = np.abs(g.numpy() - np.asarray(w)).max()
        assert err < TOL, (name, err)


@pytest.mark.parametrize("causal,lens", [
    (True, (160, 97)), (False, (160, 97)), (True, None)])
def test_function_matches_plain_autograd(causal, lens):
    """FlashAttention's gradients (the plain backward on the CPU) against
    autograd through the plain attention with the equivalent bias; the
    padded query rows' output gradient is zero, as a loss over valid
    positions gives."""
    rng = np.random.default_rng(1)
    B, H, L, D = 2, 2, 160, 32
    leaves = [torch.from_numpy(_rand(rng, (B, H, L, D))).requires_grad_()
              for _ in range(3)]
    w = torch.from_numpy(_rand(rng, (B, H, L, D)))
    kv = None if lens is None else torch.tensor(lens)
    bias = None
    if kv is not None:
        keep = torch.arange(L)[None, :] < kv[:, None]
        w = w * keep[:, None, :, None]
        bias = torch.where(keep, 0.0, -1e9)[:, None, None, :]
    out = F.flash_attention(*leaves, causal=causal, kv_lengths=kv)
    assert out.grad_fn is not None
    got = torch.autograd.grad((out * w).sum(), leaves)
    ref = [t.detach().clone().requires_grad_() for t in leaves]
    want = torch.autograd.grad(
        (attention_plain(*ref, bias=bias, causal=causal) * w).sum(), ref)
    for name, g, r in zip("qkv", got, want):
        err = (g - r).abs().max().item()
        assert err < TOL, (name, err)


def test_blind_rows_give_zero_gradients():
    """A query row that sees no key (kv length 0, or causal with Lq > Lk)
    has output 0 and logsumexp 0: its dq is 0 and it adds nothing to dk
    and dv; nothing is NaN."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(_rand(rng, (2, 1, 40, 16))).requires_grad_()
    k = torch.from_numpy(_rand(rng, (2, 1, 24, 16))).requires_grad_()
    v = torch.from_numpy(_rand(rng, (2, 1, 24, 16))).requires_grad_()
    out = F.flash_attention(q, k, v, causal=True,
                            kv_lengths=torch.tensor([0, 24]))
    gq, gk, gv = torch.autograd.grad(out.square().sum(), (q, k, v))
    for g in (gq, gk, gv):
        assert torch.isfinite(g).all()
    assert (gq[0] == 0).all() and (gk[0] == 0).all() and (gv[0] == 0).all()
    # causal with Lq > Lk: the first Lq - Lk rows of sample 1 see no key
    assert (gq[1, :, :16] == 0).all() and (gq[1, :, 16:] != 0).any()


def test_backward_on_the_cpu_launches_nothing():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(_rand(rng, (1, 1, 64, 16))).requires_grad_()
               for _ in range(3))
    before = (F.flash_forward.launches, F.flash_bwd_dq.launches,
              F.flash_bwd_dkv.launches)
    F.flash_attention(q, k, v, causal=True).sum().backward()
    assert (F.flash_forward.launches, F.flash_bwd_dq.launches,
            F.flash_bwd_dkv.launches) == before
    assert q.grad is not None and k.grad is not None and v.grad is not None


@pytest.mark.parametrize("D", [16, 128])
def test_backward_on_the_cpu_takes_no_route(D):
    """On the CPU neither route's kernels launch, at either route's head
    dim: the gradients come from the plain version."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(_rand(rng, (1, 2, 70, D))).requires_grad_()
               for _ in range(3))
    before = (dict(F.flash_bwd_dq.route_launches),
              dict(F.flash_bwd_dkv.route_launches))
    out = F.flash_attention(q, k, v, causal=True)
    got = torch.autograd.grad(out.square().sum(), (q, k, v))
    assert (F.flash_bwd_dq.route_launches,
            F.flash_bwd_dkv.route_launches) == before
    o, lse = F.flash_forward_plain(q.detach(), k.detach(), v.detach(), True)
    want = F.flash_backward_plain(q.detach(), k.detach(), v.detach(), o, lse,
                                  2 * o, True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("D,route", [(16, "mma"), (32, "mma"), (64, "mma"),
                                     (128, "sm90")])
def test_bwd_route_by_head_dim(D, route):
    assert F.bwd_route(D) == route


@pytest.mark.parametrize("D", [8, 48, 80, 256])
def test_bwd_route_refuses_other_head_dims(D):
    with pytest.raises(ValueError, match="head dim"):
        F.bwd_route(D)


@pytest.mark.parametrize("Lq,Lk", [
    (4096, 9),  # the SAM decoder's image -> token attention
    (1000, 9), (1, 9), (512, 64), (513, 64), (4096, 65), (512, 512),
    (130, 70),
])
def test_dkv_split_covers_the_queries(Lq, Lk):
    """The split query walk of the mma.sync dk/dv kernel: runs of whole
    64-query tiles that cover [0, Lq) once each with no empty run; no split
    where Lk > 64 (a block per key tile already); at the SAM decoder's shape
    (B*H = 256) at least two blocks for each of the 132 SMs."""
    splits, tiles = F.dkv_split(Lq, Lk)
    tile = F.DKV_QUERY_TILE
    runs = [(z * tiles * tile, min(Lq, (z + 1) * tiles * tile))
            for z in range(splits)]
    assert runs[0][0] == 0 and runs[-1][1] == Lq
    assert all(a < b for a, b in runs)
    assert all(runs[i][1] == runs[i + 1][0] for i in range(splits - 1))
    assert tiles <= F.DKV_SPLIT_TILES or splits == 1
    if Lk > F.DKV_SPLIT_MAX_LK:
        assert splits == 1
    if (Lq, Lk) == (4096, 9):
        assert 256 * splits >= 2 * 132


def test_forward_only_kernels_raise_under_grad_on_the_cpu_too():
    """The window, rel-pos and int8 kernels have no backward: under grad,
    on either device, their wrappers raise rather than hand back a tensor
    whose gradient the card would silently drop."""
    from interactvlm_tpu_torch.ops import int8_matmul as Q
    from interactvlm_tpu_torch.ops import sam_attention as S

    rng = np.random.default_rng(4)
    q = torch.from_numpy(_rand(rng, (2, 4, 16))).requires_grad_()
    f = torch.from_numpy(_rand(rng, (2, 4, 4)))
    with pytest.raises(RuntimeError, match="no backward"):
        S.window_attention(q, q, q, f, (2, 2))
    rh, rw = torch.zeros(2, 2, 4), torch.zeros(2, 4, 2)
    with pytest.raises(RuntimeError, match="no backward"):
        S.rel_attention(q, q, q, rh, rw, (2, 2))
    x = torch.from_numpy(_rand(rng, (3, 32))).requires_grad_()
    w = torch.ones(8, 32, dtype=torch.int8)
    with pytest.raises(RuntimeError, match="no backward"):
        Q.int8_matmul_fused(x, w, torch.ones(8))
    with torch.no_grad():
        assert S.window_attention(q, q, q, f, (2, 2)).shape == q.shape
        assert Q.int8_matmul_fused(x, w, torch.ones(8)).shape == (3, 8)
