"""The port's training losses and batched lifts against the JAX package:
every function of ``models/losses.py`` and the three batched lifts of
``geometry/lift.py``, values and gradients (torch autograd against
``jax.grad``) on the same numpy inputs, including the extreme inputs of
``tests/test_losses.py`` (logits of +-40, probabilities of exactly 0 and 1).

Tolerance: f32 on both sides, differing in summation order and in the
library's exp/log: values to 1e-5 relative (plus 1e-6 absolute), gradients
to 1e-4 of the largest gradient magnitude plus 1e-5 relative. Gradients are
held to be finite everywhere.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import interactvlm_tpu.geometry.lift as JL
import interactvlm_tpu.models.losses as JLoss
import interactvlm_tpu_torch.geometry.lift as TL
import interactvlm_tpu_torch.models.losses as TLoss

B, V, H, W, N, P = 4, 2, 16, 16, 50, 40


def _masks(rng):
    pred = rng.uniform(-40, 40, (B, V, H, W)).astype(np.float32)
    pred[2:] = rng.uniform(0, 1, pred[2:].shape)  # probability rows
    pred[2, 0, 0, 0], pred[3, 0, 0, 0] = 0.0, 1.0
    gt = rng.choice([0.0, 1.0, -1.0], (B, V, H, W),
                    p=[0.6, 0.3, 0.1]).astype(np.float32)
    gt[1, 1] = 0.0  # an empty target view: dice must give 0 there
    return pred, gt


def _maps(rng, per_sample=False):
    lead = (3, B, V, H, W) if per_sample else (3, V, H, W)
    p2v = rng.integers(-1, N, lead).astype(np.int32)
    bary = rng.uniform(0, 1, lead).astype(np.float32)
    return p2v, bary


def _check(fn_t, fn_j, x, *, grad=True):
    """fn_t / fn_j map the differentiable input to one output; compare the
    output and the gradient of a fixed weighted sum of it."""
    rng = np.random.default_rng(123)
    yt = fn_t(torch.tensor(x))
    w = rng.standard_normal(tuple(yt.shape)).astype(np.float32)
    want = np.asarray(fn_j(jnp.asarray(x)))
    np.testing.assert_allclose(yt.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)
    if not grad:
        return
    xt = torch.tensor(x, requires_grad=True)
    (g_t,) = torch.autograd.grad((fn_t(xt) * torch.from_numpy(w)).sum(), xt)
    g_j = np.asarray(jax.grad(lambda a: (fn_j(a) * w).sum())(jnp.asarray(x)))
    assert np.isfinite(g_t.numpy()).all() and np.isfinite(g_j).all()
    scale = max(np.abs(g_j).max(), 1e-30)
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-5,
                               atol=1e-4 * scale)


IS_PROB = np.array([False, False, True, True])


@pytest.mark.parametrize("name", ["focal", "dice", "mse"])
def test_per_sample_mask_losses(name):
    pred, gt = _masks(np.random.default_rng(0))
    ip_t, ip_j = torch.from_numpy(IS_PROB), jnp.asarray(IS_PROB)
    gt_t, gt_j = torch.from_numpy(gt), jnp.asarray(gt)
    fns = {
        "focal": (lambda p: TLoss.focal_mask_loss(p, gt_t, ip_t, 0.5),
                  lambda p: JLoss.focal_mask_loss(p, gt_j, ip_j, 0.5)),
        "dice": (lambda p: TLoss.dice_mask_loss(p, gt_t, ip_t, 1.0),
                 lambda p: JLoss.dice_mask_loss(p, gt_j, ip_j, 1.0)),
        "mse": (lambda p: TLoss.mse_mask_loss(p, gt_t),
                lambda p: JLoss.mse_mask_loss(p, gt_j)),
    }
    _check(*fns[name], pred)


@pytest.mark.parametrize("component", [0, 1, 2])
def test_combined_mask_losses(component):
    pred, gt = _masks(np.random.default_rng(1))
    has = np.array([1.0, 0.0, 1.0, 1.0], np.float32)  # row 1: a VQA row

    def fn_t(p):
        return TLoss.combined_mask_losses(
            p, torch.from_numpy(gt), torch.from_numpy(IS_PROB),
            torch.from_numpy(has), 2.0, 0.5, 1.0, 1.0)[component]

    def fn_j(p):
        return JLoss.combined_mask_losses(
            p, jnp.asarray(gt), jnp.asarray(IS_PROB), jnp.asarray(has),
            2.0, 0.5, 1.0, 1.0)[component]

    _check(fn_t, fn_j, pred)


def test_combined_mask_losses_without_heatmap_rows():
    pred, gt = _masks(np.random.default_rng(2))
    none = np.zeros(B, bool)
    got = TLoss.combined_mask_losses(
        torch.from_numpy(pred[:2]), torch.from_numpy(gt[:2]),
        torch.from_numpy(none[:2]), torch.ones(2))
    want = JLoss.combined_mask_losses(
        jnp.asarray(pred[:2]), jnp.asarray(gt[:2]), jnp.asarray(none[:2]),
        jnp.ones(2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)
    assert float(got[2]) == 0.0


@pytest.mark.parametrize("active", [(True, False, True, True),
                                    (False, False, False, False)])
def test_human_contact_3d_loss(active):
    rng = np.random.default_rng(3)
    pred = rng.uniform(-30, 30, (B, V, H, W)).astype(np.float32)
    p2v, bary = _maps(rng)
    gtc = rng.choice([0.0, 1.0], (B, N)).astype(np.float32)
    is_h = np.array(active)
    _check(lambda p: TLoss.human_contact_3d_loss(
               p, torch.from_numpy(gtc), torch.from_numpy(p2v),
               torch.from_numpy(bary), torch.from_numpy(is_h), N),
           lambda p: JLoss.human_contact_3d_loss(
               p, jnp.asarray(gtc), jnp.asarray(p2v), jnp.asarray(bary),
               jnp.asarray(is_h), N), pred)


def test_object_contact_3d_loss():
    rng = np.random.default_rng(4)
    pred = rng.uniform(-6, 6, (B, V, H, W)).astype(np.float32)
    pred[3] = -30.0  # nothing above the threshold: the sample is skipped
    p2v, bary = _maps(rng, per_sample=True)
    gtc = rng.choice([0.0, 1.0], (B, N)).astype(np.float32)
    valid = np.arange(N)[None, :] < np.array([N, 30, 45, N])[:, None]
    is_oc = np.array([True, True, False, True])
    _check(lambda p: TLoss.object_contact_3d_loss(
               p, torch.from_numpy(gtc), torch.from_numpy(p2v),
               torch.from_numpy(bary), torch.from_numpy(valid),
               torch.from_numpy(is_oc)),
           lambda p: JLoss.object_contact_3d_loss(
               p, jnp.asarray(gtc), jnp.asarray(p2v), jnp.asarray(bary),
               jnp.asarray(valid), jnp.asarray(is_oc)), pred)


@pytest.mark.parametrize("extreme", [False, True])
def test_object_afford_3d_loss(extreme):
    rng = np.random.default_rng(5)
    vals = rng.uniform(0, 1, (B, V, H, W)).astype(np.float32)
    if extreme:  # probabilities of exactly 0 and 1 hit the clip
        vals[0] = 0.0
        vals[1] = 1.0
    p2p = rng.integers(-1, P, (B, V, H, W)).astype(np.int32)
    gta = rng.uniform(0, 1, (B, P)).astype(np.float32)
    is_oa = np.array([True, True, False, True])
    _check(lambda p: TLoss.object_afford_3d_loss(
               p, torch.from_numpy(gta), torch.from_numpy(p2p),
               torch.from_numpy(is_oa)),
           lambda p: JLoss.object_afford_3d_loss(
               p, jnp.asarray(gta), jnp.asarray(p2p), jnp.asarray(is_oa)),
           vals)


def test_batched_lifts():
    rng = np.random.default_rng(6)
    logits = rng.uniform(-25, 25, (B, V, H, W)).astype(np.float32)
    p2v, bary = _maps(rng)
    active = np.array([True, False, True, True])
    _check(lambda x: TL.lift_batch_soft(x, torch.from_numpy(p2v),
                                        torch.from_numpy(bary), N,
                                        torch.from_numpy(active)),
           lambda x: JL.lift_batch_soft(x, jnp.asarray(p2v),
                                        jnp.asarray(bary), N,
                                        jnp.asarray(active)), logits)
    p2v5, bary5 = _maps(rng, per_sample=True)
    _check(lambda x: TL.lift_batch_thresholded(
               x, torch.from_numpy(p2v5), torch.from_numpy(bary5), N, 0.3),
           lambda x: JL.lift_batch_thresholded(
               x, jnp.asarray(p2v5), jnp.asarray(bary5), N, 0.3), logits)
    p2p = rng.integers(-1, P, (B, V, H, W)).astype(np.int32)
    vals = rng.uniform(0, 1, (B, V, H, W)).astype(np.float32)
    _check(lambda x: TL.lift_batch_points(x, torch.from_numpy(p2p), P),
           lambda x: JL.lift_batch_points(x, jnp.asarray(p2p), P), vals)


def test_clip_splits_the_gradient_on_a_bound_as_jax_does():
    x = torch.tensor([0.0, 0.5, 1.0], requires_grad=True)
    (g,) = torch.autograd.grad(TL.clip(x, 0.0, 1.0).sum(), x)
    want = jax.grad(lambda a: jnp.clip(a, 0.0, 1.0).sum())(
        jnp.asarray([0.0, 0.5, 1.0]))
    np.testing.assert_array_equal(g.numpy(), np.asarray(want))
