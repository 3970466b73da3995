"""End-to-end parity of the port's generate-mode hcontact evaluation with the
JAX package's, on ``interactvlm_tiny`` with the same weights (carried by
``from_jax_params``) and the same numpy batch, streaming and with a cached
view embedding; plus the port's lift forms and mask upsampling against JAX.

Tolerances: f32 on the CPU on both sides, differing in summation order
through LLaMA, the SAM tail and the lift: generated ids identical, mask
logits within 1e-4 (absolute and relative), contact probabilities within
1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as nn
import pytest
import torch

from interactvlm_tpu.config import interactvlm_tiny as jax_tiny
from interactvlm_tpu.eval.evaluate import evaluate_batch as jax_evaluate
from interactvlm_tpu.geometry import lift as jax_lift
from interactvlm_tpu.models.interactvlm import InteractVLM as JaxIVLM
from interactvlm_tpu.utils.testing import make_synthetic_batch
from interactvlm_tpu_torch.config import interactvlm_tiny
from interactvlm_tpu_torch.eval.evaluate import evaluate_batch
from interactvlm_tpu_torch.geometry import lift
from interactvlm_tpu_torch.models.interactvlm import InteractVLM
from interactvlm_tpu_torch.utils.weights import from_jax_params

MASK = 32
T = 4


def numpy_tree(params):
    return jax.tree.map(np.array, nn.meta.unbox(params))


def force_seg_token(tree, seg):
    """Give the residual stream a large constant channel and point the
    [SEG] logit at it, so every row emits [SEG] and the mask tail runs on
    real seg hidden states (random weights alone almost never emit it)."""
    p = tree["params"]["llava"]
    p["lm"]["model"]["embed_tokens"]["embedding"][:, 0] = 30.0
    p["mm_projector"]["bias"][0] = 30.0
    p["lm"]["lm_head"]["kernel"][0, seg] = 5.0
    return tree


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_tiny()
    batch = make_synthetic_batch(jcfg, B=2, L=12, mask_size=MASK)
    jm = JaxIVLM(jcfg)
    params = numpy_tree(jm.init(jax.random.PRNGKey(0), batch))
    models = {}
    for forced in (False, True):
        tree = force_seg_token(numpy_tree(params), jcfg.seg_token_idx) \
            if forced else params
        tm = InteractVLM(interactvlm_tiny(), device="cpu")
        missing, unexpected = tm.load_state_dict(from_jax_params(tree),
                                                 strict=False)
        assert not unexpected
        assert all("mask_downscaling" in k for k in missing)
        models[forced] = (tree, tm)
    return jcfg, jm, batch, models


@pytest.mark.parametrize("forced,cached", [(True, False), (True, True),
                                           (False, False)])
def test_evaluate_batch_matches_jax(setup, forced, cached):
    jcfg, jm, batch, models = setup
    tree, tm = models[forced]
    maps = {"p2v": batch["human_p2v"], "bary": batch["human_bary"],
            "num_vertices": jcfg.num_human_vertices}
    jemb = temb = None
    if cached:
        jemb = jm.apply(tree, batch["sam_images"][:1],
                        method=JaxIVLM.encode_sam_images)
        with torch.inference_mode():
            temb = tm.encode_sam_images(
                torch.from_numpy(np.array(batch["sam_images"][:1])))
        np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), atol=1e-4)
    want = jax_evaluate(jm, tree, batch, jcfg, MASK, "hcontact",
                        max_new_tokens=T, human_maps=maps,
                        cached_image_emb=jemb)
    np_batch = {k: np.array(v) for k, v in batch.items()}
    got = evaluate_batch(tm, np_batch, MASK, "hcontact", max_new_tokens=T,
                         human_maps={k: np.array(v) for k, v in maps.items()},
                         cached_image_emb=temb)
    np.testing.assert_array_equal(got["generated_ids"].numpy(),
                                  want["generated_ids"])
    np.testing.assert_array_equal(got["has_seg"].numpy(), want["has_seg"])
    assert bool(got["has_seg"].all()) == forced
    np.testing.assert_allclose(got["pred_masks"].numpy(), want["pred_masks"],
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got["pred_contact_3d"].numpy(),
                               want["pred_contact_3d"], atol=1e-5)
    if forced:
        assert np.abs(want["pred_masks"]).max() > 0


def test_upsample_masks_matches_jax_resize():
    """Bilinear upsampling with half-pixel centres, edges included."""
    rng = np.random.default_rng(0)
    low = rng.standard_normal((2, 3, 8, 8)).astype(np.float32) * 4
    want = jax.image.resize(jnp.asarray(low), (2, 3, 32, 32), method="bilinear")
    got = InteractVLM.upsample_masks(torch.from_numpy(low), 32).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    # the border rows/columns are where a wrong convention shows
    np.testing.assert_allclose(got[..., 0, :], np.asarray(want)[..., 0, :],
                               atol=1e-5)
    np.testing.assert_allclose(got[..., :, -1], np.asarray(want)[..., :, -1],
                               atol=1e-5)


def test_lift_forms_match_jax():
    """Scatter lift against JAX; the port's gather maps equal JAX's; the
    gather lift equals the scatter lift when no vertex exceeds max_k."""
    rng = np.random.default_rng(1)
    V, H, W, N = 4, 16, 16, 40
    p2v = rng.integers(0, N, (V, H, W, 3)).astype(np.int32)
    p2v[:, :5] = -1
    bary = rng.dirichlet([1, 1, 1], (V, H, W)).astype(np.float32)
    logits = (rng.standard_normal((V, H, W)) * 8).astype(np.float32)
    p2v3, bary3 = lift.corner_major(p2v), lift.corner_major(bary)
    want = jax_lift.lift_multiview_soft(jnp.asarray(logits), jnp.asarray(p2v3),
                                        jnp.asarray(bary3), N)
    got = lift.lift_multiview_soft(torch.from_numpy(logits),
                                   torch.from_numpy(p2v3),
                                   torch.from_numpy(bary3), N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    idx, w = lift.build_gather_maps(p2v, bary, N)
    jidx, jw = jax_lift.build_gather_maps(p2v, bary, N)
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    np.testing.assert_array_equal(w, np.asarray(jw))
    gathered = lift.lift_multiview_soft_gather(
        torch.from_numpy(logits), torch.from_numpy(idx), torch.from_numpy(w))
    np.testing.assert_allclose(gathered.numpy(), got.numpy(), atol=1e-6)
