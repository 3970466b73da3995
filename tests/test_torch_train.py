"""The port's training path against the JAX package on the CPU:
``InteractVLM.forward`` (``forward_train``) on ``interactvlm_tiny`` with
LoRA, the gradient of every trainable parameter, three optimizer steps of
``TrainStep`` against the JAX ``make_train_step``, and the step's own
behaviour (frozen parameters, the NaN guard, accumulation, the schedule,
the synthetic batch).

The weights are the JAX package's, carried across by ``from_jax_params``;
LoRA's B factors are set to seeded non-zero values first, so that the A
factors have a gradient to compare. The batch is ``make_synthetic_batch``'s
(an hcontact and an oafford row, so the human 3D loss, the affordance loss
and the heatmap rows all run).

Tolerances (f32 on both sides, differing in summation order through LLaMA,
SAM's decoder, the bilinear upsampling and the lifts' scatters):
- losses 1e-5 relative (plus 1e-6 absolute), mask logits 1e-4;
- gradients: each trainable's gradient within 1e-3 of its own largest
  magnitude (plus 1e-3 relative), and its norm within 1e-4 relative;
- optimizer steps: per-step loss and gradient norm as above. Adam's first
  update is lr * g / (|g| + eps), about lr in size wherever g is not tiny:
  where the reference gradient sits at rounding noise (below 1e-3 of its
  leaf's largest magnitude, or below ``NOISE`` of the model's) the sign of
  g, and so the update, is noise.
  Elsewhere parameters after three steps agree to 2e-3 of lr.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as nn
import pytest
import torch

from interactvlm_tpu.config import interactvlm_tiny as jax_tiny
from interactvlm_tpu.config import llama_tiny as jax_llama_tiny
from interactvlm_tpu.models.interactvlm import InteractVLM as JaxIVLM
from interactvlm_tpu.parallel.mesh import create_mesh
from interactvlm_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from interactvlm_tpu.train.optimizer import trainable_mask as jax_trainable_mask
from interactvlm_tpu.train.optimizer import (
    warmup_decay_schedule as jax_schedule,
)
from interactvlm_tpu.train.train_step import create_sharded_state, make_train_step
from interactvlm_tpu.utils.testing import make_synthetic_batch as jax_batch
from interactvlm_tpu_torch.config import interactvlm_tiny, llama_tiny
from interactvlm_tpu_torch.models.interactvlm import InteractVLM
from interactvlm_tpu_torch.train.optimizer import (
    apply_trainable_mask,
    cast_frozen_params,
    make_optimizer,
    trainable_mask,
    warmup_decay_schedule,
)
from interactvlm_tpu_torch.train.train_step import TrainStep
from interactvlm_tpu_torch.utils.testing import make_synthetic_batch
from interactvlm_tpu_torch.utils.weights import from_jax_params, init_params

MASK, RANK, LR = 32, 4, 1e-3
# a gradient that is zero in exact arithmetic (a key projection's bias:
# softmax ignores a shift shared by every key) comes out as rounding noise
# of ~1e-10 of the largest gradient on either side: gradients are compared
# to this share of the largest gradient of the model, absolute
NOISE = 1e-7
LOSS_KEYS = ("loss", "ce_loss", "mask_bce_loss", "mask_dice_loss",
             "mask_l2_loss", "mask_loss", "hC_loss", "oA_loss", "oC_loss")


def _np(tree):
    return jax.tree.map(np.array, nn.meta.unbox(tree))


def _set_lora_b(tree, rng):
    """Seeded non-zero LoRA B factors (init draws them zero)."""
    for name, layer in tree["params"]["llava"]["lm"]["model"].items():
        if name.startswith("layer_"):
            for proj in ("q_proj", "v_proj"):
                b = layer["self_attn"][proj]["lora_b"]
                b[...] = rng.standard_normal(b.shape).astype(np.float32) * 0.05
    return tree


def _port(tree, cfg):
    tm = InteractVLM(cfg, device="cpu")
    missing, unexpected = tm.load_state_dict(from_jax_params(tree),
                                             strict=False)
    assert not unexpected and all("mask_downscaling" in k for k in missing)
    return tm


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_tiny(llama=jax_llama_tiny(lora_rank=RANK))
    tcfg = interactvlm_tiny(llama=llama_tiny(lora_rank=RANK))
    jb = jax_batch(jcfg, B=2, L=12, mask_size=MASK)
    jm = JaxIVLM(jcfg)
    tree = _set_lora_b(_np(jm.init(jax.random.PRNGKey(0), jb)),
                       np.random.default_rng(0))
    mask = jax_trainable_mask(tree)

    def loss_fn(train, frozen):
        merged = jax.tree.map(lambda t, f, m: t if m else f, train,
                              jax.lax.stop_gradient(frozen), mask)
        out = jm.apply(merged, jb)
        return out["loss"], out

    (_, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        tree, tree)
    return dict(jcfg=jcfg, tcfg=tcfg, jm=jm, tree=tree, mask=mask,
                jb=jb, out=jax.tree.map(np.asarray, out),
                grads=_np(grads),
                tb=make_synthetic_batch(tcfg, B=2, L=12, mask_size=MASK,
                                        device="cpu"))


def test_synthetic_batch_equals_the_jax_packages():
    for kw in (dict(), dict(max_seg_tokens=2), ):
        jcfg, tcfg = jax_tiny(**kw), interactvlm_tiny(**kw)
        want = jax_batch(jcfg, B=3, L=14, tasks=(2, 3, 4), mask_size=16,
                         seed=5)
        got = make_synthetic_batch(tcfg, B=3, L=14, tasks=(2, 3, 4),
                                   mask_size=16, seed=5, device="cpu")
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=k)


def test_forward_train_matches_jax(setup):
    tm = _port(setup["tree"], setup["tcfg"])
    got = tm(setup["tb"])
    want = setup["out"]
    assert sorted(got) == sorted(want)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["pred_masks"].detach().numpy(),
                               want["pred_masks"], rtol=1e-4, atol=1e-4)
    for k in ("hC_loss", "oA_loss", "mask_l2_loss", "ce_loss"):
        assert got[k].item() > 0, k  # each term really ran


def test_trainable_names_match_the_jax_mask(setup):
    tm = _port(setup["tree"], setup["tcfg"])
    port = trainable_mask(n for n, _ in tm.named_parameters())
    as_arrays = jax.tree.map(lambda m, p: np.full(p.shape, m, np.float32),
                             setup["mask"], setup["tree"])
    jax_names = {k for k, v in from_jax_params(as_arrays).items()
                 if bool(v.all())}
    assert {k for k, v in port.items() if v} == jax_names
    assert any("lora_A" in k for k in jax_names)
    assert not any("image_encoder" in k or "vision_tower" in k
                   for k in jax_names)


def test_gradients_of_every_trainable_match_jax(setup):
    tm = _port(setup["tree"], setup["tcfg"])
    mask = trainable_mask(n for n, _ in tm.named_parameters())
    for n, p in tm.named_parameters():
        p.requires_grad_(mask[n])
    tm(setup["tb"])["loss"].backward()
    want = from_jax_params(setup["grads"])
    floor = NOISE * max(np.abs(w.numpy()).max() for w in want.values())
    checked = 0
    for n, p in tm.named_parameters():
        if not mask[n]:
            assert p.grad is None, n  # no gradient enters a frozen tower
            continue
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        w = want[n].numpy()
        scale = np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3 * scale + floor,
                                   err_msg=n)
        if scale > floor:
            np.testing.assert_allclose(np.linalg.norm(g), np.linalg.norm(w),
                                       rtol=1e-4, err_msg=n)
            checked += 1
    assert checked > 20  # LoRA A and B of every layer, heads, decoder


def test_three_optimizer_steps_match_jax(setup):
    jm, tree, jb = setup["jm"], setup["tree"], setup["jb"]
    mesh = create_mesh(n_data=1, n_model=1, devices=jax.devices()[:1])
    tx, _ = jax_make_optimizer(lr=LR, warmup_steps=0, total_steps=50,
                               mask=jax_trainable_mask)
    with mesh:
        state, shardings = create_sharded_state(jm, tx, jb, mesh)
        state = state.replace(params=jax.tree.map(jnp.asarray, tree),
                              opt_state=tx.init(tree))
        step = make_train_step(jm, tx, mesh, shardings, jb, donate=False)
        jmetrics = []
        for _ in range(3):
            state, m = step(state, jb)
            jmetrics.append(jax.tree.map(float, m))
    want_params = from_jax_params(_np(state.params))

    tm = _port(tree, setup["tcfg"])
    init_port = {n: p.detach().clone() for n, p in tm.named_parameters()}
    opt, sched = make_optimizer(tm, lr=LR, warmup_steps=0, total_steps=50)
    train = TrainStep(tm, opt, sched)
    for i in range(3):
        m = train(setup["tb"])
        for k in ("loss", "ce_loss", "mask_loss", "hC_loss", "oA_loss",
                  "grad_norm"):
            np.testing.assert_allclose(m[k].item(), jmetrics[i][k],
                                       rtol=1e-4, err_msg=f"step {i} {k}")
        assert m["skipped_nonfinite"].item() == 0.0
    assert train.step == 3 and int(state.step) == 3
    grads = from_jax_params(setup["grads"])
    floor = NOISE * max(np.abs(g.numpy()).max() for g in grads.values())
    init = from_jax_params(tree)
    moved = 0
    for n, p in tm.named_parameters():
        if n not in want_params:  # the unused mask-downscaling convs
            assert not p.requires_grad and torch.equal(p, init_port[n]), n
            continue
        got, want = p.detach().numpy(), want_params[n].numpy()
        if not p.requires_grad:
            np.testing.assert_array_equal(got, want, err_msg=n)
            continue
        g = np.abs(grads[n].numpy())
        sure = g > max(1e-3 * g.max(), floor)
        np.testing.assert_allclose(got[sure], want[sure], rtol=0,
                                   atol=2e-3 * LR, err_msg=n)
        moved += int((np.abs(got - init[n].numpy())[sure] > 0.5 * LR).any())
    assert moved > 20


def _snapshot(tm, opt, sched):
    return ({n: p.detach().clone() for n, p in tm.named_parameters()},
            copy.deepcopy(opt.state_dict()), sched.last_epoch)


def test_frozen_parameters_stay_bit_identical_and_the_nan_guard(setup):
    tm = _port(setup["tree"], setup["tcfg"])
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    opt, sched = make_optimizer(tm, lr=LR, warmup_steps=2, total_steps=50)
    train = TrainStep(tm, opt, sched)
    assert opt.param_groups[0]["lr"] == 0.0  # step 0 of a warm-up
    assert opt.param_groups[0]["weight_decay"] == 0.0
    assert opt.param_groups[0]["betas"] == (0.9, 0.95)
    for _ in range(2):
        assert train(setup["tb"])["skipped_nonfinite"].item() == 0.0
    for n, p in tm.named_parameters():
        if not p.requires_grad:
            assert torch.equal(p, before[n]), n
    lora_b = tm.llava.lm.model.layers[0].self_attn.q_proj.lora_B.weight
    assert not torch.equal(lora_b, before[
        "llava.lm.model.layers.0.self_attn.q_proj.lora_B.weight"])

    params, opt_state, epoch = _snapshot(tm, opt, sched)
    bad = dict(setup["tb"])
    bad["gt_hcontact"] = torch.full_like(bad["gt_hcontact"], float("nan"))
    m = train(bad)
    assert m["skipped_nonfinite"].item() == 1.0
    assert not np.isfinite(m["loss"].item())
    assert train.step == 2 and sched.last_epoch == epoch
    for n, p in tm.named_parameters():
        assert torch.equal(p, params[n]), n
    for i, st in opt.state_dict()["state"].items():
        for k, v in st.items():
            assert torch.equal(v, opt_state["state"][i][k]), (i, k)
    assert train(setup["tb"])["skipped_nonfinite"].item() == 0.0
    assert train.step == 3


def _halves(batch):
    shared = ("human_p2v", "human_bary")
    return [{k: v if k in shared else v[i:i + 2] for k, v in batch.items()}
            for i in (0, 2)]


def test_accumulation_of_two_by_two_equals_one_batch_of_four():
    tcfg = interactvlm_tiny(llama=llama_tiny(lora_rank=RANK))
    batch = make_synthetic_batch(tcfg, B=4, L=12, tasks=(2, 3),
                                 mask_size=MASK, seed=3, device="cpu")
    ref = InteractVLM(tcfg, device="cpu")
    init_params(ref, torch.Generator().manual_seed(1))
    with torch.no_grad():
        for n, p in ref.named_parameters():
            if "lora_B" in n:
                p.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(2))
    models = [copy.deepcopy(ref) for _ in range(2)]
    deltas, metrics = [], []
    for model, b in zip(models, (batch, _halves(batch))):
        apply_trainable_mask(model)
        params = [p for p in model.parameters() if p.requires_grad]
        before = [p.detach().clone() for p in params]
        # plain SGD at lr 1: each update is minus the clipped gradient
        sgd = torch.optim.SGD(params, lr=1.0)
        sched = torch.optim.lr_scheduler.LambdaLR(sgd, lambda s: 1.0)
        metrics.append(TrainStep(model, sgd, sched)(b))
        deltas.append([(b0 - p).detach() for b0, p in zip(before, params)])
    for k in ("loss", "ce_loss", "mask_bce_loss", "hC_loss", "oA_loss",
              "grad_norm"):
        np.testing.assert_allclose(metrics[1][k].item(), metrics[0][k].item(),
                                   rtol=1e-5, err_msg=k)
    assert len(deltas[0]) > 20
    floor = NOISE * max(g.abs().max().item() for g in deltas[0])
    for g1, g0 in zip(deltas[1], deltas[0]):
        np.testing.assert_allclose(g1.numpy(), g0.numpy(), rtol=1e-4,
                                   atol=1e-5 * g0.abs().max().item() + floor)


def test_schedule_equals_optax():
    ours, want = warmup_decay_schedule(1.0, 10, 110), jax_schedule(1.0, 10, 110)
    for s in (0, 5, 10, 60, 110, 200):
        assert ours(s) == pytest.approx(float(want(s)), rel=1e-6, abs=1e-7), s
    assert ours(0) == 0.0
    no_warmup, want0 = warmup_decay_schedule(3e-4, 0, 50), jax_schedule(3e-4, 0, 50)
    for s in (0, 1, 25):
        assert no_warmup(s) == pytest.approx(float(want0(s)), rel=1e-6), s


def test_clip_is_optaxs_global_norm_rule():
    import optax

    g = [torch.tensor([3.0, 4.0]), torch.tensor([[12.0]])]
    from interactvlm_tpu_torch.train.optimizer import (
        clip_by_global_norm_,
        global_norm,
    )
    norm = global_norm(g)
    assert norm.item() == 13.0
    clip_by_global_norm_(g, norm, 1.0)
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.array([3.0, 4.0]), jnp.array([[12.0]])], None)
    for a, b in zip(g, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    small = [torch.tensor([0.3, 0.4])]
    clip_by_global_norm_(small, global_norm(small), 1.0)
    np.testing.assert_array_equal(small[0].numpy(),
                                  np.float32([0.3, 0.4]))


def test_cast_frozen_params_keeps_trainables_f32():
    tm = InteractVLM(interactvlm_tiny(llama=llama_tiny(lora_rank=RANK)),
                     device="cpu")
    cast_frozen_params(tm, torch.bfloat16, min_size=2 ** 10)
    mask = trainable_mask(n for n, _ in tm.named_parameters())
    for n, p in tm.named_parameters():
        if mask[n]:
            assert p.dtype == torch.float32, n
        elif p.numel() >= 2 ** 10:
            assert p.dtype == torch.bfloat16, n
        else:
            assert p.dtype == torch.float32, n


def test_layers_compute_in_their_dtype_over_f32_master_weights():
    """Training keeps trainables in f32 under bf16 layers: Linear,
    LayerNorm, ConvTranspose2d and Embedding cast input and parameters to
    the dtype they were built in (flax's ``dtype``), whatever their
    weights' dtype."""
    from interactvlm_tpu_torch.models.layers import (
        ConvTranspose2d,
        Embedding,
        LayerNorm,
        Linear,
    )

    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    lin, ln = Linear(8, 4, dtype=bf16), LayerNorm(8, dtype=bf16)
    up = ConvTranspose2d(8, 4, 2, stride=2, dtype=bf16)
    emb = Embedding(10, 8, dtype=bf16)
    mods = (lin, ln, up, emb)
    for m in mods:
        for p in m.parameters():
            p.data.normal_(generator=gen)
    x = torch.randn(3, 8, generator=gen)
    img = torch.randn(2, 8, 3, 3, generator=gen)
    ids = torch.tensor([1, 7])

    def run():
        return lin(x), ln(x), up(img), emb(ids)

    want = run()
    for m in mods:
        for p in m.parameters():
            p.data = p.data.float()  # the f32 master copy of a trainable
    for got, w in zip(run(), want):
        assert got.dtype == bf16
        assert torch.equal(got, w)


def test_remat_recomputes_each_layer_to_the_same_gradients():
    """``remat`` (the port of ``nn.remat(LlamaBlock)``) runs each decoder
    layer under ``torch.utils.checkpoint``: the loss and every gradient
    equal those of the stored-activation pass (the CPU recompute is
    deterministic, so exactly)."""
    from interactvlm_tpu_torch.models.llama import (
        LlamaForCausalLM,
        cross_entropy_loss,
    )

    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(4, 500, (2, 24), generator=gen)
    labels = ids.clone()
    labels[:, :8] = -100
    out = []
    for remat in (False, True):
        m = init_params(LlamaForCausalLM(llama_tiny(lora_rank=RANK,
                                                    remat=remat),
                                         device="cpu"),
                        torch.Generator().manual_seed(1))
        with torch.no_grad():
            for n, p in m.named_parameters():
                if "lora_B" in n:
                    p.normal_(0.0, 0.05,
                              generator=torch.Generator().manual_seed(2))
        logits, _ = m(ids)
        loss = cross_entropy_loss(logits, labels)
        loss.backward()
        out.append((loss.item(), {n: p.grad.clone()
                                  for n, p in m.named_parameters()}))
    assert out[0][0] == out[1][0]
    for n, g in out[0][1].items():
        assert torch.equal(g, out[1][1][n]), n
