"""Training CLI.

Port of ``interactvlm_tpu/train/train.py`` (a rebuild of the reference
``train.py``: :30-148 args, :421-632 loop): builds the tokenizer and seg
tokens, the composite model on the card with seeded random weights
(``utils/weights.py:init_params``), the hybrid dataset mixture and its
thread-pool loader, then runs the epoch / validate / best-checkpoint loop
through ``TrainStep`` (``train/train_step.py``). The flags and their
defaults are the JAX package's, so a JAX ``pretrained_config.json``
re-hydrates here; ``--device`` picks the CPU. The wall-clock meters and the
NaN-loss skip (train.py:547-551) are kept.

    python -m interactvlm_tpu_torch.train.train --dataset_dir <tree> \
        --tokenizer whitespace [--model_scale tiny] [--device cpu]

Supports ``--synthetic`` for smoke runs without data or a real tokenizer.

On n ranks it trains on an (n / n_model_shards, n_model_shards) mesh
(``parallel/mesh.py``), the same ``TrainStep``: data parallel, Adam's
moments ZeRO-sharded over ``data``, LLaMA tensor-parallel over ``model``.
Launch one process a card with torchrun, which sets each rank's ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK`` (the rank's card); the ranks talk over
NCCL, or over gloo with ``--device cpu``:

    torchrun --nproc_per_node 4 -m interactvlm_tpu_torch.train.train \
        --dataset_dir <tree> --n_model_shards 2 ...

Each data rank collates only its rows of each global batch (the rows the
one-process loader builds: every row's draws are made in row order on every
rank, ``real_batch_iter``), the global batch's losses drive every rank's
step, and rank 0 alone logs,
writes the code snapshot and validation output and saves checkpoints,
which hold the whole (one-card) state and restore onto any layout.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from interactvlm_tpu_torch.parallel.mesh import Mesh
from interactvlm_tpu_torch.utils.device import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser("interactvlm_tpu_torch training")
    # experiment / io (reference train.py:30-60)
    p.add_argument("--exp_name", default="ivlm_tpu")
    p.add_argument("--log_base_dir", default="./runs")
    p.add_argument("--dataset_dir", default="./data")
    p.add_argument("--version", default=None,
                   help="HF model dir for tokenizer/weights")
    p.add_argument("--tokenizer", default="hf",
                   choices=["hf", "whitespace"],
                   help="'whitespace' = offline deterministic tokenizer "
                        "(tests / zero-egress runs)")
    p.add_argument("--model_scale", default="full",
                   choices=["full", "tiny"],
                   help="'tiny' = tiny towers + REAL data path (the "
                        "closed-loop learning tests)")
    p.add_argument("--device", default="cuda",
                   help="where the model runs: the card unless 'cpu'")
    p.add_argument("--image_size", type=int, default=1024,
                   help="SAM view render size fed to the datasets")
    p.add_argument("--clip_size", type=int, default=224)
    p.add_argument("--num_human_vertices", type=int, default=6890)
    p.add_argument("--num_object_points", type=int, default=2048,
                   help="point-cloud size for oafford gt/lift (reference "
                        "2048-point clouds, ocontact_3d.py)")
    p.add_argument("--num_conversations", type=int, default=1,
                   help="conversations per image row block (reference "
                        "num_classes_per_sample, dataset.py:196)")
    # schedule (train.py:83-99; run_train.sh presets)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--steps_per_epoch", type=int, default=500)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--grad_accumulation_steps", type=int, default=1)
    p.add_argument("--data_workers", type=int, default=8,
                   help="sample-construction threads (reference "
                        "DataLoader workers, train.py:334-352)")
    p.add_argument("--prefetch_depth", type=int, default=4)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup_steps", type=int, default=100)
    p.add_argument("--model_max_length", type=int, default=512)
    # model
    p.add_argument("--token_type", default="Gen")
    p.add_argument("--max_seg_tokens", type=int, default=0,
                   help="seg-token slots supervised per row (reference "
                        "trains one mask set per seg token, InteractVLM"
                        ".py:389-410). 0 = auto: 2 for Gen-Hu-Obj/Gen-Int "
                        "(a row can carry [HSEG]+[OSEG]), else 1")
    p.add_argument("--hC_sam_view_type", default="4MV-Z_Vitru_mv2")
    p.add_argument("--oC_sam_view_type", default="4MV-Z_HM")
    p.add_argument("--multiview_channels", type=int, default=4)
    p.add_argument("--multiview_cam_cond", action="store_true", default=True)
    p.add_argument("--cam_encoder_type", default="simple")
    p.add_argument("--lora_r", type=int, default=8)
    p.add_argument("--lora_alpha", type=float, default=16.0)
    p.add_argument("--int8_base", action="store_true",
                   help="QLoRA: freeze the LLaMA base in int8 (STE "
                        "activation grads, ops/quant.py) while the bf16 "
                        "LoRA adapters + heads train; the reference's "
                        "bnb-int8 role (run_demo.py:106-129) extended to "
                        "training.")
    # losses (train.py:100-120)
    p.add_argument("--ce_loss_weight", type=float, default=1.0)
    p.add_argument("--bce_loss_weight", type=float, default=2.0)
    p.add_argument("--bce_loss_alpha", type=float, default=0.5)
    p.add_argument("--dice_loss_weight", type=float, default=1.0)
    p.add_argument("--dice_loss_scale", type=float, default=1.0)
    p.add_argument("--hC_loss_weight", type=float, default=3.0)
    p.add_argument("--oC_loss_weight", type=float, default=1.0)
    # data mixture (train.py:61-82)
    p.add_argument("--dataset", default="hcontact")
    p.add_argument("--sample_rates", default="1")
    p.add_argument("--hC_question_type", default="parts")
    p.add_argument("--oC_question_type", default="simple")
    p.add_argument("--fixed_templates", action="store_true",
                   help="always use the FIRST question/answer template "
                        "(sample order stays random) -- for offline "
                        "closed-loop tests where template variety only "
                        "slows the tiny model's convergence. Contact "
                        "datasets only (other sets pick CONTENT with the "
                        "same rng; build_dataset rejects them)")
    # parallelism
    p.add_argument("--n_model_shards", type=int, default=1,
                   help="ranks of the model axis (LLaMA tensor-parallel); "
                        "the world size over it is the data axis")
    # runtime
    p.add_argument("--resume", action="store_true")
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic data + tiny model smoke run")
    p.add_argument("--mask_size", type=int, default=32,
                   help="synthetic-mode label size")
    p.add_argument("--val_every", type=int, default=1)
    p.add_argument("--val_batches", type=int, default=50,
                   help="max validation batches per epoch gate")
    p.add_argument("--val_max_new_tokens", type=int, default=32,
                   help="generation budget for the TRAIN-TIME epoch gate "
                        "(short on purpose: the gate ranks checkpoints, "
                        "it is not the reference-protocol eval; the eval "
                        "CLI defaults to 512 like reference "
                        "evaluate.py:104)")
    p.add_argument("--save_every", type=int, default=1)
    p.add_argument("--no_eval", action="store_true")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="capture a torch.profiler trace of steps 1..N "
                        "into <run>/profile")
    p.add_argument("--no_tensorboard", action="store_true")
    return p.parse_args(argv)


def resolve_max_seg_tokens(args) -> int:
    """0/absent = auto: 2 slots for the interaction token types whose rows
    can carry both [HSEG] and [OSEG] (reference InteractVLM.py:389-410
    decodes one mask set per token), 1 otherwise."""
    k = getattr(args, "max_seg_tokens", 0)
    if k:
        return k
    base = getattr(args, "token_type", "Gen").replace("-DifDe", "")
    return 2 if base in ("Gen-Hu-Obj", "Gen-Int") else 1


def build_model_and_config(args, vocab_size=None, seg_token_idx=None,
                           hseg_token_idx=None, oseg_token_idx=None,
                           device="cuda", mesh=None):
    """Build the composite model of ``build_config`` on ``device`` (its
    parameters are uninitialised: ``init_params`` or a checkpoint fills
    them), LLaMA tensor-parallel over ``mesh``'s model axis where one is
    given. Returns (model, config)."""
    from interactvlm_tpu_torch.models.interactvlm import InteractVLM

    dev = resolve_device(device)
    cfg = build_config(args, vocab_size, seg_token_idx, hseg_token_idx,
                       oseg_token_idx, dev)
    return InteractVLM(cfg, device=dev, mesh=mesh), cfg


def build_config(args, vocab_size=None, seg_token_idx=None,
                 hseg_token_idx=None, oseg_token_idx=None, device="cuda"):
    """The composite model's configuration for the run's flags.

    Token registration MUST precede the model build: the [SEG]/[HSEG]/[OSEG]
    ids live past the base 32000 vocab, so ``vocab_size`` must already
    account for them or embed_tokens/lm_head can never represent them
    (reference adds tokens before from_pretrained + resize, train.py:163-179,
    utils/utils.py:335-362).

    The configurations are the JAX package's, except that on the card SAM
    computes in bf16 (its attention kernels take bf16 only), and at full
    scale CLIP too: the JAX trainer stores both frozen towers in the LLaMA
    dtype, and ``chip_smoke.py``'s 13B LoRA path runs them so.
    """
    from interactvlm_tpu_torch import config as cfgs

    dev = torch.device(device)
    bf16 = torch.bfloat16
    max_seg = resolve_max_seg_tokens(args)
    if args.synthetic:
        llama = cfgs.llama_tiny(lora_rank=args.lora_r and 4)
        cfg = cfgs.interactvlm_tiny(llama=llama, max_seg_tokens=max_seg)
        if dev.type == "cuda":
            cfg = dataclasses.replace(cfg, sam=cfgs.sam_tiny(dtype=bf16))
    elif getattr(args, "model_scale", "full") == "tiny":
        # tiny towers on the REAL data path (closed-loop learning tests)
        llama = cfgs.llama_tiny(lora_rank=args.lora_r and 4)
        tiny_kw = {}
        if seg_token_idx is not None:
            tiny_kw = dict(seg_token_idx=seg_token_idx,
                           hseg_token_idx=hseg_token_idx,
                           oseg_token_idx=oseg_token_idx)
        if dev.type == "cuda":
            tiny_kw["sam"] = cfgs.sam_tiny(dtype=bf16)
        cfg = cfgs.interactvlm_tiny(
            llama=llama, **tiny_kw,
            token_type=args.token_type,
            max_seg_tokens=max_seg,
            hC_sam_view_type=args.hC_sam_view_type,
            oC_sam_view_type=args.oC_sam_view_type,
            multiview_channels=args.multiview_channels,
            multiview_cam_cond=args.multiview_cam_cond,
            cam_encoder_type=args.cam_encoder_type,
            num_human_vertices=args.num_human_vertices,
            num_object_points=getattr(args, "num_object_points", 2048),
            ce_loss_weight=args.ce_loss_weight,
            bce_loss_weight=args.bce_loss_weight,
            bce_loss_alpha=args.bce_loss_alpha,
            dice_loss_weight=args.dice_loss_weight,
            dice_loss_scale=args.dice_loss_scale,
            hC_loss_weight=args.hC_loss_weight,
            oC_loss_weight=args.oC_loss_weight,
        )
    else:
        llama_kw = dict(lora_rank=args.lora_r, lora_alpha=args.lora_alpha,
                        weights_int8=getattr(args, "int8_base", False))
        if vocab_size is not None:
            llama_kw["vocab_size"] = vocab_size
        tok_kw = {}
        if seg_token_idx is not None:
            tok_kw = dict(
                seg_token_idx=seg_token_idx,
                hseg_token_idx=hseg_token_idx,
                oseg_token_idx=oseg_token_idx,
            )
        llama = cfgs.llama_13b(**llama_kw)
        if dev.type == "cuda":
            tok_kw.update(clip=cfgs.clip_vit_l_14(dtype=llama.dtype),
                          sam=cfgs.sam_vit_h(dtype=llama.dtype))
        cfg = cfgs.InteractVLMConfig(
            llama=llama,
            **tok_kw,
            num_human_vertices=args.num_human_vertices,
            num_object_points=getattr(args, "num_object_points", 2048),
            token_type=args.token_type,
            max_seg_tokens=max_seg,
            hC_sam_view_type=args.hC_sam_view_type,
            oC_sam_view_type=args.oC_sam_view_type,
            multiview_channels=args.multiview_channels,
            multiview_cam_cond=args.multiview_cam_cond,
            cam_encoder_type=args.cam_encoder_type,
            ce_loss_weight=args.ce_loss_weight,
            bce_loss_weight=args.bce_loss_weight,
            bce_loss_alpha=args.bce_loss_alpha,
            dice_loss_weight=args.dice_loss_weight,
            dice_loss_scale=args.dice_loss_scale,
            hC_loss_weight=args.hC_loss_weight,
            oC_loss_weight=args.oC_loss_weight,
        )
    return cfg


def make_tokenizer(args, tokenizer_name: str, version: Optional[str]):
    """The run's tokenizer with the seg tokens added (reference
    train.py:163-179): the offline ``WhitespaceTokenizer`` or, for "hf",
    the model's HF tokenizer (``transformers`` is imported only then).
    Returns (tokenizer, seg ids kwargs for ``build_model_and_config``)."""
    from interactvlm_tpu_torch.utils.constants import add_new_tokens

    if tokenizer_name == "whitespace":
        from interactvlm_tpu_torch.utils.testing import WhitespaceTokenizer

        tokenizer = WhitespaceTokenizer(args.model_max_length)
    else:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(
            version, model_max_length=args.model_max_length)
        tokenizer.pad_token = tokenizer.unk_token
    tokenizer, seg, hseg, oseg = add_new_tokens(tokenizer, args.token_type)
    token_kw = dict(seg_token_idx=seg, hseg_token_idx=hseg,
                    oseg_token_idx=oseg)
    if tokenizer_name != "whitespace":
        token_kw["vocab_size"] = len(tokenizer)
    return tokenizer, token_kw


def synthetic_batch_iter(cfg, batch_size, mask_size, seed=0, device="cuda"):
    from interactvlm_tpu_torch.utils.testing import make_synthetic_batch

    i = 0
    while True:
        yield make_synthetic_batch(
            cfg, B=batch_size, mask_size=mask_size, seed=seed + i,
            device=device)
        i += 1


def _load_human_maps(dataset_dir, device="cpu"):
    """Find the Vitruvian p2v/bary lift maps: either the consolidated
    ``human_lift_maps.npz`` or the datagen tree's
    ``hcontact_vitruvian_mv2/lift_maps.npz`` (datagen/recipes.py).

    Returns CORNER-MAJOR (3, V, H, W) tensors on ``device``, int32 ``p2v``
    and f32 ``bary``, converted once here (the lifts' layout,
    ``geometry.lift.corner_major``); None without a file. The on-disk
    layout stays (V, H, W, 3).
    """
    from interactvlm_tpu_torch.geometry.lift import corner_major

    for rel in ("human_lift_maps.npz",
                os.path.join("hcontact_vitruvian_mv2", "lift_maps.npz")):
        path = os.path.join(dataset_dir, rel)
        if os.path.exists(path):
            maps_npz = np.load(path)
            return {
                "p2v": torch.from_numpy(corner_major(
                    np.asarray(maps_npz["p2v"], np.int32))).to(device),
                "bary": torch.from_numpy(corner_major(
                    np.asarray(maps_npz["bary"], np.float32))).to(device),
            }
    return None


def real_batch_iter(args, cfg, tokenizer, device="cpu", mesh=None):
    """Hybrid-dataset loader with a background prefetch thread. Batches are
    tensors in pinned host memory when ``device`` is the card (the human
    maps on ``device``, loaded once).

    Every row's random draws (the mixture's pick, then the dataset's
    templates, dropouts and retries: ``HybridDataset.plan``) are made in
    row order in the loader's thread; the thread pool only reads files and
    builds the samples. So the batches do not depend on the number of
    workers, and with a ``mesh`` each data rank makes the draws of every
    row of the global batch and builds and collates its own block of them:
    n ranks hold the one-process batch's rows."""
    from interactvlm_tpu_torch.data.collate import collate
    from interactvlm_tpu_torch.data.datasets import (
        HybridDataset,
        build_dataset,
    )
    from interactvlm_tpu_torch.runtime.prefetch import (
        ParallelSampler,
        PrefetchIterator,
    )

    names = args.dataset.split("||")
    rates = [float(r) for r in args.sample_rates.split(",")]
    if len(rates) != len(names):
        rates = [1.0] * len(names)
    datasets = [
        build_dataset(name, args.dataset_dir, "train", args)
        for name in names
    ]
    hybrid = HybridDataset(
        datasets, rates,
        samples_per_epoch=args.batch_size
        * args.grad_accumulation_steps
        * args.steps_per_epoch,
    )

    # object lift maps ride every batch iff the mixture contains object
    # datasets (fixed per run, so every batch has the same keys)
    include_object_maps = any(n in ("oafford", "ocontact") for n in names)

    # human lift maps: without them the hC 3D loss silently drops out of
    # real-data training (reference loads the fixed Vitruvian p2v/bary
    # maps per view set, components.py:204-218)
    human_maps = _load_human_maps(args.dataset_dir, device)
    pin = torch.device(device).type == "cuda"

    # Per-sample construction (B x V 1024^2 PNG decodes per batch) runs on
    # a thread pool: the C++ decoder releases the GIL so threads scale
    # (reference uses multi-worker DataLoaders, train.py:334-352).
    workers = getattr(args, "data_workers", 8)
    sampler = ParallelSampler(
        lambda build: build(), num_workers=workers,
        lookahead=max(2 * args.batch_size, workers),
    )
    mesh = mesh or Mesh()
    rows = args.batch_size // mesh.n_data
    first = mesh.data_index * rows

    def plans():
        while True:
            batch = [hybrid.plan() for _ in range(args.batch_size)]
            yield from batch[first:first + rows]

    def gen():
        sample_it = sampler.iterate(plans())
        try:
            while True:
                samples = [next(sample_it) for _ in range(rows)]
                batch, _ = collate(
                    samples, tokenizer, max_len=args.model_max_length,
                    multiview_channels=args.multiview_channels,
                    include_object_maps=include_object_maps,
                    human_maps=human_maps,
                    num_human_vertices=cfg.num_human_vertices,
                    num_object_points=cfg.num_object_points,
                    num_conversations=getattr(args, "num_conversations", 1),
                    max_seg_tokens=cfg.max_seg_tokens,
                    pin_memory=pin,
                )
                yield batch
        finally:
            # a closed loader leaves no sample decoding behind it: the
            # queued look-ahead is cancelled, the started samples finish
            sampler.pool.shutdown(wait=True, cancel_futures=True)

    return PrefetchIterator(gen(), depth=getattr(args, "prefetch_depth", 4))


def make_validator(args, cfg, model, tokenizer, example, device="cpu",
                   mesh=None):
    """Generate-mode validation closure for the epoch gate (reference
    train.py:421-472 validates and gates best-checkpoint saving on the
    contact metric, not train loss). ``val_fn(model)`` returns (score,
    results); with a ``mesh`` every data rank takes its share of each
    batch and every rank gets the whole report."""
    from interactvlm_tpu_torch.eval.evaluate import validate

    if args.synthetic:
        from interactvlm_tpu_torch.utils.testing import make_synthetic_batch

        human_maps = {
            "p2v": example["human_p2v"], "bary": example["human_bary"],
            "num_vertices": cfg.num_human_vertices,
        }

        def batches():
            for i in range(2):
                b = make_synthetic_batch(
                    cfg, B=args.batch_size, tasks=(2,),
                    mask_size=args.mask_size, seed=10_000 + i,
                    device=device,
                )
                meta = {
                    "image_paths": [f"val{i}_{j}.jpg"
                                    for j in range(args.batch_size)],
                    "sampled_classes_list": [["chair"]] * args.batch_size,
                }
                yield b, meta

        mask_size = args.mask_size
        ds_name = "hcontact"
    else:
        from interactvlm_tpu_torch.data.collate import collate
        from interactvlm_tpu_torch.data.datasets import (
            ValDataset,
            build_dataset,
        )

        name = args.dataset.split("||")[0]
        # same construction path as training + the eval CLI, so the val
        # prompts/views match what training saw by construction
        ds = ValDataset(build_dataset(name, args.dataset_dir, "val", args))
        mask_size = (
            args.image_size
            if args.image_size != 1024
            else ds.dataset.view_set.mask_size
        )
        ds_name = name
        human_maps = _load_human_maps(args.dataset_dir, device)
        if human_maps is not None:
            human_maps = {
                **human_maps, "num_vertices": cfg.num_human_vertices,
            }

        def batches():
            from interactvlm_tpu_torch.runtime.prefetch import (
                iter_sample_batches,
            )

            for samples in iter_sample_batches(
                ds, args.batch_size,
                limit=args.val_batches * args.batch_size,
                num_workers=getattr(args, "data_workers", 8),
            ):
                yield collate(samples, tokenizer,
                              max_len=args.model_max_length,
                              multiview_channels=args.multiview_channels,
                              num_human_vertices=cfg.num_human_vertices,
                              num_object_points=cfg.num_object_points,
                              human_maps=human_maps,
                              include_object_maps=name in
                              ("oafford", "ocontact"))

    def val_fn(model):
        results, _ = validate(
            batches(), model, ds_name, mask_size, human_maps=human_maps,
            max_new_tokens=getattr(args, "val_max_new_tokens", 32),
            mesh=mesh,
        )
        # contact F1 is the gate when available (reference train.py:434-453)
        return results.get("f1", results.get("giou", 0.0)), results

    return val_fn


@dataclasses.dataclass
class Trainer:
    """What ``main`` leaves behind: the model (on its device, trained), the
    step and its optimizer and scheduler, the config, the tokenizer, the
    run directory, the seconds the loader took for the first batch
    (fetched before the loop) and one record a step (``history``: epoch,
    it, the update count, the loss, its terms (``loss_terms``), the rows
    of each dataset task (``rows_by_task``), whether the NaN guard skipped
    the update, data_s (the wait for the batch), batch_s (data_s and the step,
    synchronised) and loader_wait_share = data_s / batch_s, the share of
    the step's wall time the card waited on the loader)."""

    model: Any
    step: Any
    optimizer: Any
    scheduler: Any
    cfg: Any
    tokenizer: Any
    run_dir: str
    first_batch_s: float
    history: List[Dict[str, float]]


def rows_by_task(batch) -> Dict[str, int]:
    """The rows of a batch (or of its micro-batches) by dataset task:
    {task name: rows} from its ``task_ids`` (``utils/constants.TASK_IDS``;
    the first name of an id that several datasets share)."""
    from interactvlm_tpu_torch.utils.constants import TASK_IDS

    names = {}
    for name, tid in TASK_IDS.items():
        names.setdefault(tid, name)
    rows: Dict[str, int] = {}
    for micro in (batch if isinstance(batch, list) else [batch]):
        for tid in micro["task_ids"].tolist():
            rows[names[tid]] = rows.get(names[tid], 0) + 1
    return rows


def distributed_run(args) -> bool:
    """Whether this process is one rank of several: launched by torchrun
    (``WORLD_SIZE`` set), inside an initialised process group, or asked for
    model shards."""
    import torch.distributed as dist

    return ("WORLD_SIZE" in os.environ or dist.is_initialized()
            or args.n_model_shards > 1)


def setup_mesh(args):
    """(device, mesh) of a distributed run (``parallel/mesh.py:
    join_launch``: NCCL with this rank's card, gloo under ``--device
    cpu``); the mesh has ``--n_model_shards`` model ranks. Raises where the
    world size does not tile or a data rank's share of the batch is not
    whole."""
    from interactvlm_tpu_torch.parallel.mesh import create_mesh, join_launch

    dev = join_launch(args.device, f"--n_model_shards {args.n_model_shards}")
    mesh = create_mesh(n_model=args.n_model_shards)
    if args.batch_size % mesh.n_data:
        raise ValueError(f"--batch_size {args.batch_size} does not split "
                         f"over {mesh.n_data} data ranks")
    return dev, mesh


class _NoLogger:
    def log(self, *a, **k):
        pass

    log_images = log

    def close(self):
        pass


def main(argv=None):
    args = parse_args(argv)
    if distributed_run(args):
        dev, mesh = setup_mesh(args)
    else:
        dev, mesh = resolve_device(args.device), Mesh()
    main_rank = mesh.is_main

    from interactvlm_tpu_torch.data.collate import to_device
    from interactvlm_tpu_torch.runtime.hostmem import tune_host_allocator
    from interactvlm_tpu_torch.train.checkpoints import (
        CheckpointManager,
        save_config,
    )
    from interactvlm_tpu_torch.train.optimizer import (
        cast_frozen_params,
        warmup_decay_schedule,
    )
    from interactvlm_tpu_torch.train.train_step import (
        TrainStep,
        shard_params_of,
    )
    from interactvlm_tpu_torch.utils.meters import AverageMeter
    from interactvlm_tpu_torch.utils.profiling import (
        MetricLogger,
        StepTimer,
        copy_code_snapshot,
        mask_panel,
        profile_trace,
    )
    from interactvlm_tpu_torch.utils.weights import init_params

    tune_host_allocator()
    run_dir = os.path.join(args.log_base_dir, args.exp_name)
    os.makedirs(run_dir, exist_ok=True)

    # tokenizer + seg tokens FIRST, then the model, so the vocab table and
    # token indices are correct from construction (reference train.py:163-179)
    tokenizer = None
    token_kw = {}
    if not args.synthetic:
        tokenizer, token_kw = make_tokenizer(args, args.tokenizer,
                                             args.version)

    model, cfg = build_model_and_config(args, device=dev, mesh=mesh,
                                        **token_kw)
    if args.model_scale == "tiny" and not args.synthetic and \
            dev.type != "cpu":
        # the tiny preset's weights are drawn on the CPU and copied, so a
        # run starts from the same weights on every device
        host_model, _ = build_model_and_config(args, device="cpu",
                                               **token_kw)
        init_params(host_model, torch.Generator().manual_seed(0))
        model.load_state_dict(
            shard_params_of(model, host_model.state_dict(), mesh))
        del host_model
    else:
        init_params(model, torch.Generator(device=dev).manual_seed(0))
    # frozen towers stored in the compute dtype, trainables in f32
    cast_frozen_params(model, cfg.llama.dtype)
    if main_rank:
        save_config(
            run_dir, {**vars(args), **token_kw}, "pretrained_config.json"
        )
        save_config(run_dir, cfg, "config.json")
        copy_code_snapshot(run_dir)
        logger = MetricLogger(run_dir, use_tb=not args.no_tensorboard)
    else:
        logger = _NoLogger()

    loader = None
    if args.synthetic:
        # every rank draws the global batch; the step cuts its rows
        batches = synthetic_batch_iter(cfg, args.batch_size, args.mask_size,
                                       device=dev)
    else:
        batches = loader = real_batch_iter(args, cfg, tokenizer, dev, mesh)

    t0 = time.time()
    example = next(batches)
    first_batch_s = time.time() - t0
    total_steps = args.epochs * args.steps_per_epoch
    sched = warmup_decay_schedule(args.lr, args.warmup_steps, total_steps)

    accum = max(1, args.grad_accumulation_steps)
    if accum > 1:
        # a list of micro-batches, whose gradients TrainStep averages; as
        # in the JAX package, the first batch (fetched above) is not used
        def group(batches_iter):
            while True:
                yield [next(batches_iter) for _ in range(accum)]

        batches = group(iter(batches))
        example = next(batches)

    step = TrainStep(model, mesh=mesh, lr=args.lr,
                     warmup_steps=args.warmup_steps, total_steps=total_steps)
    trainer = Trainer(model, step, step.optimizer, step.scheduler, cfg,
                      tokenizer, run_dir, first_batch_s, [])
    ckpt = CheckpointManager(run_dir)
    if args.resume:
        restored = ckpt.restore(map_location=dev)
        if restored is not None:
            step.load_state_dict(restored)
            if main_rank:
                print(f"resumed from step {step.step}")

    batch_time = AverageMeter("batch_time")
    data_time = AverageMeter("data_time")
    start_epoch = step.step // args.steps_per_epoch
    first_micro = example[0] if accum > 1 else example
    val_fn = None
    timer = StepTimer()
    # the --profile_steps capture: open from step 1 of the first epoch run
    # to step N (or the epoch's end)
    trace = contextlib.ExitStack()

    def on_device(b):
        return [to_device(m, dev) for m in b] if accum > 1 else to_device(
            b, dev)

    for epoch in range(start_epoch, args.epochs):
        for it in range(args.steps_per_epoch):
            timer.start()
            batch = example if it == 0 and epoch == start_epoch else next(
                batches)
            timer.mark_data()
            data_time.update(timer.data_s)

            if args.profile_steps and it == 1 and epoch == start_epoch:
                prof_dir = os.path.join(run_dir, "profile")
                trace.callback(print, "profile -> "
                               + os.path.join(prof_dir, "trace.json"))
                trace.enter_context(profile_trace(prof_dir))
            # a real loader collates this rank's rows; a synthetic batch
            # is the global one, which the step cuts
            metrics = step(on_device(batch), local=not args.synthetic)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            if it == args.profile_steps:
                trace.close()

            timer.mark_step()
            data_s, batch_s = timer.data_s, timer.step_s
            batch_time.update(batch_s)
            loss = float(metrics["loss"])
            trainer.history.append({
                "epoch": epoch, "it": it, "step": step.step, "loss": loss,
                "loss_terms": {k: float(v) for k, v in metrics.items()
                               if k.endswith("_loss")},
                "rows_by_task": rows_by_task(batch),
                "skipped_nonfinite": float(metrics["skipped_nonfinite"]),
                "data_s": data_s, "batch_s": batch_s,
                "loader_wait_share": data_s / batch_s})
            lr_now = sched(step.step)
            # every step's record in metrics.jsonl (its own data and step
            # seconds beside the running means); the console every 10th
            logger.log(step.step, {
                **metrics,
                "lr": lr_now,
                "train/data_secs": data_s,
                "train/batch_secs": batch_s,
                "train/total_secs_per_batch": batch_time.avg,
                "train/data_secs_per_batch": data_time.avg,
            })
            if it % 10 == 0 and main_rank:
                if float(metrics.get("skipped_nonfinite", 0.0)) > 0:
                    # NaN guard: the step already dropped this update
                    # (reference train.py:547-551 skips the batch)
                    print(f"WARNING: non-finite loss at {epoch}:{it}; "
                          "update skipped")
                print(
                    f"epoch {epoch} step {it}/{args.steps_per_epoch} "
                    f"loss {loss:.4f} "
                    f"ce {float(metrics.get('ce_loss', 0.0)):.4f} "
                    f"mask {float(metrics.get('mask_loss', 0.0)):.4f} "
                    f"lr {lr_now:.2e} "
                    f"sec/batch {batch_time.avg:.3f}"
                )
        trace.close()  # fewer steps than --profile_steps

        if (epoch + 1) % args.save_every == 0:
            state = step.state_dict()
            if main_rank:
                ckpt.save(step.step, state)
            del state
        if not args.no_eval and (epoch + 1) % args.val_every == 0:
            if val_fn is None:
                val_fn = make_validator(args, cfg, model, tokenizer,
                                        first_micro, device=dev, mesh=mesh)
            score, vres = val_fn(model)
            logger.log(step.step, {f"val/{k}": v for k, v in vres.items()})
            # image panel: CLIP | SAM view | pred | GT on one sample
            # (reference utils/utils.py:457-470)
            with torch.inference_mode():
                fwd = model.forward_train(to_device(first_micro, dev))
            pm = fwd["pred_masks"].float().cpu().numpy()
            gm = first_micro["gt_masks"].cpu().numpy()
            if pm.ndim == 5:  # K-seg-slot path: panel shows slot 0
                pm, gm = pm[:, 0], gm[:, 0]
            logger.log_images(
                step.step, "val/panel",
                mask_panel(
                    first_micro["images_clip"][0].cpu().numpy(),
                    first_micro["sam_images"][0, 0].float().cpu().numpy(),
                    pm[0, 0], gm[0, 0],
                ),
            )
            del fwd
            state = step.state_dict()
            if main_rank:
                print(f"epoch {epoch} val: "
                      + " ".join(f"{k}={v:.4f}" for k, v in vres.items()))
                if ckpt.save_best(step.step, state, score):
                    print(f"new best at step {step.step}: {score:.4f}")
            del state

    if loader is not None:
        loader.close()
    logger.close()
    if main_rank:
        print("training done")
    return trainer


if __name__ == "__main__":
    main()
    import torch.distributed as _dist

    if _dist.is_initialized():
        _dist.destroy_process_group()
