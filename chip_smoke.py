"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); exits non-zero, and
prints no result, without them. Phases, each of which fails the run:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: the hand-written kernel sources under
   ``interactvlm_tpu_torch/csrc/`` (flash forward, with its wgmma kernels
   for head dims 128 and 16, the latter reading q, k and v as strided
   views; flash backward dq, which also forms D = rowsum(dO O),
   and dk/dv, with their wgmma kernels for head dim 128 and the split
   query walk of dk/dv at short key lengths; window attention, with its
   wgmma kernel for head dim 80 that reads q, k and v as strided views;
   global rel-pos attention, with its wgmma kernel for head dim 80; the one-launch
   fused int8 matmul, K split over a thread-block cluster; the int4 decode
   matmul, K split over a cluster as its shape's plan says; the int8 row
   quantize, with its row-factor route; the wgmma int8 GEMM, which is also
   the pre-quantized matmul; the wgmma int4 GEMM;
   the wgmma bf16 serving matmul; the tensor-core rate loop; the window
   copy), one ``nvcc`` each, all started together;
3. kernels: each kernel against its plain PyTorch version at the shapes the
   serving, training and probe paths give it and at the edges of the wgmma
   kernels' tiles (the int8 matmul at the rows where its two routes meet,
   flash at head dim 128 with ragged lengths and rows that see no key; the
   flash forward and backward at the fusion's full-width shape, D = 16,
   Lq = 4096, Lk = 512; the flash forward at head dim 80 padded to 128,
   the SAM global block without its rel-pos bias; at head dim 16 the SAM
   decoder's shape on the projections' views, the key widths and kv-length
   and causal edges of its wgmma kernel's tiles, and its CTA plan timed
   against one 128-row query tile of one head a CTA),
   inputs from a seeded generator, with the kernel's, the plain version's
   and one library call's time beside the least time the card could take
   (``bound_ms``); the int8 matmul also at the 7B QLoRA step's shapes;
   the int4 matmul at the 7B-int4 path's shapes on both routes and in the
   row-parallel form, bit for bit against its plain version and against
   the unpack route the card took before it, both timed; the two-pass
   routes also time each pass,
   and the int8 and bf16 matmul cases add each call's device time from the
   profiler (``device_ms``, with what launched per call) beside the
   yardsticks' (``library_device_ms``, ``bf16_linear_device_ms``): CUDA
   events around back-to-back calls of a few microseconds time the host;
4. the probes: the chain probe (eight variants: bf16 and int8 matmuls,
   library and hand-written, at 32768 x 1280 x 5120, 20 chained
   iterations), the tensor-core rate probe (four operand types at 512 x 1280
   x 1280) and the window-attention probe (nine variants at 200 windows and
   the 64 x 64 global grid), each variant's line printed; every chain
   variant must launch each of its kernels twice an iteration;
5. the lift maps: a UV sphere of SMPL's 6890 vertices under the first four
   ``4MV-Z_Vitru_mv2`` cameras, rasterized at 1024^2 on the card by the
   port (``geometry/rasterizer.py``), checked against the CPU's at 128^2,
   and turned into gather form (256 pixels a vertex and view): the maps of
   every path below; for the interaction path also the sphere under the
   first four ``4MV-Z_Vitru`` cameras and a 2048-vertex sphere under the
   four ``4MV-Z_HM_BM`` object cameras;
6. reference: the ``interactvlm_tiny`` pipeline on the card against the same
   weights on the CPU, dense (bf16 SAM), int8 (int8 LLaMA in f32 with the
   int8 KV cache, int8 bf16 SAM) and int4 (int4 LLaMA, otherwise as int8); then
   the interaction branches (Gen-Hu-Obj-DifDe, vi_v1 cams, K = 2 seg
   slots, answers carrying [HSEG] and [OSEG], per-sample object maps): the
   K-slot masks and both lifts;
7. the 13B path: ``interactvlm_13b`` at full width and depth in bf16 with
   seeded random weights, B=8 images x V=4 views, a 64-token prompt, 32
   greedy decode steps, 1024^2 masks and a 6890-vertex lift, through
   ``evaluate_batch`` in streaming and in cached-view mode;
8. the 7B-int8 path, the JAX package's chip serving configuration
   (``bench.py``): LLaMA-7B with int8 weights and the int8 KV cache, CLIP
   ViT-L/14, SAM ViT-H with int8 weights and tanh GELU, all bf16; streaming
   at B=8 and cached at B=32, otherwise as the 13B path;
9. the 7B-int4 path (``bench.py`` with ``BENCH_WQ=int4``): the 7B-int8
   path with the LLaMA weights packed int4, read by the int4 matmul
   (``ops/int4_matmul.py``: the packed nibbles inside kernel 6's two
   routes, no unpacked copy: none may be made on the card); also each
   decode shape's device time of the int4 call beside the unpack route's
   pieces and kernel 6 on an int8 weight, a decode step's sums;
10. the interaction path (``13b_hoi``), the JAX package's hcontact-ocontact
   preset: the 13B path with ``Gen-Hu-Obj`` tokens, ``vi_v1`` cams and K = 2
   seg slots, streaming only (object views are per-sample renders), the
   human maps of ``4MV-Z_Vitru`` and per-sample object maps (3, B, V,
   1024, 1024) of the 2048-vertex sphere; each row's slots fold into one
   SAM decode over B*K*V = 64 images;
11. the training reference: one LoRA and one QLoRA (int8 base) training
   step of ``interactvlm_tiny`` on the card in bf16 (a 259-token spliced
   prompt, so LLaMA's attention runs the flash forward and both backward
   kernels) against the same step on the CPU in f32 from the same
   weights: each loss term, and the cosine and norm of every trainable's
   gradient; and one K = 2 step of the interaction branches with the DifDe
   decoders and the fusion, held so too, whose splitter, cam encoder,
   three decoders and fusion are also held as whole gradients from an f32
   step on the card;
12. the 13B LoRA training path, the JAX trainer's default preset
   (``scripts/run_train.sh`` hcontact-damon): LLaMA-13B bf16 with LoRA rank
   8 on q/v and remat, CLIP ViT-L/14, SAM ViT-H, B=8 hcontact rows of 512
   spliced tokens (two right-padded), 1024^2 masks and the 6890-vertex 3D
   contact loss on the real maps, AdamW with the preset's schedule: one
   warm-up step, then timed steps through ``TrainStep``;
13. the 7B QLoRA training path, the JAX package's one-chip training
   configuration: LLaMA-7B with a frozen int8 base (kernel 6 forward, the
   straight-through backward), otherwise as the 13B path; also the
   backward's device time (the W_q cast and the bf16 GEMM);
14. the DAMON workflow (``damon_workflow_phase``), the first real input
   pipeline on the card: the port's DAMON recipe writes a 1024^2 tree of
   16 photos on the card; the training CLI (``train/train.py:main``, 13B
   LoRA, B=8, 8 loader threads) takes 4 steps from it, each step's wall
   and data seconds, the loader-wait share and the launches a step
   printed; the CLI's step is split against ``TrainStep`` on one real
   batch (resident on the card, or copied each step); ``validate`` runs on the trained model (2
   batches of 8, the cached view encode); then the tiny chain at 64^2
   (train with eval and saving, resume, export, the eval CLI on the card
   and on the CPU from one run directory, their reports held together,
   and the restored model's mask logits and lifted contacts held card
   against CPU);
15. the demo and the fit (``demo_fit_phase``), the end-user chain: a demo
   folder written on the card (seeded 640 x 480 photos, the canonical
   ``4MV-Z_Vitru_mv2`` renders of the 6890-vertex sphere at 1024^2 and its
   lift maps, a seeded sparse 10475 x 6890 SMPL -> SMPL-X matrix, the body
   template in SMPL-X's vertex count, the 2048-vertex object sphere);
   ``interactvlm_13b`` in bf16 with seeded random weights through the
   demo's per-image loop (``demo/run_demo.py:run_images``): hcontact on 4
   images, h2dcontact on 2, ocontact on 2 (its first image builds the
   object views at 1024^2 on the card), each leg's seconds, its images'
   ``evaluate_batch`` seconds, peak memory and kernels 1-3's launches per
   image, and every file of the output bundle checked; the tiny demo
   (``--random_weights``, 64^2) on the card and the CPU from the same
   weights, held together; then the fit: the fit CLI
   (``fit/data_io.py:main``) at the reference's full settings (512^2, 250
   steps, ICP, scale, the trajectory GIF) on a folder of the scene with
   the demo's contacts; a recovery fit from the contacts of the object's
   true pose (translation and rotation error, scale and silhouette IoU at
   the start, after ICP and after Adam), held to the port on the CPU (ICP,
   and ten steps from the card's ICP result); ICP's seconds and
   synchronising calls, and one step's split (silhouette forward and
   backward, contact loss, Adam, the card's idle time);
17. the distributed paths on the one card (``distributed_phase``), one
   line each: (1) the training CLI under ``torchrun --nproc_per_node 1``
   with NCCL (the sharded step on a 1 x 1 mesh) at 13B LoRA, B = 8, on a
   1024^2 DAMON tree, its losses held to the one-process CLI's in the same
   call; then two gloo ranks sharing the card (every collective a gloo
   all-reduce or broadcast of card tensors; their times are not multi-card
   numbers): (2) the 1 x 2 tensor-parallel 13B LoRA step on phase 12's
   weights and batch, each loss term and each trainable's gradient held
   to phase 12's one-process step; (3) the 2 x 1 data-parallel 7B QLoRA
   step (4 rows a rank, Adam's moments ZeRO-sharded) held to phase 13's;
   (4) the 1 x 2 tensor-parallel greedy decode of LLaMA-13B bf16 against
   the one-process decode, and of LLaMA-7B int8, whose row-parallel
   linears take kernel 7's given-scale route; (5) ``evaluate.py
   --distributed`` on two ranks against the one-process report; (6)
   ``graft_entry_torch.dryrun_multichip(2)``; (7) the memory budgets of
   every path beside its measured peak; (8) the 1 x 2 step in f32 at
   LLaMA-13B's width over two layers against one process on the card
   (whether the bf16 step's gradient gap is summation order);
18. the LISA workflow (``lisa_workflow_phase``): LISA-layout trees
   written on the host (``utils/lisa_tree.py``: ade20k photos at 683 x
   512 with id maps, refcoco at 640 x 480 with polygon, compressed-RLE
   and G_REFER annotations, ReasonSeg polygons at mixed sizes, VQA); the
   training CLI at the 13B LoRA defaults on LISA's own mixture
   (``sem_seg_lisa||refer_seg_lisa||vqa||reason_seg`` at 9,3,3,1), B=8,
   8 loader threads, 3 steps: each step's wall and data seconds, the
   loader-wait share, rows by task and by dataset, the loss terms,
   kernels 1-5's launches and the peak GB beside phase 14's DAMON step;
   ``validate`` of 8 ReasonSeg rows (gIoU, cIoU); the tiny chain at 64^2
   with three conversations a row, card against CPU;
19. the entry probes (``entry_probes_phase``): the twins of the SAM, int8,
   int4, decode, lift, data and train-step probe scripts through their
   ``main`` at full width, iterations cut, every variant's line printed,
   each variant's launches held (kernel 1 at head dim 80 padded to 128 in
   the SAM probe's ``norel``) and the lift probe's two gather forms held
   to each other;
20. the ``bench.py`` twin (``bench_twin_phase``): ``python3
   bench_torch.py`` in a subprocess at its card defaults (``bench.py``'s
   chip configuration: the 7B int8 path's model, streaming B = 8 and
   cached B = 32, the gather lift at K = 256 on ``bench.py``'s
   4722-vertex sphere), one timed window of two iterations a mode; its
   record's keys and metric string, finite positive values, its MFU in
   (0, 1) against 989 TFLOP/s, and its launches of one streaming and one
   cached iteration held to the 7B-int8 path's of one batch a mode in the
   same run; the gather lift's largest difference from the scatter lift
   on its maps, and the vertices with more than K candidate pixels in a
   view, reported.

Each serving path reports images/s, the time of each leg, peak memory, the
decode host/device split and each kernel's launches over its run; the 7B
paths also check the int8 and int4 matmuls' calls by route (the int4
path's int8 and int4 calls together equal the int8 path's int8 calls):
the encoder's and the prefill's through the row quantize and a GEMM,
decode's and the lm_head's through the one-launch kernel;
the int8 path also times decode with the int8 against the dense cache.
The training
path reports step time, images/s and tokens/s, peak memory, the
forward/backward/optimizer split, the device's busy share and each
kernel's launches per step.

Each path counts every kernel's launches from 0 over its run; the
``{"kernels": [...]}`` line, second to last, gives each kernel's count on
the path named in ``KERNELS`` and on every path. The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import json
import math
import os
import pickle
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

import bench_torch
from interactvlm_tpu_torch.config import (
    clip_tiny,
    clip_vit_l_14,
    interactvlm_13b,
    interactvlm_tiny,
    llama_13b,
    llama_7b,
    llama_tiny,
    sam_tiny,
    sam_vit_h,
)
from interactvlm_tpu_torch.data.collate import collate, to_device
from interactvlm_tpu_torch.data.datasets import ValDataset, build_dataset
from interactvlm_tpu_torch.datagen import __main__ as datagen_cli
from interactvlm_tpu_torch.datagen.generate import (
    verify_contact_reconstruction,
)
from interactvlm_tpu_torch.datagen.recipes import (
    AFFORD_LIST_PIAD,
    generate_damon_tree,
    generate_piad_tree,
)
from interactvlm_tpu_torch.demo import demo_utils, run_demo
from interactvlm_tpu_torch.eval import evaluate as eval_cli
from interactvlm_tpu_torch.fit import data_io as fit_io
from interactvlm_tpu_torch.fit import fit as fit_mod
from interactvlm_tpu_torch.fit import icp as fit_icp
from interactvlm_tpu_torch.fit import optimizer as fit_opt
from interactvlm_tpu_torch.fit import renderer as fit_render
from interactvlm_tpu_torch.fit import utils as fit_utils
from interactvlm_tpu_torch.eval.evaluate import (
    damon_binary_contact,
    damon_semantic_contact,
    evaluate_batch,
    lift_objects_per_sample,
    seg_slots,
    truncate_at_answer,
    validate,
)
from interactvlm_tpu_torch.geometry.lift import (
    build_gather_maps,
    corner_major,
    lift_batch_soft,
    lift_multiview_soft_gather,
)
from interactvlm_tpu_torch.geometry.rasterizer import (
    build_lift_maps,
    pick_window,
    uv_sphere,
)
from interactvlm_tpu_torch.geometry.views import HUMAN_VIEWS, OBJECT_VIEWS
from interactvlm_tpu_torch.models.generate import greedy_generate
from interactvlm_tpu_torch.models.interactvlm import InteractVLM, lift_human
from interactvlm_tpu_torch.models.layers import Int4Linear, Int8Linear
from interactvlm_tpu_torch.models.llama import LlamaForCausalLM, init_kv_cache
from interactvlm_tpu_torch.ops import _cuda
from interactvlm_tpu_torch.ops import flash_attention as FA
from interactvlm_tpu_torch.ops import int4_matmul as Q4
from interactvlm_tpu_torch.ops import int8_matmul as Q
from interactvlm_tpu_torch.ops import mxu as MX
from interactvlm_tpu_torch.ops import quant as QT
from interactvlm_tpu_torch.ops import sam_attention as SA
from interactvlm_tpu_torch.ops import serving_matmul as SM
from interactvlm_tpu_torch.probes import chain as chain_probe
from interactvlm_tpu_torch.probes.common import (
    WRAPPERS,
    busy_ns,
    card_trace,
    device_busy_ms,
    issue_and_wall_ms,
    on_card,
    read_launches,
    reset_launches,
)
from interactvlm_tpu_torch.probes import data as data_probe
from interactvlm_tpu_torch.probes import decode as decode_probe
from interactvlm_tpu_torch.probes import int4 as int4_probe
from interactvlm_tpu_torch.probes import int8 as int8_probe
from interactvlm_tpu_torch.probes import lift as lift_probe
from interactvlm_tpu_torch.probes import mxu as mxu_probe
from interactvlm_tpu_torch.probes import sam as sam_probe
from interactvlm_tpu_torch.probes import train_step as train_step_probe
from interactvlm_tpu_torch.probes import winattn as winattn_probe
from interactvlm_tpu_torch.runtime import native_image
from interactvlm_tpu_torch.runtime.prefetch import iter_sample_batches
from interactvlm_tpu_torch.train import export as export_cli
from interactvlm_tpu_torch.train import train as train_cli
from interactvlm_tpu_torch.train.checkpoints import (
    CheckpointManager,
    load_config,
)
from interactvlm_tpu_torch.train.optimizer import (
    apply_trainable_mask,
    cast_frozen_params,
    make_optimizer,
)
from interactvlm_tpu_torch.train.train_step import TrainStep
from interactvlm_tpu_torch.utils.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from interactvlm_tpu_torch.utils.lisa_tree import write_lisa_tree
from interactvlm_tpu_torch.utils.testing import (
    WhitespaceTokenizer,
    greedy_decode_lm,
    make_synthetic_batch,
)
from interactvlm_tpu_torch.utils.weights import init_params

# Dense peak rates (NVIDIA data sheets): bf16 tensor-core FLOP/s, HBM
# bytes/s, int8 tensor-core OP/s, f32 FLOP/s on the CUDA cores (no TF32),
# and exponentials/s on the special-function units: 16 a clock an SM
# (CUDA C++ Programming Guide, arithmetic instruction throughput, compute
# capability 9.0) at the boost clock, 132 SMs x 1.98 GHz (SXM), 114 x
# 1.755 GHz (PCIe).
PEAKS = {"H100 SXM": (989e12, 3.35e12, 1979e12, 67e12, 132 * 16 * 1.98e9),
         "H100 PCIe": (756e12, 2.0e12, 1513e12, 51e12, 114 * 16 * 1.755e9)}
# kernel vs plain version, element-wise (see compare)
ATOL, WINDOW_ATOL, RTOL, RMS_TOL, LSE_TOL = 4e-3, 2e-2, 2e-2, 1e-2, 1e-3
# int8 matmul vs plain version (see compare_int8)
INT8_RTOL, INT8_ATOL_OF_MAX = 2.0 ** -7, 1e-6
# flash backward kernels vs plain version (see compare_grad)
GRAD_ATOL_OF_RMS = 2e-2
B, V, L_TEXT, T, MASK = 8, 4, 64, 32, 1024
B_CACHED_INT8 = 32  # the 7B-int8 cached batch (bench.py's default)
REPEATS = 2  # timed batches per mode and path, after one warm-up batch each
LEG_REPEATS = 1
# the lift maps: a UV sphere of SMPL's 6890 vertices under the first V
# cameras of the canonical body view set, 1024^2, gather form with MAX_K
# pixels a vertex and view (bench.py's)
N_VERTS, MAX_K, SPHERE, VIEW_SET = 6890, 256, (83, 84), "4MV-Z_Vitru_mv2"
# the interaction path (13b_hoi), the JAX package's hcontact-ocontact
# preset: K seg-token slots a row; the human maps under the preset's
# hC_sam_view_type, the object maps of a 2048-vertex sphere (34 x 62, the
# preset's num_object_points) under its oC_sam_view_type
K_HOI, HOI_HUMAN_VIEWS, HOI_OBJECT_VIEWS = 2, "4MV-Z_Vitru", "4MV-Z_HM_BM"
OBJ_SPHERE, N_OBJ = (34, 62), 2048
# the tiny interaction reference: seg ids 500 / 501 / 502 of the 512-token
# tiny vocabulary
HOI_TINY = dict(token_type="Gen-Hu-Obj-DifDe", cam_encoder_type="vi_v1",
                hseg_token_idx=501, oseg_token_idx=502, max_seg_tokens=K_HOI)
# the 13B training path: the preset's batch of 8, 257 text tokens (512
# spliced), rows 0 and 1 right-padded to these text lengths
L_TRAIN, TRAIN_PADDED = 257, (200, 129)
TRAIN_STEPS = 3  # timed steps, after one warm-up step

# each kernel's sources (the first holds its entry point), the TPU kernel
# it replaces (its wrapper, whose launch count a path reads, is
# ``probes/common.py:WRAPPERS[name]``), its symbols in a profile (one a route; int8_matmul_prequant launches the int8 GEMM, so it
# shares int8_matmul's), and the path whose count the kernel line reports
CSRC = "interactvlm_tpu_torch/csrc/"
KERNELS = {
    "flash_attention": dict(
        sources=[CSRC + "flash_attention.cu", CSRC + "flash_fwd_sm90.cuh",
                 CSRC + "flash_fwd_d16_sm90.cuh", CSRC + "d16_sm90.cuh",
                 CSRC + "attention_core.cuh"],
        replaces="interactvlm_tpu/ops/flash_attention.py:43",
        symbols=["flash_fwd_kernel", "flash_fwd_sm90_kernel",
                 "flash_fwd_d16_kernel"],
        path="train_13b_lora"),
    "window_attention": dict(
        sources=[CSRC + "window_attention.cu",
                 CSRC + "window_attention_sm90.cuh", CSRC + "sm90_core.cuh",
                 CSRC + "attention_core.cuh"],
        replaces="interactvlm_tpu/ops/sam_attention.py:117",
        symbols=["window_kernel", "window_fwd_sm90_kernel"],
        path="train_13b_lora"),
    "rel_attention": dict(
        sources=[CSRC + "rel_attention.cu", CSRC + "rel_attention_sm90.cuh",
                 CSRC + "attention_core.cuh"],
        replaces="interactvlm_tpu/ops/sam_attention.py:39",
        symbols=["rel_kernel", "rel_fwd_sm90_kernel"],
        path="train_13b_lora"),
    "int8_matmul": dict(
        sources=[CSRC + "int8_gemm_sm90.cu", CSRC + "int8_prequant.cu",
                 CSRC + "int8_matmul.cu", CSRC + "gemm_sm90.cuh"],
        replaces="interactvlm_tpu/ops/int8_matmul.py:39",
        symbols=["int8_splitk_kernel", "int8_gemm_kernel"],
        path="7b_int8"),
    # at head dim 16 the first launch is the one pass (dq and the dK/dV
    # partials) or the dq kernel, the second the partials' reduce or the
    # dk/dv kernel (both the rows kernel's symbol)
    "flash_attention_bwd_dq": dict(
        sources=[CSRC + "flash_attention_bwd.cu", CSRC + "flash_bwd_sm90.cuh",
                 CSRC + "flash_bwd_d16_sm90.cuh", CSRC + "d16_sm90.cuh",
                 CSRC + "attention_core.cuh"],
        replaces="interactvlm_tpu/ops/flash_attention.py:190",
        symbols=["flash_bwd_dq_kernel", "flash_bwd_dq_sm90_kernel",
                 "flash_bwd_d16_rows_kernel"],
        path="train_13b_lora"),
    "flash_attention_bwd_dkv": dict(
        sources=[CSRC + "flash_attention_bwd.cu", CSRC + "flash_bwd_sm90.cuh",
                 CSRC + "flash_bwd_d16_sm90.cuh", CSRC + "d16_sm90.cuh",
                 CSRC + "attention_core.cuh"],
        replaces="interactvlm_tpu/ops/flash_attention.py:243",
        symbols=["flash_bwd_dkv_kernel", "flash_bwd_dkv_sm90_kernel",
                 "flash_bwd_dkv_reduce_kernel", "flash_bwd_d16_dkv_kernel",
                 "flash_bwd_d16_reduce_kernel"],
        path="train_13b_lora"),
    "quantize_rows": dict(
        sources=[CSRC + "int8_prequant.cu"],
        replaces="interactvlm_tpu/ops/int8_matmul.py:82",
        symbols=["quantize_rows_kernel"],
        path="7b_int8"),
    "int8_matmul_prequant": dict(
        sources=[CSRC + "int8_gemm_sm90.cu", CSRC + "gemm_sm90.cuh"],
        replaces="interactvlm_tpu/ops/int8_matmul.py:124",
        symbols=["int8_gemm_kernel"],
        path="probes"),
    "fused_dense": dict(
        sources=[CSRC + "serving_matmul.cu", CSRC + "gemm_sm90.cuh"],
        replaces="interactvlm_tpu/ops/serving_matmul.py:50",
        symbols=["dense_gemm_kernel"],
        path="probes"),
    "mxu_loop": dict(
        sources=[CSRC + "mxu_probe.cu", CSRC + "sm90_core.cuh"],
        replaces="scripts/mxu_probe.py:28",
        symbols=["wgmma_loop_kernel", "fma_loop_kernel"],
        path="probes"),
    "window_copy": dict(
        sources=[CSRC + "window_copy.cu"],
        replaces="scripts/winattn_probe.py:123",
        symbols=["window_copy_kernel"],
        path="probes"),
    # the int4 weight read as packed nibbles: the decode kernel, and kernel 7
    # with the row factor then the int4 GEMM (it replaces the JAX package's
    # int4_matmul, which XLA fuses: no Pallas kernel)
    "int4_matmul": dict(
        sources=[CSRC + "int4_matmul.cu", CSRC + "int4_gemm_sm90.cu",
                 CSRC + "int8_prequant.cu", CSRC + "matmul_core.cuh"],
        replaces="interactvlm_tpu/ops/quant.py:199",
        symbols=["int4_splitk_kernel", "int4_gemm_kernel"],
        path="7b_int4"),
    # kernel 7's given-scale route: a row-parallel int8 linear's slice of
    # each row, quantized with the whole row's absmax
    "quantize_rows_given": dict(
        sources=[CSRC + "int8_prequant.cu"],
        replaces="interactvlm_tpu/ops/int8_matmul.py:82",
        symbols=["quantize_rows_kernel"],
        path="tp_decode_7b_int8"),
}
SERVING_KERNELS = ("flash_attention", "window_attention", "rel_attention",
                   "int8_matmul")
TRAINING_KERNELS = ("flash_attention", "flash_attention_bwd_dq",
                    "flash_attention_bwd_dkv")


T0 = time.perf_counter()


def log(*a):
    """Print a line; a phase's JSON line gains ``t_s``, the seconds since
    the script started."""
    if len(a) == 1 and str(a[0]).startswith('{"phase"'):
        a = ('{"t_s": %.1f, %s' % (time.perf_counter() - T0, a[0][1:]),)
    print(*a, flush=True)


def peaks(name: str):
    return PEAKS["H100 PCIe" if "PCIe" in name else "H100 SXM"]


def bound(flops, nbytes, name, int8=False, f32=False, exps=0):
    """The least time in ms for the work: operations over the bf16 (with
    ``int8``, the int8 tensor-core; with ``f32``, the CUDA cores' f32)
    peak, or ``exps`` exponentials over the special-function units' rate
    (attention's softmax: at head dim 16 these outlast the products), or
    bytes over the memory rate, whichever is largest, and which of
    operations or bytes it is."""
    flop_s, byte_s, int8_s, f32_s, exp_s = peaks(name)
    t_ops = max(flops / (int8_s if int8 else f32_s if f32 else flop_s),
                exps / exp_s) * 1e3
    t_bytes = nbytes / byte_s * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms_by_name(fn, iters: int, warmup: int = 2, calls=None):
    """What one call of ``fn`` runs on the card, by name (the first 60
    characters): [device ms, launches] a call, from torch.profiler over
    ``iters`` calls, every kernel, memset and copy, over the calls the
    trace holds (the most launches of one name, since the profiler may drop
    a call's events; ``calls`` where one name runs more than once a call).
    Empty where the trace holds no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and on_card(e):
            n = by.setdefault(e.name[:60], [0.0, 0])
            n[0] += e.time_range.end - e.time_range.start
            n[1] += 1
    calls = calls or max((c for _, c in by.values()), default=1)
    return {n: [us / 1e3 / calls, c / calls] for n, (us, c) in by.items()}


def device_ms(fn, iters: int, warmup: int = 2, calls=None):
    """Device time of one call of ``fn`` in ms (``device_ms_by_name``
    summed) and what ran, by name, per call; None where the trace holds no
    device activity (time with ``time_ms`` then). Unlike CUDA events around
    back-to-back calls it leaves out the host's issue time between
    launches."""
    by = device_ms_by_name(fn, iters, warmup, calls)
    if not by:
        return None, None
    return (sum(ms for ms, _ in by.values()),
            {n: c for n, (_, c) in by.items()})


def wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def spread(xs):
    return {"median": float(np.median(xs)), "min": min(xs), "max": max(xs)}


def rand_bf16(gen, shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(
        torch.bfloat16)


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def compare(got, want, lse=None, lse_want=None, atol=ATOL):
    """Kernel output against its plain version. Element-wise, each output
    within atol + RTOL * |plain|: both write bf16 (8 bits, so a rounding
    step of up to 2^-8 of the value) and round the probabilities to bf16
    against a different maximum; atol covers outputs near zero. Over the
    whole output, the RMS error within RMS_TOL of the plain output's RMS,
    which a systematic error of a percent fails even where every element
    passes. The logsumexp is f32 on both sides: LSE_TOL absolute.

    The window kernel takes WINDOW_ATOL: its plain version, like the TPU
    window kernel, rounds the normalised probabilities to bf16, while the
    CUDA kernel rounds them against its running maximum before it
    normalises. Over 196 keys with the rel-pos bias the softmax is peaked,
    so one weight's rounding step times a value of up to ~4 moves an output
    by up to ~2^-6 whatever the output's own size."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    res = {"max_abs_err": err.max().item(),
           "err_over_limit": (err / (atol + RTOL * w.abs())).max().item(),
           "rms_rel_err": (err.square().mean()
                           / w.square().mean().clamp_min(1e-30)).sqrt().item()}
    del g, w, err
    if lse is not None:
        res["lse_abs_err"] = max_err(lse, lse_want)
    res["tol"] = {"atol": atol, "rtol": RTOL, "rms_rel": RMS_TOL,
                  "lse_abs": LSE_TOL}
    res["ok"] = (res["err_over_limit"] <= 1.0 and res["rms_rel_err"] <= RMS_TOL
                 and res.get("lse_abs_err", 0.0) <= LSE_TOL)
    return res


def sdpa():
    # the library yardstick only: the port itself never calls it
    return torch.nn.functional.scaled_dot_product_attention


# --------------------------------------------------------------- kernels
def case_flash_prefill(gen, name, L, lens, what, H=40):
    """LLaMA-13B causal attention, one layer: B=8, H=40 (20 on one of two
    model ranks), D=128, per-row kv lengths ``lens``: the serving prefill
    (L=319, all valid) and the training forward (L=512, two rows
    right-padded)."""
    Bq, D = B, 128
    q, k, v = (rand_bf16(gen, (Bq, H, L, D)) for _ in range(3))
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    got, lse = FA.flash_forward(q, k, v, True, None, lens)
    want, lse_want = FA.flash_forward_plain(q, k, v, True, None, lens)
    mask = float_mask(Bq, L, L, True, lens)
    pairs = int(FA._visible(Bq, L, L, True, lens, "cuda").sum().item()) * H
    t, by = bound(4 * D * pairs, (4 * Bq * H * L * D) * 2 + Bq * H * L * 4
                  + Bq * 4, name, exps=pairs)
    return dict(
        shape=what, **compare(got, want, lse, lse_want),
        kernel_ms=time_ms(lambda: FA.flash_forward(q, k, v, True, None, lens), 20),
        plain_ms=time_ms(
            lambda: FA.flash_forward_plain(q, k, v, True, None, lens), 5),
        library_ms=time_ms(lambda: sdpa()(q, k, v, attn_mask=mask), 20),
        bound_ms=t, bound_by=by)


def case_flash_sam(gen, name, Lk=9,
                   what="B=32 H=8 Lq=4096 Lk=9 D=16 (SAM decoder image->token)"):
    """D = 16 over the 64 x 64 SAM grid: B*V=32, H=8, Lq=4096, non-causal,
    no kv lengths. Lk=9: the SAM decoder's image -> token attention; Lk=512:
    the fusion's image -> LLaVA attention at full width (its padded
    positions are not masked, as in the JAX package). Besides the kernel's
    time on its own plan (``kernel_ms``, and the profiler's ``device_ms``:
    CUDA events around back-to-back calls time the host's issue where a
    call is shorter than it), the CTAs an SM holds, and its time with one
    head's 128-row query tile a CTA (``one_tile_a_cta_ms``, ``_device_ms``:
    8192 CTAs that each load K and V and one query tile, as the mma.sync
    kernel's 16 384 did), in turns with the default; at Lk = 9 also each
    group of heads a CTA (``by_heads_per_cta``), and every plan must give
    the default's bits."""
    R, H, Lq, D = B * V, 8, 4096, 16
    q = rand_bf16(gen, (R, H, Lq, D))
    k, v = rand_bf16(gen, (R, H, Lk, D)), rand_bf16(gen, (R, H, Lk, D))
    got, lse = FA.flash_forward(q, k, v)
    want, lse_want = FA.flash_forward_plain(q, k, v)
    t, by = bound(4 * R * H * Lq * Lk * D,
                  (2 * R * H * Lq * D + 2 * R * H * Lk * D) * 2
                  + R * H * Lq * 4, name, exps=R * H * Lq * Lk)

    def one_wave():
        return FA.flash_forward(q, k, v)

    def one_tile():
        return FA.flash_forward(q, k, v, False, None, None, (1, 1))

    plans = {"kernel_ms": [], "one_tile_a_cta_ms": []}
    for fn, key in ((one_wave, "kernel_ms"), (one_tile, "one_tile_a_cta_ms"),
                    (one_tile, "one_tile_a_cta_ms"), (one_wave, "kernel_ms")):
        plans[key].append(time_ms(fn, 20))
    res = compare(got, want, lse, lse_want)
    # the CTA plan moves no bit: every row runs the same arithmetic
    res["plans_equal"] = all(
        torch.equal(x, y) for x, y in zip(
            FA.flash_forward(q, k, v, False, None, None, (1, 1)), (got, lse)))
    by_heads = {}
    if Lk == 9:
        # heads a CTA against the CTAs an SM and the profiler's time
        for G in (1, 2, 4, 8):
            o2, l2 = FA.flash_forward(q, k, v, False, None, None, (0, G))
            res["plans_equal"] = (res["plans_equal"] and torch.equal(o2, got)
                                  and torch.equal(l2, lse))
            by_heads[G] = {"blocks_per_sm": FA.d16_blocks_per_sm(Lk, H, G),
                           "device_ms": device_ms(lambda: FA.flash_forward(
                               q, k, v, False, None, None, (0, G)), 10)[0]}
    res["ok"] = res["ok"] and res["plans_equal"]
    return dict(
        shape=what, route=FA.fwd_route(D), key_tiles=FA.d16_key_tiles(D, Lk),
        blocks_per_sm=FA.d16_blocks_per_sm(Lk, H), by_heads_per_cta=by_heads,
        **res,
        kernel_ms=min(plans["kernel_ms"]),
        device_ms=device_ms(one_wave, 10)[0],
        one_tile_a_cta_ms=min(plans["one_tile_a_cta_ms"]),
        one_tile_a_cta_device_ms=device_ms(one_tile, 10)[0],
        plain_ms=time_ms(lambda: FA.flash_forward_plain(q, k, v), 5),
        library_ms=time_ms(lambda: sdpa()(q, k, v), 20),
        bound_ms=t, bound_by=by)


def case_flash_sam_views(gen, name):
    """The SAM decoder's image -> token attention at (b) as the decoder
    calls it: q, k and v the (B, H, L, 16) head views of its (32, L, 128)
    projections, read in place, and o a view whose transpose back to
    tokens must be contiguous; the result must equal, bit for bit, the
    call on contiguous copies. Timed beside the contiguous call the
    mma.sync route needed (copies of q, k and v, the kernel, o's copy back
    to tokens: ``with_copies_ms``)."""
    R, H, Lq, Lk, D = B * V, 8, 4096, 9, 16

    def views(L):
        return rand_bf16(gen, (R, L, H * D)).view(R, L, H, D).transpose(1, 2)

    q, k, v = views(Lq), views(Lk), views(Lk)
    got, lse = FA.flash_forward(q, k, v)
    want, lse_want = FA.flash_forward_plain(q, k, v)
    res = compare(got, want, lse, lse_want)
    cont, cont_lse = FA.flash_forward(q.contiguous(), k.contiguous(),
                                      v.contiguous())
    res["out_transpose_contiguous"] = got.transpose(1, 2).is_contiguous()
    res["equals_contiguous_call"] = (torch.equal(got, cont)
                                     and torch.equal(lse, cont_lse))
    res["ok"] = (res["ok"] and res["out_transpose_contiguous"]
                 and res["equals_contiguous_call"])
    t, by = bound(4 * R * H * Lq * Lk * D,
                  (2 * R * H * Lq * D + 2 * R * H * Lk * D) * 2
                  + R * H * Lq * 4, name, exps=R * H * Lq * Lk)

    def with_copies():
        o, _ = FA.flash_forward(q.contiguous(), k.contiguous(),
                                v.contiguous())
        return o.transpose(1, 2).reshape(R, Lq, H * D)

    return dict(
        shape="B=32 H=8 Lq=4096 Lk=9 D=16 views of (32, L, 128) "
        "projections (SAM decoder image->token, as called)",
        route=FA.fwd_route(D), **res,
        kernel_ms=time_ms(lambda: FA.flash_forward(q, k, v), 20),
        device_ms=device_ms(lambda: FA.flash_forward(q, k, v), 10)[0],
        with_copies_ms=time_ms(with_copies, 20),
        plain_ms=time_ms(lambda: FA.flash_forward_plain(q, k, v), 5),
        library_ms=time_ms(lambda: sdpa()(q, k, v), 20),
        bound_ms=t, bound_by=by)


# Head dim 128 at the edges of the wgmma kernel's 128-row and 128-key tiles:
# (what, B, H, Lq, Lk, causal, kv lengths)
FLASH_EDGE_CASES = [
    ("Lq=1 Lk=200 causal, kv lengths 200 and 1", 2, 8, 1, 200, True,
     (200, 1)),
    ("Lq=63 Lk=200 causal (bottom-right offset)", 2, 8, 63, 200, True, None),
    ("Lq=Lk=129 causal, kv lengths 0, 1 and full", 3, 8, 129, 129, True,
     (0, 1, 129)),
    ("Lq=300 Lk=129 causal: 171 rows see no key", 2, 8, 300, 129, True,
     None),
    ("Lq=319 Lk=500 non-causal, kv lengths 500 and 77", 2, 8, 319, 500,
     False, (500, 77)),
]
# Head dim 16 at the edges of its wgmma kernel's key tiles (16 ceil(Lk /
# 16 t) keys for the fewest t tiles of at most 128) and 128-row query
# tiles: (what, B, H, Lq, Lk, causal, kv lengths)
FLASH_D16_EDGE_CASES = [
    ("Lq=300 Lk=1: one 16-key tile", 4, 8, 300, 1, False, None),
    ("Lq=300 Lk=9: one 16-key tile", 4, 8, 300, 9, False, None),
    ("Lq=300 Lk=17: one 32-key tile", 4, 8, 300, 17, False, None),
    ("Lq=300 Lk=300: three 112-key tiles", 4, 8, 300, 300, False, None),
    ("Lq=300 Lk=512: four 128-key tiles", 4, 8, 300, 512, False, None),
    ("Lq=300 Lk=513: five 112-key tiles", 4, 8, 300, 513, False, None),
    ("Lq=200 Lk=300 causal (bottom-right offset)", 2, 8, 200, 300, True,
     None),
    ("Lq=300 Lk=129 causal: 171 rows see no key", 2, 8, 300, 129, True,
     None),
    ("Lq=Lk=129 causal, kv lengths 0, 1 and full", 3, 8, 129, 129, True,
     (0, 1, 129)),
]


def case_flash_edge(gen, name, what, Bq, H, Lq, Lk, causal, lens, D=128):
    """Kernel 1 at head dim D on one edge case: rows that see no key must
    give exact zeros and logsumexp 0, besides ``compare``'s limits."""
    q = rand_bf16(gen, (Bq, H, Lq, D))
    k, v = rand_bf16(gen, (Bq, H, Lk, D)), rand_bf16(gen, (Bq, H, Lk, D))
    kv = (None if lens is None
          else torch.tensor(lens, dtype=torch.int32, device="cuda"))
    got, lse = FA.flash_forward(q, k, v, causal, None, kv)
    want, lse_want = FA.flash_forward_plain(q, k, v, causal, None, kv)
    res = compare(got, want, lse, lse_want)
    vis = FA._visible(Bq, Lq, Lk, causal, kv, "cuda")
    blind = ~vis.any(-1).expand(Bq, H, Lq)
    res["blind_rows"] = int(blind.sum().item())
    res["ok"] = (res["ok"] and bool((got[blind] == 0).all())
                 and bool((lse.reshape(Bq, H, Lq)[blind] == 0).all()))
    pairs = int(vis.sum().item()) * H
    t, by = bound(4 * D * pairs, (2 * Bq * H * Lq * D + 2 * Bq * H * Lk * D)
                  * 2 + Bq * H * Lq * 4, name, exps=pairs)
    mask = float_mask(Bq, Lq, Lk, causal, kv)
    return dict(
        shape=f"B={Bq} H={H} D={D} {what}", route=FA.fwd_route(D), **res,
        kernel_ms=time_ms(lambda: FA.flash_forward(q, k, v, causal, None, kv),
                          20),
        plain_ms=time_ms(lambda: FA.flash_forward_plain(q, k, v, causal, None,
                                                        kv), 5),
        library_ms=time_ms(lambda: sdpa()(q, k, v, attn_mask=mask), 20),
        bound_ms=t, bound_by=by)


def case_window(gen, name):
    """ViT-H window block: 32 images x 25 windows x 16 heads = 12 800 rows,
    L=196 (14x14), D=80, stacked factors (R, 28, 196), on the route
    ``window_route`` names. q, k and v first as contiguous rows, then
    (``strided``, from its own generator, so no other case's inputs move)
    as the views of one (800, 196, 3 x 16 x 80) qkv tensor that the
    encoder's qkv linear leaves, the layout the serving and training paths
    give the kernel; its output must be a view whose transpose back to
    tokens is contiguous. Each timed by events and by the profiler's device
    time a call."""
    R, hw, L, D, nH = B * V * 25 * 16, (14, 14), 196, 80, 16
    q, k, v = (rand_bf16(gen, (R, L, D)) for _ in range(3))
    f = rand_bf16(gen, (R, 28, L), 0.5)
    got = SA.window_attention(q, k, v, f, hw)
    want = SA.window_attention_plain(q, k, v, f, hw)
    c = torch.arange(L, device="cuda")
    bias = (f[:, c // 14, :] + f[:, 14 + c % 14, :]).transpose(1, 2).contiguous()
    t, by = bound(4 * R * L * L * D, 4 * R * L * D * 2 + R * 28 * L * 2, name)
    res = dict(
        shape="R=12800 L=196 D=80 (ViT-H window block, all 32 images)",
        route=SA.window_route(D, hw), **compare(got, want, atol=WINDOW_ATOL),
        kernel_ms=time_ms(lambda: SA.window_attention(q, k, v, f, hw), 10),
        device_ms=device_ms(lambda: SA.window_attention(q, k, v, f, hw), 5)[0],
        plain_ms=time_ms(lambda: SA.window_attention_plain(q, k, v, f, hw), 3),
        library_ms=time_ms(lambda: sdpa()(q, k, v, attn_mask=bias), 10),
        bound_ms=t, bound_by=by)
    del q, k, v, got, want, bias
    sgen = torch.Generator(device="cuda").manual_seed(3)
    qkv = rand_bf16(sgen, (R // nH, L, 3 * nH * D))
    qs, ks, vs = qkv.view(R // nH, L, 3, nH, D).permute(2, 0, 3, 1, 4).unbind(0)
    got = SA.window_attention(qs, ks, vs, f, hw)
    layout_ok = got.transpose(1, 2).is_contiguous()
    strided = compare(got, SA.window_attention_plain(qs, ks, vs, f, hw),
                      atol=WINDOW_ATOL)
    res["strided"] = dict(
        shape="BW=800 nH=16 L=196 D=80 views of one (800, 196, 3840) qkv "
        "tensor", **strided, out_transpose_contiguous=layout_ok,
        kernel_ms=time_ms(lambda: SA.window_attention(qs, ks, vs, f, hw), 10),
        device_ms=device_ms(lambda: SA.window_attention(qs, ks, vs, f, hw),
                            5)[0])
    res["err_over_limit"] = max(res["err_over_limit"],
                                strided["err_over_limit"])
    res["ok"] = res["ok"] and strided["ok"] and layout_ok
    return res


def case_global(gen, name, hw=(64, 64)):
    """ViT-H global attention, one image's 16 heads (D=80), over the grid
    ``hw``: 64 x 64 (L=4096) as on the main path, or a ragged grid at the
    edges of the wgmma kernel's tiles (25 x 40: L=1000, no multiple of its
    64-key tiles, and W != 64). The plain version over all 512 rows of a
    block would need ~34 GB of f32 logits. At 64 x 64 the kernel is also
    timed over all 512 rows (``kernel_ms_per_block``)."""
    (H, W), D, R = hw, 80, 16
    L = H * W

    def inputs(R):
        q, k, v = (rand_bf16(gen, (R, L, D)) for _ in range(3))
        return q, k, v, rand_bf16(gen, (R, H, L), 0.5), rand_bf16(
            gen, (R, L, W), 0.5)

    def flops_bytes(R):
        return 4 * R * L * L * D, 4 * R * L * D * 2 + R * (H + W) * L * 2

    q, k, v, rh, rw = inputs(R)
    got = SA.rel_attention(q, k, v, rh, rw, hw)
    want = SA.rel_attention_plain(q, k, v, rh, rw, hw)
    c = torch.arange(L, device="cuda")
    bias = (rh[:, c // W, :].transpose(1, 2) + rw[:, :, c % W]).contiguous()
    t, by = bound(*flops_bytes(R), name)
    main = hw == (64, 64)
    out = dict(
        shape=f"R={R} L={L} ({H}x{W}) D={D} " + (
            "(ViT-H global block, one image)" if main else "(ragged grid)"),
        route=SA.rel_route(D), **compare(got, want),
        kernel_ms=time_ms(lambda: SA.rel_attention(q, k, v, rh, rw, hw), 10),
        plain_ms=time_ms(lambda: SA.rel_attention_plain(q, k, v, rh, rw, hw), 3),
        library_ms=time_ms(lambda: sdpa()(q, k, v, attn_mask=bias), 10),
        bound_ms=t, bound_by=by)
    del q, k, v, rh, rw, got, want
    if not main:
        return out
    big = inputs(B * V * 16)
    out["kernel_ms_per_block"] = time_ms(lambda: SA.rel_attention(*big, hw), 3, 1)
    out["bound_ms_per_block"] = bound(*flops_bytes(B * V * 16), name)[0]
    # the yardstick over the block: SDPA with the bias an image (16 rows) a
    # call, every call on one image's bias (its values do not move the time;
    # the block's 32 biases would take 17 GB)
    qb, kb, vb = big[:3]
    out["library_ms_per_block"] = time_ms(lambda: [
        sdpa()(qb[i:i + R], kb[i:i + R], vb[i:i + R], attn_mask=bias)
        for i in range(0, B * V * 16, R)], 1, 1)
    return out


def compare_grad(got, want):
    """A backward kernel's gradient against its plain version. Both
    recompute P from the same logsumexp in f32 and round P and dS to bf16
    as their products' operands, so they differ by the order of f32 sums,
    by a rounding step of P or dS where that order moves a value across a
    bf16 boundary, and by the bf16 output's rounding. Gradients have no
    fixed scale: each element within GRAD_ATOL_OF_RMS of the plain
    gradient's RMS plus RTOL of its magnitude, the RMS error within RMS_TOL
    of the plain RMS, and every element finite."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    rms = w.square().mean().sqrt().clamp_min(1e-30)
    res = {"max_abs_err": err.max().item(),
           "err_over_limit": (err / (GRAD_ATOL_OF_RMS * rms
                                     + RTOL * w.abs())).max().item(),
           "rms_rel_err": (err.square().mean().sqrt() / rms).item(),
           "tol": {"atol_of_rms": GRAD_ATOL_OF_RMS, "rtol": RTOL,
                   "rms_rel": RMS_TOL}}
    res["ok"] = (res["err_over_limit"] <= 1.0 and res["rms_rel_err"] <= RMS_TOL
                 and bool(torch.isfinite(g).all()))
    return res


def float_mask(Bq, Lq, Lk, causal, lens):
    """The explicit float mask (B, 1, Lq, Lk) equal to the kernels' masking,
    for the SDPA yardstick; None where nothing is masked."""
    if not causal and lens is None:
        return None
    vis = FA._visible(Bq, Lq, Lk, causal, lens, "cuda")
    return torch.where(vis, 0.0, float("-inf")).to(torch.bfloat16)


def compare_dsum(got, do, o):
    """The dq kernel's D = rowsum(dO O) against the f32 torch rowsum of the
    same bf16 inputs. Each product of two bf16 values is exact in f32, so
    the two differ only in the order of their f32 additions: each element
    within 2 D 2^-24 of the sum of the magnitudes of its terms, the bound
    of any two orders of D additions."""
    prod = do.float() * o.float()
    want = prod.sum(-1).reshape(got.shape)
    limit = (2 * do.shape[-1] * 2.0 ** -24
             * prod.abs().sum(-1).reshape(got.shape)).clamp_min(1e-30)
    err = (got - want).abs()
    over = (err / limit).max().item()
    return {"dsum_max_abs_err": err.max().item(), "dsum_err_over_limit": over,
            "dsum_ok": over <= 1.0 and bool(torch.isfinite(got).all())}


def case_flash_bwd(gen, name, what, Bq, H, Lq, Lk, D, causal, lens):
    """Kernels 4 and 5 at one shape: (dq, dk, dv) from the port's forward
    against ``flash_backward_plain``, the dq kernel's D against the torch
    rowsum (``compare_dsum``) where the first launch writes D, and what a
    ``flash_backward`` call runs on the card (only its kernels, no torch
    operation). At head dim 16 q, k, v and dO are the (B, H, L, 16) views
    of (B, L, H, 16) tensors that the training path hands the backward, o
    the forward's view, and dq, dk, dv come back as views (``views``: their
    transposes are contiguous); ``old_copies_ms`` times the copies the
    mma.sync route's call made around the kernels (q, k, v, o and dO made
    contiguous, dq, dk and dv copied back to tokens). Times: the first
    launch (the one pass, or the dq kernel with D) and the second (the
    partials' reduce, or the dk/dv kernel) alone, by CUDA events and by
    device time, the whole backward, the plain version, and, as the library
    yardstick the port never calls, SDPA's backward alone and SDPA forward
    + backward with the same explicit float mask against the port's flash
    forward + backward. ``route`` is ``bwd_route(D)``; ``plan`` the head
    dim 16 route's ``d16_bwd_plan`` (``dkv_split`` the mma.sync dk/dv
    kernel's). Bounds count this run's visible (query, key) pairs, each
    for the launch it is set beside (``dq_bound_ms`` the first,
    ``dkv_bound_ms`` the second): the dq kernel recomputes S and dP and
    forms dQ (6 D flops a pair) over q, k, v, dO, O, lse and dq, D; the
    dk/dv kernel recomputes S and dP and forms dV and dK (8) over q, k, v,
    dO, lse, D and dk, dv; the one pass does the whole backward's 10 (S,
    dP, dV, dK, dQ) over q, k, v, o, dO, lse and dq and its 16 x 16
    partials; the partials' reduce adds its runs' partials of the Lk keys
    in f32 and writes dk, dv; the whole backward needs 10 over q, k, v, o,
    dO, lse and dq, dk, dv; each but the reduce one exponential a pair
    (P). ``vs_f64`` holds the kernels' and the plain version's distance
    from the exact gradient (the plain version in f64, which rounds
    neither P nor dS) in ``compare_grad``'s units: not a check, it says
    which side of a failed comparison is off."""
    views = D == FA.VIEW_HEAD_DIM

    def heads(L):
        if views:
            return rand_bf16(gen, (Bq, L, H, D)).transpose(1, 2)
        return rand_bf16(gen, (Bq, H, L, D))

    q, do = heads(Lq), heads(Lq)
    k, v = heads(Lk), heads(Lk)
    kv = (None if lens is None
          else torch.tensor(lens, dtype=torch.int32, device="cuda"))
    o, lse = FA.flash_forward(q, k, v, causal, None, kv)
    got = FA.flash_backward(q, k, v, o, lse, do, causal, None, kv)
    want = FA.flash_backward_plain(q, k, v, o, lse, do, causal, None, kv)
    cmp = {n: compare_grad(g, w) for n, g, w in zip(("dq", "dk", "dv"),
                                                    got, want)}
    if views:
        cmp["dq"]["views"] = all(g.transpose(1, 2).is_contiguous()
                                 for g in got)
        cmp["dq"]["ok"] = cmp["dq"]["ok"] and cmp["dq"]["views"]
    exact = FA.flash_backward_plain(*(t.double() for t in (q, k, v, o, lse,
                                                          do)), causal,
                                    None, kv)
    vs_f64 = {n: {side: {m: compare_grad(x, e)[m]
                         for m in ("err_over_limit", "rms_rel_err")}
                  for side, x in (("kernel", g), ("plain", w))}
              for n, g, w, e in zip(("dq", "dk", "dv"), got, want, exact)}
    del got, exact
    scale = D ** -0.5
    _, carry = FA.flash_bwd_dq(q, k, v, do, o, lse, causal, scale, kv)
    if carry.shape == lse.shape:  # the first launch writes D
        cmp["dq"].update(compare_dsum(carry, do, o))
        cmp["dq"]["ok"] = cmp["dq"]["ok"] and cmp["dq"]["dsum_ok"]
    # what a flash_backward call runs on the card: its kernels and nothing
    # else (no torch operation; an empty trace shows nothing either way)
    launched = device_ms_by_name(lambda: FA.flash_backward(
        q, k, v, o, lse, do, causal, None, kv), 10)
    cmp["dq"]["backward_runs_only_its_kernels"] = all(
        "flash_bwd_" in n for n in launched)
    cmp["dq"]["ok"] = (cmp["dq"]["ok"]
                       and cmp["dq"]["backward_runs_only_its_kernels"])
    pairs = int(FA._visible(Bq, Lq, Lk, causal, kv, "cuda").sum().item()) * H
    BH = Bq * H
    qb, kb, rows = BH * Lq * D * 2, BH * Lk * D * 2, BH * Lq * 4
    plan = FA.d16_bwd_plan_on_card(Bq, H, Lq, Lk) if views else None
    if plan is not None and plan.fused:
        part = plan.runs * BH * 2 * 16 * 16 * 4  # written whole a CTA
        read = plan.runs * BH * 2 * Lk * 16  # the reduce's f32 values
        dq_t = bound(10 * D * pairs, 3 * qb + 2 * kb + rows + qb + part,
                     name, exps=pairs)
        dkv_t = bound(read, 4 * read + 2 * kb, name, f32=True)
    else:
        dq_t = bound(6 * D * pairs, 3 * qb + 2 * kb + 2 * rows + qb, name,
                     exps=pairs)
        dkv_t = bound(8 * D * pairs, 2 * qb + 2 * kb + 2 * rows + 2 * kb,
                      name, exps=pairs)
    bwd_t = bound(10 * D * pairs, 3 * qb + 2 * kb + rows + qb + 2 * kb, name,
                  exps=pairs)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    mask = float_mask(Bq, Lq, Lk, causal, kv)
    lib_out = sdpa()(*leaves, attn_mask=mask)

    def port_fwd_bwd():
        out = FA.flash_attention(*leaves, causal=causal, kv_lengths=kv)
        return torch.autograd.grad(out, leaves, do)

    def lib_fwd_bwd():
        return torch.autograd.grad(sdpa()(*leaves, attn_mask=mask), leaves,
                                   do)

    def first():
        return FA.flash_bwd_dq(q, k, v, do, o, lse, causal, scale, kv)

    def second():
        return FA.flash_bwd_dkv(q, k, v, do, lse, carry, causal, scale, kv)

    route = FA.bwd_route(D)
    out = dict(
        shape=what, route=route,
        dkv_split=FA.dkv_split(Lq, Lk) if route == "mma" else (1, None),
        dq=cmp["dq"], dk=cmp["dk"], dv=cmp["dv"], vs_f64=vs_f64,
        dq_ms=time_ms(first, 20), dkv_ms=time_ms(second, 20),
        dq_device_ms=device_ms(first, 20)[0],
        dkv_device_ms=device_ms(second, 20)[0],
        # [device ms, launches] a call by kernel: the split's reduce pass
        dkv_device_ms_by_kernel=device_ms_by_name(second, 20),
        backward_ms=time_ms(lambda: FA.flash_backward(
            q, k, v, o, lse, do, causal, None, kv), 20),
        backward_device_ms_by_kernel=launched,
        plain_ms=time_ms(lambda: FA.flash_backward_plain(
            q, k, v, o, lse, do, causal, None, kv), 3),
        library_ms=time_ms(lambda: torch.autograd.grad(
            lib_out, leaves, do, retain_graph=True), 10),
        library="SDPA backward (dq, dk and dv together)",
        port_fwd_bwd_ms=time_ms(port_fwd_bwd, 10),
        library_fwd_bwd_ms=time_ms(lib_fwd_bwd, 10),
        # ten calls each: a library kernel that runs twice a call must not
        # halve the count
        port_fwd_bwd_device_ms_by_kernel=device_ms_by_name(port_fwd_bwd, 10,
                                                           calls=10),
        library_fwd_bwd_device_ms=device_ms(lib_fwd_bwd, 10, calls=10)[0],
        library_device_ms=device_ms(lambda: torch.autograd.grad(
            lib_out, leaves, do, retain_graph=True), 10, calls=10)[0],
        dq_bound_ms=dq_t[0], dq_bound_by=dq_t[1],
        dkv_bound_ms=dkv_t[0], dkv_bound_by=dkv_t[1],
        backward_bound_ms=bwd_t[0], backward_bound_by=bwd_t[1],
        visible_pairs=pairs)
    if views:
        out["plan"] = plan._asdict()

        def old_copies():
            # the mma.sync route's call: contiguous q, k, v, o and dO in,
            # dq, dk and dv (contiguous (B, H, L, 16)) copied back to tokens
            for t in (q, k, v, o, do):
                t.contiguous()
            for L in (Lq, Lk, Lk):
                torch.empty(Bq, H, L, D, dtype=q.dtype, device="cuda"
                            ).transpose(1, 2).contiguous()

        out["old_copies_ms"] = time_ms(old_copies, 20)
        out["old_copies_device_ms"] = device_ms(old_copies, 10)[0]
    return out


# Head dim 16 at the edges of the backward's plan: the one pass at Lk <= 16
# (Lk 9, an odd head count: one head a CTA), the two kernels past it
# (17: one 32-key tile; 130: three of 48; 520: nine of 64 and nine 64-key
# dk/dv CTAs; 1100: eighteen of 64, past the resident K/V budget, so the dq
# kernel streams K and V through its ring), Lq off the 128-row tiles,
# causal with Lq != Lk both ways, kv lengths 0 and 1: (what, B, H, Lq, Lk,
# causal, kv lengths)
FLASH_D16_BWD_EDGE_CASES = [
    ("Lq=257 Lk=9 causal, H=3: 248 rows see no key", 1, 3, 257, 9, True,
     None),
    ("Lq=200 Lk=9, kv lengths 0, 1 and 9", 3, 4, 200, 9, False, (0, 1, 9)),
    ("Lq=300 Lk=17 causal", 1, 2, 300, 17, True, None),
    ("Lq=70 Lk=130 causal, kv lengths 130 and 1", 2, 2, 70, 130, True,
     (130, 1)),
    ("Lq=200 Lk=130, kv length 0", 1, 2, 200, 130, False, (0,)),
    ("Lq=1000 Lk=520, kv length 520", 1, 2, 1000, 520, False, (520,)),
    ("Lq=300 Lk=1100: K and V streamed", 1, 2, 300, 1100, False, None),
    ("Lq=300 Lk=1100 causal, kv lengths 1100 and 700: K and V streamed", 2,
     2, 300, 1100, True, (1100, 700)),
]


def case_flash_bwd_edge(gen, what, Bq, H, Lq, Lk, causal, lens):
    """One head-dim-16 backward edge case on the training path's views:
    each gradient against ``flash_backward_plain`` (``compare_grad``) and
    exact zeros where no row sees a key or a row sees none; returns one row
    for each of the two launches' kernels."""
    def heads(L):
        return rand_bf16(gen, (Bq, L, H, 16)).transpose(1, 2)

    q, do, k, v = heads(Lq), heads(Lq), heads(Lk), heads(Lk)
    kv = (None if lens is None
          else torch.tensor(lens, dtype=torch.int32, device="cuda"))
    o, lse = FA.flash_forward(q, k, v, causal, None, kv)
    got = FA.flash_backward(q, k, v, o, lse, do, causal, None, kv)
    want = FA.flash_backward_plain(q, k, v, o, lse, do, causal, None, kv)
    cmp = {n: compare_grad(g, w) for n, g, w in zip(("dq", "dk", "dv"),
                                                    got, want)}
    vis = FA._visible(Bq, Lq, Lk, causal, kv, "cuda")[:, 0]
    blind = ~vis.any(-1)  # (B, Lq)
    unseen = ~vis.any(-2)  # (B, Lk)
    cmp["dq"]["blind_rows_zero"] = bool(
        (got[0].transpose(1, 2)[blind] == 0).all())
    for n, g in zip(("dk", "dv"), got[1:]):
        cmp[n]["unseen_keys_zero"] = bool(
            (g.transpose(1, 2)[unseen] == 0).all())
    for n, c in cmp.items():
        c["ok"] = (c["ok"] and c.get("blind_rows_zero", True)
                   and c.get("unseen_keys_zero", True))
    shape = f"B={Bq} H={H} {what} D=16 (views)"
    plan = FA.d16_bwd_plan_on_card(Bq, H, Lq, Lk)._asdict()
    worst = max(cmp["dk"], cmp["dv"], key=lambda c: c["err_over_limit"])
    return ({"shape": shape, "route": FA.bwd_route(16), "plan": plan,
             **cmp["dq"]},
            {"shape": shape, "route": FA.bwd_route(16), "plan": plan,
             **worst, "ok": cmp["dk"]["ok"] and cmp["dv"]["ok"]})


def bwd_rows(case, which):
    """One backward case as the row of one kernel: ``dq`` or ``dkv``."""
    if which == "dq":
        worst = case["dq"]
    else:
        worst = max(case["dk"], case["dv"], key=lambda c: c["err_over_limit"])
    return dict(shape=case["shape"], route=case["route"], **worst,
                kernel_ms=case[f"{which}_ms"],
                backward_ms=case["backward_ms"], plain_ms=case["plain_ms"],
                library_ms=case["library_ms"],
                bound_ms=case[f"{which}_bound_ms"],
                bound_by=case[f"{which}_bound_by"])


# (what, M, K, N, bias, activation, calls per streaming / cached batch of
# the 7B-int8 path): the SAM ViT-H encoder over 32 views (window blocks
# partition 32 x 64 x 64 tokens into 32 x 25 windows of 196), LLaMA-7B
# prefill of 8 x 319 tokens, and decode at B=8 (streaming) and B=32 (cached)
SAM_WIN, SAM_TOK, PREFILL = B * V * 25 * 196, B * V * 64 * 64, B * (L_TEXT - 1 + 256)
INT8_CASES = [
    ("SAM qkv, window blocks", SAM_WIN, 1280, 3840, True, "none", (28, 0)),
    ("SAM qkv, global blocks", SAM_TOK, 1280, 3840, True, "none", (4, 0)),
    ("SAM proj, window blocks", SAM_WIN, 1280, 1280, True, "none", (28, 0)),
    ("SAM proj, global blocks", SAM_TOK, 1280, 1280, True, "none", (4, 0)),
    ("SAM lin1 + tanh GELU", SAM_TOK, 1280, 5120, True, "gelu_tanh", (32, 0)),
    ("SAM lin2", SAM_TOK, 5120, 1280, True, "none", (32, 0)),
    ("LLaMA-7B prefill q/k/v/o", PREFILL, 4096, 4096, False, "none", (128, 0)),
    ("LLaMA-7B prefill gate/up", PREFILL, 4096, 11008, False, "none", (64, 0)),
    ("LLaMA-7B prefill down", PREFILL, 11008, 4096, False, "none", (32, 0)),
    ("LLaMA-7B prefill q/k/v/o, cached B=32", 4 * PREFILL, 4096, 4096, False,
     "none", (0, 128)),
    ("LLaMA-7B prefill gate/up, cached B=32", 4 * PREFILL, 4096, 11008, False,
     "none", (0, 64)),
    ("LLaMA-7B prefill down, cached B=32", 4 * PREFILL, 11008, 4096, False,
     "none", (0, 32)),
    ("LLaMA-7B decode q/k/v/o, B=8", B, 4096, 4096, False, "none",
     (128 * (T - 1), 0)),
    ("LLaMA-7B decode gate/up, B=8", B, 4096, 11008, False, "none",
     (64 * (T - 1), 0)),
    ("LLaMA-7B decode down, B=8", B, 11008, 4096, False, "none",
     (32 * (T - 1), 0)),
    ("LLaMA-7B lm_head, B=8", B, 4096, 32000, False, "none", (T, 0)),
    ("LLaMA-7B decode q/k/v/o, B=32", 32, 4096, 4096, False, "none",
     (0, 128 * (T - 1))),
    ("LLaMA-7B decode gate/up, B=32", 32, 4096, 11008, False, "none",
     (0, 64 * (T - 1))),
    ("LLaMA-7B decode down, B=32", 32, 11008, 4096, False, "none",
     (0, 32 * (T - 1))),
    ("LLaMA-7B lm_head, B=32", 32, 4096, 32000, False, "none", (0, T)),
    # the two routes where they meet: N ragged against the GEMM's 256-column
    # tile, K against its 128-byte chunk
    ("route threshold, one launch", Q.ONE_LAUNCH_MAX_ROWS, 160, 136, True,
     "gelu_tanh", None),
    ("route threshold, two passes", Q.ONE_LAUNCH_MAX_ROWS + 1, 160, 136,
     True, "gelu_tanh", None),
]
# kernel 6 on the 7B QLoRA step (bf16 x, M = B x 512 rows, forward and
# remat: 64 calls a step for gate/up, 32 for down)
NEW_PATH_INT8_CASES = [
    ("LLaMA-7B QLoRA training gate/up", B * 512, 4096, 11008, False, "none",
     None),
    ("LLaMA-7B QLoRA training down", B * 512, 11008, 4096, False, "none",
     None),
]
# the int4 matmul on the 7B-int4 path (what, M, K, N, calls per streaming
# and cached batch): decode at B=8 (streaming) and B=32 (cached) and the
# lm_head (the decode kernel), the prefill's MLP (two passes)
INT4_CASES = [
    ("LLaMA-7B int4 decode q/k/v/o, B=8", B, 4096, 4096, (128 * (T - 1), 0)),
    ("LLaMA-7B int4 decode gate/up, B=8", B, 4096, 11008, (64 * (T - 1), 0)),
    ("LLaMA-7B int4 decode down, B=8", B, 11008, 4096, (32 * (T - 1), 0)),
    ("LLaMA-7B int4 lm_head, B=8", B, 4096, 32000, (T, 0)),
    ("LLaMA-7B int4 decode q/k/v/o, B=32", B_CACHED_INT8, 4096, 4096,
     (0, 128 * (T - 1))),
    ("LLaMA-7B int4 decode gate/up, B=32", B_CACHED_INT8, 4096, 11008,
     (0, 64 * (T - 1))),
    ("LLaMA-7B int4 decode down, B=32", B_CACHED_INT8, 11008, 4096,
     (0, 32 * (T - 1))),
    ("LLaMA-7B int4 lm_head, B=32", B_CACHED_INT8, 4096, 32000, (0, T)),
    ("LLaMA-7B int4 prefill gate/up", PREFILL, 4096, 11008, (64, 0)),
    ("LLaMA-7B int4 prefill down", PREFILL, 11008, 4096, (32, 0)),
]
# the row-parallel int4 linear on one of 2 model ranks: 7B's down at decode
# (its K halved; the half's K / 2 = 2752 packed bytes ragged against the
# 128-byte chunk)
INT4_ROW_PARALLEL_CASES = [
    ("LLaMA-7B int4 decode down, B=8, one of 2 model ranks", B, 5504, 4096),
]


def compare_int8(got, want):
    """The int8 kernel against its plain version, element-wise: both share
    the quantization of x and an exact integer sum and round the rescale,
    bias and GELU alike in f32 (erff against torch.erf), so each element
    within one bf16 rounding step, 2^-7 of its magnitude, plus 1e-6 of the
    output's largest magnitude for the GELU near zero."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    limit = INT8_RTOL * w.abs() + INT8_ATOL_OF_MAX * w.abs().max()
    res = {"max_abs_err": err.max().item(),
           "err_over_limit": (err / limit.clamp_min(1e-30)).max().item(),
           "rms_rel_err": (err.square().mean()
                           / w.square().mean().clamp_min(1e-30)).sqrt().item(),
           "tol": {"rtol": INT8_RTOL, "atol_of_max": INT8_ATOL_OF_MAX}}
    res["ok"] = res["err_over_limit"] <= 1.0 and bool(torch.isfinite(g).all())
    return res


def case_int8(gen, name, what, M, K, N, with_bias, act, calls,
              x_dtype=torch.bfloat16):
    """One int8 matmul shape of the 7B-int8 or int4 path (``calls`` per
    streaming and cached batch) or of the QLoRA step, the chain probe or
    the route threshold (``calls`` None): x in ``x_dtype`` (bf16; the int4
    path's f32), random int8 W with per-column scales of the init's
    magnitude. ``route`` is the wrapper's route at M; on the
    two-pass route each pass is also timed alone (``quantize_ms``,
    ``gemm_ms``). Library
    yardsticks: ``torch._int_mm`` on the pre-quantized operands (int32 out,
    no quantization or epilogue; it refuses M <= 16, where the bf16
    ``F.linear`` is the library call) and a bf16 ``F.linear`` at the same
    shape; the port calls neither."""
    x = rand_bf16(gen, (M, K)).to(x_dtype)
    w = torch.randint(-127, 128, (N, K), generator=gen, device="cuda",
                      dtype=torch.int8)
    scale = torch.full((N,), 1.0 / (127.0 * K ** 0.5), device="cuda")
    bias = rand_bf16(gen, (N,), 0.1).float() if with_bias else None
    # the int4 path writes the layer dtype from f32 x
    out_dtype = torch.bfloat16
    got = Q.int8_matmul_fused(x, w, scale, bias, act, out_dtype)
    want = Q.int8_matmul_fused_plain(x, w, scale, bias, act, out_dtype)
    res = compare_int8(got, want)
    del got, want
    big = M * K * N > 1e11
    kernel_ms = time_ms(lambda: Q.int8_matmul_fused(
        x, w, scale, bias, act, out_dtype), 10 if big else 50)
    dev_ms, launched = device_ms(lambda: Q.int8_matmul_fused(
        x, w, scale, bias, act, out_dtype), 5 if big else 20)
    plain_ms = time_ms(lambda: Q.int8_matmul_fused_plain(
        x, w, scale, bias, act, out_dtype), 2, 1)
    nbytes = (x.element_size() * M * K + N * K
              + 4 * N * (2 if with_bias else 1) + 2 * M * N)
    t, by = bound(2 * M * K * N, nbytes, name, int8=True)
    lib = lib_dev = None
    library = "torch._int_mm (int32 product only)"
    if M > 16:
        xq = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                           dtype=torch.int8)
        lib = time_ms(lambda: torch._int_mm(xq, w.t()), 10 if big else 50)
        lib_dev = device_ms(lambda: torch._int_mm(xq, w.t()),
                            5 if big else 20)[0]
        del xq
    route = Q.int8_route(M, K)
    passes = {}
    if route == "two_pass":
        xq, xs = Q.quantize_rows(x)
        passes["quantize_ms"] = time_ms(lambda: Q.quantize_rows(x),
                                        10 if big else 50)
        passes["gemm_ms"] = time_ms(lambda: Q.int8_gemm(
            xq, xs, w, scale, bias, act, out_dtype), 10 if big else 50)
        del xq, xs
    wb, xb = rand_bf16(gen, (N, K)), x.to(torch.bfloat16)
    linear_ms = time_ms(lambda: torch.nn.functional.linear(xb, wb),
                        10 if big else 50)
    linear_dev = device_ms(lambda: torch.nn.functional.linear(xb, wb),
                           5 if big else 20)[0]
    if M <= 16:  # _int_mm refuses these rows: the bf16 product is the call
        lib, lib_dev = linear_ms, linear_dev
        library = "bf16 F.linear (torch._int_mm refuses M <= 16)"
    return dict(shape=f"{what}: M={M} K={K} N={N}"
                f"{' f32 x' if x_dtype == torch.float32 else ''}"
                f"{' +bias' if with_bias else ''}"
                f"{' +' + act if act != 'none' else ''}",
                route=route,
                calls_per_batch=({"streaming": calls[0], "cached": calls[1]}
                                 if calls else None),
                **res, kernel_ms=kernel_ms, device_ms=dev_ms,
                device_launches_per_call=launched, **passes,
                plain_ms=plain_ms, library_ms=lib, library_device_ms=lib_dev,
                library=library,
                bf16_linear_ms=linear_ms, bf16_linear_device_ms=linear_dev,
                bound_ms=t, bound_by=by)


def int4_inputs(gen, M, K, N):
    """bf16 rows with ties (``rows_with_ties``), a random packed int4 weight
    (every byte, so every nibble value -8..7 in both halves), per-column
    scales of the init's magnitude and a row factor in [0.5, 1.5), 1 on the
    columns of row 1's ties so that they stay ties."""
    x = rows_with_ties(gen, M, K)
    packed = torch.randint(-128, 128, (N, K // 2), generator=gen,
                           device="cuda", dtype=torch.int8)
    cs = torch.full((N,), 1.0 / (7.0 * K ** 0.5), device="cuda")
    rf = torch.rand(K, generator=gen, device="cuda") + 0.5
    rf[:len(TIES)] = 1.0
    return x, packed, cs, rf


def case_int4(gen, name, what, M, K, N, calls):
    """The int4 matmul (``ops/int4_matmul.py:int4_matmul_fused``) at one of
    the 7B-int4 path's shapes (``calls`` per streaming and cached batch),
    bf16 x as the path gives it (``int4_inputs``): bit for bit against its
    plain version and against the route the card took before it (the
    unpack into an (N, K) int8 copy, then kernel 6 on f32 x * rf), each
    timed by events and by the profiler's device time a call; on the
    two-pass route each pass alone too. The bound: x, the packed bytes,
    the scales and the row factor read once and the bf16 output written
    once, against the int8 operations 2 M K N; ``int8_weight_bound_ms`` is
    the same with int8 weight bytes. Library yardstick: a bf16 ``F.linear``
    at the shape (no library call reads int4 nibbles); the port calls it
    nowhere. At decode (the decode kernel) the kernel and the yardstick are
    also timed with their weights cycled past the L2
    (``cycled_device_ms``, ``library_cycled_device_ms``), as a decode step
    streams them; the warm times read a weight the L2 holds."""
    x, packed, cs, rf = int4_inputs(gen, M, K, N)

    def kernel():
        return Q4.int4_matmul_fused(x, packed, cs, rf, torch.bfloat16)

    def unpack_route():
        return Q4.int4_matmul_unpack_route(x, packed, cs, rf, torch.bfloat16)

    got = kernel()
    res = compare_exact([got], [Q4.int4_matmul_fused_plain(
        x, packed, cs, rf, torch.bfloat16)])
    res["equals_unpack_route"] = torch.equal(got, unpack_route())
    res["ok"] = res["ok"] and res["equals_unpack_route"]
    del got
    big = M * K * N > 1e11
    it, dit = (10, 5) if big else (50, 20)
    dev_ms, launched = device_ms(kernel, dit)
    # the unpack route runs its elementwise kernel several times a call
    old_dev, old_launched = device_ms(unpack_route, dit, calls=dit)
    route = Q4.int4_route(M, K)
    passes = {}
    wb = rand_bf16(gen, (N, K))
    if route == "two_pass":
        xq, xs = Q.quantize_rows(x, rf)
        passes["quantize_ms"] = time_ms(lambda: Q.quantize_rows(x, rf), it)
        passes["gemm_ms"] = time_ms(lambda: Q4.int4_gemm(xq, xs, packed, cs),
                                    it)
        passes["gemm_device_ms"] = device_ms(
            lambda: Q4.int4_gemm(xq, xs, packed, cs), dit)[0]
        del xq, xs
    else:
        nxt = _cycled(lambda: (torch.randint(
            -128, 128, (N, K // 2), generator=gen, device="cuda",
            dtype=torch.int8), cs, rf), N * K // 2)
        passes["cycled_device_ms"] = device_ms(
            lambda: Q4.int4_matmul_fused(x, *nxt(), torch.bfloat16), dit)[0]
        passes["plan"] = Q4.decode_plan_on_card(M, N, K, 0)
        del nxt
        nxt = _cycled(lambda: rand_bf16(gen, (N, K)), 2 * N * K)
        passes["library_cycled_device_ms"] = device_ms(
            lambda: F.linear(x, nxt()), dit)[0]
        del nxt
    small = 2 * M * K + 4 * K + 4 * N + 2 * M * N
    t, by = bound(2 * M * K * N, small + N * K // 2, name, int8=True)
    return dict(shape=f"{what}: M={M} K={K} N={N} bf16 x", route=route,
                calls_per_batch={"streaming": calls[0], "cached": calls[1]},
                **res, kernel_ms=time_ms(kernel, it), device_ms=dev_ms,
                device_launches_per_call=launched, **passes,
                unpack_route_ms=time_ms(unpack_route, it),
                unpack_route_device_ms=old_dev,
                unpack_route_launches_per_call=old_launched,
                plain_ms=time_ms(lambda: Q4.int4_matmul_fused_plain(
                    x, packed, cs, rf, torch.bfloat16), 2, 1),
                library_ms=time_ms(lambda: F.linear(x, wb), it),
                library_device_ms=device_ms(lambda: F.linear(x, wb), dit)[0],
                library="bf16 F.linear (no library call reads int4 nibbles)",
                bound_ms=t, bound_by=by,
                int8_weight_bound_ms=bound(2 * M * K * N, small + N * K, name,
                                           int8=True)[0])


def case_int4_row_parallel(gen, name, what, M, K, N):
    """The row-parallel int4 linear's partial product on one model rank
    (``ops/quant.py:_row_partial`` with a row factor): kernel 7's
    given-scale route with the row factor on this rank's slice of each row
    (its given absmax spans a wider row: 1.5 times the slice's own), then
    the int4 GEMM to f32; bit for bit against the plain versions and
    against the unpack route (kernel 7 on f32 x * rf, then the int8 GEMM on
    the unpacked weight), both timed. Yardstick: a bf16 ``F.linear``."""
    x, packed, cs, rf = int4_inputs(gen, M, K, N)
    amax = ((x.float() * rf).abs().amax(-1) * 1.5).contiguous()

    def kernel():
        xq, xs = Q.quantize_rows_given(x, amax, rf)
        return Q4.int4_gemm(xq, xs, packed, cs, torch.float32)

    def unpack_route():
        xq, xs = Q.quantize_rows_given((x.float() * rf).contiguous(), amax)
        return Q.int8_gemm(xq, xs, Q4.unpacked(packed), cs,
                           dtype=torch.float32)

    got = kernel()
    xq, xs = Q.quantize_rows_given_plain(x, amax, rf)
    res = compare_exact([got], [Q4.int4_gemm_plain(xq, xs, packed, cs,
                                                   torch.float32)])
    res["equals_unpack_route"] = torch.equal(got, unpack_route())
    res["ok"] = res["ok"] and res["equals_unpack_route"]
    del got, xq, xs
    t, by = bound(2 * M * K * N, 2 * M * K + N * K // 2 + 4 * K + 4 * M
                  + 4 * N + 4 * M * N, name, int8=True)
    wb = rand_bf16(gen, (N, K))
    return dict(shape=f"{what}: M={M} K={K} N={N} bf16 x, f32 out",
                route="row_parallel", **res,
                kernel_ms=time_ms(kernel, 50), device_ms=device_ms(kernel,
                                                                   20)[0],
                unpack_route_ms=time_ms(unpack_route, 50),
                unpack_route_device_ms=device_ms(unpack_route, 20,
                                                 calls=20)[0],
                plain_ms=time_ms(lambda: Q4.int4_gemm_plain(
                    *Q.quantize_rows_given_plain(x, amax, rf), packed, cs,
                    torch.float32), 2, 1),
                library_ms=time_ms(lambda: F.linear(x, wb), 50),
                library="bf16 F.linear", bound_ms=t, bound_by=by)


FUSION_SHAPE = "B=32 H=8 Lq=4096 Lk=512 D=16 (fusion, full width)"


def kernel_phase(name):
    gen = torch.Generator(device="cuda").manual_seed(0)
    L_serve, lens = L_TEXT - 1 + 256, train_kv_lengths()
    cases = {"flash_attention": [
                 case_flash_prefill(gen, name, L_serve, (L_serve,) * B,
                                    "B=8 H=40 L=319 D=128 causal kv_lengths "
                                    "(LLaMA prefill, 1 layer)"),
                 case_flash_sam(gen, name),
                 case_flash_prefill(gen, name, 512, lens,
                                    "B=8 H=40 L=512 D=128 causal, kv lengths "
                                    f"{lens} (LLaMA-13B training, 1 layer)")],
             "window_attention": [case_window(gen, name)],
             # the ragged grid from its own generator, so no other case's
             # inputs move
             "rel_attention": [
                 case_global(gen, name),
                 case_global(torch.Generator(device="cuda").manual_seed(2),
                             name, (25, 40))]}
    torch.cuda.empty_cache()
    bwd = [case_flash_bwd(gen, name, "B=8 H=40 L=512 D=128 causal, kv "
                          f"lengths {lens} (LLaMA-13B training, 1 layer)",
                          B, 40, 512, 512, 128, True, lens),
           case_flash_bwd(gen, name, "B=32 H=8 Lq=4096 Lk=9 D=16 (SAM "
                          "decoder image->token, training)", B * V, 8, 4096,
                          9, 16, False, None),
           # the training shape again on a second draw from its own
           # generator, so no other case's inputs move
           case_flash_bwd(torch.Generator(device="cuda").manual_seed(1), name,
                          "B=8 H=40 L=512 D=128 causal, kv lengths "
                          f"{lens} (LLaMA-13B training, second draw)",
                          B, 40, 512, 512, 128, True, lens)]
    # the fusion's attention at full width (training runs its backward),
    # from its own generator, so no other case's inputs move
    bwd.append(case_flash_bwd(
        torch.Generator(device="cuda").manual_seed(3), name,
        FUSION_SHAPE + ", training", B * V, 8, 4096, 512, 16, False, None))
    for c in bwd:
        log(json.dumps({"name": "flash_attention_bwd", **c}))
    for which in ("dq", "dkv"):
        cases[f"flash_attention_bwd_{which}"] = [bwd_rows(c, which)
                                                 for c in bwd]
    torch.cuda.empty_cache()
    cases["int8_matmul"] = []
    for c in INT8_CASES + NEW_PATH_INT8_CASES:
        cases["int8_matmul"].append(case_int8(gen, name, *c))
        torch.cuda.empty_cache()
    # from its own generator, so no other case's inputs move
    gen4 = torch.Generator(device="cuda").manual_seed(7)
    cases["int4_matmul"] = []
    for c in INT4_CASES:
        cases["int4_matmul"].append(case_int4(gen4, name, *c))
        torch.cuda.empty_cache()
    cases["int4_matmul"] += [case_int4_row_parallel(gen4, name, *c)
                             for c in INT4_ROW_PARALLEL_CASES]
    # drawn last, so every earlier case keeps its inputs
    cases["flash_attention"] += [case_flash_edge(gen, name, *c)
                                 for c in FLASH_EDGE_CASES]
    # the head-dim-16 backward at its plan's edges, from a generator of its
    # own
    gen_bwd16 = torch.Generator(device="cuda").manual_seed(10)
    for c in FLASH_D16_BWD_EDGE_CASES:
        dq_row, dkv_row = case_flash_bwd_edge(gen_bwd16, *c)
        cases["flash_attention_bwd_dq"].append(dq_row)
        cases["flash_attention_bwd_dkv"].append(dkv_row)
    cases["flash_attention"].append(case_flash_sam(
        torch.Generator(device="cuda").manual_seed(4), name, 512,
        FUSION_SHAPE))
    cases["flash_attention"].append(case_flash_norel(
        torch.Generator(device="cuda").manual_seed(6), name))
    # head dim 16 on the projections' views, then at its tiles' edges, each
    # from a generator of its own
    cases["flash_attention"].append(case_flash_sam_views(
        torch.Generator(device="cuda").manual_seed(8), name))
    gen16 = torch.Generator(device="cuda").manual_seed(9)
    cases["flash_attention"] += [case_flash_edge(gen16, name, *c, D=16)
                                 for c in FLASH_D16_EDGE_CASES]
    torch.cuda.empty_cache()
    tp_cases(name, cases, lens)
    for kname, rows in cases.items():
        for row in rows:
            log(json.dumps({"name": kname, **row}))
            if not row["ok"]:
                raise SystemExit(f"{kname} disagrees with its plain version "
                                 f"at {row['shape']}: {row}")
    torch.cuda.empty_cache()
    return cases


# --------------------------------------------------------------- probe kernels
# the chain probe's shapes: the ViT-H MLP's two matmuls over 32 768 rows
CHAIN_M, CHAIN_K, CHAIN_N = 32768, 1280, 5120
# kernel 9 vs plain version, element-wise (see compare_dense)
DENSE_RTOL, DENSE_ATOL_OF_RMS, DENSE_RMS_TOL = 2.0 ** -7, 1e-3, 2.0 ** -8
# kernel 11 vs plain version: bf16 and f32 within MXU_TOL_OF_MAX of the
# largest output, at a loop count whose int8 sums stay exact in f32
MXU_TOL_OF_MAX, MXU_CHECK_LOOPS, MXU_TIME_LOOPS = 1e-5, 4, 2048
TIES = [127.0, 2.5, 3.5, -2.5, 0.5, 1.5, -0.5, 126.5, -127.0]


def compare_exact(got, want):
    """Outputs that must be bit for bit equal: each pair of tensors."""
    errs = [max_err(g, w) for g, w in zip(got, want)]
    ok = all(torch.equal(g, w) for g, w in zip(got, want))
    return {"max_abs_err": max(errs), "err_over_limit": 0.0 if ok else
            float("inf"), "tol": "bit-exact", "ok": ok}


def compare_dense(got, want):
    """Kernel 9 against its plain version: both sum f32 products of bf16
    inputs, in another order, and round once to the output type. Each
    element within DENSE_RTOL (one bf16 step) of its magnitude plus
    DENSE_ATOL_OF_RMS of the output's RMS (sums that cancel to near zero),
    and the RMS error within DENSE_RMS_TOL of the plain RMS."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    rms = w.square().mean().sqrt().clamp_min(1e-30)
    res = {"max_abs_err": err.max().item(),
           "err_over_limit": (err / (DENSE_RTOL * w.abs()
                                     + DENSE_ATOL_OF_RMS * rms)).max().item(),
           "rms_rel_err": (err.square().mean().sqrt() / rms).item(),
           "tol": {"rtol": DENSE_RTOL, "atol_of_rms": DENSE_ATOL_OF_RMS,
                   "rms_rel": DENSE_RMS_TOL}}
    res["ok"] = (res["err_over_limit"] <= 1.0
                 and res["rms_rel_err"] <= DENSE_RMS_TOL
                 and bool(torch.isfinite(g).all()))
    return res


def rows_with_ties(gen, M, K):
    """bf16 rows from the generator, row 0 zero, row 1 exact rounding ties
    (amax 127)."""
    x = rand_bf16(gen, (M, K))
    x[0] = 0.0
    x[1] = 0.0
    x[1, :len(TIES)] = torch.tensor(TIES, device="cuda")
    return x


def int8_weight(gen, N, K):
    w = torch.randint(-127, 128, (N, K), generator=gen, device="cuda",
                      dtype=torch.int8)
    return w, torch.full((N,), 1.0 / (127.0 * K ** 0.5), device="cuda")


def case_quantize(gen, name, M, K, what="chain probe"):
    """Kernel 7 at the chain's activations (K = 1280) and hidden activations
    (K = 5120), and at the int4 probe's decode rows (M = 8, K = 4096):
    bytes bound it (2 in, 1 out an element, a scale a row). No single torch
    call computes it: no library time."""
    x = rows_with_ties(gen, M, K)
    res = compare_exact(Q.quantize_rows(x), Q.quantize_rows_plain(x))
    t, by = bound(0, 3 * M * K + 4 * M, name)
    return dict(shape=f"M={M} K={K} bf16 ({what})", **res,
                kernel_ms=time_ms(lambda: Q.quantize_rows(x), 20),
                device_ms=device_ms(lambda: Q.quantize_rows(x), 5)[0],
                plain_ms=time_ms(lambda: Q.quantize_rows_plain(x), 5),
                library_ms=None, library=None, bound_ms=t, bound_by=by)


# kernel 8 where the int4 probe runs it, f32 out: int4_grouped's products
# of one 128-column group at the 8 decode rows (N = 4096: q, k, v, o and
# down; N = 11008: gate and up), and int4_grouped_batched's block-diagonal
# rows, G = K / 128 groups of the 8 rows (q, k, v, o; down)
INT4_PREQUANT = [(8, 128, 4096), (8, 128, 11008), (256, 4096, 4096),
                 (688, 11008, 4096)]


def case_prequant(gen, name, M, K, N, act, dtype=torch.bfloat16,
                  what="chain probe"):
    """Kernel 8 at one of the chain's (or the int4 probe's) shapes:
    pre-quantized rows (kernel 7's output) times a random int8 weight.
    Without a GELU bit for bit; with one within ``compare_int8``'s limits;
    in both, bit for bit the int8 GEMM with no bias, the kernel it launches
    (``int8_gemm_ms`` times that call). Library yardstick:
    ``torch._int_mm`` on the same operands (the int32 product only; it
    takes M > 16 only); both also by device time a call."""
    xq, xs = Q.quantize_rows(rand_bf16(gen, (M, K)))
    w, scale = int8_weight(gen, N, K)

    def kernel():
        return Q.int8_matmul_prequant(xq, xs, w, scale, dtype, act)

    def gemm():
        return Q.int8_gemm(xq, xs, w, scale, None, act, dtype)

    got = kernel()
    want = Q.int8_matmul_prequant_plain(xq, xs, w, scale, dtype, act)
    res = (compare_exact([got], [want]) if act == "none"
           else compare_int8(got, want))
    res["equals_int8_gemm"] = torch.equal(got, gemm())
    res["ok"] = res["ok"] and res["equals_int8_gemm"]
    del got, want
    out_bytes = torch.empty((), dtype=dtype).element_size()
    t, by = bound(2 * M * K * N, M * K + 4 * M + N * K + 4 * N
                  + out_bytes * M * N, name, int8=True)
    dev_ms, launched = device_ms(kernel, 5)
    library = M > 16

    def int_mm():
        return torch._int_mm(xq, w.t())

    return dict(
        shape=f"M={M} K={K} N={N}{' +' + act if act != 'none' else ''}"
        f"{' f32 out' if dtype == torch.float32 else ''} ({what})", **res,
        kernel_ms=time_ms(kernel, 10), device_ms=dev_ms,
        device_launches_per_call=launched, int8_gemm_ms=time_ms(gemm, 10),
        plain_ms=time_ms(lambda: Q.int8_matmul_prequant_plain(
            xq, xs, w, scale, dtype, act), 2, 1),
        library_ms=time_ms(int_mm, 10) if library else None,
        library_device_ms=device_ms(int_mm, 5)[0] if library else None,
        library="torch._int_mm (int32 product only)" if library else None,
        bound_ms=t, bound_by=by)


def case_dense(gen, name, M, K, N, with_bias, act):
    """Kernel 9 at one of the chain's shapes, bf16 in and out. Library
    yardstick: ``F.linear`` in bf16 with the same bias (no GELU)."""
    x = rand_bf16(gen, (M, K))
    w = rand_bf16(gen, (N, K), K ** -0.5)
    b = rand_bf16(gen, (N,), 0.5) if with_bias else None
    res = compare_dense(SM.fused_dense(x, w, b, act),
                        SM.fused_dense_plain(x, w, b, act))
    t, by = bound(2 * M * K * N, 2 * (M * K + N * K + M * N) + 2 * N, name)
    dev_ms, launched = device_ms(lambda: SM.fused_dense(x, w, b, act), 5)
    return dict(
        shape=f"M={M} K={K} N={N}{' +bias' if with_bias else ''}"
        f"{' +' + act if act != 'none' else ''} (chain probe)", **res,
        kernel_ms=time_ms(lambda: SM.fused_dense(x, w, b, act), 10),
        device_ms=dev_ms, device_launches_per_call=launched,
        plain_ms=time_ms(lambda: SM.fused_dense_plain(x, w, b, act), 2, 1),
        library_ms=time_ms(lambda: torch.nn.functional.linear(x, w, b), 10),
        library_device_ms=device_ms(
            lambda: torch.nn.functional.linear(x, w, b), 5)[0],
        library="F.linear bf16 (with the bias, no GELU)", bound_ms=t,
        bound_by=by)


def case_mxu(name, label, in_dtype, acc_dtype):
    """Kernel 11 at the mxu probe's 512 x 1280 x 1280: held to its plain
    version at MXU_CHECK_LOOPS loops; timed per product as the difference
    of MXU_TIME_LOOPS and a quarter of them, so the launch and the atomic
    epilogue drop out. The bound is one product's operations over the peak
    of its type (the operands' bytes are read once for all the loops).
    Plain: one loop of the plain version; library: one torch.matmul (f32
    without TF32) or ``torch._int_mm``."""
    M, K, N = mxu_probe.M, mxu_probe.K, mxu_probe.N
    x, w = mxu_probe.make_inputs(in_dtype, (M, K, N), "cuda")
    got = MX.mxu_loop(x, w, MXU_CHECK_LOOPS, acc_dtype)
    want = MX.mxu_loop_plain(x, w, MXU_CHECK_LOOPS, acc_dtype)
    if in_dtype == torch.int8:
        res = compare_exact([got], [want])
    else:
        err = max_err(got, want)
        lim = MXU_TOL_OF_MAX * want.abs().max().item()
        res = {"max_abs_err": err, "err_over_limit": err / lim,
               "tol": {"abs_of_max": MXU_TOL_OF_MAX}, "ok": err <= lim}
    small = MXU_TIME_LOOPS // 4
    t_big = time_ms(lambda: MX.mxu_loop(x, w, MXU_TIME_LOOPS, acc_dtype), 3, 1)
    t_small = time_ms(lambda: MX.mxu_loop(x, w, small, acc_dtype), 3, 1)
    per_dot = (t_big - t_small) / (MXU_TIME_LOOPS - small)
    t, by = bound(2 * M * K * N, 0, name, int8=in_dtype == torch.int8,
                  f32=in_dtype == torch.float32)
    if in_dtype == torch.int8:
        lib = time_ms(lambda: torch._int_mm(x, w.t()), 20)
    else:
        lib = time_ms(lambda: torch.matmul(x, w.t()), 20)
    return dict(shape=f"{label}: M={M} K={K} N={N}, ms per product", **res,
                kernel_ms=per_dot, tops=2 * M * K * N / per_dot / 1e9,
                plain_ms=time_ms(lambda: MX.mxu_loop_plain(x, w, 1, acc_dtype),
                                 5),
                library_ms=lib, library="torch._int_mm" if in_dtype ==
                torch.int8 else "torch.matmul", bound_ms=t, bound_by=by)


def case_copy(gen, name):
    """The copy kernel at the window probe's BW=200 x 16 heads, L=196, D=80:
    bytes (q, k, v read, q written). Plain and library: ``q.clone()``."""
    R, L, D = 200 * 16, 196, 80
    q, k, v = (rand_bf16(gen, (R, L, D)) for _ in range(3))
    res = compare_exact([SA.window_copy(q, k, v)],
                        [SA.window_copy_plain(q, k, v)])
    t, by = bound(0, 4 * R * L * D * 2, name)
    return dict(shape=f"R={R} L={L} D={D} (window probe, BW=200)", **res,
                kernel_ms=time_ms(lambda: SA.window_copy(q, k, v), 20),
                plain_ms=time_ms(lambda: SA.window_copy_plain(q, k, v), 20),
                library_ms=time_ms(lambda: q.clone(), 20),
                library="q.clone()", bound_ms=t, bound_by=by)


def case_flash_global(gen, name):
    """The window probe's ``global_plain``: B=8 H=16 over the 64 x 64 grid
    (L = Lk = 4096), D=80 zero-padded to 128 as the variant pads it,
    non-causal, no kv lengths, scale 80^-0.5. The plain version runs image
    by image (its f32 scores take 1 GB an image)."""
    P = winattn_probe
    Bg, H, L, D = P.GB, P.GH, P.GW * P.GW, P.GD
    q, k, v = (torch.nn.functional.pad(rand_bf16(gen, (Bg, H, L, D)),
                                       (0, P.FLASH_D - D)) for _ in range(3))
    scale = D ** -0.5

    def plain():
        outs = [FA.flash_forward_plain(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                       False, scale) for i in range(Bg)]
        return (torch.cat([o for o, _ in outs]),
                torch.cat([lse for _, lse in outs]))

    got, lse = FA.flash_forward(q, k, v, False, scale)
    want, lse_want = plain()
    res = compare(got, want, lse, lse_want)
    del got, lse, want, lse_want
    Dp = P.FLASH_D
    t, by = bound(4 * Bg * H * L * L * Dp, 4 * Bg * H * L * Dp * 2
                  + Bg * H * L * 4, name, exps=Bg * H * L * L)
    return dict(
        shape=f"B={Bg} H={H} L=Lk={L} D={D} padded to {Dp}, non-causal "
        "(window probe global_plain)", **res,
        kernel_ms=time_ms(lambda: FA.flash_forward(q, k, v, False, scale), 5),
        plain_ms=time_ms(plain, 2, 1),
        library_ms=time_ms(lambda: sdpa()(q, k, v, scale=scale), 5),
        bound_ms=t, bound_by=by)


def case_flash_norel(gen, name):
    """The SAM encoder's global block without its rel-pos bias (the SAM
    probe's ``norel``), through ``flash_attention``'s padded route: B=8
    images, H=16, L = Lk = 4096, D=80 zero-padded to 128 inside the
    wrapper, non-causal, scale 80^-0.5; held against the plain version on
    the unpadded inputs, image by image. The bound counts the work and
    bytes at D = 80; SDPA takes D = 80 as it is."""
    Bg, H, L, D = B, 16, 4096, 80
    q, k, v = (rand_bf16(gen, (Bg, H, L, D)) for _ in range(3))
    scale = D ** -0.5

    def plain():
        return torch.cat([FA.flash_forward_plain(
            q[i:i + 1], k[i:i + 1], v[i:i + 1], False, scale)[0]
            for i in range(Bg)])

    got = FA.flash_attention(q, k, v, False, scale)
    res = compare(got, plain())
    del got
    t, by = bound(4 * Bg * H * L * L * D, 4 * Bg * H * L * D * 2, name,
                  exps=Bg * H * L * L)
    return dict(
        shape=f"B={Bg} H={H} L=Lk={L} D={D}, padded to "
        f"{FA.padded_head_dim(D)} in flash_attention, non-causal (SAM "
        "global block without rel-pos, the SAM probe's norel)", **res,
        kernel_ms=time_ms(lambda: FA.flash_attention(q, k, v, False, scale),
                          5),
        plain_ms=time_ms(plain, 2, 1),
        library_ms=time_ms(lambda: sdpa()(q, k, v, scale=scale), 5),
        bound_ms=t, bound_by=by)


def probe_kernel_phase(name):
    """Kernels 7, 8, 9, 11 and the copy kernel, each against its plain
    version at the probes' shapes (kernels 7 and 8 also at the int4
    probe's decode rows, INT4_PREQUANT); and the earlier kernels at the shapes
    only the probes give them: kernel 1 at ``global_plain``'s, kernel 6
    without a bias at the chain's (with the erf GELU on the first matmul).
    Kernels 2 and 3 run in the probes on the kernel phase's rows (L, D),
    only over fewer of them (kernel 2 also on zero factors)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    M, K, N = CHAIN_M, CHAIN_K, CHAIN_N
    cases = {
        "flash_attention": [case_flash_global(gen, name)],
        "int8_matmul": [
            case_int8(gen, name, "chain probe pallas_int8_gelu, 1st matmul",
                      M, K, N, False, "gelu", None),
            case_int8(gen, name, "chain probe pallas_int8(_gelu), 2nd matmul",
                      M, N, K, False, "none", None)],
        "quantize_rows": [case_quantize(gen, name, M, K),
                          case_quantize(gen, name, M, N),
                          case_quantize(gen, name, 8, 4096, "int4 probe")],
        "int8_matmul_prequant": [case_prequant(gen, name, *s, act)
                                 for s in ((M, K, N), (M, N, K))
                                 for act in ("none", "gelu")]
        + [case_prequant(gen, name, *s, "none", torch.float32, "int4 probe")
           for s in INT4_PREQUANT],
        "fused_dense": [case_dense(gen, name, *s, *e)
                        for s in ((M, K, N), (M, N, K))
                        for e in ((False, "none"), (True, "gelu"))],
        "mxu_loop": [case_mxu(name, *c) for c in mxu_probe.COMBOS],
        "window_copy": [case_copy(gen, name)],
    }
    for kname, rows in cases.items():
        for row in rows:
            log(json.dumps({"name": kname, **row}))
            if not row["ok"]:
                raise SystemExit(f"{kname} disagrees with its plain version "
                                 f"at {row['shape']}: {row}")
    torch.cuda.empty_cache()
    return cases


def probes_phase():
    """This slice's path: the three probes at their default sizes on the
    card, every variant (each prints its line). Launches are counted from 0
    over the three; each chain variant must launch each of its kernels
    twice an iteration."""
    reset_launches()
    chain = chain_probe.main(list(chain_probe.VARIANTS))
    mxu = mxu_probe.main()
    win = winattn_probe.main(list(winattn_probe.VARIANTS))
    launches = read_launches()
    bad = {v: r["launches"] for v, r in chain.items()
           if any(n != 2 * r["iters"] for n in r["launches"].values())}
    log(json.dumps({"phase": "probes", "chain": chain, "mxu": mxu,
                    "winattn": win, "launches": launches}))
    needed = ["quantize_rows", "int8_matmul_prequant", "fused_dense",
              "mxu_loop", "window_copy", "int8_matmul", "window_attention",
              "rel_attention", "flash_attention"]
    if bad or not all(launches[n] > 0 for n in needed):
        raise SystemExit(f"the probes' launches are off: {bad or launches}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------- models
def synthetic_batch(cfg, batch, prompt_len, device, seed):
    """Random prompt ids with the <image> token at position 1, all-valid
    masks, labels that supervise nothing (the whole prompt is kept), and
    random pixels and camera parameters."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, min(cfg.llama.vocab_size, 30000), (batch, prompt_len))
    ids[:, 1] = IMAGE_TOKEN_INDEX
    gen = torch.Generator(device=device).manual_seed(seed)
    S, C = cfg.sam.img_size, cfg.clip.image_size
    return {
        "input_ids": ids,
        "labels": np.full_like(ids, IGNORE_INDEX),
        "images_clip": torch.randn((batch, C, C, 3), generator=gen,
                                   device=device),
        "sam_images": torch.randn((batch, V, S, S, 3), generator=gen,
                                  device=device, dtype=cfg.sam.dtype),
        "cam_params": torch.randn((batch, V, 5), generator=gen, device=device),
    }


def synthetic_lift_maps(hw, n_verts, device, seed, background=0.7):
    """Corner-major pixel -> vertex maps (3, V, hw, hw) over ``n_verts``
    vertices with a share of background (-1) pixels, and barycentric
    weights that sum to 1 over the three corners: the tiny reference
    pipeline's maps, whose mesh (``num_human_vertices``) no rasterizer
    draws."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (3, V, hw, hw)
    p2v = torch.randint(0, n_verts, shape, generator=gen, device=device,
                        dtype=torch.int32)
    bg = torch.rand(shape[1:], generator=gen, device=device) < background
    p2v = torch.where(bg[None], -1, p2v)
    bary = torch.rand(shape, generator=gen, device=device) + 0.05
    return {"p2v": p2v, "bary": bary / bary.sum(0, keepdim=True),
            "num_vertices": n_verts}


@torch.no_grad()
def real_lift_maps(sphere=SPHERE, view_set=VIEW_SET, gather=True,
                   n_expected=N_VERTS):
    """The lift maps of the card paths: a UV sphere (by default ``SPHERE``,
    SMPL's 6890 vertices) under the first V cameras of ``view_set``,
    rasterized at MASK^2 on the card by the port (``bench.py`` builds its
    maps so, on the host), with the smallest safe window (``pick_window``).
    Checks the maps (ids in range, barycentrics summing to 1 on covered
    pixels, the card's maps equal the CPU's at 128^2) and returns the
    corner-major maps, their gather form (MAX_K pixels a vertex and view;
    None without ``gather``) and which vertices have at most MAX_K pixels
    in every view; ``n_expected`` is the sphere's vertex count. Built
    outside inference mode: the training paths' losses keep the
    barycentrics for their backward."""
    verts, faces = uv_sphere(*sphere)
    n_verts = len(verts)
    cams = {**HUMAN_VIEWS, **OBJECT_VIEWS}[view_set].cam_params()[:V]
    window = max(pick_window(verts, faces, c, MASK) for c in cams)
    small = [build_lift_maps(verts, faces, cams, 128, max(
        pick_window(verts, faces, c, 128) for c in cams), device=d)
        for d in ("cuda", "cpu")]
    same_as_cpu = (torch.equal(small[0][0].cpu(), small[1][0])
                   and torch.equal(small[0][2].cpu(), small[1][2])
                   and (small[0][1].cpu() - small[1][1]).abs().max().item()
                   <= 1e-6)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p2v, bary, p2f = build_lift_maps(verts, faces, cams, MASK, window,
                                     device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    covered = p2f >= 0
    counts = torch.stack([torch.bincount(p2v[v][covered[v]].reshape(-1).long(),
                                         minlength=n_verts)
                          for v in range(V)])
    fits = (counts <= MAX_K).all(0)
    gidx = gw = None
    t0 = time.perf_counter()
    if gather:
        gidx, gw = build_gather_maps(p2v.cpu().numpy(), bary.cpu().numpy(),
                                     n_verts, max_k=MAX_K)
        gidx, gw = torch.from_numpy(gidx).cuda(), torch.from_numpy(gw).cuda()
    gather_s = time.perf_counter() - t0
    sums = bary.sum(-1)[covered]
    res = {"phase": "lift_maps", "mesh": f"uv_sphere{sphere}",
           "vertices": n_verts, "faces": len(faces), "views": view_set,
           "size": MASK, "window": window, "candidates": len(faces) * window ** 2,
           "build_s": build_s, "gather_form_s": gather_s if gather else None,
           "background_share": 1.0 - covered.float().mean().item(),
           "background_share_by_view": [
               1.0 - c.float().mean().item() for c in covered],
           "vertices_seen": int((counts > 0).any(0).sum()),
           "max_pixels_a_vertex_and_view": int(counts.max()),
           "vertices_over_max_k": int((~fits).sum()),
           "equal_to_cpu_at_128": same_as_cpu}
    log(json.dumps(res))
    ok = (same_as_cpu and n_verts == n_expected
          and bool(((p2v >= 0) == covered[..., None]).all())
          and int(p2v.max()) < n_verts
          and bool(torch.isfinite(bary).all())
          and (sums - 1).abs().max().item() < 1e-3
          and 0.05 < res["background_share"] < 0.95)
    if not ok:
        raise SystemExit(f"the lift maps are malformed: {res}")
    maps = {"p2v": corner_major(p2v), "bary": corner_major(bary),
            "num_vertices": n_verts}
    return maps, gidx, gw, fits


def let_seg_token_appear(model, batch, device, kv_cache, token=None):
    """Random weights almost never emit [SEG], and without it the mask and
    lift legs return zeros. Make the seg token's lm_head row 1.5x that of
    the token most often emitted, so that it wins wherever that token did
    (for an int8 or int4 head: the same row with 1.5x its scale).
    ``token``: another seg token to raise so ([HSEG], [OSEG])."""
    llava = model.llava
    seg = model.config.seg_token_idx if token is None else token
    ids = torch.as_tensor(batch["input_ids"], device=device)
    px = torch.as_tensor(batch["images_clip"], device=device).to(
        model.config.clip.dtype)
    out = greedy_generate(llava, ids, px, max_new_tokens=8, eos_id=-1,
                          kv_cache=kv_cache)
    mode = int(torch.mode(out["generated_ids"].flatten()).values)
    head = llava.lm.lm_head
    with torch.no_grad():
        if isinstance(head, Int8Linear):
            head.weight[seg] = head.weight[mode]
            head.weight_scale[seg] = 1.5 * head.weight_scale[mode]
        elif isinstance(head, Int4Linear):
            head.weight_q4[seg] = head.weight_q4[mode]
            head.weight_scale[seg] = 1.5 * head.weight_scale[mode]
        else:
            head.weight[seg] = 1.5 * head.weight[mode]


def reference_phase(weights: str):
    """interactvlm_tiny on the card against the same weights in f32 on the
    CPU, through evaluate_batch. LLaMA and CLIP run f32 on both sides (the
    generated ids must match); SAM runs bf16 on the card (the window kernel
    takes bf16 only), so masks are held to 5e-2 of their largest magnitude
    and contacts to 5e-2 absolute: bf16 keeps ~3 significant digits through
    two encoder blocks, the decoder and the lift's sigmoid.

    ``weights`` "dense"; "int8": int8 LLaMA weights with the int8 KV
    cache, and the int8 SAM encoder; "int4": packed int4 LLaMA weights
    (the lm_head too), otherwise as "int8". On the card every int8 linear
    launches the int8 kernel and every int4 one the int4 kernel; on the
    CPU the JAX package's composition runs, which rounds x / (amax / 127)
    where the kernel rounds x * (127 / amax): they differ only on a rounding
    tie, so the ids must still match."""
    quant = weights != "dense"
    kv = "int8" if quant else "dense"
    cpu_cfg = interactvlm_tiny(
        llama=llama_tiny(weights_int8=weights == "int8",
                         weights_int4=weights == "int4"),
        sam=sam_tiny(weights_int8=quant))
    gpu_cfg = dataclasses.replace(cpu_cfg, sam=sam_tiny(
        dtype=torch.bfloat16, weights_int8=quant))
    cpu = init_params(InteractVLM(cpu_cfg, device="cpu"),
                      torch.Generator().manual_seed(1))
    batch = synthetic_batch(cpu_cfg, 2, 12, "cpu", 1)
    batch["sam_images"] = batch["sam_images"].float()
    let_seg_token_appear(cpu, batch, "cpu", kv)
    gpu = InteractVLM(gpu_cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    maps = synthetic_lift_maps(64, cpu_cfg.num_human_vertices, "cpu", 2)
    gpu_batch = {k: torch.as_tensor(x).cuda() if torch.is_tensor(x) else x
                 for k, x in batch.items()}
    gpu_maps = {k: x.cuda() if torch.is_tensor(x) else x
                for k, x in maps.items()}
    want = evaluate_batch(cpu, batch, 64, human_maps=maps, eos_id=-1,
                          max_new_tokens=8, kv_cache=kv)
    reset_launches()
    got = evaluate_batch(gpu, gpu_batch, 64, human_maps=gpu_maps, eos_id=-1,
                         max_new_tokens=8, kv_cache=kv)
    launched = read_launches()
    ids_equal = torch.equal(got["generated_ids"].cpu(), want["generated_ids"])
    scale = want["pred_masks"].abs().max().item()
    mask_err = max_err(got["pred_masks"].cpu(), want["pred_masks"]) / max(scale, 1e-6)
    contact_err = max_err(got["pred_contact_3d"].cpu(), want["pred_contact_3d"])
    res = dict(phase="reference", config="interactvlm_tiny",
               weights=weights, kv_cache=kv,
               ids_equal=ids_equal, has_seg=int(want["has_seg"].sum()),
               mask_rel_err=mask_err, contact_abs_err=contact_err,
               launches=launched)
    log(json.dumps(res))
    needed = (["window_attention"] + (["int8_matmul"] if quant else [])
              + (["int4_matmul"] if weights == "int4" else []))
    if not (ids_equal and mask_err < 5e-2 and contact_err < 5e-2
            and all(launched[n] > 0 for n in needed)
            and bool(want["has_seg"].any())):
        raise SystemExit(f"the card disagrees with the CPU reference: {res}")


def let_both_seg_tokens_appear(model, batch, device, steps):
    """Random weights almost never emit [HSEG] and [OSEG], let alone as the
    first two seg tokens of one answer, which a K = 2 path needs. Rank the
    tokens the model emits in ``steps`` greedy steps by count; give [HSEG]
    1.5x the lm_head row of one of the most emitted, then [OSEG] 1.5x the
    row of a token that follows [HSEG] in the new answers (the most common
    first), until some answer's first two seg tokens are one of each (at
    most 4 x 4 tries). The lm_head is a bf16 or f32 Linear."""
    llava, cfg = model.llava, model.config
    ids = torch.as_tensor(batch["input_ids"], device=device)
    px = torch.as_tensor(batch["images_clip"], device=device).to(
        cfg.clip.dtype)
    seg_ids = torch.tensor(model.seg_ids, device=device)
    hseg, oseg = cfg.hseg_token_idx, cfg.oseg_token_idx

    def generate():
        return greedy_generate(llava, ids, px, max_new_tokens=steps,
                               eos_id=-1)["generated_ids"]

    def ranked(tokens):
        counts = torch.bincount(tokens.flatten().long())
        order = torch.argsort(counts, descending=True, stable=True)
        return [t for t in order.tolist() if counts[t] > 0
                and t not in model.seg_ids]

    head = llava.lm.lm_head.weight
    with torch.no_grad():
        for a in ranked(generate())[:4]:
            head[hseg] = 1.5 * head[a]
            gen = generate()
            after = gen[:, 1:][gen[:, :-1] == hseg]
            for b in ranked(after)[:4]:
                head[oseg] = 1.5 * head[b]
                gen = generate()
                is_seg = torch.isin(gen, seg_ids)
                _, tok, valid = seg_slots(gen, is_seg, gen[..., None].float(),
                                          K_HOI)
                both = (((tok == hseg) & valid).any(1)
                        & ((tok == oseg) & valid).any(1))
                if bool(both.any()):
                    return {"hseg_row_of": a, "oseg_row_of": b,
                            "answers_with_both": int(both.sum())}
    raise SystemExit("no answer's first seg tokens are [HSEG] and [OSEG]")


def hoi_reference_phase():
    """The interaction branches of interactvlm_tiny (Gen-Hu-Obj-DifDe,
    vi_v1 cams, K = 2 slots) on the card against the same weights in f32 on
    the CPU, through evaluate_batch with ``max_seg_tokens=2``: the human
    maps shared, the object maps per sample. LLaMA and CLIP run f32 on both
    sides (the ids must match); SAM runs bf16 on the card, so the K-slot
    masks are held to 5e-2 of their largest magnitude and both lifts to
    5e-2 absolute, as in ``reference_phase``. Some answer must carry both
    [HSEG] and [OSEG] (``let_both_seg_tokens_appear``)."""
    cpu_cfg = interactvlm_tiny(**HOI_TINY)
    gpu_cfg = dataclasses.replace(cpu_cfg,
                                  sam=sam_tiny(dtype=torch.bfloat16))
    cpu = init_params(InteractVLM(cpu_cfg, device="cpu"),
                      torch.Generator().manual_seed(6))
    batch = synthetic_batch(cpu_cfg, 2, 12, "cpu", 6)
    batch["sam_images"] = batch["sam_images"].float()
    chosen = let_both_seg_tokens_appear(cpu, batch, "cpu", 8)
    gpu = InteractVLM(gpu_cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    human = synthetic_lift_maps(64, cpu_cfg.num_human_vertices, "cpu", 2)
    objs = [synthetic_lift_maps(64, cpu_cfg.num_object_points, "cpu", 3 + b,
                                background=0.3) for b in range(2)]
    batch["obj_p2v"] = torch.stack([o["p2v"] for o in objs], 1)
    batch["obj_bary"] = torch.stack([o["bary"] for o in objs], 1)
    batch["gt_ocontact"] = torch.zeros(2, cpu_cfg.num_object_points)
    gpu_batch = {k: torch.as_tensor(x).cuda() if torch.is_tensor(x) else x
                 for k, x in batch.items()}
    gpu_human = {k: x.cuda() if torch.is_tensor(x) else x
                 for k, x in human.items()}
    kw = dict(max_new_tokens=8, eos_id=-1, max_seg_tokens=K_HOI)
    want = evaluate_batch(cpu, batch, 64, human_maps=human, **kw)
    reset_launches()
    got = evaluate_batch(gpu, gpu_batch, 64, human_maps=gpu_human, **kw)
    launched = read_launches()
    ids_equal = torch.equal(got["generated_ids"].cpu(), want["generated_ids"])
    scale = want["pred_masks_k"].abs().max().item()
    mask_err = max_err(got["pred_masks_k"].cpu(),
                       want["pred_masks_k"]) / max(scale, 1e-6)
    lifts = {k: None if want[k] is None or got[k] is None
             else max_err(got[k].cpu(), want[k])
             for k in ("pred_hcontact_3d", "pred_ocontact_3d")}
    tok, valid = want["token_ids_k"], want["valid_k"]
    both = (((tok == cpu_cfg.hseg_token_idx) & valid).any(1)
            & ((tok == cpu_cfg.oseg_token_idx) & valid).any(1))
    res = dict(phase="hoi_reference", config="interactvlm_tiny "
               "Gen-Hu-Obj-DifDe vi_v1 K=2", seg_rows=chosen,
               ids_equal=ids_equal, token_ids_k=tok.tolist(),
               rows_with_both=int(both.sum()), mask_k_rel_err=mask_err,
               lift_abs_err=lifts, launches=launched)
    log(json.dumps(res))
    if not (ids_equal and bool(both.any()) and mask_err < 5e-2
            and all(e is not None and e < 5e-2 for e in lifts.values())
            and launched["window_attention"] > 0):
        raise SystemExit(f"the card's interaction branches disagree with "
                         f"the CPU reference: {res}")


def config_13b_hoi():
    """The JAX package's interaction preset (``scripts/run_train.sh``
    hcontact-ocontact: ``--token_type Gen-Hu-Obj --cam_encoder_type vi_v1``,
    K = 2 by ``train/train.py``) at full width in bf16: LLaMA-13B, CLIP
    ViT-L/14, SAM ViT-H; [SEG] / [HSEG] / [OSEG] at 32000 / 32001 / 32002
    of the reference tokenizer's 32003 (padded to 32128)."""
    bf16 = torch.bfloat16
    return dataclasses.replace(
        interactvlm_13b(), llama=llama_13b(dtype=bf16, vocab_size=32003),
        clip=clip_vit_l_14(dtype=bf16), sam=sam_vit_h(dtype=bf16),
        token_type="Gen-Hu-Obj", cam_encoder_type="vi_v1",
        max_seg_tokens=K_HOI, seg_token_idx=32000, hseg_token_idx=32001,
        oseg_token_idx=32002, hC_sam_view_type=HOI_HUMAN_VIEWS,
        oC_sam_view_type=HOI_OBJECT_VIEWS, num_object_points=N_OBJ,
        img_emb_len=clip_vit_l_14().num_patches - 1)


def config_13b():
    bf16 = torch.bfloat16
    cfg0 = interactvlm_13b()
    return dataclasses.replace(
        cfg0, clip=clip_vit_l_14(dtype=bf16), sam=sam_vit_h(dtype=bf16),
        seg_token_idx=min(cfg0.llama.vocab_size - 1, 32000),
        img_emb_len=clip_vit_l_14().num_patches - 1)


def config_7b_int8():
    """``bench.py``'s chip configuration: LLaMA-7B int8 weights (no remat),
    CLIP ViT-L/14, SAM ViT-H int8 with tanh GELU, all bf16."""
    bf16 = torch.bfloat16
    llama = llama_7b(dtype=bf16, remat=False, weights_int8=True)
    return dataclasses.replace(
        interactvlm_13b(), llama=llama, clip=clip_vit_l_14(dtype=bf16),
        sam=sam_vit_h(dtype=bf16, gelu_approx=True, weights_int8=True),
        seg_token_idx=min(llama.vocab_size - 1, 32000),
        img_emb_len=clip_vit_l_14().num_patches - 1)


def config_7b_int4():
    """``bench.py``'s chip configuration with ``BENCH_WQ=int4``: as
    ``config_7b_int8`` with the LLaMA weights packed int4 (the lm_head
    too), the int8 KV cache and the int8 SAM encoder with tanh GELU."""
    cfg = config_7b_int8()
    return dataclasses.replace(cfg, llama=dataclasses.replace(
        cfg.llama, weights_int8=False, weights_int4=True))


def serving_path_phase(path, cfg, kv_cache, b_cached, lift):
    """Drive ``evaluate_batch`` at full width and depth in streaming (B=8)
    and cached (``b_cached``) mode, on the real lift maps ``lift``
    (``real_lift_maps``). The cached batch is the streaming batch
    repeated, so every copy must generate the streaming ids. Launches are
    counted from 0 over the first round (one streaming and one cached
    batch), and per mode. Returns the round's launches and each mode's
    (``read_launches`` differences)."""
    t0 = time.perf_counter()
    model = InteractVLM(cfg, device="cuda")
    init_params(model, torch.Generator(device="cuda").manual_seed(0))
    model.eval().requires_grad_(False)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(json.dumps({"phase": "init", "path": path, "params": n_params,
                    "s": time.perf_counter() - t0}))

    batch = synthetic_batch(cfg, B, L_TEXT, "cuda", 0)
    batch["images_clip"] = batch["images_clip"].to(cfg.clip.dtype)
    let_seg_token_appear(model, batch, "cuda", kv_cache)
    reps = b_cached // B
    batches = {"streaming": batch, "cached": {
        "input_ids": np.tile(batch["input_ids"], (reps, 1)),
        "labels": np.tile(batch["labels"], (reps, 1)),
        "images_clip": batch["images_clip"].repeat(reps, 1, 1, 1),
        "cam_params": batch["cam_params"].repeat(reps, 1, 1)}}
    maps, gidx, gw, fits = lift
    # the canonical renders are fixed: cached serving encodes them once
    cached = model.encode_sam_images(batch["sam_images"][:1])

    def run(mode):
        return evaluate_batch(
            model, batches[mode], MASK, max_new_tokens=T, human_maps=maps,
            eos_id=-1, kv_cache=kv_cache,
            cached_image_emb=cached if mode == "cached" else None)

    modes = ("streaming", "cached")
    for mode in modes:  # warm-up: cuBLAS handles, allocator
        run(mode)
    torch.cuda.reset_peak_memory_stats()
    # the first round's batches are the path's run: their launches are
    # counted and their outputs checked; the later rounds only add times
    outs, secs, int8_by_mode, by_mode = {}, {m: [] for m in modes}, {}, {}
    with UnpackCounter() as unpacks:
        for rnd in range(REPEATS):
            if rnd == 0:
                reset_launches()
            for mode in modes:
                before, counts = int8_counts(), read_launches()
                out, ms = wall_ms(lambda: run(mode))
                secs[mode].append(ms / 1e3)
                outs.setdefault(mode, out)
                if rnd == 0:
                    int8_by_mode[mode] = {k: v - before[k]
                                          for k, v in int8_counts().items()}
                    by_mode[mode] = launches_between(counts, read_launches())
            if rnd == 0:
                launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    needed = ["flash_attention", "window_attention", "rel_attention"]
    int4 = cfg.llama.weights_int4
    quantized = cfg.llama.weights_int8 or int4
    if quantized:
        needed.append("int8_matmul")
    if int4:
        needed.append("int4_matmul")
    log(json.dumps({"phase": "unpacks_on_card", "path": path,
                    "calls": unpacks.n}))
    if unpacks.n:
        raise SystemExit(f"the {path} path unpacked int4 weights on the card "
                         f"{unpacks.n} times")
    for n in needed:
        if launches[n] <= 0:
            raise SystemExit(f"the {path} path never launched {n}")
    if launches["rel_routes"] != {"mma": 0, "sm90": launches["rel_attention"]}:
        raise SystemExit(f"the {path} path's global attention left the wgmma "
                         f"route: {launches['rel_routes']}")
    if launches["window_routes"] != {"mma": 0,
                                     "sm90": launches["window_attention"]}:
        raise SystemExit(f"the {path} path's window attention left the wgmma "
                         f"route: {launches['window_routes']}")
    # the round's two batches each run one SAM decode: its image -> token
    # attention a decoder block on the head-dim-16 kernel, LLaMA's on
    # head dim 128's
    d16 = 2 * cfg.sam.decoder_depth
    if launches["fwd_routes"] != {"sm90": launches["flash_attention"] - d16,
                                  "sm90_d16": d16, "mma": 0}:
        raise SystemExit(f"the {path} path's flash forward left its routes: "
                         f"{launches['fwd_routes']}")
    if quantized:
        # per batch: 7 projections a layer and the lm_head, at the prefill
        # and each of the T - 1 decode steps; 4 linears a SAM block when
        # the encoder runs (streaming only). The prefill's projections and
        # the encoder's linears take the two passes (a row quantize and a
        # GEMM each); the lm_head (at the prefill's last positions) and
        # decode, B rows, the one-launch kernel. With int4 LLaMA weights
        # LLaMA's calls take the int4 matmul's routes (its two-pass route's
        # row quantize is kernel 7's too, its GEMM the int4 one), the
        # encoder's kernel 6.
        proj = 7 * cfg.llama.num_layers
        one = 1 + (proj + 1) * (T - 1)
        sam_calls = 4 * cfg.sam.encoder_depth if cfg.sam.weights_int8 else 0
        one4, two4 = (one, proj) if int4 else (0, 0)  # LLaMA's on int4
        want = {}
        for mode, sam in (("streaming", sam_calls), ("cached", 0)):
            one8, two8 = one - one4, proj + sam - two4
            want[mode] = {"calls": one8 + two8, "one_launch": one8,
                          "two_pass": two8, "quantize_rows": proj + sam,
                          "int8_gemm": two8, "int4_calls": one4 + two4,
                          "int4_one_launch": one4, "int4_two_pass": two4,
                          "int4_gemm": two4}
        log(json.dumps({"phase": "int8_launches", "path": path,
                        "by_mode": int8_by_mode, "expected": want}))
        if int8_by_mode != want:
            raise SystemExit(f"int8 launches {int8_by_mode} != {want}")

    for mode, out in outs.items():
        nb = batches[mode]["input_ids"].shape[0]
        masks, contact = out["pred_masks"], out["pred_contact_3d"]
        ok = (tuple(masks.shape) == (nb, V, MASK, MASK)
              and tuple(contact.shape) == (nb, N_VERTS)
              and bool(torch.isfinite(masks).all())
              and bool(torch.isfinite(contact).all())
              and float(contact.min()) >= 0.0 and float(contact.max()) <= 1.0
              and bool(out["has_seg"].any()))
        med = float(np.median(secs[mode]))
        log(json.dumps({"phase": "main_path", "path": path, "mode": mode,
                        "batch": nb, "kv_cache": kv_cache,
                        "images_per_s": nb / med,
                        "images_per_s_min": nb / max(secs[mode]),
                        "images_per_s_max": nb / min(secs[mode]),
                        "batch_s": secs[mode],
                        "has_seg": int(out["has_seg"].sum()),
                        "contact_mean": float(contact.mean()), "ok": ok}))
        if not ok:
            raise SystemExit(f"{path} {mode} outputs are malformed")
    ids = outs["streaming"]["generated_ids"]
    if not torch.equal(outs["cached"]["generated_ids"],
                       ids.repeat(reps, 1)):
        raise SystemExit(f"{path}: streaming and cached runs generated "
                         f"different ids")
    runs = [leg_times(model, batch, maps, gidx, gw, fits, outs["streaming"],
                      kv_cache) for _ in range(LEG_REPEATS)]
    legs = {k: spread([r[k] for r in runs]) for k in runs[0]}
    log(json.dumps({"phase": "legs_ms", "path": path, **legs,
                    "peak_gb": peak_gb}))
    log(json.dumps({"phase": "decode_host_device_ms", "path": path,
                    "kv_cache": kv_cache,
                    **decode_split(model, batch, kv_cache)}))
    if kv_cache == "int8" and cfg.llama.weights_int8:
        log(json.dumps({"phase": "decode_int8_vs_dense_cache_ms",
                        "path": path, **decode_by_cache(model, batch)}))
    if cfg.llama.weights_int4:
        log(json.dumps({"phase": "int4_costs", "path": path,
                        **int4_costs(cfg.llama)}))
    log(json.dumps({"phase": "profile", "path": path, "mode": "streaming",
                    **device_busy(lambda: run("streaming"))}))
    del model, cached, outs
    gc.collect()
    torch.cuda.empty_cache()
    return launches, by_mode


def int8_counts():
    """The int8 and int4 matmuls' calls on the card, their calls by route,
    and the launches of the two-pass routes' kernels (kernel 7 serves
    both)."""
    return {"calls": Q.int8_matmul_fused.launches,
            **Q.int8_matmul_fused.route_launches,
            "quantize_rows": Q.quantize_rows.launches,
            "int8_gemm": Q.int8_gemm.launches,
            "int4_calls": Q4.int4_matmul_fused.launches,
            **{"int4_" + r: n
               for r, n in Q4.int4_matmul_fused.route_launches.items()},
            "int4_gemm": Q4.int4_gemm.launches}


class UnpackCounter:
    """Counts ``ops/quant.py:unpack_int4`` calls on card tensors while
    active (each the start of a transient (N, K) int8 copy of a packed
    weight), patched where the port looks it up."""

    def __enter__(self):
        self.n, self.saved = 0, QT.unpack_int4

        def counted(packed):
            self.n += int(packed.is_cuda)
            return self.saved(packed)

        QT.unpack_int4 = Q4.unpack_int4 = counted
        return self

    def __exit__(self, *exc):
        QT.unpack_int4 = Q4.unpack_int4 = self.saved


def decode_by_cache(model, batch):
    """The decode leg (greedy_generate less prefill, host clock around
    synchronised calls) with the int8 and the dense cache on the same
    weights, one of each after a warm-up of both."""
    llava = model.llava
    ids = torch.as_tensor(batch["input_ids"], device="cuda")
    px = batch["images_clip"]
    Lp = L_TEXT - 1 + model.config.clip.num_patches
    out = {"int8": [], "dense": []}
    for kv in out:  # warm-up: the dense cache's shapes are new here
        greedy_generate(llava, ids, px, max_new_tokens=T, eos_id=-1,
                        kv_cache=kv)
    for kv in ("int8", "dense"):
        _, p = wall_ms(lambda: llava.prefill(ids, px, Lp + T, kv_cache=kv))
        _, g = wall_ms(lambda: greedy_generate(llava, ids, px,
                                               max_new_tokens=T, eos_id=-1,
                                               kv_cache=kv))
        out[kv].append(g - p)
    return out


def device_busy(fn):
    """One batch under torch.profiler, tracing the card's activity alone
    and read from the profiler's raw events (a trace with the host's
    operations costs over a minute to read for one 13B batch): the share of
    its wall time in which the card ran a kernel, copy or memset, the names
    with the most device time, the device time and count of the card's
    copies (kernels and memcpys whose name holds "copy": each a copy the
    host asked for, ``.contiguous()``, a reshape of a view, a dtype cast),
    and the device time and count of each hand-written kernel whose wrapper
    launched in the batch, in all and by symbol (route). The profiler's
    host-side cost lengthens the batch, so the share is a lower bound.
    ``None`` where the trace holds no device activity."""
    before = {n: WRAPPERS[n].launches for n in KERNELS}
    ms, evs = card_trace(fn)
    busy = busy_ns(evs)
    by_name = {}
    for name, _, d in evs:
        n = by_name.setdefault(name, [0.0, 0])
        n[0] += d / 1e6
        n[1] += 1
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:8]
    ours, by_symbol = {}, {}
    for n, w in KERNELS.items():
        # two wrappers may launch one symbol (the int8 GEMM): a kernel's
        # time counts only where its own wrapper launched in this run
        launched = WRAPPERS[n].launches > before[n]
        hits = [(k, v) for k, v in by_name.items() if launched
                and any(s in k for s in w["symbols"])]
        ours[n] = [sum(v[0] for _, v in hits), sum(v[1] for _, v in hits)]
        for sym in w["symbols"]:
            mine = [v for k, v in hits if sym in k]
            if mine:
                by_symbol[sym] = [sum(v[0] for v in mine),
                                  sum(v[1] for v in mine)]
    copies = [v for k, v in by_name.items() if "copy" in k.lower()]
    return {"batch_ms": ms, "device_busy_ms": busy / 1e6,
            "device_busy_share": busy / 1e6 / ms if evs else None,
            "copy_device_ms": sum(v[0] for v in copies),
            "copy_launches": sum(v[1] for v in copies),
            "top_device_ms": [[k[:80], v[0], v[1]] for k, v in top],
            "kernel_device_ms": ours, "symbol_device_ms": by_symbol}


def device_or_event_ms(fn, iters, calls=None):
    """``device_ms`` of one call, or CUDA events (``time_ms``) where the
    profiler's trace holds no device activity; and which it was."""
    ms = device_ms(fn, iters, calls=calls)[0]
    return (ms, "device") if ms is not None else (time_ms(fn, iters),
                                                  "events")


def _cycled(make, nbytes):
    """Copies of ``make()``'s tensors enough to pass the 50 MB L2 between
    reuses (the serving and training paths stream their weights from
    memory), and a function that returns the next copy each call."""
    copies = [make() for _ in range(max(1, min(16, -(-200_000_000
                                                     // nbytes))))]
    it = iter(range(1 << 62))
    return lambda: copies[next(it) % len(copies)]


def linear_shapes(lcfg):
    """The LLaMA's linears: what -> (N, K, calls per layer)."""
    h, i = lcfg.hidden_size, lcfg.intermediate_size
    return {"q/k/v/o": (h, h, 4), "gate/up": (i, h, 2), "down": (h, i, 1)}


@torch.no_grad()
def int4_costs(lcfg):
    """Device time a call (``device_ms``) at the 7B decode shapes (B rows,
    bf16 x) of the int4 call (``int4_matmul``: the decode kernel), of
    kernel 6 on an int8 weight of the same shape (the 7B-int8
    path's call), and of the unpack route the card took before: the unpack
    of the packed weight into a transient (N, K) int8 copy (nibble
    extraction and a cat), kernel 6 on it (f32 x * rf) and that whole
    call; the unpack beside its bytes bound (N K / 2 read, N K written),
    the packed weight's and the int8 weight's bytes bounds (N K / 2 and N
    K read), and each summed over one decode step's calls (the packed
    bound of a 7B step ≈ 1.0 ms, the int8 one ≈ 2.0). Weights are cycled past
    the L2, as decode streams them. ``host_issue_us``: the host's time to
    issue one call (500 calls back to back at the q/k/v/o shape) of
    ``int4_matmul``, of its wrapper ``int4_matmul_fused`` and of kernel
    6's ``int8_matmul_fused``: decode is host-bound, so these set its
    pace."""
    name = torch.cuda.get_device_name(0)
    gen = torch.Generator(device="cuda").manual_seed(9)
    shapes = {k: (N, K, n * lcfg.num_layers)
              for k, (N, K, n) in linear_shapes(lcfg).items()}
    shapes["lm_head"] = (lcfg.padded_vocab_size, lcfg.hidden_size, 1)
    keys = ("int4_matmul_ms", "int8_kernel_ms", "unpack_ms", "kernel_ms",
            "unpack_route_ms", "unpack_bound_ms", "packed_bound_ms",
            "int8_bound_ms")
    rows, step = {}, dict.fromkeys(keys, 0.0)
    for what, (N, K, n) in shapes.items():
        def make():
            return (torch.randint(-127, 128, (N, K // 2), generator=gen,
                                  device="cuda", dtype=torch.int8),
                    torch.full((N,), 1.0 / (7.0 * K ** 0.5), device="cuda"),
                    torch.ones(K, device="cuda"))

        nxt = _cycled(make, N * K // 2)
        x = rand_bf16(gen, (B, K))
        whole, how_w = device_or_event_ms(
            lambda: QT.int4_matmul(x, *nxt()), 20)
        # the unpack runs its elementwise kernel several times a call
        unpack, how = device_or_event_ms(
            lambda: torch.cat(QT.unpack_int4(nxt()[0]), 1), 20, calls=20)
        ws = _cycled(lambda: torch.cat(QT.unpack_int4(nxt()[0]), 1), N * K)
        xr = x.float()
        cs = torch.full((N,), 1.0 / (7.0 * K ** 0.5), device="cuda")
        kernel, how_k = device_or_event_ms(lambda: Q.int8_matmul_fused(
            xr, ws(), cs, out_dtype=torch.bfloat16), 20)
        int8, how_8 = device_or_event_ms(lambda: Q.int8_matmul_fused(
            x, ws(), cs), 20)
        old, how_o = device_or_event_ms(
            lambda: Q4.int4_matmul_unpack_route(x, *nxt()), 20, calls=20)
        t, _ = bound(0, N * K // 2 + N * K, name)
        packed_t, _ = bound(0, N * K // 2, name)
        int8_t, _ = bound(0, N * K, name)
        vals = dict(zip(keys, (whole, int8, unpack, kernel, old, t, packed_t,
                               int8_t)))
        rows[what] = {"N": N, "K": K, "calls_per_decode_step": n, **vals,
                      "timed_by": [how_w, how_8, how, how_k, how_o]}
        for k, v in vals.items():
            step[k] += n * v
        if what == "q/k/v/o":
            w4, w8 = nxt(), ws()
            host = {"int4_matmul": host_issue_us(
                        lambda: QT.int4_matmul(x, *w4)),
                    "int4_matmul_fused": host_issue_us(
                        lambda: Q4.int4_matmul_fused(x, *w4)),
                    "int8_matmul_fused": host_issue_us(
                        lambda: Q.int8_matmul_fused(x, w8, cs))}
            del w4, w8
        del nxt, ws
        torch.cuda.empty_cache()
    return {"rows": B, "by_shape": rows, "per_decode_step": step,
            "host_issue_us": host}


def host_issue_us(fn, calls: int = 500):
    """The host's time in µs to issue one call of ``fn``: ``calls`` calls
    back to back on the host clock after a synchronise, two rounds, the
    lower (the card runs behind, so its time is not in it while the
    queue has room)."""
    out = []
    for _ in range(2):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return min(out)


@torch.no_grad()
def ste_backward_costs(lcfg, rows):
    """Device time a call (``device_ms``) of the straight-through backward
    (``ops/quant.py:ste_input_grad``) at the QLoRA step's shapes (``rows``
    = B x 512, bf16 g): the transient bf16 copy of W_q, the bf16 GEMM with
    an f32 output, and the whole call; the GEMM beside its operations bound
    and a bf16-output ``torch.mm`` (a yardstick, whose rounding the
    backward must not take), and each summed over one step's calls (every
    int8 linear of every layer once)."""
    name = torch.cuda.get_device_name(0)
    gen = torch.Generator(device="cuda").manual_seed(10)
    out, step = {}, {"w_cast_ms": 0.0, "gemm_ms": 0.0, "ste_backward_ms": 0.0}
    for what, (N, K, n) in linear_shapes(lcfg).items():
        n *= lcfg.num_layers
        g = rand_bf16(gen, (rows, N))
        w = torch.randint(-127, 128, (N, K), generator=gen, device="cuda",
                          dtype=torch.int8)
        scale = torch.full((N,), 1.0 / (127.0 * K ** 0.5), device="cuda")
        gs = (g.float() * scale).to(torch.bfloat16)
        wb = w.to(torch.bfloat16)
        cast, how = device_or_event_ms(lambda: w.to(torch.bfloat16), 10)
        gemm, how_g = device_or_event_ms(
            lambda: torch.mm(gs, wb, out_dtype=torch.float32), 10)
        whole, how_w = device_or_event_ms(
            lambda: QT.ste_input_grad(g, w, scale, torch.bfloat16), 10)
        bf16_mm, how_b = device_or_event_ms(lambda: torch.mm(gs, wb), 10)
        t, by = bound(2 * rows * N * K, 2 * rows * N + 2 * N * K + 4 * rows * K,
                      name)
        out[what] = {"M": rows, "N": N, "K": K, "calls_per_step": n,
                     "w_cast_ms": cast, "gemm_ms": gemm,
                     "gemm_bound_ms": t, "gemm_bound_by": by,
                     "bf16_out_mm_ms": bf16_mm, "ste_backward_ms": whole,
                     "timed_by": [how, how_g, how_w, how_b]}
        for k, v in (("w_cast_ms", cast), ("gemm_ms", gemm),
                     ("ste_backward_ms", whole)):
            step[k] += n * v
        del g, w, gs, wb
        torch.cuda.empty_cache()
    return {"by_shape": out, "per_step": step}


def decode_split(model, batch, kv_cache):
    """Where the decode leg's time goes, in one call: the synchronised wall
    time of greedy_generate, the host time until it returns, and the card's
    busy time (``device_busy_ms``); prefill's are subtracted to leave the
    31 decode steps."""
    llava, cfg = model.llava, model.config
    ids = torch.as_tensor(batch["input_ids"], device="cuda")
    px = batch["images_clip"]
    Lp = L_TEXT - 1 + cfg.clip.num_patches

    def prefill():
        return llava.prefill(ids, px, Lp + T, kv_cache=kv_cache)

    def generate():
        return greedy_generate(llava, ids, px, max_new_tokens=T, eos_id=-1,
                               kv_cache=kv_cache)

    walls, issue = {}, {}
    for n, f in (("p", prefill), ("g", generate)):
        issue[n], walls[n] = issue_and_wall_ms(f)
    busy = {n: device_busy_ms(f)
            for n, f in (("p", prefill), ("g", generate))}
    return {"decode_wall": walls["g"] - walls["p"],
            "decode_host_issue": issue["g"] - issue["p"],
            "decode_device_busy": busy["g"] - busy["p"],
            "generate_wall": walls["g"], "generate_host_issue": issue["g"],
            "generate_device_busy": busy["g"]}


def leg_times(model, batch, maps, gidx, gw, fits, ref, kv_cache):
    """Each leg of one streaming batch, host clock around a synchronised
    call. The gather-form lift (the bench's) is held to the scatter form
    that evaluate_batch runs, 1e-5 absolute, on the vertices with at most
    MAX_K pixels in every view (``fits``): there both sum the same f32
    terms in a different order. The gather form keeps MAX_K pixels of a
    vertex and view, as ``bench.py``'s does, and the real maps give the
    sphere's poles and near-silhouette rings more."""
    cfg = model.config
    ids = torch.as_tensor(batch["input_ids"], device="cuda")
    px = batch["images_clip"]
    Lp = L_TEXT - 1 + cfg.clip.num_patches
    llava = model.llava
    _, prefill = wall_ms(lambda: llava.prefill(ids, px, Lp + T,
                                               kv_cache=kv_cache))
    gen, generate = wall_ms(
        lambda: greedy_generate(llava, ids, px, max_new_tokens=T, eos_id=-1,
                                kv_cache=kv_cache))
    # the hidden state that predicted each sample's first [SEG]
    is_seg = ref["generated_ids"] == cfg.seg_token_idx
    first = torch.where(ref["has_seg"], is_seg.int().argmax(1), 0)
    h = gen["step_hidden"][torch.arange(B, device="cuda"), first]
    emb, encode = wall_ms(lambda: model.encode_sam_images(batch["sam_images"]))
    cams = batch["cam_params"]

    def tail():
        low = model.low_res_masks_from_image_emb(h, None, emb, cams)
        return model.upsample_masks(low, MASK)

    masks, mask_tail = wall_ms(tail)
    scatter, lift = wall_ms(
        lambda: lift_human(masks, maps["p2v"], maps["bary"], N_VERTS))
    gathered, lift_gather = wall_ms(lambda: torch.stack(
        [lift_multiview_soft_gather(m, gidx, gw) for m in masks]))
    diff = max_err(scatter[:, fits], gathered[:, fits])
    if not diff < 1e-5:
        raise SystemExit(f"gather-form lift disagrees with the scatter form: {diff}")
    return {"clip_prefill": prefill, "decode": generate - prefill,
            "sam_encode": encode, "mask_tail": mask_tail, "lift": lift,
            "lift_gather": lift_gather, "lift_gather_vs_scatter": diff}


def hoi_path_phase(path, cfg, human, obj):
    """The interaction path: ``config_13b_hoi`` through ``evaluate_batch``
    with ``max_seg_tokens=K_HOI`` in streaming mode (object views are
    per-sample renders, so no cached embedding) at B=8, V=4, T=32, 1024^2
    masks: one warm-up batch, then REPEATS timed ones, launches counted
    from 0 over the first. Each row's K slots fold into one SAM decode over
    B*K*V images; the [HSEG] slots lift onto the human maps ``human``, the
    [OSEG] slots onto ``obj`` given as per-sample maps (3, B, V, H, W).
    Checks: some answer carries both tokens, every output finite, contacts
    in [0, 1], and each of kernels 1, 2 and 3 launched as many times as
    the path has calls for it, on its wgmma route."""
    t0 = time.perf_counter()
    model = InteractVLM(cfg, device="cuda")
    init_params(model, torch.Generator(device="cuda").manual_seed(0))
    model.eval().requires_grad_(False)
    torch.cuda.synchronize()
    log(json.dumps({"phase": "init", "path": path,
                    "params": sum(p.numel() for p in model.parameters()),
                    "s": time.perf_counter() - t0}))
    batch = synthetic_batch(cfg, B, L_TEXT, "cuda", 0)
    batch["images_clip"] = batch["images_clip"].to(cfg.clip.dtype)
    chosen = let_both_seg_tokens_appear(model, batch, "cuda", T)
    # the object's maps as a batch of its renders carries them: one copy a
    # sample, (3, B, V, H, W), the layout the ocontact lift reads
    objs = {k: obj[k][:, None].expand((3, B) + obj[k].shape[1:]).contiguous()
            for k in ("p2v", "bary")}
    batch["obj_p2v"], batch["obj_bary"] = objs["p2v"], objs["bary"]
    batch["gt_ocontact"] = torch.zeros(B, N_OBJ, device="cuda")
    maps_gb = sum(t.numel() * t.element_size() for t in objs.values()) / 1e9

    def run():
        return evaluate_batch(model, batch, MASK, "hcontact",
                              max_new_tokens=T, human_maps=human, eos_id=-1,
                              max_seg_tokens=K_HOI)

    run()  # warm-up: cuBLAS handles, allocator
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for rnd in range(REPEATS):
        if rnd == 0:
            reset_launches()
        o, ms = wall_ms(run)
        secs.append(ms / 1e3)
        if rnd == 0:
            launches, out = read_launches(), o
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_global = len(cfg.sam.encoder_global_attn_indexes)
    n_window = cfg.sam.encoder_depth - n_global
    # kernel 1: each LLaMA layer's prefill and each SAM decoder block's
    # image -> token attention, one call over all B*K*V slot images
    want = {"flash_attention": cfg.llama.num_layers + cfg.sam.decoder_depth,
            "fwd_routes": {"sm90": cfg.llama.num_layers,
                           "sm90_d16": cfg.sam.decoder_depth, "mma": 0},
            "window_attention": n_window, "rel_attention": n_global,
            "window_routes": {"mma": 0, "sm90": n_window},
            "rel_routes": {"mma": 0, "sm90": n_global}}
    tok, valid = out["token_ids_k"], out["valid_k"]
    both = (((tok == cfg.hseg_token_idx) & valid).any(1)
            & ((tok == cfg.oseg_token_idx) & valid).any(1))
    h3d, o3d, masks = (out["pred_hcontact_3d"], out["pred_ocontact_3d"],
                       out["pred_masks_k"])
    checks = {
        "launches_as_expected": all(launches[k] == v
                                    for k, v in want.items()),
        "a_row_with_both_slots": bool(both.any()),
        "masks_k_shape_finite": (tuple(masks.shape)
                                 == (B, K_HOI, V, MASK, MASK)
                                 and bool(torch.isfinite(masks).all())),
        "contacts_in_0_1": all(
            c is not None and bool(torch.isfinite(c).all())
            and float(c.min()) >= 0.0 and float(c.max()) <= 1.0
            for c in (h3d, o3d)),
        "contact_shapes": (h3d is not None and o3d is not None
                           and tuple(h3d.shape) == (B, N_VERTS)
                           and tuple(o3d.shape) == (B, N_OBJ)),
    }
    med = float(np.median(secs))
    log(json.dumps({"phase": "main_path", "path": path, "mode": "streaming",
                    "batch": B, "slots": K_HOI, "seg_rows": chosen,
                    "images_per_s": B / med,
                    "images_per_s_min": B / max(secs),
                    "images_per_s_max": B / min(secs), "batch_s": secs,
                    "peak_gb": peak_gb, "object_maps_gb": maps_gb,
                    "token_ids_k": tok.tolist(),
                    "rows_with_both": int(both.sum()),
                    "hcontact_mean": float(h3d.mean()) if h3d is not None
                    else None,
                    "ocontact_mean": float(o3d.mean()) if o3d is not None
                    else None,
                    "launches": launches, "expected": want, **checks}))
    if not all(checks.values()):
        raise SystemExit(f"the {path} path failed: {checks}")
    runs = [hoi_leg_times(model, batch, human) for _ in range(LEG_REPEATS)]
    legs = {k: spread([r[k] for r in runs]) for k in runs[0]}
    log(json.dumps({"phase": "legs_ms", "path": path, **legs,
                    "peak_gb": peak_gb}))
    log(json.dumps({"phase": "decode_host_device_ms", "path": path,
                    "kv_cache": "dense",
                    **decode_split(model, batch, "dense")}))
    prof = device_busy(run)
    log(json.dumps({"phase": "profile", "path": path, "mode": "streaming",
                    **prof, "device_busy_share_of_median_batch":
                        None if prof["device_busy_share"] is None
                        else prof["device_busy_ms"] / (med * 1e3)}))
    del model, batch, objs, out
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def hoi_leg_times(model, batch, human):
    """Each leg of one streaming batch of the interaction path, host clock
    around a synchronised call: CLIP + prefill, decode, the SAM encode, the
    K-slot mask tail (text projection, cam conditioning, the splitter, one
    decode over B*K*V images, the upsampling), the human lift of each row's
    [HSEG] slot and the per-sample object lift of its [OSEG] slot."""
    cfg = model.config
    ids = torch.as_tensor(batch["input_ids"], device="cuda")
    px = batch["images_clip"]
    Lp = L_TEXT - 1 + cfg.clip.num_patches
    llava = model.llava
    _, prefill = wall_ms(lambda: llava.prefill(ids, px, Lp + T))
    gen, generate = wall_ms(lambda: greedy_generate(
        llava, ids, px, max_new_tokens=T, eos_id=-1))
    gen_ids = gen["generated_ids"]
    is_seg = torch.isin(gen_ids, torch.tensor(model.seg_ids, device="cuda"))
    seg_h, tok, valid = seg_slots(gen_ids, is_seg, gen["step_hidden"], K_HOI)
    emb, encode = wall_ms(lambda: model.encode_sam_images(batch["sam_images"]))
    cams = batch["cam_params"]

    def tail():
        low = model.multi_seg_low_res_masks(seg_h, tok, valid, emb, cams)
        return model.upsample_masks(low.flatten(0, 1), MASK).unflatten(
            0, (B, K_HOI))

    masks, mask_tail = wall_ms(tail)
    rows = torch.arange(B, device="cuda")
    h_slot = ((tok == cfg.hseg_token_idx) & valid).int().argmax(1)
    o_slot = ((tok == cfg.oseg_token_idx) & valid).int().argmax(1)
    _, lift_h = wall_ms(lambda: lift_human(
        masks[rows, h_slot], human["p2v"], human["bary"], N_VERTS))
    _, lift_o = wall_ms(lambda: lift_objects_per_sample(
        masks[rows, o_slot], batch, N_OBJ, "cuda"))
    return {"clip_prefill": prefill, "decode": generate - prefill,
            "sam_encode": encode, "mask_tail_k": mask_tail,
            "human_lift": lift_h, "object_lift": lift_o}


# --------------------------------------------------------------- training
# training reference phase: each loss term within LOSS_RTOL of the CPU's
# (relative, or absolute below 1e-2); each trainable's gradient with a
# cosine of at least GRAD_COS and a norm within GRAD_NORM_RTOL of the CPU's,
# where the CPU gradient's norm is above GRAD_FLOOR of the largest one (a
# key projection's bias has an exactly zero gradient in exact arithmetic:
# there both sides are rounding noise, and only finiteness is held). See
# train_reference_phase for why these sizes.
LOSS_RTOL, GRAD_COS, GRAD_NORM_RTOL, GRAD_FLOOR = 2e-2, 0.99, 1e-1, 1e-3
REF_TRAIN_L, REF_TRAIN_PADDED = 256, 200


def right_pad(batch, row, length, seg, hseg=None):
    """Right-pad one row of a ``make_synthetic_batch`` batch to ``length``
    text tokens: its [SEG] token (with ``hseg``, K-slot batches' [HSEG] two
    positions before it) and its three supervised positions move inside
    the length (as the batch lays them out at the end of a row), the rest
    becomes padding (id 0, mask 0, label ignored)."""
    ids, labels = batch["input_ids"], batch["labels"]
    ids[row, length - 2] = seg
    if hseg is not None:
        ids[row, length - 4] = hseg
    labels[row] = IGNORE_INDEX
    labels[row, length - 3:length] = ids[row, length - 3:length]
    labels[row, length - 3] = 9
    ids[row, length:] = 0
    batch["attn_mask"][row, length:] = 0


def train_kv_lengths():
    """The spliced lengths of the 13B training batch: text length - 1 +
    256 patches; the padded rows first."""
    P = clip_vit_l_14().num_patches
    text = list(TRAIN_PADDED) + [L_TRAIN] * (B - len(TRAIN_PADDED))
    return tuple(n - 1 + P for n in text)


def one_seg_pair_a_row(batch, seg_ids):
    """Keep one [HSEG] and one [OSEG] a row of a K-slot synthetic batch
    (at L - 4 and L - 2), as the preset's answers carry: its random prompt
    ids hit the seg ids of the tiny vocabulary, and the first two marked
    positions would then be stray ones."""
    ids, labels = batch["input_ids"], batch["labels"]
    stray = torch.isin(ids, torch.tensor(seg_ids))
    stray[:, -4] = stray[:, -2] = False
    ids[stray] = 7
    labels[stray & (labels != IGNORE_INDEX)] = 7


HOI_HEADS = ("attention_splitter.", "cam_pose_encoder.",
             "sam.human_mask_decoder.", "sam.object_mask_decoder.",
             "sam.mask_decoder.", "fusion.", "text_hidden_fcs.")


def by_head(card, cpu):
    """Each of ``HOI_HEADS``' gradient as one vector, the card's against
    the CPU's (name -> flat gradient): the CPU norm, the cosine and the
    norm's relative error."""
    out = {}
    for head in HOI_HEADS:
        g, w = (torch.cat([v.flatten() for n, v in d.items()
                           if n.startswith(head)]) for d in (card, cpu))
        out[head] = {"cpu_norm": w.norm().item(),
                     "cos": (g @ w / (g.norm() * w.norm())).item(),
                     "norm_rel_err": abs(g.norm().item() / w.norm().item()
                                         - 1)}
    return out


def heads_in_f32(cpu, cfg, mask):
    """The interaction heads' gradients (``HOI_HEADS``, each as one vector)
    from one K = 2 step on the card in f32 against the CPU's, at the
    training reference's cosine and norm limits. The bf16 step cannot hold
    them (its ``bf16_grads_by_head`` are logged): at the tiny widths a
    rounding flips ReLU and GELU kinks of the 32-wide decoders, and
    LLaMA's token tables set the per-leaf floor above the decoders'
    leaves. A 64-token prompt keeps LLaMA's attention below the flash
    prefill's 256 spliced tokens, and the SAM embedding is the CPU's (the
    window kernel takes bf16 only), so every operation is the card's f32
    version of what the CPU runs: the splitter, the cam encoder, the three
    decoders by route, the fusion, the losses and their backward."""
    batch = make_synthetic_batch(cfg, B=2, L=64, tasks=(2, 3), mask_size=64,
                                 seed=7, device="cpu")
    one_seg_pair_a_row(batch, cpu.seg_ids)
    cpu.zero_grad(set_to_none=True)
    emb = cpu.encode_sam_images(batch["sam_images"])
    cpu(batch)["loss"].backward()
    gpu = InteractVLM(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    apply_trainable_mask(gpu)
    gpu.encode_sam_images = lambda px: emb.cuda()
    gpu({k: v.cuda() for k, v in batch.items()})["loss"].backward()
    card, ref = ({n: (p.grad if p.grad is not None else torch.zeros_like(p)
                      ).float().cpu()
                  for n, p in m.named_parameters() if mask[n]}
                 for m in (gpu, cpu))
    del gpu
    return by_head(card, ref)


def train_reference_phase(kind: str):
    """One LoRA training forward and backward of ``interactvlm_tiny`` (rank
    4, remat on; ``kind`` "qlora" over a frozen int8 LLaMA base, the
    straight-through backward; "hoi" the interaction branches with K = 2
    slots, the DifDe decoders and the fusion: ``HOI_TINY`` with
    ``use_fusion``, an hcontact and an oafford row, each with [HSEG] and
    [OSEG], so all three decoders train) on the card in bf16 against the
    same on the CPU in f32,
    from the same weights (LoRA B drawn non-zero so A has a gradient). A
    256-token prompt (259 spliced, one row right-padded to 200) makes
    LLaMA's causal attention launch the flash forward (twice a layer under
    remat) and both backward kernels with ragged kv lengths; SAM runs bf16
    on the card (its encoder without autograd). bf16 keeps ~3 significant
    digits: through two LLaMA layers, SAM's decoder and the lifts a loss
    moves by well under a percent, a gradient's direction by a fraction of
    one (cosine >= 0.99), and a small leaf's norm, summed over few terms,
    by a few percent (so 10 %). The trainable leaves stay f32 on the card
    (cast_frozen_params), as in training. Under ``qlora`` the card's int8
    linears quantize bf16 activations with kernel 6 and the CPU's f32 ones
    with the composition: besides the rounding-tie difference of the int8
    tiny pipeline (``reference_phase``), an activation one bf16 step off
    moves its int8 value by one where it sits near a rounding boundary,
    noise of the size of bf16's own (one part in 254 against 256), which
    the same limits hold. Under "hoi" the heads' and decoders' gradients
    are also held as whole vectors from an f32 step on the card
    (``heads_in_f32``): in bf16 only the per-leaf check holds them."""
    bf16 = torch.bfloat16
    qlora = kind == "qlora"
    heads = dict(HOI_TINY, use_fusion=True) if kind == "hoi" else {}
    llama = llama_tiny(lora_rank=4, remat=True, weights_int8=qlora)
    cpu_cfg = interactvlm_tiny(llama=llama, **heads)
    gpu_cfg = interactvlm_tiny(llama=dataclasses.replace(llama, dtype=bf16),
                               sam=sam_tiny(dtype=bf16), **heads)
    cpu = init_params(InteractVLM(cpu_cfg, device="cpu"),
                      torch.Generator().manual_seed(4))
    with torch.no_grad():
        gen = torch.Generator().manual_seed(5)
        for n, p in cpu.named_parameters():
            if "lora_B" in n:
                p.normal_(0.0, 0.05, generator=gen)
    gpu = cast_frozen_params(InteractVLM(gpu_cfg, device="cuda"), bf16)
    gpu.load_state_dict(cpu.state_dict())
    batch = make_synthetic_batch(cpu_cfg, B=2, L=REF_TRAIN_L, tasks=(2, 3),
                                 mask_size=64, seed=4, device="cpu")
    batch["attn_mask"] = torch.ones_like(batch["input_ids"])
    if kind == "hoi":
        one_seg_pair_a_row(batch, cpu.seg_ids)
        right_pad(batch, 1, REF_TRAIN_PADDED, cpu_cfg.oseg_token_idx,
                  cpu_cfg.hseg_token_idx)
    else:
        right_pad(batch, 1, REF_TRAIN_PADDED, cpu_cfg.seg_token_idx)
    mask = apply_trainable_mask(cpu)
    apply_trainable_mask(gpu)
    want = cpu(batch)
    want["loss"].backward()
    reset_launches()
    got = gpu({k: v.cuda() for k, v in batch.items()})
    got["loss"].backward()
    torch.cuda.synchronize()
    launched = read_launches()
    losses = {}
    for k, w in want.items():
        if w.dim() == 0:
            g, w = got[k].item(), w.item()
            losses[k] = {"cpu": w, "card": g,
                         "err": abs(g - w) / max(abs(w), 1e-2)}
    def grad(p):  # a trainable the loss does not reach (the IoU head)
        return p.grad.float().cpu() if p.grad is not None else torch.zeros(
            p.shape)

    cpu_grads = {n: grad(p) for n, p in cpu.named_parameters() if mask[n]}
    floor = GRAD_FLOOR * max(g.norm().item() for g in cpu_grads.values())
    worst_cos, worst_norm, finite, n_held = 1.0, 0.0, True, 0
    worst_leaf = {}
    for n, p in gpu.named_parameters():
        if not mask[n]:
            continue
        g, w = grad(p), cpu_grads[n]
        finite = finite and bool(torch.isfinite(g).all())
        if w.norm().item() > floor:
            n_held += 1
            cos = (g.flatten() @ w.flatten() / (g.norm() * w.norm())).item()
            norm_err = abs(g.norm().item() / w.norm().item() - 1)
            if cos < worst_cos:
                worst_leaf["cos"] = [n, cos, w.norm().item()]
            if norm_err > worst_norm:
                worst_leaf["norm"] = [n, norm_err, w.norm().item()]
            worst_cos = min(worst_cos, cos)
            worst_norm = max(worst_norm, norm_err)
    bf16_heads = f32_heads = {}
    if kind == "hoi":
        bf16_heads = by_head({n: grad(p) for n, p in gpu.named_parameters()
                              if mask[n]}, cpu_grads)
        f32_heads = heads_in_f32(cpu, cpu_cfg, mask)
    heads_ok = all(h["cpu_norm"] > 0 and h["cos"] >= GRAD_COS
                   and h["norm_rel_err"] <= GRAD_NORM_RTOL
                   for h in f32_heads.values())
    res = dict(phase="train_reference", config=f"interactvlm_tiny {kind} 4",
               losses=losses, grads_held=n_held,
               bf16_grads_by_head=bf16_heads, f32_grads_by_head=f32_heads,
               grads_total=sum(mask.values()), worst_cos=worst_cos,
               worst_norm_rel_err=worst_norm, worst_leaf=worst_leaf,
               grads_finite=finite,
               launches=launched,
               tol={"loss_rtol": LOSS_RTOL, "grad_cos": GRAD_COS,
                    "grad_norm_rtol": GRAD_NORM_RTOL,
                    "grad_floor": GRAD_FLOOR})
    log(json.dumps(res))
    needed = TRAINING_KERNELS + (("int8_matmul",) if qlora else ())
    int8_frozen = all(p.grad is None for n, p in gpu.named_parameters()
                      if p.dtype == torch.int8)
    if not (all(v["err"] <= LOSS_RTOL for v in losses.values()) and finite
            and worst_cos >= GRAD_COS and worst_norm <= GRAD_NORM_RTOL
            and int8_frozen and all(launched[n] > 0 for n in needed)
            and heads_ok):
        raise SystemExit(f"the card's training step disagrees with the "
                         f"CPU's: {res}")
    del cpu, gpu, got, want
    gc.collect()
    torch.cuda.empty_cache()


def config_13b_train():
    """The JAX trainer's default preset at full width: LLaMA-13B bf16 with
    LoRA rank 8 (alpha 16) on q/v and remat, CLIP ViT-L/14 and SAM ViT-H in
    bf16 (exact GELU, no int8)."""
    bf16 = torch.bfloat16
    llama = llama_13b(dtype=bf16, lora_rank=8, lora_alpha=16.0)
    return dataclasses.replace(
        interactvlm_13b(), llama=llama, clip=clip_vit_l_14(dtype=bf16),
        sam=sam_vit_h(dtype=bf16),
        seg_token_idx=min(llama.vocab_size - 1, 32000),
        img_emb_len=clip_vit_l_14().num_patches - 1)


def config_7b_qlora_train():
    """The JAX package's one-chip training configuration
    (``scripts/train_step_probe.py`` with ``PROBE_INT8=1``) at full width:
    LLaMA-7B with a frozen int8 base and LoRA rank 8 (alpha 16) on q/v,
    remat, the lm_head in bf16 (it trains); CLIP ViT-L/14 and SAM ViT-H in
    bf16 (exact GELU, no int8)."""
    bf16 = torch.bfloat16
    llama = llama_7b(dtype=bf16, lora_rank=8, lora_alpha=16.0,
                     weights_int8=True)
    return dataclasses.replace(
        config_13b_train(), llama=llama,
        seg_token_idx=min(llama.vocab_size - 1, 32000))


def frozen_fingerprint(model):
    """Per frozen parameter, two sums over its raw bits (plain and
    position-weighted): any changed element changes them."""
    sums = []
    with torch.no_grad():
        for p in model.parameters():
            if p.requires_grad:
                continue
            bits = p.detach().flatten().view(
                {1: torch.int8, 2: torch.int16, 4: torch.int32}[
                    p.element_size()]).long()
            w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
            sums.append(torch.stack([bits.sum(), (bits * w).sum()]))
    return torch.stack(sums).cpu()


def train_launches_expected(cfg, steps: int = 1):
    """Each kernel's launches over ``steps`` training steps of ``cfg``
    (B=8 rows of 512 spliced tokens, LLaMA's head dim 128)."""
    layers, dec = cfg.llama.num_layers, cfg.sam.decoder_depth
    n_global = len(cfg.sam.encoder_global_attn_indexes)
    qlora = cfg.llama.weights_int8
    # each layer's flash forward runs again in the backward under remat;
    # the SAM decoder's image->token attention (Lq = 4096) once a block;
    # under QLoRA each layer's 7 int8 linears twice too (forward and
    # remat), all on the two-pass route (B x 512 rows)
    two = 2 * 7 * layers if qlora else 0
    want = {n: 0 for n in KERNELS}
    want.update({"flash_attention": 2 * layers + dec,
                 "fwd_routes": {"sm90": 2 * layers, "sm90_d16": dec,
                                "mma": 0},
                 "flash_attention_bwd_dq": layers + dec,
                 "flash_attention_bwd_dkv": layers + dec,
                 "window_attention": cfg.sam.encoder_depth - n_global,
                 "rel_attention": n_global,
                 "int8_matmul": two, "quantize_rows": two,
                 "int8_routes": {"one_launch": 0, "two_pass": two},
                 "int8_gemm": two, "int4_gemm": 0,
                 "int4_routes": {"one_launch": 0, "two_pass": 0},
                 "window_routes": {"mma": 0, "sm90": cfg.sam.encoder_depth
                                   - n_global},
                 "rel_routes": {"mma": 0, "sm90": n_global},
                 "bwd_dq_routes": {"sm90": layers, "sm90_d16": dec,
                                   "mma": 0},
                 "bwd_dkv_routes": {"sm90": layers, "sm90_d16": dec,
                                    "mma": 0}})
    return {k: ({r: steps * c for r, c in v.items()} if isinstance(v, dict)
                else steps * v) for k, v in want.items()}


def training_path_phase(path, cfg, maps, reference=None):
    """A LoRA (or QLoRA) training step at B=8 on the real lift maps
    ``maps`` (the human 3D loss's): one warm-up step (step 0 of the
    warm-up, lr 0), then TRAIN_STEPS timed steps, each phase's end
    synchronised (``TrainStep``'s ``mark``); launches counted from 0 over
    the first timed step; one more step under the profiler. Under
    ``weights_int8`` (QLoRA) also the straight-through backward's device
    time (``ste_backward_costs``). With ``reference``, first one forward
    and backward of the fresh model on the batch, saved there for phase
    17's sharded step (``save_reference``)."""
    t0 = time.perf_counter()
    model = InteractVLM(cfg, device="cuda")
    init_params(model, torch.Generator(device="cuda").manual_seed(0))
    cast_frozen_params(model, torch.bfloat16)
    opt, sched = make_optimizer(model)  # lr 3e-4, warm-up 100 of 15000
    step = TrainStep(model, opt, sched)
    n_train = sum(p.numel() for p in step.params)
    torch.cuda.synchronize()
    log(json.dumps({"phase": "init", "path": path,
                    "params": sum(p.numel() for p in model.parameters()),
                    "trainable": n_train, "s": time.perf_counter() - t0}))

    t0 = time.perf_counter()
    batch = make_synthetic_batch(cfg, B=B, L=L_TRAIN, tasks=(2,),
                                 mask_size=MASK, seed=0, device="cuda")
    batch["attn_mask"] = torch.ones_like(batch["input_ids"])
    batch["human_p2v"], batch["human_bary"] = maps["p2v"], maps["bary"]
    for row, n in enumerate(TRAIN_PADDED):
        right_pad(batch, row, n, cfg.seg_token_idx)
    lens = tuple((batch["attn_mask"].sum(1) - 1
                  + cfg.clip.num_patches).tolist())
    if lens != train_kv_lengths():
        raise SystemExit(f"training kv lengths {lens}")
    log(json.dumps({"phase": "train_batch", "s": time.perf_counter() - t0,
                    "kv_lengths": lens}))
    if reference is not None:
        save_reference(path, model, batch, reference)
    fp = frozen_fingerprint(model)
    watched = {n: p.detach().clone() for n, p in model.named_parameters()
               if "lora_B" in n or "mask_decoder" in n}

    steps = [step(batch)]  # warm-up: cuBLAS handles, the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs, split = [], {"forward": [], "backward": [], "optimizer": []}
    for i in range(TRAIN_STEPS):
        marks = []

        def mark(phase):
            torch.cuda.synchronize()
            marks.append((phase, time.perf_counter()))

        if i == 0:
            reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        steps.append(step(batch, mark))
        if i == 0:
            launches = read_launches()
        prev = t
        for phase, at in marks:
            split[phase].append((at - prev) * 1e3)
            prev = at
        secs.append(prev - t)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with torch.no_grad():
        _, sam_ms = wall_ms(lambda: model.encode_sam_images(
            batch["sam_images"]))
    metrics = [{k: float(v) for k, v in m.items()} for m in steps]
    tokens = sum(lens)
    med = float(np.median(secs))
    res = dict(phase="main_path", path=path, batch=B,
               spliced_tokens=tokens, step_ms=spread([x * 1e3 for x in secs]),
               images_per_s=B / med, tokens_per_s=tokens / med,
               peak_gb=peak_gb, split_ms={k: spread(v) for k, v in split.items()},
               sam_encode_in_forward_ms=sam_ms, metrics=metrics,
               lr_last=opt.param_groups[0]["lr"], updates=step.step)
    log(json.dumps(res))
    log(json.dumps({"phase": "profile", "path": path,
                    **device_busy(lambda: step(batch))}))
    qlora = cfg.llama.weights_int8
    if qlora:
        log(json.dumps({"phase": "ste_backward_costs", "path": path,
                        **ste_backward_costs(cfg.llama, B * (
                            L_TRAIN - 1 + cfg.clip.num_patches))}))

    want = train_launches_expected(cfg)
    layers = cfg.llama.num_layers
    log(json.dumps({"phase": "train_launches_per_step", "launches": launches,
                    "expected": want}))
    moved = {n: not torch.equal(p.detach(), watched[n])
             for n, p in model.named_parameters() if n in watched}
    lora_b = [n for n in moved if "lora_B" in n]
    dec_moved = sum(moved[n] for n in moved if "mask_decoder" in n)
    checks = {
        "losses_finite": all(np.isfinite(m[k]) for m in metrics
                             for k in m if k.endswith("loss")),
        "none_skipped": all(m["skipped_nonfinite"] == 0.0 for m in metrics),
        "grad_norm_finite_positive": all(
            np.isfinite(m["grad_norm"]) and m["grad_norm"] > 0
            for m in metrics),
        "frozen_bit_identical": torch.equal(fp, frozen_fingerprint(model)),
        "every_lora_b_moved": len(lora_b) == 2 * layers and all(
            moved[n] for n in lora_b),
        "mask_decoder_moved": dec_moved > 0,
        "launches_as_expected": launches == want,
    }
    log(json.dumps({"phase": "train_checks", **checks,
                    "mask_decoder_params_moved": dec_moved,
                    "mask_decoder_params": sum("mask_decoder" in n
                                               for n in moved)}))
    if not all(checks.values()):
        raise SystemExit(f"the {path} training path failed: {checks}")
    del model, opt, sched, step, batch, watched
    gc.collect()
    torch.cuda.empty_cache()
    return launches, med * 1e3


# --------------------------------------------------------------- DAMON
# the DAMON workflow: a tree of DAMON_IMAGES photos, two objects each (one a
# 'supporting' contact, which yields the foot_ground subset), written by the
# port's recipe on the card; the 13B LoRA CLI at B = DAMON_B for
# DAMON_STEPS steps with DAMON_WORKERS loader threads; validate over
# DAMON_VAL_BATCHES batches of DAMON_B; then the tiny chain at 64^2 on the
# 178-vertex sphere (tests/test_datagen_recipes.py:sphere_mesh's shape)
DAMON_IMAGES, DAMON_B, DAMON_STEPS, DAMON_WORKERS = 16, 8, 4, 8
# the DAMON CLI's median step (ms) after its first, for phase 18's
STEP_MS = {}
DAMON_VAL_BATCHES = 2
DAMON_OBJECTS = ("chair", "bicycle", "skateboard", "cup", "bench",
                 "surfboard", "motorcycle", "bed")
TINY_SPHERE, TINY_SIZE, TINY_IMAGES = (12, 16), 64, 8
# the tiny chain, card against CPU on the restored model: the mask logits
# and the lifted contacts (sigmoid means) within these. SAM runs bf16 on
# the card (its kernels take bf16 only), f32 on the CPU; measured on an
# H100: logits 0.0239 (trained) and 0.0244 (forced) apart, contacts
# 0.00155 and 6.9e-6; the limits are about 4 and 6 times those
TINY_LOGIT_TOL, TINY_CONTACT_TOL = 0.1, 0.01
# the eval CLI's batches in the tiny chain; the forced copy's logit offset
TINY_EVAL_B, TINY_EVAL_BATCHES, MASK_BIAS = 4, 2, 8.0
# loader-off legs of the CLI's step split: rounds of (resident, copied)
SPLIT_ROUNDS, SPLIT_STEPS = 1, 1
WORKDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "damon_workflow")


def body_parts_of(n):
    """A fabricated body-part segmentation of an n-vertex sphere (top to
    bottom), the feet last."""
    cut = [0, n // 4, n // 2, n - n // 8, n - n // 16, n]
    names = ("head", "torso", "legs", "left foot", "right foot")
    return {k: list(range(a, b)) for k, a, b in zip(names, cut, cut[1:])}


def write_damon_tree(root, sphere, size, n_images, device="cuda"):
    """A DAMON tree under ``root``: ``n_images`` seeded 640 x 480 JPEG
    photos, each with one object's contact and a 'supporting' one (feet
    and legs; ``sphere_annotations``), through the port's
    ``generate_damon_tree`` on ``device``. Returns (seconds of the recipe,
    bytes written, samples)."""
    verts, faces = uv_sphere(*sphere)
    n = len(verts)
    annot = sphere_annotations(n, n_images)
    write_photos(root, list(annot))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate_damon_tree(root, annot, verts, faces, HUMAN_VIEWS[VIEW_SET],
                              size, body_parts_of(n), device=device)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(d, f))
                 for d, _, fs in os.walk(root) for f in fs)
    samples = sum(len(v) for v in out["annot"].values())
    if not all("foot_ground" in v for v in out["annot"].values()):
        raise SystemExit("the DAMON recipe wrote no foot_ground subset")
    return secs, nbytes, samples


def cli_train(argv):
    """``train_cli.main(argv)`` from a clean card. Returns the trainer, the
    CLI's seconds, the launches, the peak GB and the image loads by
    decoder and format."""
    loads0 = collections.Counter(native_image.loads)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    trainer = train_cli.main(argv)
    secs = time.perf_counter() - t0
    return (trainer, secs, read_launches(),
            torch.cuda.max_memory_allocated() / 1e9,
            dict(native_image.loads - loads0))


def cli_step_ms(trainer):
    """The CLI's steps after the new model's first, less the wait for the
    batch (ms): the copy to the card and the step, synchronised."""
    return [(h["batch_s"] - h["data_s"]) * 1e3 for h in trainer.history[1:]]


def step_split_ms(step, batch):
    """``TrainStep`` on one real pinned batch with no loader running, each
    step synchronised as the CLI's: the batch resident on the card (copied
    once), or copied each step as the CLI copies it. SPLIT_ROUNDS rounds
    of SPLIT_STEPS steps each, the two alternating."""
    resident = to_device(batch, "cuda")
    out = {"resident": [], "copied": []}
    for _ in range(SPLIT_ROUNDS):
        for leg in out:
            for _ in range(SPLIT_STEPS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                step(resident if leg == "resident" else to_device(batch,
                                                                  "cuda"))
                torch.cuda.synchronize()
                out[leg].append((time.perf_counter() - t) * 1e3)
    return out


def tiny_masks_card_and_cpu(run, tree):
    """The restored tiny model of ``run`` on the card and on the CPU, on
    the eval CLI's batches of the test split (TINY_EVAL_BATCHES of
    TINY_EVAL_B) through its path (the first batch's view encode cached,
    then ``evaluate_batch``). Returns, card against CPU: whether the
    generated ids are equal, the rows with a seg token, and the largest
    difference, the CPU's range and the card's distance from the threshold
    of the mask logits (0) and of the lifted contacts (0.5) on those
    rows."""
    outs, batches = {}, None
    for dev in ("cuda", "cpu"):
        model, cfg, targs, cfg_json = eval_cli.restore_run(run, dev)
        if batches is None:
            tok, _ = train_cli.make_tokenizer(targs, cfg_json["tokenizer"],
                                              cfg_json.get("version"))
            ds = ValDataset(build_dataset("hcontact", tree, "test", targs))
            batches = [collate(samples, tok, max_len=targs.model_max_length,
                               num_human_vertices=cfg.num_human_vertices)[0]
                       for samples in iter_sample_batches(
                           ds, TINY_EVAL_B,
                           limit=TINY_EVAL_BATCHES * TINY_EVAL_B)]
        maps = train_cli._load_human_maps(tree, dev)
        maps["num_vertices"] = cfg.num_human_vertices
        outs[dev] = []
        with torch.inference_mode():
            emb = model.encode_sam_images(
                batches[0]["sam_images"][:1].to(model.device, cfg.sam.dtype))
            for batch in batches:
                out = evaluate_batch(model, batch, targs.image_size,
                                     max_new_tokens=16, human_maps=maps,
                                     cached_image_emb=emb)
                outs[dev].append({k: out[k].float().cpu() for k in (
                    "generated_ids", "pred_masks", "pred_contact_3d",
                    "has_seg")})
        del model, maps, emb, out
    card, cpu = outs["cuda"], outs["cpu"]
    rows = [o["has_seg"] > 0 for o in cpu]

    def cat(side, key):
        return torch.cat([o[key][r].flatten() for o, r in zip(side, rows)])

    res = {"seg_rows": int(sum(r.sum() for r in rows)),
           "ids_equal": all(torch.equal(a["generated_ids"],
                                        b["generated_ids"])
                            for a, b in zip(card, cpu))}
    for name, key, at in (("logit", "pred_masks", 0.0),
                          ("contact", "pred_contact_3d", 0.5)):
        c, p = cat(card, key), cat(cpu, key)
        res[name] = {"max_diff": (c - p).abs().max().item(),
                     "cpu_range": [p.min().item(), p.max().item()],
                     "cpu_above": (p > at).float().mean().item(),
                     "card_margin": (c - at).abs().min().item()}
    return res


def force_mask_bias(run, dst):
    """A run directory ``dst`` holding ``run``'s pretrained config and its
    best checkpoint with every mask decoder's logits raised by about
    MASK_BIAS: hypernetwork output channel 0 set to 1 and upscaled feature
    channel 0 to the constant GELU(MASK_BIAS), so each mask's channel-0
    term is that constant (every mask full, its contacts near 1)."""
    os.makedirs(dst)
    shutil.copy(os.path.join(run, "pretrained_config.json"), dst)
    state = CheckpointManager(run).restore_best()
    sd = state["model"]
    up = ".output_upscaling.3."
    for key in [k for k in sd if k.endswith(up + "weight")]:
        dec = key[:-len(up + "weight")]
        sd[key][:, 0] = 0.0  # ConvTranspose2d weight (in, out, k, k)
        sd[dec + up + "bias"][0] = MASK_BIAS
        heads = {k.rsplit(".layers.", 1)[0] for k in sd if k.startswith(
            dec + ".output_hypernetworks_mlps.")}
        for head in heads:
            last = max(int(k.rsplit(".layers.", 1)[1].split(".")[0])
                       for k in sd if k.startswith(head + ".layers."))
            sd[f"{head}.layers.{last}.weight"][0] = 0.0
            sd[f"{head}.layers.{last}.bias"][0] = 1.0
    CheckpointManager(dst).save_best(state["step"], state, 0.0)


def damon_workflow_phase(train_step_ms):
    """The DAMON workflow through the port's entry points: (1) a 1024^2
    DAMON tree of the 6890-vertex sphere written on the card; (2) the
    training CLI at full width (13B LoRA, the hcontact-damon defaults, the
    whitespace tokenizer) for one epoch of DAMON_STEPS steps, no save, no
    eval: each step's wall and data seconds and the share the card waited
    on the loader, the peak memory and each kernel's launches a step, the
    PNG and JPEG loads, and the CLI's step against ``train_step_ms`` (the
    TrainStep path's median in this run); the CLI's step split against
    ``TrainStep`` on one real batch with no loader (resident on the card,
    or copied each step); (3) ``validate`` on the trained model over the
    tree's test split, cached view encode, 32 new tokens, after
    ``let_seg_token_appear``: images/s, seg_rate, every metric finite;
    (4) the tiny chain: a 64^2
    tree, ``train.main`` for two epochs with eval and saving,
    ``--resume`` for a third, ``export.main``, and ``eval.evaluate.main``
    on the card and on the CPU from the same run directory, their reports
    equal; the restored model's mask logits and lifted contacts on the
    card and the CPU within TINY_LOGIT_TOL and TINY_CONTACT_TOL. Returns
    the launches of the training and the validation runs."""
    shutil.rmtree(WORKDIR, ignore_errors=True)
    tree = os.path.join(WORKDIR, "damon_1024")
    runs = os.path.join(WORKDIR, "runs")
    secs, nbytes, samples = write_damon_tree(tree, SPHERE, MASK, DAMON_IMAGES)
    log(json.dumps({"phase": "damon_tree", "size": MASK, "images":
                    DAMON_IMAGES, "samples": samples, "s": secs,
                    "bytes": nbytes, "decoder": native_image.decoder(),
                    "decoder_build_error": native_image.build_error}))

    # (2) the training CLI at full width
    argv = ["--model_scale", "full", "--tokenizer", "whitespace",
            "--dataset", "hcontact", "--dataset_dir", tree,
            "--batch_size", str(DAMON_B), "--data_workers",
            str(DAMON_WORKERS), "--epochs", "1", "--steps_per_epoch",
            str(DAMON_STEPS), "--no_eval", "--save_every", "2",
            "--log_base_dir", runs, "--exp_name", "damon_13b",
            "--no_tensorboard"]
    trainer, cli_s, launches, peak_gb, loads = cli_train(argv)
    hist = trainer.history
    steady = cli_step_ms(trainer)
    STEP_MS["damon_cli"] = float(np.median(steady))
    want = train_launches_expected(trainer.cfg, DAMON_STEPS)
    per_step = {n: launches[n] / DAMON_STEPS for n in TRAINING_KERNELS
                + ("window_attention", "rel_attention")}
    res = {"phase": "damon_train", "argv": argv, "cli_s": cli_s,
           "first_batch_s": trainer.first_batch_s,
           "steps": [{"step_s": h["batch_s"] - h["data_s"],
                      "data_s": h["data_s"], "wall_s": h["batch_s"],
                      "loader_wait_share": h["loader_wait_share"],
                      "loss": h["loss"]} for h in hist],
           "step_ms_after_first": spread(steady),
           "train_step_path_ms": train_step_ms,
           "cli_over_train_step": float(np.median(steady)) / train_step_ms,
           "peak_gb": peak_gb, "launches_per_step": per_step,
           "image_loads": loads, "decoder": native_image.decoder()}
    log(json.dumps(res))
    # each sample reads its V mask PNGs, then its photo (a JPEG), after
    # the dataset's V render PNGs; the loader may have read ahead, and has
    # finished every sample it started once the CLI returns
    V = trainer.cfg.multiview_channels
    pngs = loads.get(native_image.decoder() + "_png", 0)
    jpegs = loads.get("pil_jpeg", 0)
    checks = {
        "steps": trainer.step.step == DAMON_STEPS and len(hist) == DAMON_STEPS,
        "losses_finite": all(np.isfinite(h["loss"]) for h in hist),
        "none_skipped": all(h["skipped_nonfinite"] == 0.0 for h in hist),
        "launches_as_expected": launches == want,
        "nothing_saved": not os.path.exists(os.path.join(runs, "damon_13b",
                                                         "ckpt")),
        "loaded_pngs": (jpegs >= DAMON_STEPS * DAMON_B
                        and pngs == V * (jpegs + 1)
                        and sum(loads.values()) == pngs + jpegs),
    }
    log(json.dumps({"phase": "damon_train_checks", **checks,
                    "expected": want, "launches": launches}))
    if not all(checks.values()):
        raise SystemExit(f"the DAMON training CLI failed: {checks}")

    # the CLI's step against TrainStep on one real batch, no loader running
    args = train_cli.parse_args(argv)
    loader = train_cli.real_batch_iter(args, trainer.cfg, trainer.tokenizer,
                                       "cuda")
    batch = next(loader)
    loader.close()
    split = step_split_ms(trainer.step, batch)
    del batch

    # (3) validate at full width on the trained model
    model, tokenizer = trainer.model, trainer.tokenizer
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    model.requires_grad_(False)
    with torch.inference_mode():
        ds = ValDataset(build_dataset("hcontact", tree, "test", args))
        maps = train_cli._load_human_maps(tree, "cuda")
        maps["num_vertices"] = model.config.num_human_vertices
        n_val = DAMON_VAL_BATCHES * DAMON_B

        def batches():
            for samples in iter_sample_batches(ds, DAMON_B, limit=n_val,
                                               num_workers=DAMON_WORKERS):
                yield collate(samples, tokenizer,
                              max_len=args.model_max_length,
                              num_human_vertices=maps["num_vertices"],
                              human_maps=maps)

        first, _ = next(batches())
        ids, _ = truncate_at_answer(first["input_ids"].numpy(),
                                    first["labels"].numpy())
        let_seg_token_appear(model, {"input_ids": ids,
                                     "images_clip": first["images_clip"]},
                             "cuda", "dense")
        del first
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        results, saved = validate(batches(), model, "hcontact", MASK,
                                  human_maps=maps, cache_view_encode=True,
                                  max_new_tokens=T,
                                  max_batches=DAMON_VAL_BATCHES)
        torch.cuda.synchronize()
        val_s = time.perf_counter() - t0
        val_launches = read_launches()
        binary = damon_binary_contact(saved)
        semantic = damon_semantic_contact(saved)["weighted_f1"]
    layers = model.config.llama.num_layers
    want_val = {n: 0 for n in KERNELS}
    want_val.update({"flash_attention": DAMON_VAL_BATCHES * (
        layers + model.config.sam.decoder_depth),
        "fwd_routes": {"sm90": DAMON_VAL_BATCHES * layers,
                       "sm90_d16": DAMON_VAL_BATCHES
                       * model.config.sam.decoder_depth, "mma": 0},
        "window_attention": 28, "rel_attention": 4})
    res = {"phase": "damon_validate", "images": n_val, "s": val_s,
           "images_per_s": n_val / val_s, "results": results,
           "damon_binary": binary, "damon_semantic_weighted_f1": semantic,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": {n: val_launches[n] for n in want_val}}
    log(json.dumps(res))
    finite = all(np.isfinite(v) for v in results.values())
    if not (finite and results.get("seg_rate", 0) > 0
            and len(saved["pred"]) == n_val
            and all(val_launches[n] == c for n, c in want_val.items())):
        raise SystemExit(f"the DAMON validation failed: {res}")
    del model, maps, ds, saved

    res = {"phase": "damon_step_split", "train_step_path_ms": train_step_ms,
           "cli_ms": spread(steady),
           "train_step_resident_ms": spread(split["resident"]),
           "train_step_copied_ms": spread(split["copied"]),
           "all_ms": {"cli": steady, **split}}
    log(json.dumps(res))

    # (4) the tiny chain, the card against the CPU
    t0 = time.perf_counter()
    tiny = os.path.join(WORKDIR, "damon_64")
    write_damon_tree(tiny, TINY_SPHERE, TINY_SIZE, TINY_IMAGES)
    run = os.path.join(runs, "tiny")
    common = ["--model_scale", "tiny", "--tokenizer", "whitespace",
              "--dataset", "hcontact", "--dataset_dir", tiny,
              "--image_size", str(TINY_SIZE), "--clip_size", "28",
              "--num_human_vertices", "178", "--model_max_length", "384",
              "--hC_question_type", "simple", "--fixed_templates",
              "--batch_size", "2", "--steps_per_epoch", "4", "--lr", "1e-2",
              "--warmup_steps", "1", "--val_batches", "2",
              "--data_workers", "2", "--log_base_dir", runs,
              "--exp_name", "tiny", "--no_tensorboard"]
    first = train_cli.main(common + ["--epochs", "2"])
    resumed = train_cli.main(common + ["--epochs", "3", "--resume"])
    sd = export_cli.main(["--run_dir", run, "--out_dir",
                          os.path.join(WORKDIR, "export")])
    # the trained model's logits and contacts, card against CPU, before
    # any threshold; then the reports of a copy whose masks are all full
    # (every logit about MASK_BIAS): no value lies near its threshold
    # there, so the card's and the CPU's reports must be equal
    masks = tiny_masks_card_and_cpu(run, tiny)
    forced = os.path.join(runs, "tiny_forced")
    force_mask_bias(run, forced)
    forced_masks = tiny_masks_card_and_cpu(forced, tiny)
    ev = ["--run_dir", forced, "--dataset_dir", tiny, "--batch_size",
          str(TINY_EVAL_B), "--max_batches", str(TINY_EVAL_BATCHES),
          "--max_new_tokens", "16"]
    card = eval_cli.main(ev)
    cpu = eval_cli.main(ev + ["--device", "cpu"])
    diffs = {f"{part}.{k}": abs(card[part][k] - v)
             for part in cpu for k, v in cpu[part].items()}
    res = {"phase": "damon_tiny_chain", "s": time.perf_counter() - t0,
           "steps": [first.step.step, resumed.step.step],
           "saved_steps": CheckpointManager(run).steps(),
           "best": os.path.exists(os.path.join(run, "ckpt_best")),
           "exported_keys": len(sd), "masks": masks,
           "forced_masks": forced_masks, "card": card, "cpu": cpu,
           "report_max_diff": max(diffs.values()),
           "tol": [TINY_LOGIT_TOL, TINY_CONTACT_TOL]}
    log(json.dumps(res))
    held = all(m["seg_rows"] > 0 and m["ids_equal"]
               and m["logit"]["max_diff"] <= TINY_LOGIT_TOL
               and m["contact"]["max_diff"] <= TINY_CONTACT_TOL
               for m in (masks, forced_masks))
    clear = (forced_masks["logit"]["card_margin"] > TINY_LOGIT_TOL
             and forced_masks["contact"]["card_margin"] > TINY_CONTACT_TOL
             and forced_masks["logit"]["cpu_above"] == 1.0)
    if not (first.step.step == 8 and resumed.step.step == 12
            and res["saved_steps"] == [8, 12] and res["best"]
            and not any("lora_" in k for k in sd)
            and held and clear and card["metrics"]["seg_rate"] > 0
            and card["metrics"]["f1"] > 0 and card.keys() == cpu.keys()
            and all(d == 0 for d in diffs.values())):
        raise SystemExit(f"the tiny DAMON chain failed: {res}")
    del first, resumed, sd
    shutil.rmtree(WORKDIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches, val_launches


# ---------------------------------------------------- the demo and the fit
# phase 15 (demo_fit_phase): the demo's per-image loop at 13B full width,
# then the joint human-object fit through its CLI at the reference's full
# settings (data_io.main's defaults: 512^2, 250 steps, ICP, scale, video)
DEMO_LEGS = (("hcontact", 4), ("h2dcontact", 2), ("ocontact", 2))
DEMO_OBJECTS = ("chair", "bicycle", "cup", "bench")
DEMO_PHOTO = (480, 640)  # rows, columns of the seeded photos
N_SMPLX = 10475  # SMPL-X's vertices: rows of the SMPL -> SMPL-X matrix
TINY_DEMO_LEGS = (("hcontact", 1), ("h2dcontact", 1), ("ocontact", 1))
TINY_OBJ_SPHERE = (6, 8)
FIT_SIZE, FIT_STEPS, FIT_CPU_STEPS = 512, 250, 10
# the fit scene: OSX intrinsics from a 200 x 240 px bbox in the 512^2 frame
# (focal 5208 x 4688 px), the 6890-vertex sphere (radius 0.8, faces wound
# outward) at the depth such a bbox gives a body, the 2048-vertex sphere
# stretched to an ellipsoid (asymmetric: Adam's first step is lr * sign(g),
# so no gradient component may sit at its rounding) posed against the
# human's front left at a seeded rotation
FIT_BBOX = np.array([156.0, 136.0, 200.0, 240.0], np.float32)
FIT_HUMAN_CENTER = np.array([0.05, -0.1, 41.7], np.float32)
FIT_OBJECT_AXES = np.array([0.35, 0.22, 0.28], np.float32)
FIT_CONTACT_DIRECTION = np.array([0.55, 0.25, -0.8], np.float32)
# the recovery fit's contacts, from the true pose: object vertices within
# the first distance of the human's surface, human vertices within the
# second of an object vertex
FIT_CONTACT_DIST = (0.06, 0.08)
# the card against the port on the CPU on the recovery scene, set before
# the first card call (PERF.md): ICP's result on the same inputs,
# and the first FIT_CPU_STEPS steps from the card's ICP result (losses
# relative, parameters absolute). Measured on the CPU: a 2-ulp change of
# the scene's vertices moves ICP's rot6d, translation and log scale by
# 1.5e-3, 6.6e-4 and 3.0e-3 (nearest-neighbour near-ties flip at depth
# 41.7), and ten steps from one start by 3.5e-5 (loss), 8.4e-4, 1.6e-5 and
# 2.6e-5 (Adam moves every coordinate by about lr, whatever its gradient's
# size); the limits are about ten times those
FIT_ICP_TOL = {"rot6d": 2e-2, "translation": 1e-2, "log_scale": 3e-2}
FIT_STEP_TOL = {"loss": 5e-4, "rot6d": 1e-2, "translation": 2e-4,
                "log_scale": 3e-4}
FIT_SPLIT_ITERS = 20


def outward(verts, faces):
    """A UV sphere with its faces wound outward (``uv_sphere`` winds them
    inward), as a body or object mesh is wound."""
    return verts, np.ascontiguousarray(faces[:, ::-1])


def random_rotation(seed):
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q.astype(np.float32)


def smpl_to_smplx_matrix(n_smpl, n_smplx, seed):
    """A seeded sparse SMPL -> SMPL-X transfer matrix of the released
    one's shape: each SMPL-X vertex a convex combination of three SMPL
    vertices."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    cols = rng.integers(0, n_smpl, (n_smplx, 3)).ravel()
    vals = rng.dirichlet([1.0, 1.0, 1.0], n_smplx).astype(np.float32).ravel()
    rows = np.repeat(np.arange(n_smplx), 3)
    return sp.csr_matrix((vals, (rows, cols)), shape=(n_smplx, n_smpl))


def write_demo_folder(root, sphere, obj_sphere, size, legs, device="cuda"):
    """The demo's inputs under ``root``, nothing downloaded: seeded photos
    ``<object>__<i>.jpg`` in one folder a contact type (``legs``); the
    canonical ``4MV-Z_Vitru_mv2`` renders of the ``sphere`` at ``size``^2
    (``shaded_render`` on the port's lift maps, rasterized on ``device``)
    and those maps as ``human_maps.npz``; a seeded sparse SMPL -> SMPL-X
    pickle; the body template in SMPL-X's vertex count (the sphere carried
    through that matrix: with ``--smpl_to_smplx`` the demo colours the
    template by the SMPL-X contacts); and ``object_mesh.obj`` (the
    ``obj_sphere``) beside the ocontact photos. Returns the seconds."""
    import pickle

    from PIL import Image

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    verts, faces = outward(*uv_sphere(*sphere))
    vs = HUMAN_VIEWS[VIEW_SET]
    cams = vs.cam_params()
    window = max(pick_window(verts, faces, c, size) for c in cams)
    p2v, bary, p2f = build_lift_maps(verts, faces, cams, size, window,
                                     device=device)
    p2v, bary = p2v.cpu().numpy(), bary.cpu().numpy()
    os.makedirs(os.path.join(root, "renders"))
    vt = torch.as_tensor(verts, device=device)
    for i, name in enumerate(vs.names):
        Image.fromarray(demo_utils.shaded_render(vt, faces, p2f[i], p2v[i],
                                                 bary[i])).save(
            os.path.join(root, "renders", f"{name}.png"))
    np.savez(os.path.join(root, "human_maps.npz"), p2v=p2v, bary=bary)
    m = smpl_to_smplx_matrix(len(verts), N_SMPLX, 1)
    with open(os.path.join(root, "smpl_to_smplx.pkl"), "wb") as f:
        pickle.dump({"matrix": m}, f)
    fit_io.save_obj_mesh(os.path.join(root, "body_template.obj"), m @ verts,
                         faces)
    for ctype, n in legs:
        os.makedirs(os.path.join(root, ctype))
        for i in range(n):
            name = "mug" if ctype == "ocontact" else DEMO_OBJECTS[i % 4]
            Image.fromarray(rng.integers(0, 256, DEMO_PHOTO + (3,), np.uint8)
                            ).save(os.path.join(root, ctype,
                                                f"{name}__{i}.jpg"),
                                   quality=90)
    fit_io.save_obj_mesh(os.path.join(root, "ocontact", "object_mesh.obj"),
                         *outward(*uv_sphere(*obj_sphere)))
    return time.perf_counter() - t0


def demo_args(root, ctype, out, device="cuda", tiny=False):
    argv = ["--img_folder", os.path.join(root, ctype), "--output_folder",
            out, "--contact_type", ctype, "--max_new_tokens", str(T),
            "--device", device, "--mask_size", str(TINY_SIZE if tiny
                                                   else MASK)]
    if ctype == "hcontact":
        argv += ["--sam_renders_dir", os.path.join(root, "renders"),
                 "--human_maps", os.path.join(root, "human_maps.npz"),
                 "--smpl_to_smplx", os.path.join(root, "smpl_to_smplx.pkl"),
                 "--body_template", os.path.join(root, "body_template.obj")]
    return run_demo.parse_args(argv + (["--random_weights"] if tiny else []))


def first_prompt(args, tokenizer, cfg, device):
    """The first image's prompt ids and CLIP pixels, as the loop makes
    them."""
    from interactvlm_tpu_torch.data.tokenization import (
        tokenizer_image_token,
        wrap_image_tokens,
    )
    from interactvlm_tpu_torch.data.transforms import (
        clip_preprocess,
        load_image_rgb,
    )

    path = os.path.join(args.img_folder, sorted(
        f for f in os.listdir(args.img_folder) if f.endswith(".jpg"))[0])
    prompt = wrap_image_tokens(run_demo.build_prompt(args, path))
    return {"input_ids": np.asarray([tokenizer_image_token(prompt,
                                                           tokenizer)]),
            "images_clip": torch.from_numpy(clip_preprocess(
                load_image_rgb(path), cfg.clip.image_size)[None]).to(device)}


def check_bundle(out, ctype, stems, n_verts, n_obj, size):
    """Every file of the demo's output bundle, with its shape and finite
    values. Returns the failures."""
    from PIL import Image

    bad = []

    def need(cond, what):
        if not cond:
            bad.append(what)

    def jpg(name, shape):
        p = os.path.join(out, name)
        need(os.path.exists(p) and np.asarray(Image.open(p)).shape == shape,
             name)

    def obj(name, n):
        p = os.path.join(out, name)
        lines = open(p).read().splitlines() if os.path.exists(p) else []
        v = [ln.split() for ln in lines if ln.startswith("v ")]
        need(len(v) == n and all(len(x) == 7 for x in v), name)

    for stem, photo_hw in stems:
        masks = np.load(os.path.join(out, f"{stem}_pred_masks.npy"))
        need(masks.shape == (4, size, size) and np.isfinite(masks).all(),
             f"{stem}_pred_masks.npy")
        if ctype == "h2dcontact":
            om = np.load(os.path.join(out, f"{stem}_pred_mask_original.npy"))
            need(om.shape == photo_hw and np.isfinite(om).all(),
                 "pred_mask_original")
            jpg(f"{stem}_h2dcontact_overlay.jpg", photo_hw + (3,))
            continue
        z = np.load(os.path.join(out, f"{stem}_{ctype}_vertices.npz"))
        c = z["contact"]
        need(c.shape == ((n_verts,) if ctype == "hcontact" else (n_obj,))
             and np.isfinite(c).all() and c.min() >= 0 and c.max() <= 1,
             f"{stem} contact")
        jpg(f"{stem}_{ctype}_concat.jpg", (2 * size, 2 * size, 3))
        if ctype == "hcontact":
            need(z["contact_smplx"].shape == (N_SMPLX,)
                 and np.isfinite(z["contact_smplx"]).all(), "contact_smplx")
            obj(f"{stem}_body_with_hcontacts.obj", N_SMPLX)
        else:
            obj(f"{stem}_object_mesh_with_contacts_{ctype}.obj", n_obj)
    return bad


def demo_legs(model, tokenizer, root, out_root):
    """The demo's per-image loop (``run_demo.run_images``) on the built
    model, one leg a contact type (DEMO_LEGS), after
    ``let_seg_token_appear`` on the leg's first prompt. Each leg's seconds,
    its images' ``evaluate_batch`` seconds, the object views' build, peak
    memory and launches from 0; the bundle checked file by file. Returns
    the launches over all legs and the hcontact and ocontact legs' first
    contacts."""
    cfg = model.config
    evals, undo_eval = timed_calls(eval_cli, ["evaluate_batch"])
    builds, undo_build = timed_calls(demo_utils, ["generate_sam_inp_objs"])
    calls, builds = evals["evaluate_batch"], builds["generate_sam_inp_objs"]
    total = collections.Counter()
    contacts = {}
    try:
        for ctype, n in DEMO_LEGS:
            out = os.path.join(out_root, ctype)
            args = demo_args(root, ctype, out)
            let_seg_token_appear(model, first_prompt(args, tokenizer, cfg,
                                                     "cuda"),
                                 "cuda", "dense")
            calls.clear()
            builds.clear()
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            results = run_demo.run_images(model, tokenizer, args)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = read_launches()
            per_image = {k: launches[k] / n for k in (
                "flash_attention", "window_attention", "rel_attention")}
            want = {"flash_attention": cfg.llama.num_layers
                    + cfg.sam.decoder_depth, "window_attention": 28,
                    "rel_attention": 4}
            routes_ok = launches["fwd_routes"] == {
                "sm90": n * cfg.llama.num_layers,
                "sm90_d16": n * cfg.sam.decoder_depth, "mma": 0}
            stems = [(os.path.splitext(r["image"])[0], DEMO_PHOTO)
                     for r in results]
            bad = check_bundle(out, ctype, stems, N_VERTS, N_OBJ, MASK)
            res = {"phase": "demo", "leg": ctype, "images": n, "s": secs,
                   "s_per_image": secs / n, "evaluate_s": list(calls),
                   "outside_evaluate_s": secs - sum(calls),
                   "object_views_s": list(builds),
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "seg": [r["has_seg"] for r in results],
                   "launches_per_image": per_image,
                   "fwd_routes": launches["fwd_routes"],
                   "bundle_failures": bad}
            log(json.dumps(res))
            if (bad or len(results) != n or per_image != want
                    or not routes_ok or not results[0]["has_seg"]
                    or (ctype == "ocontact" and len(builds) != 1)):
                raise SystemExit(f"the demo failed: {res}")
            total.update({k: v for k, v in launches.items()
                          if isinstance(v, int)})
            if ctype in ("hcontact", "ocontact"):
                z = np.load(os.path.join(out, f"{stems[0][0]}_{ctype}"
                                         "_vertices.npz"))
                contacts[ctype] = z["contact"]
    finally:
        undo_eval()
        undo_build()
    return dict(total), contacts


def force_seg(model):
    """Every answer's tokens become [SEG]: a large constant channel 0 in
    the residual stream (the embeddings and the projected patches) and
    [SEG]'s lm_head weight on it (``tests/test_torch_demo.py``'s)."""
    llava, seg = model.llava, model.config.seg_token_idx
    with torch.no_grad():
        llava.lm.model.embed_tokens.weight[:, 0] = 30.0
        llava.mm_projector.bias[0] = 30.0
        llava.lm.lm_head.weight[seg, 0] = 5.0


def tiny_demo_card_and_cpu(root):
    """The ``--random_weights`` demo (tiny, 64^2) on the CPU and on the
    card from the same weights (drawn on the CPU, answers forced to
    [SEG]), on one folder: each contact type's mask logits and contacts,
    card against CPU. The CPU runs first, so the ocontact leg's object
    views are the CPU's on both."""
    write_demo_folder(root, TINY_SPHERE, TINY_OBJ_SPHERE, TINY_SIZE,
                      TINY_DEMO_LEGS)
    weights, diffs = None, {}
    for dev in ("cpu", "cuda"):
        for ctype, _ in TINY_DEMO_LEGS:
            args = demo_args(root, ctype, os.path.join(root, f"out_{dev}_"
                                                       f"{ctype}"),
                             device=dev, tiny=True)
            model, tok = run_demo.load_model(args)
            if weights is None:
                force_seg(model)
                weights = model.state_dict()
            model.load_state_dict(weights)
            res = run_demo.run_images(model, tok, args)
            if not all(r["has_seg"] for r in res):
                raise SystemExit(f"the tiny demo emitted no [SEG] on {dev}")
    for ctype, _ in TINY_DEMO_LEGS:
        out = {d: os.path.join(root, f"out_{d}_{ctype}") for d in
               ("cpu", "cuda")}
        for name in sorted(os.listdir(out["cpu"])):
            a, b = (os.path.join(out[d], name) for d in ("cuda", "cpu"))
            if name.endswith(".npy"):
                diffs[f"{ctype}/{name}"] = float(np.abs(np.load(a)
                                                        - np.load(b)).max())
            elif name.endswith(".npz"):
                za, zb = np.load(a), np.load(b)
                for k in zb.files:
                    diffs[f"{ctype}/{name}/{k}"] = float(np.abs(
                        za[k] - zb[k]).max())
    logit = max(v for k, v in diffs.items() if k.endswith(".npy"))
    contact = max(v for k, v in diffs.items() if ".npz" in k)
    res = {"phase": "demo_tiny_card_vs_cpu", "max_diff": diffs,
           "logit_max_diff": logit, "contact_max_diff": contact,
           "tol": [TINY_LOGIT_TOL, TINY_CONTACT_TOL]}
    log(json.dumps(res))
    if not (len(diffs) >= 6 and logit <= TINY_LOGIT_TOL
            and contact <= TINY_CONTACT_TOL):
        raise SystemExit(f"the tiny demo's card and CPU disagree: {res}")


def fit_scene(device="cuda"):
    """The fit's full-size scene (numpy, ``fit_human_object``'s keys) and
    its truth: the object's rotation, centre, and the contacts of the true
    pose (object and human vertex masks). The target mask is the object's
    hard render at the true pose, on ``device``."""
    hv, hf = outward(*uv_sphere(*SPHERE))
    hv = (hv + FIT_HUMAN_CENTER).astype(np.float32)
    ov, of = outward(*uv_sphere(*OBJ_SPHERE))
    ov = (ov * FIT_OBJECT_AXES).astype(np.float32)
    R = random_rotation(0)
    d = FIT_CONTACT_DIRECTION / np.linalg.norm(FIT_CONTACT_DIRECTION)
    center = (FIT_HUMAN_CENTER + d).astype(np.float32)
    posed = torch.as_tensor(ov @ R.T + center, device=device)
    focal, princpt = fit_io.camera_from_bbox(FIT_BBOX, (FIT_SIZE, FIT_SIZE))
    mask = torch.isfinite(fit_render.render_depth(
        posed, torch.as_tensor(of, device=device), focal, princpt, FIT_SIZE))
    h = torch.as_tensor(hv, device=device)
    to_surface = (posed - h.mean(0)).norm(dim=1) - 0.8
    obj_true = (to_surface < FIT_CONTACT_DIST[0]).float()
    hum_true = (torch.cdist(h, posed).amin(1) < FIT_CONTACT_DIST[1]).float()
    scene = {"obj_verts": ov, "obj_faces": of, "hum_verts": hv,
             "hum_faces": hf, "target_mask": mask.float().cpu().numpy(),
             "focal": focal, "princpt": princpt,
             "centroid_offset": np.zeros(3, np.float32),
             "obj_contact_probs": obj_true.cpu().numpy(),
             "hum_contact_probs": hum_true.cpu().numpy()}
    return scene, R, center


def write_fit_folder(d, scene, hcontact, ocontact):
    """The folder ``data_io.load_fit_inputs`` reads: the human fit npz, the
    object mesh with y and z flipped (the loader flips them back), the two
    contact npz files and the object mask."""
    os.makedirs(d)
    np.savez(os.path.join(d, "human.npz"), smpl_vertices=scene["hum_verts"],
             smpl_faces=scene["hum_faces"], bbox=FIT_BBOX)
    fit_io.save_obj_mesh(os.path.join(d, "object_mesh.obj"),
                         scene["obj_verts"] * np.array([1, -1, -1],
                                                       np.float32),
                         scene["obj_faces"])
    np.savez(os.path.join(d, "hcontact.npz"), contact=hcontact)
    np.savez(os.path.join(d, "ocontact.npz"), contact=ocontact)
    np.save(os.path.join(d, "object_mask.npy"), scene["target_mask"])


def pose_errors(scene, params, R_true, c_true):
    """Translation error, rotation error (degrees, up to the ellipsoid's
    symmetries), scale and the hard silhouette's IoU with the target mask,
    of one FitParams."""
    dev = params.translation.device
    R = fit_utils.rot6d_to_matrix(params.rot6d).double().cpu().numpy()
    # the ellipsoid is its own image under half turns about its axes
    cos = max((np.trace(R.T @ R_true.astype(np.float64) @ np.diag(f)) - 1.0)
              / 2.0 for f in ((1, 1, 1), (1, -1, -1), (-1, 1, -1),
                              (-1, -1, 1)))
    v = fit_utils.apply_transformation(
        torch.as_tensor(scene["obj_verts"], device=dev), params.rot6d,
        params.translation, torch.exp(params.log_scale))
    sil = torch.isfinite(fit_render.render_depth(
        v, torch.as_tensor(scene["obj_faces"], device=dev), scene["focal"],
        scene["princpt"], FIT_SIZE)).cpu().numpy()
    target = scene["target_mask"] > 0.5
    return {"t_err": float(np.linalg.norm(params.translation.cpu().numpy()
                                          - c_true)),
            "rot_err_deg": float(np.degrees(np.arccos(np.clip(cos, -1, 1)))),
            "scale": float(torch.exp(params.log_scale)),
            "iou": float((sil & target).sum() / max((sil | target).sum(), 1))}


def timed_calls(module, names):
    """Wrap ``module``'s functions ``names`` to record their synchronised
    seconds; returns (seconds by name, undo)."""
    secs = {n: [] for n in names}
    real = {n: getattr(module, n) for n in names}

    def wrap(n):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real[n](*a, **k)
            torch.cuda.synchronize()
            secs[n].append(time.perf_counter() - t)
            return out
        return wrapped

    for n in names:
        setattr(module, n, wrap(n))
    return secs, lambda: [setattr(module, n, f) for n, f in real.items()]


def icp_costs(scene):
    """ICP on the card as the fit runs it: its wall seconds, iterations and
    the synchronising calls it makes (``torch.cuda.set_sync_debug_mode``
    warns at each)."""
    import warnings

    s, t0 = fit_mod.prepare_scene(scene, "cuda")
    args = (s["obj_verts"] + t0, s["obj_faces"], s["hum_verts"],
            s["hum_faces"], s["obj_contact_probs"], s["hum_contact_probs"])
    fit_mod.icp_init(*args, estimate_scale=True)  # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    fit_mod.icp_init(*args, estimate_scale=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    iters, real_nn = [], fit_icp.nearest_neighbors

    def counted(*a):
        iters.append(1)
        return real_nn(*a)

    fit_icp.nearest_neighbors = counted
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fit_mod.icp_init(*args, estimate_scale=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        fit_icp.nearest_neighbors = real_nn
    syncs = [str(w.message) for w in caught
             if "synchroniz" in str(w.message)]
    return {"wall_s": wall, "iterations": len(iters), "syncs": len(syncs),
            "syncs_per_iteration": len(syncs) / max(len(iters), 1),
            "sync_sites": sorted(set(m[:80] for m in syncs))[:5]}


def fit_step_split(scene, params):
    """Where one fit step's time goes on the card, after the contact loss's
    kick-in (step 60): CUDA events over FIT_SPLIT_ITERS calls of the
    silhouette's forward, its forward and backward (mask IoU and centroid
    losses), the contact loss forward and backward, Adam's update, and the
    whole step; one step's device time from a trace of the card (the rest
    of its wall is the card idle) and, from a trace with the host's
    operations, the operations with the most device time."""
    s, _ = fit_mod.prepare_scene(scene, "cuda")
    p = fit_opt.FitParams(*(x.detach().clone().requires_grad_()
                            for x in params))
    opt = fit_opt.make_fit_optimizer(p)
    w = fit_opt.LossWeights()

    def verts():
        return fit_utils.apply_transformation(s["obj_verts"], p.rot6d,
                                              p.translation,
                                              torch.exp(p.log_scale))

    def sil():
        return fit_render.render_silhouette(verts(), s["obj_faces"],
                                            s["focal"], s["princpt"],
                                            FIT_SIZE)

    def sil_forward():
        with torch.no_grad():
            sil()

    def sil_forward_backward():
        opt.zero_grad(set_to_none=True)
        m = sil()
        (fit_opt.mask_iou_loss(m, s["target_mask"]) + w.centroid_w * (
            (fit_utils.calculate_centroid(m) - s["target_centroid"]) ** 2
        ).sum()).backward()

    def contact():
        opt.zero_grad(set_to_none=True)
        fit_opt.contact_loss(verts(), s["hum_verts"], s["obj_contact_probs"],
                             s["hum_contact_probs"]).backward()

    def whole_step():
        opt.zero_grad(set_to_none=True)
        loss, _ = fit_opt.fit_losses(p, 60, s, w, FIT_SIZE, 1.0, 16)
        loss.backward()
        opt.step()

    ms = {"silhouette_forward": time_ms(sil_forward, FIT_SPLIT_ITERS),
          "silhouette_forward_backward": time_ms(sil_forward_backward,
                                                 FIT_SPLIT_ITERS),
          "contact_forward_backward": time_ms(contact, FIT_SPLIT_ITERS)}
    ms["adam"] = time_ms(opt.step, FIT_SPLIT_ITERS)
    ms["step"] = time_ms(whole_step, FIT_SPLIT_ITERS)
    ms["silhouette_backward"] = (ms["silhouette_forward_backward"]
                                 - ms["silhouette_forward"])
    traced = device_busy(whole_step)
    busy = (None if traced["device_busy_share"] is None
            else traced["device_busy_ms"])
    return {**ms, "step_device_busy_ms": busy,
            "step_idle_ms": None if busy is None else ms["step"] - busy,
            "step_idle_share": None if busy is None else 1.0 - busy / ms[
                "step"],
            "profiled_step": {k: traced[k] for k in (
                "batch_ms", "device_busy_ms", "device_busy_share",
                "top_device_ms")}}


def fit_card_and_cpu(scene, card_diag):
    """The recovery fit held to the port on the CPU: ICP's result on the
    same scene, and FIT_CPU_STEPS steps from the card's ICP result on the
    CPU's prepared scene, against the card's first steps. Returns the
    largest differences, the CPU's seconds and whether they are within
    FIT_ICP_TOL and FIT_STEP_TOL."""
    t = time.perf_counter()
    _, cpu = fit_mod.fit_human_object(scene, num_steps=1,
                                      image_size=FIT_SIZE, device="cpu")
    s, _ = fit_mod.prepare_scene(scene, "cpu")
    start = fit_opt.FitParams(*(p.cpu() for p in card_diag["init_params"]))
    _, _, cpu_loss, cpu_hist = fit_opt.run_fit(
        start, s, fit_opt.LossWeights(), num_steps=FIT_CPU_STEPS,
        image_size=FIT_SIZE)
    cpu_s = time.perf_counter() - t
    k, names = FIT_CPU_STEPS, fit_opt.FitParams._fields
    card_loss = card_diag["loss_history"][:k].cpu()
    icp = {n: float((a.cpu() - b).abs().max()) for n, a, b in zip(
        names, card_diag["init_params"], cpu["init_params"])}
    steps = {n: float((a[:k].cpu() - b).abs().max()) for n, a, b in zip(
        names, card_diag["params_history"], cpu_hist)}
    steps["loss"] = float(((card_loss - cpu_loss).abs()
                           / cpu_loss.abs()).max())
    held = (all(icp[n] <= FIT_ICP_TOL[n] for n in icp)
            and all(steps[n] <= FIT_STEP_TOL[n] for n in steps))
    return {"icp_max_abs_diff": icp, "steps_max_diff": steps,
            "card_losses": card_loss.tolist(),
            "cpu_losses": cpu_loss.tolist(), "cpu_s": cpu_s,
            "tol": {"icp": FIT_ICP_TOL, "steps": FIT_STEP_TOL}}, held


def fit_phase(root, contacts):
    """The fit: (1) ``data_io.main`` on a folder of the scene, the demo's
    first hcontact and ocontact contacts, at its defaults with
    ``--save_video`` (the seconds of ICP, the steps and the video, peak
    memory, launches); (2) the recovery fit (``fit_human_object``, the
    same settings) on the scene with the contacts of its true pose:
    translation and rotation error, scale and silhouette IoU at the mask
    centroid's start, after ICP and after Adam; (3) that run held to the
    port on the CPU (``fit_card_and_cpu``); (4) ICP's wall
    seconds and synchronising calls; (5) one step's split. Returns the
    launches over (1)."""
    scene, R_true, c_true = fit_scene()
    d = os.path.join(root, "fit")
    write_fit_folder(d, scene, contacts["hcontact"], contacts["ocontact"])
    secs, undo = timed_calls(fit_mod, ["icp_init", "run_fit",
                                       "save_fit_video"])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    try:
        t0 = time.perf_counter()
        best, diag = fit_io.main(["--input_path", d, "--num_steps",
                                  str(FIT_STEPS), "--image_size",
                                  str(FIT_SIZE), "--save_video"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
    finally:
        undo()
    launches = read_launches()
    from PIL import Image

    hist = diag["loss_history"].cpu().numpy()
    files = {n: os.path.exists(os.path.join(d, n)) for n in (
        "final_object.obj", "final_human.obj", "fit_result.npz",
        "fit_trajectory.gif")}
    with Image.open(os.path.join(d, "fit_trajectory.gif")) as im:
        frames = im.n_frames
    res = {"phase": "fit_cli", "size": FIT_SIZE, "steps": FIT_STEPS,
           "s": cli_s, "icp_s": secs["icp_init"], "steps_s": secs["run_fit"],
           "ms_per_step": secs["run_fit"][0] * 1e3 / FIT_STEPS,
           "video_s": secs["save_fit_video"], "video_frames": frames,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "contacts": [int((contacts[k] > 0.5).sum()) for k in contacts],
           "first_loss": float(hist[0]), "best_loss": float(
               diag["best_loss"]), "files": files,
           "launches": {n: launches[n] for n in KERNELS}}
    log(json.dumps(res))
    if not (all(files.values()) and np.isfinite(hist).all()
            and len(hist) == FIT_STEPS and float(diag["best_loss"]) <= hist[0]
            and frames >= 2 and not any(launches[n] for n in KERNELS)):
        raise SystemExit(f"the fit CLI failed: {res}")
    del best, diag

    # (2) the recovery fit, on the card
    t0 = time.perf_counter()
    best, diag = fit_mod.fit_human_object(scene, num_steps=FIT_STEPS,
                                          image_size=FIT_SIZE, device="cuda")
    torch.cuda.synchronize()
    rec_s = time.perf_counter() - t0
    s, t_mask = fit_mod.prepare_scene(scene, "cuda")
    start = fit_opt.FitParams(
        fit_utils.matrix_to_rot6d(torch.eye(3, device="cuda")), t_mask,
        torch.zeros((), device="cuda"))
    errs = {"mask_centroid_start": pose_errors(scene, start, R_true, c_true),
            "after_icp": pose_errors(scene, diag["init_params"], R_true,
                                     c_true),
            "after_adam": pose_errors(scene, best, R_true, c_true)}
    res = {"phase": "fit_recovery", "s": rec_s,
           "contacts": [int(scene["obj_contact_probs"].sum()),
                        int(scene["hum_contact_probs"].sum())],
           "first_loss": float(diag["loss_history"][0]),
           "best_loss": float(diag["best_loss"]), **errs}
    log(json.dumps(res))
    if not (np.isfinite(diag["loss_history"].cpu().numpy()).all()
            and errs["after_adam"]["iou"] > 0):
        raise SystemExit(f"the recovery fit failed: {res}")

    # (3) the card against the port on the CPU
    res, held = fit_card_and_cpu(scene, diag)
    log(json.dumps({"phase": "fit_card_vs_cpu", "steps": FIT_CPU_STEPS,
                    **res}))
    if not held:
        raise SystemExit(f"the fit's card and CPU disagree: {res}")

    # (4) ICP's syncs, (5) one step's split
    res = {"phase": "fit_step_split", "icp": icp_costs(scene),
           **fit_step_split(scene, diag["init_params"])}
    log(json.dumps(res))
    del best, diag
    return launches


def demo_fit_phase():
    """Phase 15: the demo's folder written on the card; ``interactvlm_13b``
    in bf16 with seeded random weights through the demo's per-image loop
    (DEMO_LEGS: hcontact with the renders, maps, SMPL-X matrix and body
    template; h2dcontact on the photos; ocontact, whose first image builds
    the object views at 1024^2 on the card); the tiny demo card against
    CPU; then the fit (``fit_phase``). Returns the launches of the demo's
    legs and of the fit CLI."""
    t_phase = time.perf_counter()
    work = os.path.join(WORKDIR, "demo_fit")
    shutil.rmtree(work, ignore_errors=True)
    folder_s = write_demo_folder(work, SPHERE, OBJ_SPHERE, MASK, DEMO_LEGS)
    t0 = time.perf_counter()
    cfg = config_13b()
    model = InteractVLM(cfg, device="cuda")
    init_params(model, torch.Generator(device="cuda").manual_seed(0))
    model.eval().requires_grad_(False)
    tok = WhitespaceTokenizer()
    tok.vocab["[SEG]"] = cfg.seg_token_idx
    torch.cuda.synchronize()
    log(json.dumps({"phase": "demo_setup", "folder_s": folder_s,
                    "init_s": time.perf_counter() - t0}))
    with torch.inference_mode():
        launches, contacts = demo_legs(model, tok, work,
                                       os.path.join(work, "out"))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    tiny_demo_card_and_cpu(os.path.join(work, "tiny"))
    fit_launches = fit_phase(work, contacts)
    shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(json.dumps({"phase": "demo_fit", "s": time.perf_counter() - t_phase}))
    return launches, fit_launches


# ------------------------------------------------- the flagship workflow
# phase 16 (flagship_workflow_phase): the JAX package's interaction
# flagship, hcontact-ocontact (scripts/run_train.sh:35-48), trained through
# the CLI on trees the port's datagen writes on the card, at the preset's
# own views: DAMON under FLAG_HUMAN_VIEWS, PICO and PIAD under
# FLAG_OBJECT_VIEWS, at 1024^2
FLAG_HUMAN_VIEWS, FLAG_OBJECT_VIEWS = HOI_HUMAN_VIEWS, HOI_OBJECT_VIEWS
FLAG_PRESET = ["--exp_name", "interactvlm-3d-hcontact-ocontact",
               "--dataset", "hcontact||ocontact||oafford||vqa",
               "--sample_rates", "9,9,5,2",
               "--token_type", "Gen-Hu-Obj", "--cam_encoder_type", "vi_v1",
               "--oC_sam_view_type", "4MV-Z_HM_BM",
               "--hC_sam_view_type", "4MV-Z_Vitru",
               "--hC_question_type", "parts", "--oC_question_type", "afford",
               "--hC_loss_weight", "3.0", "--oC_loss_weight", "3.0",
               "--epochs", "30", "--steps_per_epoch", "500",
               "--batch_size", "8", "--lr", "3e-4", "--warmup_steps", "100"]
# the trees: DAMON_IMAGES photos of the 6890-vertex sphere; PICO meshes
# (UV spheres stretched into ellipsoids: 1010, 2342, 4132 and 8101
# vertices); PIAD clouds of PIAD_POINTS points; VQA_RECORDS VQA records
PICO_SPHERES = ((25, 42), (40, 60), (60, 70), (90, 91))
PICO_AXES = ((0.5, 0.9, 0.5), (0.35, 0.95, 0.35), (0.9, 0.4, 0.6),
             (0.95, 0.6, 0.45))
PICO_CLASSES = ("Bottle", "Vase", "Skateboard", "Bench")
PIAD_OBJECTS = (("chair_001", "Chair"), ("bed_002", "Bed"),
                ("bench_003", "Bench"), ("stool_004", "Stool"))
PIAD_POINTS, VQA_RECORDS = 2048, 8
FLAG_B, FLAG_STEPS, FLAG_WORKERS = 8, 4, 8
FLAG_TASKS = ("hcontact", "ocontact", "oafford", "vqa")
# the tiny chain: the five recipes on the card and on the CPU at 64^2; the
# tiny flagship CLI (the JAX package's flagship test's flags; one loader
# thread, so both devices see the same batches) for TINY_FLAG_STEPS steps
# on each, every step's loss terms held within TINY_LOSS_RTOL relative
# (SAM computes bf16 on the card, f32 on the CPU; measured on an H100:
# 9.7e-5, the limit about 5 times that); then the eval CLI on
# copies of both runs whose answers are all [OSEG] and whose masks are all
# FORCE_LOGIT, so that every lifted value is 1.0 exactly on both devices
# and the two reports must be equal
TINY_OBJ_SPHERES = ((6, 8), (12, 16))
TINY_FLAG_STEPS, TINY_FLAG_POINTS, TINY_FLAG_EVAL_B = 2, 300, 2
TINY_LOSS_RTOL, FORCE_LOGIT = 5e-4, 20.0
PNG_LEVELS, BARY_TOL = 1, 1e-4
SIDES = {"card": "cuda", "cpu": "cpu"}  # the tiny chain's two devices


def sphere_annotations(n, n_images):
    """DAMON annotations of ``n_images`` photos of an n-vertex sphere:
    one object's contact each and a 'supporting' one (feet and legs)."""
    annot = {}
    for i in range(n_images):
        start = (i * 397) % n
        annot[f"img{i:02d}.jpg"] = {
            DAMON_OBJECTS[i % len(DAMON_OBJECTS)]:
                np.arange(start, start + n // 10) % n,
            "supporting": np.concatenate([
                np.arange(n // 2 + 7 * i, n // 2 + 7 * i + n // 20),
                np.arange(n - n // 12, n)])}
    return annot


def write_photos(root, names, seed=0):
    """Seeded 640 x 480 JPEG photos ``root/images/<name>``."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    for name in names:
        Image.fromarray(rng.integers(0, 256, DEMO_PHOTO + (3,), np.uint8)
                        ).save(os.path.join(root, "images", name),
                               quality=90)


def pico_meshes(spheres, seed=0):
    """PICO objects: UV spheres stretched along PICO_AXES, each touched on
    its lowest fifth, with a photo name and a class."""
    rng = np.random.default_rng(seed)
    meshes = {}
    for i, sphere in enumerate(spheres):
        verts, faces = uv_sphere(*sphere)
        verts = (verts * np.asarray(PICO_AXES[i % len(PICO_AXES)])
                 + rng.normal(scale=0.01, size=3)).astype(np.float32)
        y = verts[:, 1]
        contact = (y < y.min() + 0.2 * (y.max() - y.min())).astype(
            np.float32)
        meshes[f"pico_{i:03d}"] = {
            "verts": verts, "faces": faces, "contact": contact,
            "image": f"pico{i}.jpg",
            "class_name": PICO_CLASSES[i % len(PICO_CLASSES)]}
    return meshes


def piad_clouds(n_points, objects, seed=0):
    """PIAD objects: a cube, a slab, a sphere and a cylinder of
    ``n_points`` points, 'sit' on the upper two fifths of each."""
    rng = np.random.default_rng(seed)
    clouds = {}
    for i, (oid, cls) in enumerate(objects):
        kind = i % 4
        if kind == 0:
            pts = rng.uniform(-0.7, 0.7, (n_points, 3))
        elif kind == 1:
            pts = rng.uniform(-1, 1, (n_points, 3)) * [0.9, 0.25, 0.6]
        elif kind == 2:
            v = rng.normal(size=(n_points, 3))
            pts = 0.7 * v / np.linalg.norm(v, axis=1, keepdims=True)
        else:
            a = rng.uniform(0, 2 * np.pi, n_points)
            pts = np.stack([0.4 * np.cos(a),
                            rng.uniform(-0.8, 0.8, n_points),
                            0.4 * np.sin(a)], 1)
        clouds[oid] = (cls, pts, pts[:, 1] > np.quantile(pts[:, 1], 0.6))
    return clouds


def write_piad_txt(path, cls, pts, sit):
    """A PIAD point file: ``<idx> <class> x y z`` and 17 affordance
    columns, 'sit' set where ``sit`` is."""
    col = int(np.argwhere(AFFORD_LIST_PIAD == "sit").item())
    lines = []
    for i, (p, a) in enumerate(zip(pts, sit)):
        aff = ["0"] * 17
        aff[col] = str(int(a))
        lines.append(f"{i} {cls} " + " ".join(f"{v:.4f}" for v in p) + " "
                     + " ".join(aff))
    with open(path, "w") as f:
        f.write("\n".join(lines))


def write_flagship_inputs(d, sphere, n_images, spheres, n_points, objects):
    """The datagen CLI's input files under ``d``: the body npz, its
    segmentation, the DAMON, LEMON-HU and RICH contacts, the PICO meshes
    pickle and the PIAD txt folder. Returns their paths."""
    verts, faces = uv_sphere(*sphere)
    n = len(verts)
    os.makedirs(os.path.join(d, "piad_txt"), exist_ok=True)
    files = {k: os.path.join(d, k + ext) for k, ext in (
        ("body", ".npz"), ("segm", ".pkl"), ("damon", ".pkl"),
        ("lemon", ".pkl"), ("rich", ".pkl"), ("pico", ".pkl"))}
    files["piad_txt"] = os.path.join(d, "piad_txt")
    np.savez(files["body"], verts=verts, faces=faces)
    lemon = {}
    for i, cls in enumerate(("mug", "bottle", "knife")):
        c = np.zeros(n, np.float32)
        c[(i * n) // 5:(i * n) // 5 + n // 8] = 1.0
        lemon[f"lemon/Images/{cls}_{i:04d}.jpg"] = c
    rich = {f"seq01/cam{i}/f{i:03d}.jpg":
            np.arange(i * n // 7, i * n // 7 + n // 9) for i in range(3)}
    for key, obj in (("segm", body_parts_of(n)),
                     ("damon", sphere_annotations(n, n_images)),
                     ("lemon", lemon), ("rich", rich),
                     ("pico", pico_meshes(spheres))):
        with open(files[key], "wb") as f:
            pickle.dump(obj, f)
    for oid, (cls, pts, sit) in piad_clouds(n_points, objects).items():
        write_piad_txt(os.path.join(files["piad_txt"], oid + ".txt"), cls,
                       pts, sit)
    return files


def datagen_argv(recipe, root, files, size, views, *extra):
    """The port's datagen CLI's argv for one recipe on ``files``."""
    inputs = {"damon": ["--contact_pkl", files["damon"]],
              "rich": ["--contact_pkl", files["rich"]],
              "lemon-hu": ["--contact_pkl", files["lemon"]],
              "pico": ["--meshes_pkl", files["pico"]],
              "piad": ["--points_dir", files["piad_txt"]]}[recipe]
    if recipe in ("damon", "rich", "lemon-hu"):
        inputs += ["--mesh", files["body"], "--segm", files["segm"]]
    return ([recipe, "--root", root, "--image_size", str(size),
             "--view_type", views] + inputs + list(extra))


def timed_on_card(fn):
    """(fn(), seconds, peak GB), the card synchronised around the call."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 1e9)


def write_flagship_tree(tree, files, size, n_images):
    """The flagship's four trees under ``tree``, rasterized on the card:
    the DAMON tree and the PICO train and test splits through the datagen
    CLI, the PIAD train split through ``generate_piad_tree`` (the CLI has
    no flag for the match lists) and its test split through the CLI; the
    photos and a flat ``vqa.pkl``. Returns one record a recipe call:
    items, seconds, seconds an item, peak GB."""
    with open(files["pico"], "rb") as f:
        pico = pickle.load(f)
    piad = sorted(os.path.splitext(n)[0]
                  for n in os.listdir(files["piad_txt"]))
    write_photos(tree, [f"img{i:02d}.jpg" for i in range(n_images)]
                 + [m["image"] for m in pico.values()]
                 + [f"{oid}.jpg" for oid in piad]
                 + [f"vqa{i}.jpg" for i in range(VQA_RECORDS)])
    with open(os.path.join(tree, "vqa.pkl"), "wb") as f:
        pickle.dump([{"image": f"vqa{i}.jpg",
                      "question": "What is the person doing with the "
                                  f"object in picture {i} ?",
                      "answer": "The person is sitting on it ."}
                     for i in range(VQA_RECORDS)], f)
    human, obj = FLAG_HUMAN_VIEWS, FLAG_OBJECT_VIEWS
    calls = (
        ("damon", n_images, lambda: datagen_cli.main(datagen_argv(
            "damon", tree, files, size, human))),
        ("pico train", len(pico), lambda: datagen_cli.main(datagen_argv(
            "pico", tree, files, size, obj))),
        ("pico test", len(pico), lambda: datagen_cli.main(datagen_argv(
            "pico", tree, files, size, obj, "--split", "test"))),
        ("piad train", len(piad), lambda: generate_piad_tree(
            tree, {oid: os.path.join(files["piad_txt"], oid + ".txt")
                   for oid in piad}, OBJECT_VIEWS[obj], size,
            object_matches={oid: [oid] for oid in piad}, affordance="sit")),
        ("piad test", len(piad), lambda: datagen_cli.main(datagen_argv(
            "piad", tree, files, size, obj, "--split", "test"))),
    )
    out = []
    for name, items, fn in calls:
        _, secs, peak = timed_on_card(fn)
        out.append({"recipe": name, "items": items, "s": secs,
                    "s_per_item": secs / items, "peak_gb": peak})
    return out


def first_damon_round_trip(tree, files):
    """``verify_contact_reconstruction`` on the card of the first DAMON
    annotation (the first image's first object): its masks as written and
    the tree's lift maps."""
    from PIL import Image

    with open(files["damon"], "rb") as f:
        annot = pickle.load(f)
    image = sorted(annot)[0]
    obj = sorted(annot[image])[0]
    root = os.path.join(tree, "hcontact_vitruvian_mv2")
    stem = os.path.splitext(image)[0]
    masks = np.stack([np.asarray(Image.open(os.path.join(
        root, "masks", f"{stem}_{obj}_{v}.png"))) >= 128
        for v in HUMAN_VIEWS[FLAG_HUMAN_VIEWS].names])
    maps = np.load(os.path.join(root, "lift_maps.npz"))
    cmask = np.zeros(len(np.load(files["body"])["verts"]), bool)
    cmask[np.asarray(annot[image][obj])] = True
    counts = verify_contact_reconstruction(
        masks, torch.as_tensor(maps["p2v"], device="cuda"),
        torch.as_tensor(maps["bary"], device="cuda"), cmask)
    return {"image": image, "object": obj, **counts}


def flagship_validate(model, tokenizer, args, tree):
    """``validate`` of the trained flagship model on one batch of FLAG_B
    rows each of hcontact, ocontact and oafford from the tree's test
    splits (a split's samples repeated to fill it), the cached view encode
    for hcontact, T new tokens, each task's own seg token raised by
    ``let_seg_token_appear``. Returns one record a task and the three
    validations' launches together."""
    maps = train_cli._load_human_maps(tree, "cuda")
    maps["num_vertices"] = model.config.num_human_vertices
    batches = {}
    for name in ("hcontact", "ocontact", "oafford"):
        ds = ValDataset(build_dataset(name, tree, "test", args))
        batches[name] = collate(
            [ds[i % len(ds)] for i in range(FLAG_B)], tokenizer,
            max_len=args.model_max_length,
            num_human_vertices=model.config.num_human_vertices,
            num_object_points=model.config.num_object_points,
            human_maps=maps,
            include_object_maps=name in ("ocontact", "oafford"))
    cfg = model.config
    head = model.llava.lm.lm_head.weight
    seg_rows = {t: head[t].clone() for t in (cfg.hseg_token_idx,
                                             cfg.oseg_token_idx)}
    sam = model.config.sam
    n_global = len(sam.encoder_global_attn_indexes)
    want = {"flash_attention": model.config.llama.num_layers
            + sam.decoder_depth,
            "fwd_routes": {"sm90": model.config.llama.num_layers,
                           "sm90_d16": sam.decoder_depth, "mma": 0},
            "window_attention": sam.encoder_depth - n_global,
            "rel_attention": n_global}
    out, full = {}, []
    for name, (batch, meta) in batches.items():
        # the task's own seg token, raised alone: [HSEG] for hcontact,
        # [OSEG] for the object tasks
        token = (cfg.hseg_token_idx if name == "hcontact"
                 else cfg.oseg_token_idx)
        for t, row in seg_rows.items():
            head[t] = row
        ids, _ = truncate_at_answer(batch["input_ids"].numpy(),
                                    batch["labels"].numpy())
        let_seg_token_appear(model, {"input_ids": ids,
                                     "images_clip": batch["images_clip"]},
                             "cuda", "dense", token=token)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        results, _ = validate(iter([(batch, meta)]), model, name, MASK,
                              human_maps=maps, max_new_tokens=T,
                              cache_view_encode=name == "hcontact",
                              max_batches=1)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launches()
        full.append(launches)
        out[name] = {"images": FLAG_B, "s": secs,
                     "images_per_s": FLAG_B / secs, "results": results,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "launches": {n: launches[n] for n in want},
                     "launches_expected": want}
        metric = results["auc" if name == "oafford" else "f1"]
        if not (np.isfinite(metric) and results["seg_rate"] > 0
                and all(launches[n] == c for n, c in want.items())):
            raise SystemExit(f"the flagship's {name} validation failed: "
                             f"{out[name]}")
    return out, sum_launches(full)


def tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def tree_differences(got_root, want_root):
    """How the tree under ``got_root`` differs from ``want_root``: the
    files of one side only, the largest PNG level, map and barycentric
    differences, and the pickles (by ``repr``) and text files that
    differ."""
    from PIL import Image

    got, want = tree_files(got_root), tree_files(want_root)
    res = {"files": len(want), "only_one_side": sorted(set(got) ^ set(want)),
           "png_levels": 0, "maps": 0.0, "bary": 0.0, "pickles_differ": [],
           "text_differ": []}
    for rel in sorted(set(got) & set(want)):
        a, b = os.path.join(want_root, rel), os.path.join(got_root, rel)
        if rel.endswith(".png"):
            x = np.asarray(Image.open(a)).astype(int)
            y = np.asarray(Image.open(b)).astype(int)
            res["png_levels"] = max(res["png_levels"], int(
                np.abs(x - y).max()) if x.shape == y.shape else 256)
        elif rel.endswith(".pkl"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                if repr(pickle.load(fa)) != repr(pickle.load(fb)):
                    res["pickles_differ"].append(rel)
        elif rel.endswith(".npz"):
            za, zb = np.load(a), np.load(b)
            for k in za.files:
                kind = "bary" if k == "bary" or os.path.basename(
                    rel).startswith("bary") else "maps"
                same = k in zb.files and za[k].shape == zb[k].shape
                res[kind] = max(res[kind], float(np.abs(
                    za[k].astype(np.float64) - zb[k].astype(np.float64)
                ).max()) if same else float("inf"))
        else:
            with open(a) as fa, open(b) as fb:
                if fa.read() != fb.read():
                    res["text_differ"].append(rel)
    return res


def recipes_card_and_cpu(work, files):
    """The five recipes through the datagen CLI at TINY_SIZE on the card
    and on the CPU from the same input files, each in a root of its own:
    the card's seconds and how its tree differs from the CPU's."""
    out = {}
    for recipe in ("damon", "lemon-hu", "rich", "piad", "pico"):
        views = (FLAG_OBJECT_VIEWS if recipe in ("piad", "pico")
                 else FLAG_HUMAN_VIEWS)
        roots = {side: os.path.join(work, side, recipe) for side in SIDES}
        secs = {side: timed_on_card(lambda: datagen_cli.main(datagen_argv(
            recipe, roots[side], files, TINY_SIZE, views, "--device",
            dev)))[1] for side, dev in SIDES.items()}
        out[recipe] = {"card_s": secs["card"], "cpu_s": secs["cpu"],
                       **tree_differences(roots["card"], roots["cpu"])}
    return out


def force_object_answers(run, dst):
    """A run directory ``dst`` holding ``run``'s pretrained config and its
    latest weights with every answer token [OSEG] (a constant channel 0 in
    the residual stream, from the embeddings and the projected patches,
    and [OSEG]'s lm_head row on it) and every mask logit FORCE_LOGIT (the
    mask decoders' upscaled channel 0 the constant GELU(FORCE_LOGIT), each
    hypernetwork's output 1 on channel 0 and 0 on the others)."""
    os.makedirs(dst)
    shutil.copy(os.path.join(run, "pretrained_config.json"), dst)
    oseg = load_config(run, "pretrained_config.json")["oseg_token_idx"]
    state = CheckpointManager(run).restore()
    sd = state["model"]
    sd["llava.lm.model.embed_tokens.weight"][:, 0] = 30.0
    sd["llava.mm_projector.bias"][0] = 30.0
    sd["llava.lm.lm_head.weight"][oseg, 0] = 5.0
    up = ".output_upscaling.3."
    for key in [k for k in sd if k.endswith(up + "weight")]:
        dec = key[:-len(up + "weight")]
        sd[key][:, 0] = 0.0  # ConvTranspose2d weight (in, out, k, k)
        sd[dec + up + "bias"][0] = FORCE_LOGIT
        heads = {k.rsplit(".layers.", 1)[0] for k in sd if k.startswith(
            dec + ".output_hypernetworks_mlps.")}
        for head in heads:
            last = max(int(k.rsplit(".layers.", 1)[1].split(".")[0])
                       for k in sd if k.startswith(head + ".layers."))
            sd[f"{head}.layers.{last}.weight"].zero_()
            sd[f"{head}.layers.{last}.bias"].zero_()
            sd[f"{head}.layers.{last}.bias"][0] = 1.0
    CheckpointManager(dst).save(state["step"], state)


def tiny_flagship_card_and_cpu(work, files):
    """The tiny chain: the five recipes card against CPU; a tiny flagship
    tree written on the card; the tiny flagship CLI for TINY_FLAG_STEPS
    steps with saving on the card and on the CPU, every step's loss terms
    held within TINY_LOSS_RTOL; the eval CLI for ocontact and oafford on
    both runs (printed) and on their forced copies (held equal)."""
    t0 = time.perf_counter()
    recipes = recipes_card_and_cpu(os.path.join(work, "recipes"), files)
    tree = os.path.join(work, "tree")
    write_flagship_tree(tree, files, TINY_SIZE, TINY_IMAGES)
    runs = os.path.join(work, "runs")
    argv = ["--tokenizer", "whitespace", "--model_scale", "tiny",
            "--dataset", "hcontact||ocontact||oafford||vqa",
            "--sample_rates", "9,9,5,2",
            "--token_type", "Gen-Hu-Obj", "--cam_encoder_type", "vi_v1",
            "--oC_sam_view_type", FLAG_OBJECT_VIEWS,
            "--hC_sam_view_type", FLAG_HUMAN_VIEWS,
            "--hC_question_type", "parts", "--oC_question_type", "afford",
            "--hC_loss_weight", "3.0", "--oC_loss_weight", "3.0",
            "--dataset_dir", tree, "--image_size", str(TINY_SIZE),
            "--clip_size", "28", "--num_human_vertices", "178",
            "--num_object_points", str(TINY_FLAG_POINTS),
            "--model_max_length", "384", "--epochs", "1",
            "--steps_per_epoch", str(TINY_FLAG_STEPS), "--batch_size", "4",
            "--lr", "1e-3", "--warmup_steps", "2", "--log_base_dir", runs,
            "--val_batches", "1", "--val_every", "1", "--data_workers", "1",
            "--no_tensorboard"]
    steps = {}
    for side, dev in SIDES.items():
        trainer = train_cli.main(argv + ["--exp_name", side, "--device",
                                         dev])
        steps[side] = [{"loss": h["loss"], **h["loss_terms"],
                        "rows": h["rows_by_task"]} for h in trainer.history]
        del trainer
    rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6)
              for a, b in zip(steps["card"], steps["cpu"]) for k in b
              if k != "rows")
    reports, forced = {}, {}
    for side, dev in SIDES.items():
        run = os.path.join(runs, side)
        force_object_answers(run, run + "_forced")
        for name in ("ocontact", "oafford"):
            ev = ["--dataset_dir", tree, "--val_dataset", name,
                  "--batch_size", str(TINY_FLAG_EVAL_B), "--max_batches",
                  "1", "--max_new_tokens", "8", "--device", dev]
            reports[f"{name}_{side}"] = eval_cli.main(["--run_dir", run]
                                                      + ev)
            forced[f"{name}_{side}"] = eval_cli.main(
                ["--run_dir", run + "_forced"] + ev)
    diffs = {f"{name}.{k}": abs(forced[f"{name}_card"]["metrics"][k] - v)
             for name in ("ocontact", "oafford")
             for k, v in forced[f"{name}_cpu"]["metrics"].items()}
    res = {"phase": "flagship_tiny_chain", "s": time.perf_counter() - t0,
           "recipes_card_vs_cpu": recipes, "steps": steps,
           "loss_max_rel_diff": rel, "tol": TINY_LOSS_RTOL,
           "reports": reports, "forced_reports": forced,
           "forced_max_diff": max(diffs.values())}
    log(json.dumps(res))
    trees_held = all(not r["only_one_side"] and r["png_levels"] <= PNG_LEVELS
                     and r["maps"] == 0.0 and r["bary"] <= BARY_TOL
                     and not r["pickles_differ"] and not r["text_differ"]
                     for r in recipes.values())
    runs_held = (all(len(s) == TINY_FLAG_STEPS for s in steps.values())
                 and [s["rows"] for s in steps["card"]]
                 == [s["rows"] for s in steps["cpu"]]
                 and rel <= TINY_LOSS_RTOL)
    forced_held = (all(d == 0 for d in diffs.values())
                   and all(f["metrics"]["seg_rate"] == 1.0
                           for f in forced.values())
                   and all(np.isfinite(r["metrics"][
                       "f1" if k.startswith("ocontact") else "auc"])
                       for k, r in reports.items()))
    if not (trees_held and runs_held and forced_held):
        raise SystemExit(f"the tiny flagship chain failed: trees "
                         f"{trees_held}, runs {runs_held}, forced "
                         f"{forced_held}")


def sum_launches(counts):
    """Launch counts (``read_launches`` dicts) added key by key."""
    out = {}
    for c in counts:
        for k, v in c.items():
            if isinstance(v, dict):
                routes = out.setdefault(k, {})
                for r, n in v.items():
                    routes[r] = routes.get(r, 0) + n
            else:
                out[k] = out.get(k, 0) + v
    return out


def flagship_workflow_phase():
    """Phase 16: the hcontact-ocontact flagship through the port's entry
    points: (1) its four trees written on the card at 1024^2 through the
    datagen CLI (DAMON under FLAG_HUMAN_VIEWS; PICO and PIAD under
    FLAG_OBJECT_VIEWS; a VQA pickle), each recipe's seconds, seconds an
    item and peak GB, and the first DAMON annotation's round trip; (2) the
    preset through the training CLI at full width (LLaMA-13B bf16, LoRA 8
    with remat, the whitespace tokenizer) for FLAG_STEPS steps with
    FLAG_WORKERS loader threads: each step's wall and data seconds, the
    loader-wait share, the rows of each task, each loss term, the
    launches a step against ``train_launches_expected`` and the peak GB;
    then ``TrainStep`` on one real batch without the loader (resident,
    copied) and one profiled step; (3) ``validate`` of the trained model on one batch each of hcontact,
    ocontact and oafford; (4) the tiny chain card against CPU
    (``tiny_flagship_card_and_cpu``). Returns the launches of the training
    CLI and those of the three validations together."""
    t_phase = time.perf_counter()
    work = os.path.join(WORKDIR, "flagship")
    shutil.rmtree(work, ignore_errors=True)
    files = write_flagship_inputs(os.path.join(work, "inputs"), SPHERE,
                                  DAMON_IMAGES, PICO_SPHERES, PIAD_POINTS,
                                  PIAD_OBJECTS)
    tree = os.path.join(work, "tree_1024")
    recipes = write_flagship_tree(tree, files, MASK, DAMON_IMAGES)
    round_trip = first_damon_round_trip(tree, files)
    log(json.dumps({"phase": "flagship_trees", "size": MASK,
                    "recipes": recipes, "first_damon_round_trip": round_trip,
                    "bytes": sum(os.path.getsize(os.path.join(d, f))
                                 for d, _, fs in os.walk(tree) for f in fs)}))
    if round_trip["missed"] != 0 or round_trip["original_visible"] == 0:
        raise SystemExit(f"the DAMON round trip missed contacts: "
                         f"{round_trip}")

    # (2) the preset through the training CLI at full width
    runs = os.path.join(work, "runs")
    argv = FLAG_PRESET + [
        "--model_scale", "full", "--tokenizer", "whitespace",
        "--dataset_dir", tree, "--data_workers", str(FLAG_WORKERS),
        "--epochs", "1", "--steps_per_epoch", str(FLAG_STEPS),
        "--batch_size", str(FLAG_B), "--no_eval", "--save_every", "2",
        "--log_base_dir", runs, "--no_tensorboard"]
    trainer, cli_s, launches, peak_gb, loads = cli_train(argv)
    hist = trainer.history
    want = train_launches_expected(trainer.cfg, FLAG_STEPS)
    res = {"phase": "flagship_train", "argv": argv, "cli_s": cli_s,
           "first_batch_s": trainer.first_batch_s,
           "steps": [{"wall_s": h["batch_s"], "data_s": h["data_s"],
                      "step_s": h["batch_s"] - h["data_s"],
                      "loader_wait_share": h["loader_wait_share"],
                      "rows": h["rows_by_task"], "loss": h["loss"],
                      "loss_terms": h["loss_terms"]} for h in hist],
           "step_s_after_first": spread([h["batch_s"] - h["data_s"]
                                         for h in hist[1:]]),
           "peak_gb": peak_gb,
           "launches_per_step": {n: launches[n] / FLAG_STEPS for n in
                                 TRAINING_KERNELS + ("window_attention",
                                                     "rel_attention")},
           "image_loads": loads}
    log(json.dumps(res))
    checks = {
        "steps": trainer.step.step == FLAG_STEPS and len(hist) == FLAG_STEPS,
        "losses_finite": all(np.isfinite(h["loss"]) and all(
            np.isfinite(v) for v in h["loss_terms"].values()) for h in hist),
        "none_skipped": all(h["skipped_nonfinite"] == 0.0 for h in hist),
        "launches_as_expected": launches == want,
        "nothing_saved": not os.path.exists(os.path.join(
            runs, "interactvlm-3d-hcontact-ocontact", "ckpt")),
        "rows_per_batch": all(sum(h["rows_by_task"].values()) == FLAG_B
                              and set(h["rows_by_task"]) <= set(FLAG_TASKS)
                              for h in hist),
        "k_slots": trainer.cfg.max_seg_tokens == 2,
    }
    log(json.dumps({"phase": "flagship_train_checks", **checks,
                    "expected": want, "launches": launches}))
    if not all(checks.values()):
        raise SystemExit(f"the flagship training CLI failed: {checks}")

    # where the step's time goes: TrainStep on the loader's first batch
    # with no loader running (resident on the card, or copied each step),
    # then one step under the profiler
    args = train_cli.parse_args(argv)
    loader = train_cli.real_batch_iter(args, trainer.cfg, trainer.tokenizer,
                                       "cuda")
    batch = next(loader)
    loader.close()
    split = step_split_ms(trainer.step, batch)
    prof = device_busy(lambda: trainer.step(to_device(batch, "cuda")))
    log(json.dumps({"phase": "flagship_step_split",
                    "rows": train_cli.rows_by_task(batch),
                    "batch_mb": sum(v.nbytes for v in batch.values()
                                    if torch.is_tensor(v)) / 1e6,
                    "cli_ms": spread([(h["batch_s"] - h["data_s"]) * 1e3
                                      for h in hist[1:]]),
                    "train_step_resident_ms": spread(split["resident"]),
                    "train_step_copied_ms": spread(split["copied"]),
                    "profiled_step": prof}))
    del batch

    # (3) validate the trained model, one batch a task
    model, tokenizer = trainer.model, trainer.tokenizer
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    model.requires_grad_(False)
    with torch.inference_mode():
        val, val_launches = flagship_validate(model, tokenizer, args,
                                              tree)
    log(json.dumps({"phase": "flagship_validate", **val}))
    del model, tokenizer
    gc.collect()
    torch.cuda.empty_cache()

    # (4) the tiny chain, the card against the CPU
    tiny = os.path.join(work, "tiny")
    tiny_flagship_card_and_cpu(tiny, write_flagship_inputs(
        os.path.join(tiny, "inputs"), TINY_SPHERE, TINY_IMAGES,
        TINY_OBJ_SPHERES, TINY_FLAG_POINTS, PIAD_OBJECTS[:2]))
    shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(json.dumps({"phase": "flagship_workflow",
                    "s": time.perf_counter() - t_phase}))
    return launches, val_launches


# ------------------------------------------------------------ phase 17
# the distributed paths on the one card. NCCL takes one rank a card, so the
# NCCL launch runs at world size 1 (torchrun, the training CLI), and the
# sharded math runs on two gloo ranks that share the card: every
# collective there is a gloo all-reduce or broadcast of card tensors, whose
# times are not multi-card numbers
DIST_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "distributed")
# the CLI at 2 steps (cut from 4: its third step parts from run to run),
# the tensor-parallel step at 1 (cut from 3) and the 13B decode at 16
# tokens (cut from 32): the whole script took 1112 s of its 1200 on one
# H100 machine with them at 2, 2 and 32
DIST_CLI_STEPS, DIST_TP_STEPS, DIST_DECODE_STEPS = 2, 1, 16
DIST_INT8_DECODE_STEPS, DIST_TREE_IMAGES = 16, 8
# holds: the sharded step against the one-process step in bf16 (loss terms
# relative, each trainable's gradient by cosine and norm ratio); the NCCL
# CLI's losses against the one-process CLI's; the distributed report
DIST_LOSS_RTOL, DIST_GRAD_COS, DIST_GRAD_NORM_RTOL = 1e-2, 0.99, 0.02
# a gradient that is zero in exact arithmetic (a key projection's bias:
# softmax ignores a shift shared by every key) is rounding noise on both
# sides: leaves whose one-process gradient norm is below this share of the
# largest leaf's are reported, not held
DIST_GRAD_NOISE_SHARE = 1e-3
# the 1 x 2 step in f32 at LLaMA-13B's width over DIST_F32_LAYERS layers:
# loss terms relative, each trainable's gradient by cosine and norm ratio,
# at what f32 summation order in another order can move (the one-process
# and sharded sums differ in order only)
DIST_F32_LAYERS = 2
DIST_F32_LOSS_RTOL, DIST_F32_GRAD_COS, DIST_F32_GRAD_NORM_RTOL = (
    1e-5, 0.99999, 1e-4)
CLI_LOSS_RTOL, REPORT_RTOL = 1e-5, 1e-6
# TP_INT8_CASES: kernel 6 at the halved shapes a model rank gives it
TP_INT8_CASES = [
    ("LLaMA-7B QLoRA training gate/up, one of 2 model ranks", B * 512, 4096,
     5504, False, "none", None),
    ("LLaMA-7B QLoRA training down, one of 2 model ranks", B * 512, 5504,
     4096, False, "none", None),
    ("LLaMA-7B decode gate/up, B=8, one of 2 model ranks", B, 4096, 5504,
     False, "none", None),
]
# kernel 7's given-scale route at the 1 x 2 int8 decode's row-parallel
# shapes: the prefill's down (8 x 64 rows of 5504) and decode's o_proj
GIVEN_CASES = [("LLaMA-7B prefill down, one of 2 model ranks", B * L_TEXT,
                5504),
               ("LLaMA-7B decode o_proj, B=8, one of 2 model ranks", B, 2048)]


def case_quantize_given(gen, name, what, M, K):
    """Kernel 7's given-scale route on bf16 rows whose given absmax spans a
    wider row than the slice (the all-reduced MAX): bit for bit against its
    plain version; timed beside the plain route (``quantize_rows``) and
    the plain version, with its device time (CUDA events around calls of a
    few microseconds time the host). No single library call quantizes
    rows."""
    x = rand_bf16(gen, (M, K))
    amax = (x.abs().amax(-1).float() * 1.5).contiguous()
    got = Q.quantize_rows_given(x, amax)
    want = Q.quantize_rows_given_plain(x, amax)
    ok = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    t, by = bound(0, 2 * M * K + 4 * M + M * K + 4 * M, name)
    return dict(shape=f"{what}: M={M} K={K} bf16", ok=ok,
                max_abs_err=float((got[0].int() - want[0].int()).abs().max()),
                err_over_limit=0.0 if ok else float("inf"),
                tol="bit for bit",
                kernel_ms=time_ms(lambda: Q.quantize_rows_given(x, amax), 50),
                device_ms=device_ms(lambda: Q.quantize_rows_given(x, amax),
                                    20)[0],
                plain_route_ms=time_ms(lambda: Q.quantize_rows(x), 50),
                plain_ms=time_ms(lambda: Q.quantize_rows_given_plain(x, amax),
                                 5),
                library_ms=None, bound_ms=t, bound_by=by)


def tp_cases(name, cases, lens):
    """The kernels at the shapes tensor parallelism over two model ranks
    gives them (each from its own generator, drawn after every other case):
    kernels 1, 4 and 5 at 20 of LLaMA-13B's 40 heads, kernel 6 at half of
    7B's MLP columns or rows, and kernel 7's given-scale route."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    what = (f"B=8 H=20 L=512 D=128 causal, kv lengths {lens} (LLaMA-13B "
            f"training, one of 2 model ranks)")
    cases["flash_attention"].append(case_flash_prefill(gen, name, 512, lens,
                                                       what, H=20))
    c = case_flash_bwd(gen, name, what, B, 20, 512, 512, 128, True, lens)
    log(json.dumps({"name": "flash_attention_bwd", **c}))
    for which in ("dq", "dkv"):
        cases[f"flash_attention_bwd_{which}"].append(bwd_rows(c, which))
    torch.cuda.empty_cache()
    for c in TP_INT8_CASES:
        cases["int8_matmul"].append(case_int8(gen, name, *c))
        torch.cuda.empty_cache()
    cases["quantize_rows_given"] = [case_quantize_given(gen, name, *c)
                                    for c in GIVEN_CASES]


def grad_holds(names, grads, ref, mesh):
    """Each trainable's gradient (this rank's block) against the same
    block of the one-process gradient ``ref``: {name: (cosine, norm
    ratio)}, leaves zero on both sides, or at noise
    (``DIST_GRAD_NOISE_SHARE``), left out."""
    from interactvlm_tpu_torch.parallel.mesh import shard_tensor

    out = {}
    top = max(float(g.float().norm()) for g in ref.values())
    for n, g in zip(names, grads):
        if n in ref and float(ref[n].norm()) < DIST_GRAD_NOISE_SHARE * top:
            continue  # at rounding noise on both sides
        if n not in ref:  # a trainable the one-process loss did not reach
            want = torch.zeros(g.shape, device=g.device)
        else:
            want = shard_tensor(n, ref[n], mesh.n_model,
                                mesh.model_index).to(g.device, torch.float32)
        got = g.float()
        nw, ng = want.norm(), got.norm()
        if float(nw) == 0.0 and float(ng) == 0.0:
            continue
        cos = (got * want).sum() / (ng * nw).clamp_min(1e-30)
        out[n] = (float(cos), float(ng / nw.clamp_min(1e-30)))
    return out


def grads_ok(stats):
    return all(c >= DIST_GRAD_COS and abs(r - 1.0) <= DIST_GRAD_NORM_RTOL
               for c, r in stats.values())


def loss_terms_ok(got, want):
    return all(abs(got[k] - want[k]) <= DIST_LOSS_RTOL * abs(want[k]) + 1e-6
               for k in want if k.endswith("loss"))


def clean_card():
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def sharded_train_rank(mesh, path, cfg, ref_file, steps):
    """One rank of a sharded training path: the model on ``mesh`` from
    phase 12's (13) seeded weights, ``steps`` steps of ``TrainStep``
    on the reference batch, the first step's gradients held to the
    one-process step's. Returns the metrics, step seconds, peak GB, Adam's
    moment bytes, the gradient holds and the first step's launches."""
    ref = torch.load(ref_file, map_location="cpu", weights_only=False)
    clean_card()
    t0 = time.perf_counter()
    model = InteractVLM(cfg, device="cuda", mesh=mesh)
    init_params(model, torch.Generator(device="cuda").manual_seed(0))
    cast_frozen_params(model, torch.bfloat16)
    step = TrainStep(model, mesh=mesh)
    batch = to_device(ref["batch"], "cuda")
    init_s = time.perf_counter() - t0
    holds = {}
    metrics, secs = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        if i == 0:
            reset_launches()
        t = time.perf_counter()
        m = step(batch, on_grads=(lambda n, g, _: holds.update(
            grad_holds(n, g, ref["grads"], mesh))) if i == 0 else None)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        if i == 0:
            launches = read_launches()
        metrics.append({k: float(v) for k, v in m.items()})
    res = dict(path=path, rank=mesh.rank, init_s=init_s, step_s=secs,
               metrics=metrics, ref_metrics=ref["metrics"],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               moment_bytes=step.moment_bytes(), grads=holds,
               launches=launches, trainable=sum(p.numel()
                                                for p in step.params))
    del model, step, batch, ref
    clean_card()
    return res


def tp_decode_rank(mesh, path, lcfg, ref_file, kv):
    """One rank of a 1 x 2 tensor-parallel greedy decode: the LLaMA of
    ``lcfg`` from the one-process decode's seeded weights, its prompt, the
    tokens and the launches."""
    ref = torch.load(ref_file, map_location="cpu", weights_only=False)
    clean_card()
    lm = LlamaForCausalLM(lcfg, device="cuda", mesh=mesh)
    init_params(lm, torch.Generator(device="cuda").manual_seed(0))
    lm.requires_grad_(False)
    ids = ref["ids"].cuda()
    Bq, total = ids.shape[0], ref["total"]
    init = QT.init_kv_cache_int8 if kv == "int8" else init_kv_cache
    with torch.inference_mode():
        caches = init(lcfg, Bq, total, "cuda", n_model=mesh.n_model)
        torch.cuda.synchronize()
        reset_launches()
        t = time.perf_counter()
        toks = greedy_decode_lm(lm, ids, caches, total)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
    res = dict(path=path, rank=mesh.rank, tokens=toks, s=secs,
               launches=read_launches(),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del lm, caches
    clean_card()
    return res


def dist_validate_rank(mesh, argv):
    """One rank of the eval CLI under ``--distributed`` (gloo, the card
    shared): its report and launches."""
    reset_launches()
    rep = eval_cli.main(argv)
    return dict(report=rep, launches=read_launches())


def config_13b_f32_tp():
    """The f32 tensor-parallel check's model: LLaMA-13B's width (LoRA 8 on
    q/v) at DIST_F32_LAYERS layers and SAM ViT-H's mask decoder, all f32.
    Flash takes bf16 only, so every attention must stay below its
    thresholds: CLIP is cut to the tiny tower (a 64-token prompt splices
    to 67 tokens, below LLaMA's flash prefill) and SAM's grid to 16 x 16
    (256 image queries, below the decoder's flash at 512). The frozen SAM
    encoder is not run (its kernels take bf16 only): a seeded embedding
    stands in for it on both sides, and one block of it is built."""
    f32 = torch.float32
    llama = llama_13b(dtype=f32, lora_rank=8, lora_alpha=16.0,
                      num_layers=DIST_F32_LAYERS)
    return dataclasses.replace(
        interactvlm_13b(), llama=llama, clip=clip_tiny(dtype=f32),
        sam=sam_vit_h(dtype=f32, img_size=256, encoder_depth=1,
                      encoder_global_attn_indexes=(0,)),
        seg_token_idx=min(llama.vocab_size - 1, 32000),
        img_emb_len=clip_tiny().num_patches - 1)


def f32_reference(out_file):
    """The one-process f32 step's forward and backward on the card:
    seeded weights, a synthetic B = 8 batch of 64-token prompts with
    1024^2 masks and lift maps, a seeded 16 x 16 SAM embedding; its loss
    terms,
    every trainable's gradient, the batch and the embedding, to
    ``out_file``."""
    clean_card()
    cfg = config_13b_f32_tp()
    model = InteractVLM(cfg, device="cuda")
    init_params(model, torch.Generator(device="cuda").manual_seed(0))
    apply_trainable_mask(model)
    g = cfg.sam.image_embedding_size
    emb = torch.randn((B, V, g, g, cfg.sam.prompt_embed_dim),
                      generator=torch.Generator(device="cuda").manual_seed(8),
                      device="cuda")
    model.encode_sam_images = lambda px: emb
    batch = make_synthetic_batch(cfg, B=B, L=L_TEXT, tasks=(2,),
                                 mask_size=MASK, seed=0, device="cuda")
    out = model(batch)
    out["loss"].backward()
    torch.save({"metrics": {k: float(v) for k, v in out.items()
                            if v.dim() == 0},
                "grads": {n: p.grad.detach().cpu()
                          for n, p in model.named_parameters()
                          if p.requires_grad and p.grad is not None},
                "batch": {k: v.cpu() for k, v in batch.items()},
                "emb": emb.cpu()}, out_file)
    del model, out, emb, batch
    clean_card()


def tp_f32_rank(mesh, ref_file):
    """One rank of the 1 x 2 f32 step: the model on ``mesh`` from the
    reference's seeded weights and embedding, one ``TrainStep`` on its
    batch, each trainable's gradient held to the one-process gradient."""
    ref = torch.load(ref_file, map_location="cpu", weights_only=False)
    clean_card()
    model = InteractVLM(config_13b_f32_tp(), device="cuda", mesh=mesh)
    init_params(model, torch.Generator(device="cuda").manual_seed(0))
    emb = ref["emb"].cuda()
    model.encode_sam_images = lambda px: emb
    step = TrainStep(model, mesh=mesh)
    batch = to_device(ref["batch"], "cuda")
    holds = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    m = step(batch, on_grads=lambda n, g, _: holds.update(
        grad_holds(n, g, ref["grads"], mesh)))
    torch.cuda.synchronize()
    res = dict(rank=mesh.rank, step_s=time.perf_counter() - t,
               metrics={k: float(v) for k, v in m.items()},
               ref_metrics=ref["metrics"], grads=holds,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del model, step, batch, emb, ref
    clean_card()
    return res


def dist_ranks(mesh, work):
    """Lines 2 to 5 of phase 17 on each of two gloo ranks sharing card 0
    (the spawned mesh is 1 x 2; the data-parallel path makes a 2 x 1 one
    over the same two ranks)."""
    from interactvlm_tpu_torch.parallel.mesh import create_mesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"tp_train_13b_lora": sharded_train_rank(
        mesh, "tp_train_13b_lora", config_13b_train(),
        os.path.join(work, "ref_train_13b_lora.pt"), DIST_TP_STEPS)}
    dp = create_mesh(2, 1)
    out["dp_train_7b_qlora"] = sharded_train_rank(
        dp, "dp_train_7b_qlora", config_7b_qlora_train(),
        os.path.join(work, "ref_train_7b_qlora.pt"), 1)
    out["tp_decode_13b"] = tp_decode_rank(
        mesh, "tp_decode_13b", config_13b().llama,
        os.path.join(work, "ref_decode_13b.pt"), "dense")
    out["tp_decode_7b_int8"] = tp_decode_rank(
        mesh, "tp_decode_7b_int8", config_7b_int8().llama,
        os.path.join(work, "ref_decode_7b_int8.pt"), "int8")
    out["dist_validate"] = dist_validate_rank(dp, json.load(open(
        os.path.join(work, "eval_argv.json"))))
    out["tp_f32_13b"] = tp_f32_rank(mesh, os.path.join(work,
                                                       "ref_tp_f32.pt"))
    return out


def save_reference(path, model, batch, out_file):
    """The one-process reference of a sharded training path: one forward
    and backward of ``model`` (phase 12's or 13's, before its warm-up) on
    ``batch``: the loss terms and every trainable's gradient, and the batch
    itself, to ``out_file``."""
    out = model(batch)
    out["loss"].backward()
    grads = {n: p.grad.detach().float().cpu()
             for n, p in model.named_parameters()
             if p.requires_grad and p.grad is not None}
    metrics = {k: float(v) for k, v in out.items() if v.dim() == 0}
    del out
    for p in model.parameters():
        p.grad = None
    os.makedirs(os.path.dirname(out_file), exist_ok=True)
    torch.save({"metrics": metrics, "grads": grads,
                "batch": {k: v.cpu() for k, v in batch.items()}}, out_file)
    log(json.dumps({"phase": "sharded_reference", "path": path,
                    "metrics": metrics, "grads": len(grads)}))


def decode_reference(path, lcfg, kv, steps, out_file):
    """The one-process greedy decode of the LLaMA of ``lcfg`` (seeded
    weights), B = 8 seeded 64-token prompts, ``steps`` new tokens: its
    tokens, each step's two largest logits and its seconds, to
    ``out_file``."""
    clean_card()
    lm = LlamaForCausalLM(lcfg, device="cuda")
    init_params(lm, torch.Generator(device="cuda").manual_seed(0))
    lm.requires_grad_(False)
    ids = torch.randint(4, lcfg.vocab_size - 1, (B, L_TEXT),
                        generator=torch.Generator().manual_seed(7))
    total = L_TEXT + steps - 1
    init = QT.init_kv_cache_int8 if kv == "int8" else init_kv_cache
    with torch.inference_mode():
        caches = init(lcfg, B, total, "cuda")
        torch.cuda.synchronize()
        t = time.perf_counter()
        toks, top2 = greedy_decode_lm(lm, ids.cuda(), caches, total,
                                      top2=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.save({"ids": ids, "total": total, "tokens": toks, "top2": top2,
                "s": secs, "peak_gb": peak}, out_file)
    del lm, caches
    clean_card()
    return dict(tokens=toks, top2=top2, s=secs, peak_gb=peak)


def parting(got, want, top2):
    """Where a tensor-parallel decode's tokens part from the one-process
    decode's: (row, step, the one-process top-2 logit gap there, whether
    that gap is a near-tie) of each row's first difference. A near-tie:
    the gap within two bf16 steps (2^-7 relative) of the top logit."""
    out = []
    for r in range(want.shape[0]):
        diff = np.nonzero(got[r] != want[r])[0]
        if len(diff):
            a, b = (float(v) for v in top2[r, diff[0]])
            gap = a - b
            out.append((r, int(diff[0]), gap,
                        gap <= 2 * 2.0 ** -7 * max(abs(a), 1.0)))
    return out


def torchrun_cli(argv, run_dir):
    """The training CLI under ``torchrun --standalone --nproc_per_node 1``
    (NCCL, world size 1): its seconds and its steps' records from the
    run's ``metrics.jsonl`` (every step's loss, data and step seconds)."""
    cmd = ["torchrun", "--standalone", "--nproc_per_node", "1", "-m",
           "interactvlm_tpu_torch.train.train", *argv]
    t0 = time.perf_counter()
    # from the checkout that holds the package
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(train_cli.__file__))))
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                         cwd=root)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        raise SystemExit(f"torchrun training CLI failed ({res.returncode}):"
                         f"\n{res.stdout[-4000:]}\n{res.stderr[-4000:]}")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return secs, [r for r in map(json.loads, f) if "loss" in r]


def budget_gb(b):
    return {k: v / 1e9 for k, v in b.components.items()} | {
        "total": b.total / 1e9}


def distributed_phase():
    """Phase 17 (see the module's docstring): prints one line a path and
    returns the launches of the paths the ranks ran (rank 0's)."""
    from interactvlm_tpu_torch.parallel.launch import spawn
    from interactvlm_tpu_torch.utils import memory as MEM

    import graft_entry_torch

    t_phase = time.perf_counter()
    work = DIST_DIR
    os.makedirs(work, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    lines = {}

    # (1) NCCL at world size 1: the training CLI under torchrun against the
    # one-process CLI, same tree, seed and argv, one loader thread (the
    # draws and templates in one order). Two steps: the card's atomic
    # scatters (the lifts' index_add, the embedding's backward) sum in a
    # varying order, Adam's first update (lr * sign(g)) absorbs that and
    # its second does not, so the third step's loss parts from run to run
    # on the H100; torch's deterministic algorithms hold it at many times
    # the step time
    tree = os.path.join(work, "damon_1024")
    write_damon_tree(tree, SPHERE, MASK, DIST_TREE_IMAGES)
    runs = os.path.join(work, "runs")
    argv = ["--model_scale", "full", "--tokenizer", "whitespace",
            "--dataset", "hcontact", "--dataset_dir", tree,
            "--batch_size", str(B), "--data_workers", "1", "--epochs", "1",
            "--steps_per_epoch", str(DIST_CLI_STEPS), "--no_eval",
            "--save_every", "2", "--log_base_dir", runs, "--no_tensorboard"]
    trainer, one_s, _, one_peak, _ = cli_train(argv + ["--exp_name", "one"])
    one = [dict(loss=h["loss"], step_s=h["batch_s"] - h["data_s"])
           for h in trainer.history]
    del trainer
    clean_card()
    nccl_s, recs = torchrun_cli(argv + ["--exp_name", "nccl"],
                                os.path.join(runs, "nccl"))
    nccl = [dict(loss=r["loss"],
                 step_s=r["train/batch_secs"] - r["train/data_secs"])
            for r in recs]
    held = len(nccl) == len(one) == DIST_CLI_STEPS and all(
        abs(a["loss"] - b["loss"]) <= CLI_LOSS_RTOL * abs(b["loss"])
        for a, b in zip(nccl, one))
    lines["nccl_cli"] = dict(
        phase="dist_nccl_cli", card=smi, launcher="torchrun --standalone "
        "--nproc_per_node 1", backend="nccl", world=1, steps=nccl,
        one_process_steps=one, cli_s=nccl_s, one_process_cli_s=one_s,
        one_process_peak_gb=one_peak, loss_rtol=CLI_LOSS_RTOL, held=held)
    log(json.dumps(lines["nccl_cli"]))
    shutil.rmtree(runs, ignore_errors=True)

    # the decode references and a tiny run for the distributed eval CLI
    ref13 = decode_reference("tp_decode_13b", config_13b().llama, "dense",
                             DIST_DECODE_STEPS,
                             os.path.join(work, "ref_decode_13b.pt"))
    ref8 = decode_reference("tp_decode_7b_int8", config_7b_int8().llama,
                            "int8", DIST_INT8_DECODE_STEPS,
                            os.path.join(work, "ref_decode_7b_int8.pt"))
    tiny = os.path.join(work, "tiny_runs")
    train_cli.main(["--synthetic", "--epochs", "1", "--steps_per_epoch", "2",
                    "--batch_size", "4", "--log_base_dir", tiny,
                    "--exp_name", "t", "--no_eval", "--no_tensorboard"])
    eval_argv = ["--run_dir", os.path.join(tiny, "t"), "--synthetic",
                 "--max_batches", "2", "--batch_size", "4",
                 "--max_new_tokens", "8"]
    one_report = eval_cli.main(eval_argv)
    with open(os.path.join(work, "eval_argv.json"), "w") as f:
        json.dump(eval_argv + ["--distributed"], f)
    t0 = time.perf_counter()
    f32_reference(os.path.join(work, "ref_tp_f32.pt"))
    f32_ref_s = time.perf_counter() - t0
    clean_card()

    # (2)-(5) two gloo ranks sharing the card
    t0 = time.perf_counter()
    ranks = spawn(dist_ranks, 2, n_model=2, backend="gloo", args=(work,),
                  threads=None)
    ranks_s = time.perf_counter() - t0

    checks = {"nccl_cli_losses": held}
    for path, cfg, nd, nm in (
            ("tp_train_13b_lora", config_13b_train(), 1, 2),
            ("dp_train_7b_qlora", config_7b_qlora_train(), 2, 1)):
        rs = [r[path] for r in ranks]
        budget = MEM.training_budget(cfg, B, V, 512, nd, nm)
        one_moments = 2 * 4 * rs[0]["trainable"]
        ok = all(loss_terms_ok(r["metrics"][0], r["ref_metrics"])
                 and grads_ok(r["grads"]) and len(r["grads"]) > 0
                 for r in rs)
        worst = min(((c, rt, n) for r in rs for n, (c, rt) in
                     r["grads"].items()), default=None)
        want = train_launches_expected(cfg)
        line = dict(
            phase=f"dist_{path}", card=smi, backend="gloo, two ranks on "
            "one card (not a multi-card time)", mesh=f"{nd}x{nm}",
            loss_terms=[{k: v for k, v in r["metrics"][0].items()
                         if k.endswith("loss")} for r in rs],
            one_process_loss_terms={k: v for k, v in rs[0][
                "ref_metrics"].items() if k.endswith("loss")},
            grad_norm=[[m["grad_norm"] for m in r["metrics"]] for r in rs],
            worst_grad=worst, grads_held=len(rs[0]["grads"]),
            step_s=[r["step_s"] for r in rs], init_s=[r["init_s"]
                                                      for r in rs],
            peak_gb=[r["peak_gb"] for r in rs],
            budget_gb=budget_gb(budget),
            moment_bytes=[r["moment_bytes"] for r in rs],
            one_rank_moment_bytes=one_moments,
            launches=rs[0]["launches"], held=ok)
        if path.startswith("dp"):
            ok = ok and all(r["moment_bytes"] <= 0.55 * one_moments
                            for r in rs)
        else:
            ok = ok and all(r["launches"][n] == want[n]
                            for r in rs for n in TRAINING_KERNELS)
        line["held"] = ok
        checks[path] = ok
        log(json.dumps(line))
        lines[path] = line

    for path, ref, lcfg, kv in (
            ("tp_decode_13b", ref13, config_13b().llama, "dense"),
            ("tp_decode_7b_int8", ref8, config_7b_int8().llama, "int8")):
        rs = [r[path] for r in ranks]
        parts = [parting(r["tokens"], ref["tokens"], ref["top2"])
                 for r in rs]
        equal = all(not p for p in parts)
        ok = all(np.array_equal(rs[0]["tokens"], r["tokens"]) for r in rs)
        ok = ok and all(tie for p in parts for *_, tie in p)
        budget = MEM.serving_budget(config_13b() if "13b" in path
                                    else config_7b_int8(), B,
                                    ref["tokens"].shape[1] + L_TEXT, V,
                                    L_TEXT, kv, 2)
        llama_gb = (MEM.llama_param_bytes(lcfg, 2) + MEM.kv_cache_bytes(
            lcfg, B, ref["tokens"].shape[1] + L_TEXT, kv, 2)) / 1e9
        launches = rs[0]["launches"]
        if kv == "int8":
            ok = ok and launches["quantize_rows_given"] > 0 \
                and launches["int8_gemm"] > 0 and launches["int8_matmul"] > 0
        line = dict(phase=f"dist_{path}", card=smi, backend="gloo, two "
                    "ranks on one card (not a multi-card time)", mesh="1x2",
                    batch=B, prompt=L_TEXT, new_tokens=ref["tokens"].shape[1],
                    tokens_equal=equal, parting=parts, s=[r["s"] for r in rs],
                    one_process_s=ref["s"], peak_gb=[r["peak_gb"] for r in rs],
                    one_process_peak_gb=ref["peak_gb"],
                    llama_and_cache_budget_gb=llama_gb,
                    serving_budget_gb=budget_gb(budget),
                    launches={n: launches[n] for n in (
                        "int8_matmul", "quantize_rows_given", "int8_gemm",
                        "flash_attention")}, held=ok)
        checks[path] = ok
        log(json.dumps(line))
        lines[path] = line

    # the 1 x 2 step in f32: does the bf16 step's gradient gap (its
    # text_hidden_fcs at cos 0.9977) come from summation order alone?
    rs = [r["tp_f32_13b"] for r in ranks]
    ref_m = rs[0]["ref_metrics"]
    loss_rel = max(abs(r["metrics"][k] - ref_m[k]) / max(abs(ref_m[k]), 1e-12)
                   for r in rs for k in ref_m if k.endswith("loss"))
    worst = min(((c, rt, n) for r in rs for n, (c, rt) in
                 r["grads"].items()), default=None)
    ok = (loss_rel <= DIST_F32_LOSS_RTOL and len(rs[0]["grads"]) > 0
          and all(c >= DIST_F32_GRAD_COS
                  and abs(rt - 1.0) <= DIST_F32_GRAD_NORM_RTOL
                  for r in rs for c, rt in r["grads"].values()))
    checks["tp_f32_13b"] = ok
    lines["tp_f32_13b"] = dict(
        phase="dist_tp_f32_13b", card=smi, backend="gloo, two ranks on one "
        "card (not a multi-card time)", mesh="1x2",
        model=f"LLaMA-13B width, {DIST_F32_LAYERS} layers, LoRA 8, f32; "
        "tiny CLIP; SAM ViT-H's decoder f32 on a seeded 16 x 16 "
        "embedding",
        loss_terms=[{k: v for k, v in r["metrics"].items()
                     if k.endswith("loss")} for r in rs],
        one_process_loss_terms={k: v for k, v in ref_m.items()
                                if k.endswith("loss")},
        loss_max_rel_diff=loss_rel, worst_grad=worst,
        grads_held=len(rs[0]["grads"]),
        grads_by_leaf={n: rs[0]["grads"][n] for n in sorted(rs[0]["grads"])
                       if not n.startswith("llava.lm.model.layers.")},
        step_s=[r["step_s"] for r in rs], reference_s=f32_ref_s,
        peak_gb=[r["peak_gb"] for r in rs],
        tol=[DIST_F32_LOSS_RTOL, DIST_F32_GRAD_COS, DIST_F32_GRAD_NORM_RTOL],
        held=ok)
    log(json.dumps(lines["tp_f32_13b"]))

    reports = [r["dist_validate"]["report"] for r in ranks]
    same = all(_reports_close(rep, one_report) for rep in reports)
    checks["dist_validate"] = same
    lines["dist_validate"] = dict(
        phase="dist_validate", card=smi, backend="gloo, two ranks on one "
        "card", report=reports[0], one_process_report=one_report,
        rtol=REPORT_RTOL, held=same)
    log(json.dumps(lines["dist_validate"]))

    # (6) the multichip dry run on the card
    clean_card()
    t0 = time.perf_counter()
    dry = graft_entry_torch.dryrun_multichip(2)
    ok = len(dry) == 2 and len({r["loss"] for r in dry}) == 1
    checks["dryrun"] = ok
    log(json.dumps({"phase": "dist_dryrun_multichip", "card": smi,
                    "backend": "gloo, two ranks on one card", "n": 2,
                    "results": dry, "s": time.perf_counter() - t0,
                    "held": ok}))

    # (7) every path's budget beside its peak
    log(json.dumps({"phase": "dist_budgets", "card": smi,
                    "capacity_gb": MEM.device_capacity() / 1e9, "paths": {
                        p: {"peak_gb": lines[p].get(
                            "peak_gb", lines[p].get("one_process_peak_gb")),
                            "budget_gb": lines[p].get(
                                "budget_gb", lines[p].get(
                                    "serving_budget_gb"))}
                        for p in ("tp_train_13b_lora", "dp_train_7b_qlora",
                                  "tp_decode_13b", "tp_decode_7b_int8")},
                    "one_process_13b_cli": {
                        "peak_gb": one_peak, "budget_gb": budget_gb(
                            MEM.training_budget(config_13b_train(), B, V,
                                                512))}}))
    log(json.dumps({"phase": "distributed_checks", "checks": checks,
                    "ranks_s": ranks_s,
                    "s": time.perf_counter() - t_phase}))
    shutil.rmtree(work, ignore_errors=True)
    if not all(checks.values()):
        raise SystemExit(f"the distributed phase failed: {checks}")
    return {p: ranks[0][p]["launches"] for p in (
        "tp_train_13b_lora", "dp_train_7b_qlora", "tp_decode_13b",
        "tp_decode_7b_int8", "dist_validate")}


# ------------------------------------------------------------ phase 18
# the LISA workflow: LISA-layout trees written on the host (utils/
# lisa_tree.py, seeded: ade20k photos at 683 x 512 with id maps, refcoco at
# 640 x 480 with polygon, compressed-RLE and G_REFER annotations, ReasonSeg
# polygons at mixed sizes, VQA records), the 13B LoRA training CLI on LISA's
# own mixture (upstream LISA train.py's datasets and sample rates) for
# LISA_STEPS steps with LISA_WORKERS loader threads, validate one batch of
# LISA_B ReasonSeg rows, then the tiny chain card against CPU with three
# conversations a row
LISA_MIXTURE = ["--dataset", "sem_seg_lisa||refer_seg_lisa||vqa||reason_seg",
                "--sample_rates", "9,3,3,1"]
LISA_TREE = dict(n_ade=16, n_refcoco=16, n_reason=8, n_vqa=8)
LISA_B, LISA_STEPS, LISA_WORKERS = 8, 3, 8
TINY_LISA_STEPS, TINY_LISA_CONVERSATIONS = 2, 3
# the tiny chain's holds, card against CPU (SAM in bf16 on the card, f32 on
# the CPU): every step's loss terms relative, the trained models' mask
# logits on one batch absolute. Measured on an H100: 4.5e-4 (the second
# step's mask BCE) and 0.0177 over logits within +-0.17; the limits are
# about 4 and 3 times those
TINY_LISA_LOSS_RTOL, TINY_LISA_LOGIT_TOL = 2e-3, 0.05


def lisa_rows_by_dataset(args, steps):
    """Each step's rows by dataset of the CLI's mixture: the loader's
    ``HybridDataset`` picks every row's dataset from its own seeded
    generator before any dataset draws, so a fresh one over the same
    datasets makes the same picks."""
    from interactvlm_tpu_torch.data.datasets import HybridDataset

    names = args.dataset.split("||")
    rates = [float(r) for r in args.sample_rates.split(",")]
    hybrid = HybridDataset([build_dataset(n, args.dataset_dir, "train", args)
                            for n in names], rates, samples_per_epoch=1)
    index = {id(d): n for d, n in zip(hybrid.datasets, names)}
    return [dict(collections.Counter(index[id(hybrid.pick()[0])]
                                     for _ in range(args.batch_size)))
            for _ in range(steps)]


def lisa_validate(model, tokenizer, args, tree):
    """``validate`` of the trained model on one batch of LISA_B ReasonSeg
    rows of the val split (its records repeated), T new tokens after
    ``let_seg_token_appear``: gIoU and cIoU in the photos' own frames, and
    the launches."""
    ds = ValDataset(build_dataset("reason_seg", tree, "val", args))
    batch, meta = collate([ds[i % len(ds)] for i in range(LISA_B)],
                          tokenizer, max_len=args.model_max_length)
    ids, _ = truncate_at_answer(batch["input_ids"].numpy(),
                                batch["labels"].numpy())
    let_seg_token_appear(model, {"input_ids": ids,
                                 "images_clip": batch["images_clip"]},
                         "cuda", "dense")
    sam = model.config.sam
    n_global = len(sam.encoder_global_attn_indexes)
    want = {"flash_attention": model.config.llama.num_layers
            + sam.decoder_depth,
            "fwd_routes": {"sm90": model.config.llama.num_layers,
                           "sm90_d16": sam.decoder_depth, "mma": 0},
            "window_attention": sam.encoder_depth - n_global,
            "rel_attention": n_global}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    results, _ = validate(iter([(batch, meta)]), model, "reason_seg", MASK,
                          max_new_tokens=T, max_batches=1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    res = {"phase": "lisa_validate", "images": LISA_B, "s": secs,
           "images_per_s": LISA_B / secs, "results": results,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": {n: launches[n] for n in want},
           "launches_expected": want}
    log(json.dumps(res))
    if not (np.isfinite(results["giou"]) and np.isfinite(results["ciou"])
            and results["seg_rate"] > 0
            and all(launches[n] == c for n, c in want.items())):
        raise SystemExit(f"the LISA validation failed: {res}")
    return launches


def tiny_lisa_card_and_cpu(work):
    """The tiny chain: a LISA tree at 1/16 of the photo sizes, the tiny
    training CLI on the mixture with TINY_LISA_CONVERSATIONS conversations
    a row for TINY_LISA_STEPS steps on the card and on the CPU (one loader
    thread, so both see the same batches), every step's loss terms held
    within TINY_LISA_LOSS_RTOL; then both trained models' mask logits on
    the CLI's first batch within TINY_LISA_LOGIT_TOL."""
    t0 = time.perf_counter()
    tree = os.path.join(work, "tree")
    write_lisa_tree(tree, n_ade=4, n_refcoco=4, n_reason=4, n_vqa=2,
                    scale=1 / 16)
    argv = ["--tokenizer", "whitespace", "--model_scale", "tiny",
            *LISA_MIXTURE, "--dataset_dir", tree,
            "--image_size", str(TINY_SIZE), "--clip_size", "28",
            "--model_max_length", "384", "--epochs", "1",
            "--steps_per_epoch", str(TINY_LISA_STEPS), "--batch_size", "4",
            "--num_conversations", str(TINY_LISA_CONVERSATIONS),
            "--lr", "1e-3", "--warmup_steps", "2", "--no_eval",
            "--log_base_dir", os.path.join(work, "runs"),
            "--data_workers", "1", "--no_tensorboard"]
    steps, masks, batch = {}, {}, None
    for side, dev in SIDES.items():
        trainer = train_cli.main(argv + ["--exp_name", side, "--device",
                                         dev])
        steps[side] = [{"loss": h["loss"], **h["loss_terms"],
                        "rows": h["rows_by_task"]} for h in trainer.history]
        if batch is None:
            args = train_cli.parse_args(argv)
            loader = train_cli.real_batch_iter(args, trainer.cfg,
                                               trainer.tokenizer)
            batch = next(loader)
            loader.close()
        with torch.inference_mode():
            out = trainer.model.forward_train(to_device(batch, dev))
        masks[side] = out["pred_masks"].float().cpu()
        del trainer, out
    rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6)
              for a, b in zip(steps["card"], steps["cpu"]) for k in b
              if k != "rows")
    mask_diff = (masks["card"] - masks["cpu"]).abs().max().item()
    res = {"phase": "lisa_tiny_chain", "s": time.perf_counter() - t0,
           "conversations": TINY_LISA_CONVERSATIONS, "steps": steps,
           "rows": int(batch["input_ids"].shape[0]),
           "loss_max_rel_diff": rel, "loss_tol": TINY_LISA_LOSS_RTOL,
           "mask_logit_max_diff": mask_diff,
           "mask_logit_range": [masks["cpu"].min().item(),
                                masks["cpu"].max().item()],
           "mask_tol": TINY_LISA_LOGIT_TOL}
    log(json.dumps(res))
    if not (all(len(s) == TINY_LISA_STEPS for s in steps.values())
            and [s["rows"] for s in steps["card"]]
            == [s["rows"] for s in steps["cpu"]]
            and res["rows"] == 4 * TINY_LISA_CONVERSATIONS
            and rel <= TINY_LISA_LOSS_RTOL
            and mask_diff <= TINY_LISA_LOGIT_TOL):
        raise SystemExit(f"the tiny LISA chain failed: {res}")


def lisa_workflow_phase():
    """Phase 18: LISA's own mixture through the port's entry points: (1)
    the LISA trees written on the host (LISA_TREE); (2) the training CLI at
    the JAX trainer's 13B LoRA defaults on ``sem_seg_lisa||refer_seg_lisa
    ||vqa||reason_seg`` at 9,3,3,1, B = LISA_B, LISA_WORKERS loader
    threads, LISA_STEPS steps: each step's wall and data seconds, the
    loader-wait share, its rows by task and by dataset, the loss terms,
    kernels 1-5's launches and the peak GB, the step against phase 14's
    DAMON CLI step in this run; (3) ``validate`` of one batch of ReasonSeg
    rows; (4) the tiny chain card against CPU. Returns the CLI's
    launches."""
    t_phase = time.perf_counter()
    work = os.path.join(WORKDIR, "lisa")
    shutil.rmtree(work, ignore_errors=True)
    tree = os.path.join(work, "tree")
    t0 = time.perf_counter()
    counts = write_lisa_tree(tree, **LISA_TREE)
    log(json.dumps({"phase": "lisa_trees", "records": counts,
                    "s": time.perf_counter() - t0,
                    "bytes": sum(os.path.getsize(os.path.join(d, f))
                                 for d, _, fs in os.walk(tree) for f in fs)}))

    runs = os.path.join(work, "runs")
    argv = ["--exp_name", "lisa-13b", *LISA_MIXTURE, "--model_scale", "full",
            "--tokenizer", "whitespace", "--dataset_dir", tree,
            "--data_workers", str(LISA_WORKERS), "--epochs", "1",
            "--steps_per_epoch", str(LISA_STEPS),
            "--batch_size", str(LISA_B), "--no_eval", "--save_every", "2",
            "--log_base_dir", runs, "--no_tensorboard"]
    trainer, cli_s, launches, peak_gb, loads = cli_train(argv)
    hist = trainer.history
    args = train_cli.parse_args(argv)
    by_dataset = lisa_rows_by_dataset(args, LISA_STEPS)
    want = train_launches_expected(trainer.cfg, LISA_STEPS)
    steady = cli_step_ms(trainer)
    damon = STEP_MS.get("damon_cli")
    res = {"phase": "lisa_train", "argv": argv, "cli_s": cli_s,
           "first_batch_s": trainer.first_batch_s,
           "steps": [{"wall_s": h["batch_s"], "data_s": h["data_s"],
                      "step_s": h["batch_s"] - h["data_s"],
                      "loader_wait_share": h["loader_wait_share"],
                      "rows_by_task": h["rows_by_task"],
                      "rows_by_dataset": rows, "loss": h["loss"],
                      "loss_terms": h["loss_terms"]}
                     for h, rows in zip(hist, by_dataset)],
           "step_ms_after_first": spread(steady),
           "damon_cli_step_ms": damon,
           "over_damon_cli": (float(np.median(steady)) / damon
                              if damon else None),
           "peak_gb": peak_gb,
           "launches_per_step": {n: launches[n] / LISA_STEPS for n in
                                 TRAINING_KERNELS + ("window_attention",
                                                     "rel_attention")},
           "image_loads": loads, "decoder": native_image.decoder()}
    log(json.dumps(res))
    checks = {
        "steps": trainer.step.step == LISA_STEPS and len(hist) == LISA_STEPS,
        "losses_finite": all(np.isfinite(h["loss"]) and all(
            np.isfinite(v) for v in h["loss_terms"].values()) for h in hist),
        "none_skipped": all(h["skipped_nonfinite"] == 0.0 for h in hist),
        "launches_as_expected": launches == want,
        "rows_per_batch": all(sum(h["rows_by_task"].values()) == LISA_B
                              and sum(r.values()) == LISA_B
                              for h, r in zip(hist, by_dataset)),
        "seg_rows": any(r.get("sem_seg_lisa", 0) + r.get("refer_seg_lisa", 0)
                        + r.get("reason_seg", 0) for r in by_dataset),
    }
    log(json.dumps({"phase": "lisa_train_checks", **checks,
                    "expected": want, "launches": launches}))
    if not all(checks.values()):
        raise SystemExit(f"the LISA training CLI failed: {checks}")

    model, tokenizer = trainer.model, trainer.tokenizer
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    model.requires_grad_(False)
    with torch.inference_mode():
        lisa_validate(model, tokenizer, args, tree)
    del model, tokenizer
    gc.collect()
    torch.cuda.empty_cache()

    tiny_lisa_card_and_cpu(os.path.join(work, "tiny"))
    shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(json.dumps({"phase": "lisa_workflow",
                    "s": time.perf_counter() - t_phase}))
    return launches


# ------------------------------------------------------------ phase 19
# the entry probes' twins at full width, iterations cut to fit the script's
# time: each variant once after its warm-up (the train-step probe: four
# windows of two steps, the first discarded), the data probe over 8 photos and one batch a count
PROBE_ITERS = {"sam": 1, "int8": 2, "int4": 1, "decode": 2, "lift": 2}
PROBE_TRAIN_ENV = {"PROBE_STEPS": "2", "PROBE_REPEATS": "3",
                   "PROBE_LEGS": "1", "PROBE_LEG_STEPS": "1"}
PROBE_DATA = dict(n_images=8, n_batches=1)
PROBE_DATA_WORKERS = ["1", "8"]
# the lift probe's two gather forms of one function, on the card
PROBE_LIFT_TOL = 1e-5


def sam_probe_launches(cfg):
    """Each SAM probe variant's launches in one encode at ``cfg``'s
    depth: the window and global kernels, or kernel 1 at the global
    blocks without the bias, and the int8 linears' two-pass route."""
    n_global = len(cfg.encoder_global_attn_indexes)
    n_win = cfg.encoder_depth - n_global
    int8 = 4 * cfg.encoder_depth  # qkv, proj, lin1, lin2 a block
    attn = {"window_attention": n_win, "rel_attention": n_global}
    two_pass = {"int8_matmul": int8, "int8_two_pass": int8,
                "quantize_rows": int8, "int8_gemm": int8}
    return {"full": attn, "gelutanh": attn,
            "norel": {"flash_attention": n_global},
            "int8": {**attn, **two_pass}, "int8erf": {**attn, **two_pass},
            "noattn": {}, "noattn8": two_pass}


def train_probe_launches_expected(cfg, env):
    """The train-step probe's launches under ``env`` (PROBE_TRAIN_ENV): its
    first step and its windows of steps (``train_launches_expected``) and,
    with PROBE_LEGS, each leg's calls (its warm-up, then 3 windows of
    PROBE_LEG_STEPS): the SAM encode alone, and the loss forward, which
    encodes too and runs each LLaMA layer's and the SAM decoder's flash
    forward once (no backward, no remat)."""
    steps = 1 + (int(env["PROBE_REPEATS"]) + 1) * int(env["PROBE_STEPS"])
    want = train_launches_expected(cfg, steps)
    if env.get("PROBE_LEGS") != "1":
        return want
    calls = 1 + 3 * int(env["PROBE_LEG_STEPS"])
    n_global = len(cfg.sam.encoder_global_attn_indexes)
    n_win = cfg.sam.encoder_depth - n_global
    for k, n in (("window_attention", n_win), ("rel_attention", n_global)):
        route = k.split("_")[0] + "_routes"
        want[k] += 2 * calls * n
        want[route]["sm90"] += 2 * calls * n
    want["flash_attention"] += calls * (cfg.llama.num_layers
                                        + cfg.sam.decoder_depth)
    want["fwd_routes"]["sm90"] += calls * cfg.llama.num_layers
    want["fwd_routes"]["sm90_d16"] += calls * cfg.sam.decoder_depth
    return want


def launches_between(before, after):
    """``read_launches`` dicts: the launches made from one to the other."""
    return {k: ({r: n - before[k][r] for r, n in v.items()}
                if isinstance(v, dict) else v - before[k])
            for k, v in after.items()}


def entry_probes_phase():
    """Phase 19: every entry probe twin through its ``main`` on the card
    at full width (PROBE_ITERS), every variant's line printed; the launch
    counts of each variant held (the SAM probe's by variant, the int8
    matmuls by route) and the lift probe's two gather forms held to each
    other. Returns the launches of the whole phase."""
    t_phase = time.perf_counter()
    checks, out = {}, {}
    reset_launches()
    t0 = time.perf_counter()
    out["sam"] = sam_probe.main(list(sam_probe.VARIANTS),
                                iters=PROBE_ITERS["sam"])
    want = sam_probe_launches(sam_vit_h())
    checks["sam"] = all(out["sam"][v]["launches"] == want[v] for v in want)
    log(json.dumps({"phase": "probe_sam", "s": time.perf_counter() - t0,
                    "variants": out["sam"], "launches_expected": want,
                    "held": checks["sam"]}))

    t0 = time.perf_counter()
    out["int8"] = int8_probe.main(iters=PROBE_ITERS["int8"])
    two_pass = {"int8_matmul": 1, "int8_two_pass": 1, "quantize_rows": 1,
                "int8_gemm": 1}
    checks["int8"] = all(r[v]["launches"] == two_pass
                         for r in out["int8"].values()
                         for v in ("pallas", "pallas_gelu"))
    log(json.dumps({"phase": "probe_int8", "s": time.perf_counter() - t0,
                    "shapes": out["int8"], "held": checks["int8"]}))

    t0 = time.perf_counter()
    out["int4"] = int4_probe.main(list(int4_probe.VARIANTS),
                                  iters=PROBE_ITERS["int4"])
    lc = llama_7b()
    one = 7 * lc.num_layers
    l4 = out["int4"]["launches"]
    checks["int4"] = (l4["int8"] == {"int8_matmul": one,
                                     "int8_one_launch": one}
                      and all(l4[v] == {"int4_matmul": one,
                                        "int4_one_launch": one}
                              for v in ("int4_native", "int4_packed"))
                      and l4["int4_grouped"]["quantize_rows"] == one
                      and l4["int4_grouped_batched"]["int8_matmul_prequant"]
                      == one)
    log(json.dumps({"phase": "probe_int4", "s": time.perf_counter() - t0,
                    **out["int4"], "held": checks["int4"]}))

    t0 = time.perf_counter()
    out["decode"] = decode_probe.main(list(decode_probe.VARIANTS),
                                      iters=PROBE_ITERS["decode"])
    ld = one + 1  # the lm_head too
    checks["decode"] = all(
        out["decode"][v]["launches"] == {"int8_matmul": ld,
                                         "int8_one_launch": ld}
        for v in ("matmul_floor", "step_full"))
    log(json.dumps({"phase": "probe_decode", "s": time.perf_counter() - t0,
                    "variants": out["decode"], "held": checks["decode"]}))

    t0 = time.perf_counter()
    out["lift"] = lift_probe.main(iters=PROBE_ITERS["lift"])
    checks["lift"] = out["lift"]["lowres_vs_resize_gather"] <= PROBE_LIFT_TOL
    log(json.dumps({"phase": "probe_lift", "s": time.perf_counter() - t0,
                    **out["lift"], "tol": PROBE_LIFT_TOL,
                    "held": checks["lift"]}))

    t0 = time.perf_counter()
    root = os.path.join(WORKDIR, "data_probe")
    shutil.rmtree(root, ignore_errors=True)
    out["data"] = data_probe.main(PROBE_DATA_WORKERS, root=root,
                                  **PROBE_DATA)
    shutil.rmtree(root, ignore_errors=True)
    checks["data"] = all(out["data"][int(w)]["s_per_batch"] > 0
                         for w in PROBE_DATA_WORKERS)
    log(json.dumps({"phase": "probe_data", "s": time.perf_counter() - t0,
                    **{str(k): v for k, v in out["data"].items()},
                    "held": checks["data"]}))

    t0 = time.perf_counter()
    before = {k: os.environ.get(k) for k in PROBE_TRAIN_ENV}
    os.environ.update(PROBE_TRAIN_ENV)
    counts = read_launches()
    try:
        out["train_step"] = train_step_probe.main()
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    got = launches_between(counts, read_launches())
    want = train_probe_launches_expected(
        train_step_probe.build_config("7b", False, False, 4, True),
        PROBE_TRAIN_ENV)
    checks["train_step"] = got == want
    log(json.dumps({"phase": "probe_train_step",
                    "s": time.perf_counter() - t0, **out["train_step"],
                    "launches": got, "launches_expected": want,
                    "held": checks["train_step"]}))
    launches = read_launches()
    gc.collect()
    torch.cuda.empty_cache()
    log(json.dumps({"phase": "entry_probes", "checks": checks,
                    "launches": launches,
                    "s": time.perf_counter() - t_phase}))
    if not all(checks.values()):
        raise SystemExit(f"the entry probes failed: {checks}")
    return launches


# ------------------------------------------------------------ phase 20
# the bench.py twin at its card defaults, its windows cut to fit the script
BENCH_TWIN_ENV = {"BENCH_ITERS": "2", "BENCH_REPEATS": "1"}
BENCH_TWIN_TIMEOUT_S = 300
# bench.py's record at its chip defaults, streaming and cached
# (bench.py:660-709), and its metric string for them
BENCH_TWIN_KEYS = {
    "metric", "unit", "kv_cache", "flops_per_image", "uncached_value",
    "uncached_spread", "uncached_vs_baseline", "uncached_mfu", "value",
    "value_spread", "vs_baseline", "vs_baseline_range", "mfu",
    "flops_per_image_cached", "cache_batch"}
BENCH_TWIN_METRIC = ("e2e_evaluate_images_per_sec_llama7b-int8_vit_h-int8_"
                     "4view_b8_t32_cachedviews_b32")
BENCH_TWIN_PEAK = 989e12  # the H100's dense bf16 FLOP/s, the twin's MFU


def per_iteration(counts):
    """A ``read_launches`` difference in ``probes/common.py:
    launches_since``'s form: the kernels that launched, and the int8 and
    int4 matmuls' calls by route as ``int8_<route>`` / ``int4_<route>``."""
    out = {n: counts[n] for n in WRAPPERS if counts[n]}
    for kind in ("int8", "int4"):
        out.update({f"{kind}_{r}": n
                    for r, n in counts[kind + "_routes"].items() if n})
    return out


def gather_against_scatter():
    """On the twin's maps (``bench.py``'s 4722-vertex sphere under the
    first V ``4MV-Z_Vitru_mv2`` cameras at MASK^2, rasterized on the card):
    the gather lift (K = 256 pixels a vertex and view) against the exact
    scatter lift that ``evaluate_batch`` uses, on one batch of seeded
    low-res logits (B x V x 256^2, scale 4, as the lift probe's) resized
    bilinearly; and the vertices with more than K candidate pixels in a
    view (a pixel is a candidate of its triangle's three vertices)."""
    dev = torch.device("cuda")
    K = bench_torch.MAX_K
    p2v, bary, gidx, gw, n = lift_probe.lift_maps(
        MASK, dev, mesh=bench_torch.sphere(), max_k=K, views=V)
    over = torch.zeros((V, n), dtype=torch.bool, device=dev)
    most = []
    for v in range(V):
        ids = p2v[:, v].reshape(3, -1)
        ids = ids[:, (ids >= 0).all(0)].reshape(-1).long()
        cand = torch.bincount(ids, minlength=n)
        over[v] = cand > K
        most.append(int(cand.max()))
    gen = torch.Generator(device=dev).manual_seed(0)
    low = torch.randn(B, V, MASK // 4, MASK // 4, generator=gen,
                      device=dev) * 4
    full = F.interpolate(low, size=(MASK, MASK), mode="bilinear",
                         align_corners=False)
    gather = torch.stack([lift_multiview_soft_gather(m, gidx, gw)
                          for m in full])
    diff = (gather - lift_batch_soft(full, p2v, bary, n)).abs()
    capped = over.any(0)
    return {"vertices": n, "max_k": K,
            "max_abs_diff": float(diff.max()),
            "max_abs_diff_within_k": (float(diff[:, ~capped].max())
                                      if bool((~capped).any()) else None),
            "vertices_over_k": int(capped.sum()),
            "vertices_over_k_by_view": over.sum(1).tolist(),
            "most_candidates_by_view": most}


def bench_twin_phase(serving_by_mode):
    """Phase 20: ``python3 bench_torch.py`` in a subprocess at its card
    defaults with BENCH_TWIN_ENV. Holds its exit code, its record's keys
    and metric string (``bench.py``'s for these knobs), finite positive
    values, its MFU in (0, 1) against 989 TFLOP/s, and its launches of one
    streaming and one cached iteration equal to the ``7b_int8`` path's of
    one batch a mode (``serving_by_mode``) in this run. Reports, and
    holds neither, the gather lift against the scatter lift on the twin's
    maps (``gather_against_scatter``). Returns the launches of one
    streaming and one cached iteration."""
    t_phase = time.perf_counter()
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(BENCH_TWIN_ENV)
    res = subprocess.run(
        [sys.executable, "bench_torch.py"], env=env, capture_output=True,
        text=True, timeout=BENCH_TWIN_TIMEOUT_S,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    twin_s = time.perf_counter() - t_phase
    err = res.stderr.splitlines()
    try:
        record = json.loads(res.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        record = {}
    launches = {}
    for mode in ("streaming", "cached"):
        head = "[bench] " + bench_torch.LAUNCH_LINE.format(mode)
        got = [json.loads(ln[len(head):]) for ln in err
               if ln.startswith(head)]
        launches[mode] = got[0] if len(got) == 1 else None
    want = {mode: per_iteration(c) for mode, c in serving_by_mode.items()}

    def mfu_of(value, flops):
        return record[value] * record[flops] / BENCH_TWIN_PEAK

    has = set(record) == BENCH_TWIN_KEYS
    checks = {
        "exit_0": res.returncode == 0,
        "record_keys": has,
        "metric": record.get("metric") == BENCH_TWIN_METRIC,
        "values_finite_positive": has and all(
            math.isfinite(record[k]) and record[k] > 0
            for k in ("value", "uncached_value")),
        "mfu_in_0_1": has and all(0 < record[k] < 1
                                  for k in ("mfu", "uncached_mfu")),
        "mfu_against_989": has and abs(
            record["mfu"] - mfu_of("value", "flops_per_image_cached")
        ) <= 1e-4 and abs(record["uncached_mfu"] - mfu_of(
            "uncached_value", "flops_per_image")) <= 1e-4,
        "launches_as_7b_int8": launches == want,
    }
    lift = gather_against_scatter()
    log(json.dumps({
        "phase": "bench_twin", "argv": ["python3", "bench_torch.py"],
        "env": BENCH_TWIN_ENV, "twin_s": twin_s, "returncode":
        res.returncode, "record": record, "bench_log": [
            ln for ln in err if ln.startswith("[bench]")],
        "launches_per_iteration": launches,
        "launches_expected_7b_int8_per_batch": want,
        "gather_vs_scatter": lift, "checks": checks,
        "s": time.perf_counter() - t_phase}))
    if not all(checks.values()):
        log(res.stderr[-4000:])
        raise SystemExit(f"the bench twin failed: {checks}")
    gc.collect()
    torch.cuda.empty_cache()
    return {n: launches["streaming"].get(n, 0)
            + launches["cached"].get(n, 0) for n in WRAPPERS}


def _reports_close(got, want):
    """Two eval reports equal in structure, their numbers within
    REPORT_RTOL relative."""
    if isinstance(want, dict):
        return isinstance(got, dict) and set(got) == set(want) and all(
            _reports_close(got[k], want[k]) for k in want)
    if isinstance(want, (list, tuple)):
        return len(got) == len(want) and all(
            _reports_close(a, b) for a, b in zip(got, want))
    if isinstance(want, (int, float)):
        return abs(got - want) <= REPORT_RTOL * abs(want) + 1e-12
    return got == want


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    name = torch.cuda.get_device_name(0)
    log(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else
        f"nvidia-smi: {smi.stderr.strip()}")
    log(json.dumps({"phase": "device", "name": name,
                    "count": torch.cuda.device_count(),
                    "torch": torch.__version__, "cuda": torch.version.cuda}))

    t0 = time.perf_counter()
    reports = _cuda.build()
    regs = {n: [ln.split(":", 1)[1].strip() for ln in r.splitlines()
                if "registers" in ln] for n, r in reports.items()}
    log(json.dumps({"phase": "build", "s": time.perf_counter() - t0,
                    "ptxas": regs}))

    t_start = time.perf_counter()
    cases = kernel_phase(name)
    for kname, rows in probe_kernel_phase(name).items():
        cases.setdefault(kname, []).extend(rows)
    log(json.dumps({"phase": "kernels_done",
                    "s": time.perf_counter() - t_start}))
    launches = {"probes": probes_phase()}
    log(json.dumps({"phase": "probes_done",
                    "s": time.perf_counter() - t_start}))
    lift = real_lift_maps()
    hoi_human = real_lift_maps(view_set=HOI_HUMAN_VIEWS, gather=False)[0]
    hoi_object = real_lift_maps(OBJ_SPHERE, HOI_OBJECT_VIEWS, gather=False,
                                n_expected=N_OBJ)[0]
    paths = {"13b_bf16": (config_13b(), "dense", B),
             "7b_int8": (config_7b_int8(), "int8", B_CACHED_INT8),
             "7b_int4": (config_7b_int4(), "int8", B_CACHED_INT8)}
    by_mode = {}
    with torch.inference_mode():
        for weights in ("dense", "int8", "int4"):
            reference_phase(weights)
        hoi_reference_phase()
        for path, (cfg, kv, b_cached) in paths.items():
            launches[path], by_mode[path] = serving_path_phase(
                path, cfg, kv, b_cached, lift)
            log(json.dumps({"phase": f"{path}_done",
                            "s": time.perf_counter() - t_start}))
        launches["13b_hoi"] = hoi_path_phase("13b_hoi", config_13b_hoi(),
                                             hoi_human, hoi_object)
        log(json.dumps({"phase": "13b_hoi_done",
                        "s": time.perf_counter() - t_start}))
        del hoi_human, hoi_object
    # the int4 path's int8 and int4 calls together take, route by route,
    # the int8 path's int8 calls' routes
    routes = {p: {r: launches[p]["int8_routes"][r]
                  + launches[p]["int4_routes"][r]
                  for r in ("one_launch", "two_pass")}
              for p in ("7b_int8", "7b_int4")}
    log(json.dumps({"phase": "int4_routes_as_int8", **routes,
                    "by_kernel": {p: {k: launches[p][k] for k in
                                      ("int8_routes", "int4_routes")}
                                  for p in routes}}))
    if (routes["7b_int4"] != routes["7b_int8"]
            or any(launches["7b_int8"]["int4_routes"].values())):
        raise SystemExit(f"the int4 path's routes differ: {routes}")
    for kind in ("lora", "qlora", "hoi"):
        train_reference_phase(kind)
    step_ms = {}
    for path, cfg in (("train_13b_lora", config_13b_train()),
                      ("train_7b_qlora", config_7b_qlora_train())):
        launches[path], step_ms[path] = training_path_phase(
            path, cfg, lift[0], os.path.join(DIST_DIR, f"ref_{path}.pt"))
        log(json.dumps({"phase": f"{path}_done",
                        "s": time.perf_counter() - t_start}))
    del lift
    launches["damon_train"], launches["damon_validate"] = \
        damon_workflow_phase(step_ms["train_13b_lora"])
    log(json.dumps({"phase": "damon_workflow_done",
                    "s": time.perf_counter() - t_start}))
    launches["demo"], launches["fit"] = demo_fit_phase()
    log(json.dumps({"phase": "demo_fit_done",
                    "s": time.perf_counter() - t_start}))
    launches["flagship_train"], launches["flagship_validate"] = \
        flagship_workflow_phase()
    log(json.dumps({"phase": "flagship_workflow_done",
                    "s": time.perf_counter() - t_start}))
    launches.update(distributed_phase())
    log(json.dumps({"phase": "distributed_done",
                    "s": time.perf_counter() - t_start}))
    launches["lisa_train"] = lisa_workflow_phase()
    log(json.dumps({"phase": "lisa_workflow_done",
                    "s": time.perf_counter() - t_start}))
    launches["entry_probes"] = entry_probes_phase()
    log(json.dumps({"phase": "entry_probes_done",
                    "s": time.perf_counter() - t_start}))
    launches["bench_twin"] = bench_twin_phase(by_mode["7b_int8"])
    log(json.dumps({"phase": "bench_twin_done",
                    "s": time.perf_counter() - t_start}))

    rows = []
    for kname, meta in KERNELS.items():
        first = cases[kname][0]
        worst = max(cases[kname], key=lambda c: c["err_over_limit"])
        path = meta["path"]
        rows.append({
            "name": kname, "route": "cuda", "source": meta["sources"][0],
            "sources": meta["sources"], "symbols": meta["symbols"],
            "replaces": meta["replaces"], "launches_path": path,
            "launches": launches[path][kname],
            "launches_by_path": {p: c[kname] for p, c in launches.items()},
            # the int8 matmul counts calls; a two-pass call launches
            # quantize_rows and the GEMM, a one-launch call its own kernel
            **({"launches_by_route": launches[path]["int8_routes"],
                "int8_gemm_launches_by_path": {p: c["int8_gemm"]
                                               for p, c in launches.items()}}
               if kname == "int8_matmul" else {}),
            # a two-pass int4 call launches kernel 7 and the int4 GEMM
            **({"launches_by_route": launches[path]["int4_routes"],
                "int4_gemm_launches_by_path": {p: c["int4_gemm"]
                                               for p, c in launches.items()}}
               if kname == "int4_matmul" else {}),
            **({"launches_by_route": launches[path]["rel_routes"]}
               if kname == "rel_attention" else {}),
            **({"launches_by_route": launches[path]["fwd_routes"]}
               if kname == "flash_attention" else {}),
            **({"launches_by_route": launches[path]["window_routes"]}
               if kname == "window_attention" else {}),
            **({"launches_by_route": launches[path][
                "bwd_" + kname.rsplit("_", 1)[1] + "_routes"]}
               if kname.startswith("flash_attention_bwd") else {}),
            "max_abs_err": worst["max_abs_err"],
            "err_over_limit": worst["err_over_limit"], "tol": worst["tol"],
            "ms": first["kernel_ms"],
            **{k: first[k] for k in ("plain_ms", "bound_ms", "bound_by",
                                      "library_ms")},
            "cases": cases[kname],
        })
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
