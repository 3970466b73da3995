"""Analytic device-memory budgets of serving and training.

Port of ``interactvlm_tpu/utils/memory.py``: the bytes of LLaMA's weights
(whole or split over ``tp`` model ranks), the KV cache, SAM's and CLIP's
weights, the activation estimates, ``serving_budget``,
``cached_serving_budget``, ``trainable_param_count`` and
``training_budget(n_data, n_model)``, the same formulas on the port's
configs, so they give the JAX functions' bytes. Their coefficients
(activation layout factors) were calibrated by the JAX package against its
own compiled programs; the card's measured peaks stand beside them in
``PERF.md``. Capacity is the card's (``device_capacity``). The JAX module's
``tp2_throughput_estimates`` is built from TPU measurements and has no
counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

# the H100 80GB HBM3's memory as nvidia-smi reports it (81559 MiB): the
# capacity where no card is present to ask
H100_80GB_BYTES = 81559 * 1024 ** 2


def device_capacity(device=None) -> int:
    """The card's memory in bytes (``total_memory``), or
    ``H100_80GB_BYTES`` where no card is present."""
    if torch.cuda.is_available():
        dev = torch.device("cuda") if device is None else torch.device(device)
        if dev.type == "cuda":
            return torch.cuda.get_device_properties(dev).total_memory
    return H100_80GB_BYTES


def _dtype_bytes(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def llama_param_bytes(cfg, tp: int = 1) -> int:
    """Weight bytes of the LLaMA stack (embed + layers + lm_head).

    int8 configs store matmul kernels in 1 byte + f32 per-out-channel
    scales; the embedding table stays in the compute dtype. TP divides
    every matmul kernel and the KV/MLP dims across ``tp`` chips.
    """
    h, d = cfg.hidden_size, cfg.head_dim
    attn_params = h * d * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
    mlp_params = 3 * h * cfg.intermediate_size
    matmul = cfg.num_layers * (attn_params + mlp_params)
    # QLoRA training (lora_rank>0) keeps the TRAINABLE lm_head + LoRA
    # adapters in flax's f32 param_dtype (Adam accumulates there); pure
    # int8 serving keeps the head int8 and everything else is cast to the
    # compute dtype (utils/weights.cast_serving_params).
    trainable_db = 4 if cfg.lora_rank > 0 else _dtype_bytes(cfg.dtype)
    head = h * cfg.vocab_size
    extra = 0
    if cfg.lora_rank > 0:
        extra += cfg.num_layers * 2 * cfg.lora_rank * (
            h + max(cfg.num_heads, cfg.num_kv_heads) * d
        ) * trainable_db
        head_bytes = head * trainable_db
    else:
        matmul += head
        head_bytes = 0
    # per-output-channel f32 scales for the int8 layout
    scale_out = cfg.num_layers * (
        d * (cfg.num_heads + 2 * cfg.num_kv_heads) + h
        + 2 * cfg.intermediate_size + h
    ) + (cfg.vocab_size if cfg.lora_rank == 0 else 0)
    int4 = bool(getattr(cfg, "weights_int4", False))
    if int4 and cfg.lora_rank == 0:
        # packed split-half nibbles: 0.5 byte/param + f32 per-column
        # scales + f32 per-input-row group factors (ops/quant.py)
        rf_rows = cfg.num_layers * (
            5 * h + cfg.num_heads * d + cfg.intermediate_size
        ) + h  # lm_head rf
        kernel_bytes = matmul // 2 + scale_out * 4 + rf_rows * 4
    elif cfg.weights_int8:
        kernel_bytes = matmul * 1 + scale_out * 4
    else:
        kernel_bytes = matmul * _dtype_bytes(cfg.dtype)
    embed = cfg.vocab_size * h * trainable_db
    norms = (2 * cfg.num_layers + 1) * h * 4  # RMSNorm gains kept f32-ish
    return (kernel_bytes + head_bytes + norms + extra) // tp + embed


def kv_cache_bytes(cfg, batch: int, max_len: int, kind: str = "int8",
                   tp: int = 1) -> int:
    """Decode KV cache (ops/quant.init_kv_cache_int8 layout)."""
    per_pos = cfg.num_kv_heads * cfg.head_dim
    n = cfg.num_layers * batch * max_len
    if kind == "int8":
        data = n * per_pos * 2 * 1
        scales = n * cfg.num_kv_heads * 2 * 4
        valid = cfg.num_layers * batch * max_len
        return (data + scales + valid) // tp
    return n * per_pos * 2 * _dtype_bytes(cfg.dtype) // tp


def sam_param_bytes(cfg) -> int:
    """SAM ViT encoder + prompt encoder + mask decoder weights."""
    e = cfg.encoder_embed_dim
    per_block = 4 * e * e + 2 * e * int(e * cfg.mlp_ratio)
    matmul = cfg.encoder_depth * per_block
    if cfg.weights_int8:
        kernel = matmul * 1 + cfg.encoder_depth * (
            (3 * e + e + int(e * cfg.mlp_ratio) + e) * 4
        )
    else:
        kernel = matmul * _dtype_bytes(cfg.dtype)
    # patch embed, pos embed, rel-pos tables, neck, norms
    g = cfg.image_embedding_size
    aux = cfg.patch_size ** 2 * 3 * e + g * g * e
    aux += cfg.encoder_depth * 2 * (2 * max(g, cfg.window_size) - 1) * (
        e // cfg.encoder_num_heads
    )
    aux += 2 * e * cfg.prompt_embed_dim + 9 * cfg.prompt_embed_dim ** 2
    # two-way decoder + hypernet MLPs (~4M params at 256-d)
    decoder = 6 * 4 * cfg.prompt_embed_dim ** 2 * 2 + 4 * (
        cfg.prompt_embed_dim ** 2 * 3
    )
    return kernel + (aux + decoder) * _dtype_bytes(cfg.dtype)


def clip_param_bytes(cfg) -> int:
    h = cfg.hidden_size
    per_block = 4 * h * h + 2 * h * cfg.intermediate_size
    params = cfg.num_layers * per_block
    params += cfg.num_patches * h + h * 3 * cfg.patch_size ** 2
    return params * _dtype_bytes(cfg.dtype)


def activation_bytes(cfg, batch: int, views: int, prompt_len: int) -> int:
    """Peak live activations on the serving path (estimate).

    The SAM encoder dominates: ~6 block-sized (BV, tokens, E)
    bf16 tensors live (residual, LN out, qkv, attn out, MLP hidden is
    bigger: 4E wide). The LLaMA prefill peak is (B, L, inter) + logits.
    """
    s = cfg.sam
    tokens = s.image_embedding_size ** 2
    sam_peak = batch * views * tokens * s.encoder_embed_dim * 2 * 4
    sam_peak += batch * views * tokens * int(
        s.encoder_embed_dim * s.mlp_ratio
    ) * 2
    lc = cfg.llama
    llama_peak = (
        batch * prompt_len * lc.intermediate_size * 2 * 2
        + batch * lc.vocab_size * 4
    )
    return max(sam_peak, llama_peak)


@dataclass
class ServingBudget:
    components: Dict[str, int]

    @property
    def total(self) -> int:
        return sum(self.components.values())

    def fits(self, hbm_bytes: Optional[int] = None,
             reserve_frac: float = 0.02) -> bool:
        """Whether the total fits ``hbm_bytes`` (the card's capacity,
        ``device_capacity``, by default) less ``reserve_frac`` of it."""
        if hbm_bytes is None:
            hbm_bytes = device_capacity()
        return self.total <= hbm_bytes * (1.0 - reserve_frac)

    def table(self) -> str:
        rows = [
            f"  {k:<16} {v / 1024 ** 3:7.2f} GiB"
            for k, v in self.components.items()
        ]
        rows.append(f"  {'TOTAL':<16} {self.total / 1024 ** 3:7.2f} GiB")
        return "\n".join(rows)


def serving_budget(cfg, batch: int, max_len: int, views: int,
                   prompt_len: int, kv: str = "int8",
                   tp: int = 1) -> ServingBudget:
    """Full InteractVLM serving HBM budget for one chip of a TP group.

    cfg: InteractVLMConfig (llama/clip/sam sub-configs).
    """
    return ServingBudget({
        "llama_params": llama_param_bytes(cfg.llama, tp=tp),
        "kv_cache": kv_cache_bytes(cfg.llama, batch, max_len, kv, tp=tp),
        "sam_params": sam_param_bytes(cfg.sam),
        "clip_params": clip_param_bytes(cfg.clip),
        "activations": activation_bytes(cfg, batch, views, prompt_len),
    })


def cached_activation_bytes(cfg, cache_batch: int, views: int,
                            prompt_len: int) -> int:
    """Peak temps of the CACHED serving program (encode-once path).

    The streaming ``activation_bytes`` term models the SAM-encode peak at
    ``batch*views`` 1024-pixel views — the cached program never runs the
    encoder, so that term overestimates its working set ~6x and would call
    every measured cached config infeasible. The cached program's temps
    scale per cached row: prefill MLP intermediates, the spliced embedding
    assembly, the mask-decoder tail over ``views`` per-row canonical
    embeddings, and the low-res upscale. Coefficients are the program
    structure (copies the JAX package's compiler keeps live); the single
    scale factor is the JAX package's calibration.
    """
    lc, s = cfg.llama, cfg.sam
    tokens = s.image_embedding_size ** 2
    per_row = (
        prompt_len * lc.intermediate_size * 2 * 2      # prefill MLP, bf16
        + prompt_len * lc.hidden_size * 2 * 3          # splice assembly
        + views * tokens * s.prompt_embed_dim * 4 * 4  # two-way tail, f32
        + views * (2 * s.image_embedding_size) ** 2 * (
            s.prompt_embed_dim // 4) * 4 * 2           # upscale stages
    )
    return int(0.9 * cache_batch * per_row)            # calibrated


def cached_serving_budget(cfg, cache_batch: int, max_len: int, views: int,
                          prompt_len: int, kv: str = "int8",
                          tp: int = 1) -> ServingBudget:
    """HBM budget of the encode-once cached serving program at ``Bc``.

    Differs from ``serving_budget`` only in the activation term (see
    ``cached_activation_bytes``); the canonical view embeddings and
    low-res lift maps it adds as arguments are <40 MB and ride inside the
    calibrated activation factor.
    """
    return ServingBudget({
        "llama_params": llama_param_bytes(cfg.llama, tp=tp),
        "kv_cache": kv_cache_bytes(cfg.llama, cache_batch, max_len, kv,
                                   tp=tp),
        "sam_params": sam_param_bytes(cfg.sam),
        "clip_params": clip_param_bytes(cfg.clip),
        "activations": cached_activation_bytes(cfg, cache_batch, views,
                                               prompt_len),
    })


# --- training budget ---------------------------------------------------------
def trainable_param_count(cfg) -> int:
    """Trainable parameters under the reference's freeze policy
    (train.py:264-322 + LoRA): LoRA a/b on q/v per layer, text_hidden_fcs,
    SAM mask decoder(s), cam-pose encoder (+splitter at Gen-Hu-Obj),
    AND the token tables -- embed_tokens + lm_head are explicitly marked
    trainable by the reference (train.py:316-322; the new [SEG] rows must
    learn) and dominate this count (~0.5 GB of f32 moments EACH at 7B).
    The LLaMA base matmuls, SAM encoder and CLIP tower are frozen."""
    lc = cfg.llama
    r = max(lc.lora_rank, 1) if lc.lora_rank else 8
    lora = lc.num_layers * 2 * (lc.hidden_size * r
                                + r * lc.num_heads * lc.head_dim)
    tables = 2 * lc.padded_vocab_size * lc.hidden_size
    fcs = lc.hidden_size * lc.hidden_size + lc.hidden_size * cfg.out_dim
    d = cfg.sam.prompt_embed_dim
    # two-way decoder blocks + hypernet MLPs + upscale convs
    mask_decoder = 6 * 4 * d * d * 2 + 4 * 3 * d * d + 8 * d * d
    n_dec = 3 if cfg.use_diff_decoder else 1
    cam = 2 * 128 * 128 + cfg.multiview_channels * 128 * cfg.out_dim
    splitter = 5 * 256 * 128 if cfg.base_token_type in (
        "Gen-Hu-Obj", "Gen-Int") else 0
    return lora + tables + fcs + n_dec * mask_decoder + cam + splitter


def train_activation_bytes(cfg, batch: int, views: int, seq_len: int,
                           n_data: int = 1, n_model: int = 1,
                           remat: bool = True) -> int:
    """Peak live activations of one training step (estimate, remat policy:
    per-LLaMA-block checkpointing as in models/llama.py).

    Three candidate peaks: (a) the frozen SAM encode of B*V views (its
    intermediates are inference-live but large -- stop_gradient means
    nothing is SAVED, yet the block-local working set is the serving peak);
    (b) LLaMA forward with remat: one block's full activation set live
    during its backward recompute + the per-block saved hiddens;
    (c) the logits/CE leg: (B, L, vocab) f32.
    """
    b = batch // max(n_data, 1)
    s = cfg.sam
    tokens = s.image_embedding_size ** 2
    sam_peak = b * views * tokens * (
        s.encoder_embed_dim * 2 * 4
        + int(s.encoder_embed_dim * s.mlp_ratio) * 2
    )
    lc = cfg.llama
    h = lc.hidden_size // max(n_model, 1) * max(n_model, 1)  # saved full
    saved = lc.num_layers * b * seq_len * h * 2 if remat else (
        lc.num_layers * b * seq_len * (
            h * 6 + lc.intermediate_size * 3 // max(n_model, 1)) * 2
    )
    block_live = b * seq_len * (
        4 * h + 3 * lc.intermediate_size // max(n_model, 1)
    ) * 2
    logits = b * seq_len * lc.vocab_size * 4 // max(n_model, 1)
    llama_peak = saved + block_live + logits

    # mask/lift legs of the TRAIN loss (absent at serving): ~10 f32
    # full-res mask temps (pred/upsample/focal/dice forward + cotangents)
    # plus the rank-1 lift candidate streams (values/weights/ids + grad;
    # geometry/lift._batched_normalized_scatter) and the trainable mask
    # decoder's saved cross-attention activations. Coefficients: the JAX
    # package's calibration.
    mask_px = b * views * cfg.sam.img_size ** 2  # == gt mask resolution
    mask_leg = 10 * mask_px * 4
    lift_leg = 4 * 3 * mask_px * 4
    dec_leg = 2 * b * views * tokens * s.prompt_embed_dim * 4
    total = (sam_peak + llama_peak + mask_leg + lift_leg + dec_leg)
    return int(total * 1.25)  # layout padding + fragmentation


def training_budget(cfg, batch: int, views: int, seq_len: int,
                    n_data: int = 1, n_model: int = 1,
                    remat: bool = True) -> ServingBudget:
    """Per-chip HBM budget of one training step on an (n_data, n_model)
    mesh: frozen bf16 towers (LLaMA base TP-sharded over ``model``),
    trainable params + grads (bf16+f32), ZeRO-style Adam moments sharded
    over BOTH axes (train/train_step.py:43-94), remat activations.

    The reference trains this scale with DeepSpeed ZeRO-2
    (reference train.py:356-389). Trainables and their grads/Adam
    moments live in f32 (flax param_dtype; optax zeros_like); grads count
    twice for the accumulation carry of the scan-based microbatch loop
    (train/train_step.py make_train_step). Frozen towers are stored in
    the compute dtype (create_sharded_state frozen_dtype /
    train/optimizer.cast_frozen_params)."""
    t = trainable_param_count(cfg)
    return ServingBudget({
        "llama_params": llama_param_bytes(cfg.llama, tp=n_model),
        "sam_params": sam_param_bytes(cfg.sam),
        "clip_params": clip_param_bytes(cfg.clip),
        # trainable copy rides inside llama/sam counts; grads are extra
        "grads": 2 * t * 4,
        "adam_moments": 2 * t * 4 // max(n_data * n_model, 1),
        "activations": train_activation_bytes(
            cfg, batch, views, seq_len, n_data, n_model, remat
        ),
    })
