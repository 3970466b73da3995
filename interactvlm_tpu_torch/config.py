"""Model configuration dataclasses and presets of the PyTorch port.

Field names, defaults and presets are those of ``interactvlm_tpu/config.py``;
only the dtypes are torch dtypes. The port keeps its own copy because the
JAX package's module imports ``jax.numpy``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SAMConfig:
    """SAM promptable-segmentation stack (reference ``build_sam.py:60-108``)."""

    img_size: int = 1024
    patch_size: int = 16
    encoder_embed_dim: int = 1280
    encoder_depth: int = 32
    encoder_num_heads: int = 16
    encoder_global_attn_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    window_size: int = 14
    mlp_ratio: float = 4.0
    prompt_embed_dim: int = 256
    mask_in_chans: int = 16
    decoder_depth: int = 2
    decoder_num_heads: int = 8
    decoder_mlp_dim: int = 2048
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    dtype: torch.dtype = torch.float32
    gelu_approx: bool = False
    # int8 encoder matmuls (qkv, proj, lin1, lin2 as Int8Linear)
    weights_int8: bool = False
    # the encoder attention's decomposed rel-pos bias (the JAX Attention's
    # ``use_rel_pos``); off, every block is a bias-free attention with no
    # rel-pos tables
    use_rel_pos: bool = True
    # the SAM probe's knock-out: each encoder attention becomes the
    # identity on the qkv's first third, then proj (no tables)
    identity_attention: bool = False

    @property
    def image_embedding_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_mask_tokens(self) -> int:
        return self.num_multimask_outputs + 1


def sam_vit_h(**kw) -> SAMConfig:
    return SAMConfig(**kw)


def sam_vit_l(**kw) -> SAMConfig:
    return SAMConfig(
        encoder_embed_dim=1024,
        encoder_depth=24,
        encoder_num_heads=16,
        encoder_global_attn_indexes=(5, 11, 17, 23),
        **kw,
    )


def sam_vit_b(**kw) -> SAMConfig:
    return SAMConfig(
        encoder_embed_dim=768,
        encoder_depth=12,
        encoder_num_heads=12,
        encoder_global_attn_indexes=(2, 5, 8, 11),
        **kw,
    )


def sam_tiny(**kw) -> SAMConfig:
    """Small config for tests: 64px images, 2 blocks."""
    return SAMConfig(
        img_size=64,
        patch_size=16,
        encoder_embed_dim=32,
        encoder_depth=2,
        encoder_num_heads=2,
        encoder_global_attn_indexes=(1,),
        window_size=2,
        prompt_embed_dim=32,
        mask_in_chans=4,
        decoder_num_heads=2,
        decoder_mlp_dim=64,
        iou_head_hidden_dim=32,
        **kw,
    )


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """CLIP ViT-L/14 tower at 224 px: 256 patches + CLS."""

    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    select_layer: int = -2
    dtype: torch.dtype = torch.float32

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def clip_vit_l_14(**kw) -> CLIPVisionConfig:
    return CLIPVisionConfig(**kw)


def clip_tiny(**kw) -> CLIPVisionConfig:
    return CLIPVisionConfig(
        image_size=28,
        patch_size=14,
        hidden_size=32,
        intermediate_size=64,
        num_layers=2,
        num_heads=2,
        **kw,
    )


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """LLaMA decoder (reference LLaVA base: LLaMA-13B, hidden 5120)."""

    vocab_size: int = 32000
    hidden_size: int = 5120
    intermediate_size: int = 13824
    num_layers: int = 40
    num_heads: int = 40
    num_kv_heads: int = 40
    head_dim: int = 128
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    lora_rank: int = 0
    lora_alpha: float = 16.0
    # lora_rank > 0 puts LoRA on q_proj/v_proj (training) over the bf16
    # base, or with weights_int8 over a frozen int8 base (QLoRA,
    # Int8LoraLinear); quantized serving weights: int8 (Int8Linear) and
    # packed int4 (Int4Linear, which takes precedence over int8)
    weights_int8: bool = False
    weights_int4: bool = False

    @property
    def padded_vocab_size(self) -> int:
        """embed_tokens/lm_head rows, rounded up to a multiple of 128; ids in
        [vocab_size, padded) are masked to -inf by ``LlamaForCausalLM.logits``."""
        return -(-self.vocab_size // 128) * 128


def llama_13b(**kw) -> LlamaConfig:
    return LlamaConfig(**kw)


def llama_7b(**kw) -> LlamaConfig:
    return LlamaConfig(
        hidden_size=4096,
        intermediate_size=11008,
        num_layers=32,
        num_heads=32,
        num_kv_heads=32,
        **kw,
    )


def llama_tiny(**kw) -> LlamaConfig:
    kw.setdefault("dtype", torch.float32)
    kw.setdefault("remat", False)
    return LlamaConfig(
        vocab_size=512,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        max_seq_len=256,
        **kw,
    )


@dataclasses.dataclass(frozen=True)
class InteractVLMConfig:
    """Composite model configuration (reference ``InteractVLM.py:139-249``)."""

    llama: LlamaConfig = dataclasses.field(default_factory=llama_13b)
    clip: CLIPVisionConfig = dataclasses.field(default_factory=clip_vit_l_14)
    sam: SAMConfig = dataclasses.field(default_factory=sam_vit_h)

    token_type: str = "Gen"  # Gen | Gen-Hu-Obj | Gen-Int (+-DifDe)
    seg_token_idx: int = 32000
    hseg_token_idx: int = -1
    oseg_token_idx: int = -1
    img_emb_len: int = 255

    multiview_channels: int = 4
    multiview_cam_cond: bool = True
    cam_encoder_type: str = "simple"  # simple | view_index | vi_v1

    hC_sam_view_type: str = "4MV-Z_Vitru_mv2"
    oC_sam_view_type: str = "4MV-Z_HM"
    num_human_vertices: int = 6890
    num_object_points: int = 2048

    ce_loss_weight: float = 1.0
    bce_loss_weight: float = 2.0
    bce_loss_alpha: float = 0.5
    dice_loss_weight: float = 1.0
    dice_loss_scale: float = 1.0
    hC_loss_weight: float = 3.0
    oC_loss_weight: float = 1.0

    max_seg_tokens: int = 1
    out_dim: int = 256

    use_fusion: bool = False
    use_uncertainty: bool = False

    @property
    def use_diff_decoder(self) -> bool:
        return "DifDe" in self.token_type

    @property
    def base_token_type(self) -> str:
        return self.token_type.replace("-DifDe", "")


def interactvlm_13b(**kw) -> InteractVLMConfig:
    return InteractVLMConfig(**kw)


def interactvlm_tiny(**kw) -> InteractVLMConfig:
    kw.setdefault("llama", llama_tiny())
    kw.setdefault("clip", clip_tiny())
    kw.setdefault("sam", sam_tiny())
    kw.setdefault("seg_token_idx", 500)
    kw.setdefault("img_emb_len", 3)
    kw.setdefault("out_dim", 32)
    kw.setdefault("num_human_vertices", 64)
    kw.setdefault("num_object_points", 32)
    return InteractVLMConfig(**kw)
