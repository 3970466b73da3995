"""SAM container with the InteractVLM text-prompt path.

Port of ``interactvlm_tpu/models/sam/sam.py``: ``encode_image`` and
``decode_masks`` with the default mask decoder (the per-domain DifDe
decoders are not ported yet).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from interactvlm_tpu_torch.config import SAMConfig
from interactvlm_tpu_torch.models.sam.image_encoder import ImageEncoderViT
from interactvlm_tpu_torch.models.sam.mask_decoder import MaskDecoder
from interactvlm_tpu_torch.models.sam.prompt_encoder import PromptEncoder
from interactvlm_tpu_torch.utils.constants import PIXEL_MEAN, PIXEL_STD
from interactvlm_tpu_torch.utils.device import resolve_device


def preprocess_pixels(x):
    """(..., H, W, 3) uint8/float RGB -> normalized float32."""
    mean = torch.tensor(PIXEL_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(PIXEL_STD, dtype=torch.float32, device=x.device)
    return (x.float() - mean) / std


class Sam(nn.Module):
    def __init__(self, config: SAMConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.image_encoder = ImageEncoderViT(config, device)
        self.prompt_encoder = PromptEncoder(config, device)
        self.mask_decoder = MaskDecoder(config, device)

    def encode_image(self, pixels):
        """(B, S, S, 3) normalized -> (B, g, g, C)."""
        return self.image_encoder(pixels)

    def decode_masks(self, image_embeddings, text_embeds,
                     multimask_output: bool = False):
        """Text-prompted mask decode: image_embeddings (B, g, g, C),
        text_embeds (B, N, C) -> (low_res_masks (B, n, 4g, 4g), iou_pred)."""
        sparse, dense = self.prompt_encoder(text_embeds)
        image_pe = self.prompt_encoder.get_dense_pe()
        return self.mask_decoder(image_embeddings, image_pe, sparse, dense,
                                 multimask_output)
