"""SAM container with the InteractVLM text-prompt path, and mask
postprocessing.

Port of ``interactvlm_tpu/models/sam/sam.py``: ``encode_image``,
``decode_masks`` with the default mask decoder or, under
``use_diff_decoder`` (the DifDe token types), the human or object decoder
that the ``domain`` names (reference ModifiedSAM, InteractVLM.py:46-54), and
``postprocess_masks``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

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
    def __init__(self, config: SAMConfig, device="cuda",
                 use_diff_decoder: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.use_diff_decoder = use_diff_decoder
        self.image_encoder = ImageEncoderViT(config, device)
        self.prompt_encoder = PromptEncoder(config, device)
        self.mask_decoder = MaskDecoder(config, device)
        if use_diff_decoder:
            self.human_mask_decoder = MaskDecoder(config, device)
            self.object_mask_decoder = MaskDecoder(config, device)

    def encode_image(self, pixels):
        """(B, S, S, 3) normalized -> (B, g, g, C)."""
        return self.image_encoder(pixels)

    def decoder_for(self, domain: Optional[str]):
        """The decoder a domain selects: under ``use_diff_decoder``,
        "hcontact" in it the human decoder, "oafford" or "ocontact" the
        object decoder; the default decoder otherwise."""
        if self.use_diff_decoder and domain is not None:
            if "hcontact" in domain:
                return self.human_mask_decoder
            if "oafford" in domain or "ocontact" in domain:
                return self.object_mask_decoder
        return self.mask_decoder

    def decode_masks(self, image_embeddings, text_embeds,
                     domain: Optional[str] = None,
                     multimask_output: bool = False):
        """Text-prompted mask decode: image_embeddings (B, g, g, C),
        text_embeds (B, N, C) -> (low_res_masks (B, n, 4g, 4g), iou_pred)."""
        sparse, dense = self.prompt_encoder(text_embeds)
        image_pe = self.prompt_encoder.get_dense_pe()
        return self.decoder_for(domain)(
            image_embeddings, image_pe, sparse.to(text_embeds.dtype), dense,
            multimask_output)


def postprocess_masks(low_res_masks, img_size: int, input_size: Sequence[int],
                      original_size: Sequence[int]):
    """Low-res decoder masks (B, N, h, w) -> the original image frame
    (B, N, H0, W0) f32 (reference sam.py:137-172): bilinear to
    (img_size, img_size), crop the unpadded ``input_size`` region, bilinear
    to ``original_size``. ``jax.image.resize`` antialiases where it
    downsamples (a triangle filter widened by the scale, weights normalised
    over the input); torch's ``antialias=True`` bilinear is that filter, and
    where it upsamples it is plain bilinear with clamped borders, as JAX's."""
    x = F.interpolate(low_res_masks.float(), size=(img_size, img_size),
                      mode="bilinear", align_corners=False, antialias=True)
    x = x[..., :input_size[0], :input_size[1]]
    return F.interpolate(x, size=tuple(original_size), mode="bilinear",
                         align_corners=False, antialias=True)
