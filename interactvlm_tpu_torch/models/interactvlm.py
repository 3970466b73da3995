"""The composite InteractVLM model, inference path: LLaVA -> [SEG] hidden
state -> camera-conditioned view prompts -> SAM multi-view mask decode ->
2D -> 3D contact lift.

Port of the inference methods of ``interactvlm_tpu/models/interactvlm.py``
for the ``Gen`` token type with ``simple`` camera conditioning. SAM runs
over the ``B*V`` folded view images in one batch, and every view's decoder
receives all V cam-conditioned prompt tokens of its sample (the reference's
broadcast, InteractVLM.py:416-435).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from interactvlm_tpu_torch.config import InteractVLMConfig
from interactvlm_tpu_torch.geometry.lift import lift_multiview_soft
from interactvlm_tpu_torch.models.components import CamPoseEncoder, TextHiddenFcs
from interactvlm_tpu_torch.models.llava import LlavaModel
from interactvlm_tpu_torch.models.sam.sam import Sam
from interactvlm_tpu_torch.utils.device import resolve_device


class InteractVLM(nn.Module):
    def __init__(self, config: InteractVLMConfig, device="cuda"):
        super().__init__()
        cfg = config
        if (cfg.token_type != "Gen" or cfg.use_fusion or cfg.use_uncertainty
                or (cfg.multiview_cam_cond and cfg.cam_encoder_type != "simple")):
            raise NotImplementedError(
                "only token_type 'Gen' with 'simple' cam conditioning is "
                "ported yet")
        device = resolve_device(device)
        self.config = cfg
        self.llava = LlavaModel(cfg.llama, cfg.clip, device)
        self.sam = Sam(cfg.sam, device)
        self.text_hidden_fcs = TextHiddenFcs(cfg.llama.hidden_size,
                                             cfg.out_dim, cfg.sam.dtype, device)
        if cfg.multiview_cam_cond:
            self.cam_pose_encoder = CamPoseEncoder(cfg.out_dim, cfg.sam.dtype,
                                                   device)

    @property
    def device(self):
        return self.llava.device

    def encode_sam_images(self, sam_images):
        """(B, V, S, S, 3) -> (B, V, g, g, C)."""
        B, V = sam_images.shape[:2]
        emb = self.sam.encode_image(sam_images.reshape((B * V,) + sam_images.shape[2:]))
        return emb.reshape((B, V) + emb.shape[1:])

    def condition_views(self, emb, cam_params):
        """One seg embedding (B, D) -> per-view prompt tokens (B, V, D)
        (reference process_embeddings, InteractVLM.py:268-294)."""
        V = self.config.multiview_channels
        tokens = emb[:, None, :].expand(emb.shape[0], V, emb.shape[-1])
        if self.config.multiview_cam_cond:
            tokens = tokens + self.cam_pose_encoder(cam_params.to(emb.dtype))
        return tokens

    def decode_view_masks(self, image_emb, view_tokens):
        """image_emb (B, V, g, g, C), view_tokens (B, V, D) -> low-res mask
        logits (B, V, 4g, 4g); each view gets all V tokens of its sample."""
        B, V = image_emb.shape[:2]
        flat = image_emb.reshape((B * V,) + image_emb.shape[2:])
        prompts = view_tokens.repeat_interleave(V, dim=0)  # (B*V, V, D)
        low, _ = self.sam.decode_masks(flat, prompts)
        low = low[:, 0]
        return low.reshape(B, V, low.shape[-2], low.shape[-1])

    @staticmethod
    def upsample_masks(low_res, out_size: int):
        """Low-res logits (B, V, h, w) -> (B, V, out, out) f32, bilinear with
        half-pixel centres (``jax.image.resize``'s convention: for upsampling
        its edge renormalisation equals clamping at the border)."""
        return F.interpolate(low_res.float(), size=(out_size, out_size),
                             mode="bilinear", align_corners=False)

    def low_res_masks_from_image_emb(self, seg_hidden, token_id, image_emb,
                                     cam_params):
        """Inference tail from a precomputed SAM embedding (B|1, V, g, g, C):
        the hcontact views are fixed renders, so their embedding is a
        constant that can be encoded once. ``token_id`` selects per-token
        routing, which the Gen token type does not use."""
        emb = self.text_hidden_fcs(seg_hidden)
        view_tokens = self.condition_views(emb, cam_params)
        B = seg_hidden.shape[0]
        if image_emb.shape[0] == 1 and B > 1:
            image_emb = image_emb.expand((B,) + image_emb.shape[1:])
        return self.decode_view_masks(image_emb, view_tokens)

    def low_res_masks_from_seg_hidden(self, seg_hidden, token_id, sam_images,
                                      cam_params):
        return self.low_res_masks_from_image_emb(
            seg_hidden, token_id, self.encode_sam_images(sam_images),
            cam_params)

    def masks_from_seg_hidden(self, seg_hidden, token_id, sam_images,
                              cam_params, mask_size: int):
        return self.upsample_masks(
            self.low_res_masks_from_seg_hidden(seg_hidden, token_id,
                                               sam_images, cam_params),
            mask_size)


def lift_human(pred_masks, p2v3, bary3, num_vertices: int):
    """(B, V, H, W) logits -> (B, N) contact probabilities; corner-major
    (3, V, H, W) maps shared across the batch."""
    return torch.stack([lift_multiview_soft(m, p2v3, bary3, num_vertices)
                        for m in pred_masks])
