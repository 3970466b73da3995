"""The composite InteractVLM model: LLaVA -> [SEG] hidden state ->
camera-conditioned view prompts -> SAM multi-view mask decode -> 2D -> 3D
contact lift, with the inference tail and the training forward.

Port of ``interactvlm_tpu/models/interactvlm.py`` for the ``Gen`` token
type with ``simple`` camera conditioning and one seg token per row. SAM runs
over the ``B*V`` folded view images in one batch, and every view's decoder
receives all V cam-conditioned prompt tokens of its sample (the reference's
broadcast, InteractVLM.py:416-435). ``forward`` is the teacher-forced
training pass (``forward_train``): it returns the reference's results dict,
every loss computed as the JAX package computes it; the frozen SAM encoder
runs without autograd (the JAX package's ``stop_gradient``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from interactvlm_tpu_torch.config import InteractVLMConfig
from interactvlm_tpu_torch.geometry.lift import lift_multiview_soft
from interactvlm_tpu_torch.models import losses as L
from interactvlm_tpu_torch.models.components import CamPoseEncoder, TextHiddenFcs
from interactvlm_tpu_torch.models.llama import cross_entropy_loss
from interactvlm_tpu_torch.models.llava import LlavaModel, seg_predictor_mask
from interactvlm_tpu_torch.models.sam.sam import Sam
from interactvlm_tpu_torch.utils.device import resolve_device

# task ids of a mixed batch (the JAX package's encoding)
TASK_VQA, TASK_SEG2D, TASK_HCONTACT, TASK_OAFFORD, TASK_OCONTACT = range(5)


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
        """(B, V, S, S, 3) -> (B, V, g, g, C); the encoder is frozen and
        runs without autograd."""
        B, V = sam_images.shape[:2]
        with torch.no_grad():
            emb = self.sam.encode_image(
                sam_images.reshape((B * V,) + sam_images.shape[2:]))
        return emb.reshape((B, V) + emb.shape[1:])

    def seg_embeddings(self, hidden, spliced_ids):
        """Project the hidden states and take each row's first seg-token
        predictor position. Returns (emb (B, out_dim), token_id (B,),
        has_seg (B,)); a row without a seg token gets a zero embedding."""
        proj = self.text_hidden_fcs(hidden)
        mask = seg_predictor_mask(spliced_ids, [self.config.seg_token_idx])
        has_seg = mask.any(1)
        pos = mask.int().argmax(1)  # the first marked position
        rows = torch.arange(hidden.shape[0], device=hidden.device)
        emb = torch.where(has_seg[:, None], proj[rows, pos], 0.0)
        nxt = (pos + 1).clamp(max=spliced_ids.shape[1] - 1)
        return emb, spliced_ids[rows, nxt], has_seg

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

    def forward(self, batch: Dict[str, Any]):
        return self.forward_train(batch)

    def forward_train(self, batch: Dict[str, Any]):
        """Teacher-forced training forward (reference model_forward,
        InteractVLM.py:296-508) over a batch of the data pipeline's keys
        (``utils/testing.make_synthetic_batch`` builds one). Returns the
        reference's results dict: ``loss``, ``ce_loss``, ``mask_bce_loss``,
        ``mask_dice_loss``, ``mask_l2_loss``, ``mask_loss``, ``hC_loss``,
        ``oA_loss``, ``oC_loss`` and ``pred_masks`` (B, V, H, W)."""
        cfg = self.config
        if cfg.max_seg_tokens > 1:
            raise NotImplementedError(
                "multi-seg training (max_seg_tokens > 1) is not ported yet")
        dev = self.device

        def get(key):
            return torch.as_tensor(batch[key], device=dev)

        task_ids = get("task_ids")
        is_h, is_oa = task_ids == TASK_HCONTACT, task_ids == TASK_OAFFORD
        is_oc, has_mask = task_ids == TASK_OCONTACT, task_ids != TASK_VQA
        image_index = batch.get("image_index")
        out = self.llava(get("input_ids"), get("images_clip"), get("labels"),
                         get("attn_mask") if "attn_mask" in batch else None,
                         image_index=image_index)
        ce_loss = cfg.ce_loss_weight * cross_entropy_loss(
            out.logits, out.spliced_labels)

        image_emb = self.encode_sam_images(get("sam_images"))
        if image_index is not None:
            image_emb = image_emb[torch.as_tensor(image_index,
                                                  device=dev).long()]
        emb, _, has_seg = self.seg_embeddings(out.hidden, out.spliced_ids)
        view_tokens = self.condition_views(emb, get("cam_params"))
        low_res = self.decode_view_masks(image_emb, view_tokens)
        gt_masks = get("gt_masks")
        pred_masks = self.upsample_masks(low_res, gt_masks.shape[-1])
        # rows without a seg token predict nothing
        pred_masks = torch.where(has_seg[:, None, None, None], pred_masks, 0.0)
        # oafford heatmap rows: sigmoid the prediction (InteractVLM.py:453-456)
        pred_for_loss = torch.where(is_oa[:, None, None, None],
                                    torch.sigmoid(pred_masks), pred_masks)
        mask_bce, mask_dice, mask_l2 = L.combined_mask_losses(
            pred_for_loss, gt_masks, is_oa, has_mask & has_seg,
            cfg.bce_loss_weight, cfg.bce_loss_alpha, cfg.dice_loss_weight,
            cfg.dice_loss_scale)

        hC = oA = oC = torch.zeros((), device=dev)
        if cfg.hC_loss_weight > 0 and "human_p2v" in batch:
            gt = get("gt_hcontact")
            hC = cfg.hC_loss_weight * L.human_contact_3d_loss(
                pred_masks, gt, get("human_p2v"), get("human_bary"), is_h,
                gt.shape[1])
        if cfg.oC_loss_weight > 0 and "obj_p2p" in batch:
            oA = cfg.oC_loss_weight * L.object_afford_3d_loss(
                torch.sigmoid(pred_masks), get("gt_oafford"), get("obj_p2p"),
                is_oa)
        if cfg.oC_loss_weight > 0 and "obj_p2v" in batch:
            oC = cfg.oC_loss_weight * L.object_contact_3d_loss(
                pred_masks, get("gt_ocontact"), get("obj_p2v"),
                get("obj_bary"), get("obj_valid_verts"), is_oc)

        mask_loss = mask_bce + mask_dice + mask_l2
        return {
            "loss": ce_loss + mask_loss + hC + oA + oC,
            "ce_loss": ce_loss,
            "mask_bce_loss": mask_bce,
            "mask_dice_loss": mask_dice,
            "mask_l2_loss": mask_l2,
            "mask_loss": mask_loss,
            "hC_loss": hC,
            "oA_loss": oA,
            "oC_loss": oC,
            "pred_masks": pred_masks,
        }

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
