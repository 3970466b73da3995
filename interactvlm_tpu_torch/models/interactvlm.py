"""The composite InteractVLM model: LLaVA -> seg-token hidden states ->
camera-conditioned view prompts -> SAM multi-view mask decode -> 2D -> 3D
contact lift, with the inference tail and the training forward.

Port of ``interactvlm_tpu/models/interactvlm.py``. SAM runs over the ``B*V``
folded view images in one batch, and every view's decoder receives all V
cam-conditioned prompt tokens of its sample (the reference's broadcast,
InteractVLM.py:416-435). The token types: ``Gen`` ([SEG]), ``Gen-Hu-Obj``
([SEG], [HSEG], [OSEG]) and ``Gen-Int`` ([HSEG] = [OSEG], the reference's
[ISEG]); the last two split each view token into a human and an object
variant (``AttentionSplitter``), and a ``-DifDe`` suffix adds a human and an
object mask decoder, selected per row by task in training and by domain or
token in inference. ``max_seg_tokens`` K > 1 decodes one mask set per seg
token of a row: the slots fold into the decode batch. ``forward`` is the
teacher-forced training pass (``forward_train``): it returns the
reference's results dict, every loss computed as the JAX package computes
it; the frozen SAM encoder runs without autograd (the JAX package's
``stop_gradient``), and the optional fusion then mixes the LLaVA hidden
states into the embedding with gradients.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from interactvlm_tpu_torch.config import InteractVLMConfig
from interactvlm_tpu_torch.geometry.lift import (
    lift_multiview_soft,
    lift_multiview_thresholded,
)
from interactvlm_tpu_torch.models import losses as L
from interactvlm_tpu_torch.models.components import (
    AttentionSplitter,
    CamPoseEncoder,
    LLaVASAMFusion,
    TextHiddenFcs,
    UncertaintyModule,
    VIv1CamPoseEncoder,
    ViewIndexCamPoseEncoder,
)
from interactvlm_tpu_torch.models.llama import cross_entropy_loss
from interactvlm_tpu_torch.models.llava import LlavaModel, seg_predictor_mask
from interactvlm_tpu_torch.models.sam.sam import Sam
from interactvlm_tpu_torch.utils.device import resolve_device

# task ids of a mixed batch (the JAX package's encoding)
TASK_VQA, TASK_SEG2D, TASK_HCONTACT, TASK_OAFFORD, TASK_OCONTACT = range(5)
SPLIT_TOKEN_TYPES = ("Gen-Hu-Obj", "Gen-Int")


class InteractVLM(nn.Module):
    def __init__(self, config: InteractVLMConfig, device="cuda", mesh=None):
        super().__init__()
        cfg = config
        device = resolve_device(device)
        self.config = cfg
        # LLaMA tensor-parallel over the mesh's model axis (``mesh``:
        # parallel/mesh.py); CLIP, SAM and the heads whole on every rank
        self.mesh = mesh
        dt = cfg.sam.dtype  # the heads around SAM compute in its dtype
        self.llava = LlavaModel(cfg.llama, cfg.clip, device, mesh)
        self.sam = Sam(cfg.sam, device, use_diff_decoder=cfg.use_diff_decoder)
        self.text_hidden_fcs = TextHiddenFcs(cfg.llama.hidden_size,
                                             cfg.out_dim, dt, device)
        if cfg.multiview_cam_cond:
            V = cfg.multiview_channels
            if cfg.cam_encoder_type == "simple":
                self.cam_pose_encoder = CamPoseEncoder(cfg.out_dim, dt, device)
            elif cfg.cam_encoder_type == "view_index":
                self.cam_pose_encoder = ViewIndexCamPoseEncoder(
                    V, cfg.out_dim, dt, device)
            elif cfg.cam_encoder_type == "vi_v1":
                self.cam_pose_encoder = VIv1CamPoseEncoder(
                    V, cfg.out_dim, dt, device)
            else:
                raise ValueError(cfg.cam_encoder_type)
        if cfg.base_token_type in SPLIT_TOKEN_TYPES:
            self.attention_splitter = AttentionSplitter(cfg.out_dim, dt,
                                                        device)
        if cfg.use_fusion:
            self.fusion = LLaVASAMFusion(cfg.sam.prompt_embed_dim,
                                         cfg.llama.hidden_size, dt, device)
        if cfg.use_uncertainty:
            # built as the JAX package builds it, and called nowhere there
            # either: its flax tree has no parameters for it
            self.uncertainty = UncertaintyModule(cfg.sam.prompt_embed_dim,
                                                 dt, device)

    @property
    def device(self):
        return self.llava.device

    @property
    def seg_ids(self):
        """The token ids that mark a seg token: [SEG], plus [HSEG] and
        [OSEG] under Gen-Hu-Obj / Gen-Int."""
        cfg = self.config
        ids = [cfg.seg_token_idx]
        if cfg.base_token_type in SPLIT_TOKEN_TYPES:
            ids += [cfg.hseg_token_idx, cfg.oseg_token_idx]
        return ids

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
        mask = seg_predictor_mask(spliced_ids, self.seg_ids)
        has_seg = mask.any(1)
        pos = mask.int().argmax(1)  # the first marked position
        rows = torch.arange(hidden.shape[0], device=hidden.device)
        emb = torch.where(has_seg[:, None], proj[rows, pos], 0.0)
        nxt = (pos + 1).clamp(max=spliced_ids.shape[1] - 1)
        return emb, spliced_ids[rows, nxt], has_seg

    def seg_embeddings_k(self, hidden, spliced_ids, k: int):
        """Up to K seg-token slots a row, in emission order (the reference
        decodes one mask set per seg token, InteractVLM.py:389-410 and
        :544-576): the first K marked positions, ascending. Returns (emb
        (B, K, out_dim), token_id (B, K) read at the position after, valid
        (B, K)); an invalid slot's embedding is zero."""
        proj = self.text_hidden_fcs(hidden)
        mask = seg_predictor_mask(spliced_ids, self.seg_ids)
        Lh = mask.shape[1]
        pos_all = torch.where(mask, torch.arange(Lh, device=mask.device), Lh)
        pos = torch.topk(pos_all, k, dim=1, largest=False, sorted=True).values
        valid = pos < Lh
        posc = pos.clamp(max=Lh - 1)
        emb = torch.gather(proj, 1, posc[..., None].expand(
            posc.shape + proj.shape[-1:]))
        emb = torch.where(valid[..., None], emb, 0.0)
        token_id = torch.gather(spliced_ids, 1, (posc + 1).clamp(max=Lh - 1))
        return emb, token_id, valid

    def condition_views(self, emb, cam_params, token_id=None):
        """One seg embedding (B, D) -> per-view prompt tokens (B, V, D)
        (reference process_embeddings, InteractVLM.py:268-294): ``simple``
        adds its encoding, ``view_index`` and ``vi_v1`` multiply; under
        Gen-Hu-Obj / Gen-Int the splitter's human tokens replace a [HSEG]
        row's, else its object tokens an [OSEG] row's (so under Gen-Int,
        where the two ids are one, the human branch wins)."""
        cfg = self.config
        V = cfg.multiview_channels
        tokens = emb[:, None, :].expand(emb.shape[0], V, emb.shape[-1])
        if cfg.multiview_cam_cond:
            enc = self.cam_pose_encoder(cam_params.to(emb.dtype))
            tokens = (tokens + enc if cfg.cam_encoder_type == "simple"
                      else tokens * enc)
        if cfg.base_token_type in SPLIT_TOKEN_TYPES:
            human, obj = self.attention_splitter(tokens)
            tok = token_id[:, None, None]
            tokens = torch.where(tok == cfg.hseg_token_idx, human,
                                 torch.where(tok == cfg.oseg_token_idx, obj,
                                             tokens))
        return tokens

    def decode_view_masks(self, image_emb, view_tokens,
                          domain: Optional[str] = None):
        """image_emb (B, V, g, g, C), view_tokens (B, V, D) -> low-res mask
        logits (B, V, 4g, 4g); each view gets all V tokens of its sample,
        and ``domain`` selects the DifDe decoder."""
        B, V = image_emb.shape[:2]
        flat = image_emb.reshape((B * V,) + image_emb.shape[2:])
        prompts = view_tokens.repeat_interleave(V, dim=0)  # (B*V, V, D)
        low, _ = self.sam.decode_masks(flat, prompts, domain)
        low = low[:, 0]
        return low.reshape(B, V, low.shape[-2], low.shape[-1])

    def routed_view_masks(self, image_emb, view_tokens, sel_h, sel_o):
        """DifDe: all three decoders on every row (static shapes, as the JAX
        package runs them); ``sel_h`` (N,) rows take the human decoder's
        masks, else ``sel_o`` rows the object decoder's, else the default's."""
        low_def = self.decode_view_masks(image_emb, view_tokens)
        low_h = self.decode_view_masks(image_emb, view_tokens, "hcontact")
        low_o = self.decode_view_masks(image_emb, view_tokens, "ocontact")
        return torch.where(sel_h[:, None, None, None], low_h,
                           torch.where(sel_o[:, None, None, None], low_o,
                                       low_def))

    def multi_seg_low_res_masks(self, seg_hidden, token_id, valid, image_emb,
                                cam_params):
        """K mask sets a row, one per seg-token slot. seg_hidden (B, K, H)
        raw hidden states at the predictor positions, token_id and valid
        (B, K), image_emb (B|1, V, g, g, C). Slot (b, k) decodes against
        image b (each image repeated K times in the decode batch); under
        DifDe each slot takes its token's decoder ([HSEG] human, [OSEG]
        object, else default). Returns (B, K, V, 4g, 4g), invalid slots
        zero."""
        cfg = self.config
        B, K = seg_hidden.shape[:2]
        emb = self.text_hidden_fcs(seg_hidden.reshape(B * K, -1))
        if image_emb.shape[0] == 1 and B > 1:
            image_emb = image_emb.expand((B,) + image_emb.shape[1:])
        emb_flat = image_emb.repeat_interleave(K, dim=0)
        cams_flat = cam_params.repeat_interleave(K, dim=0)
        tok_flat = token_id.reshape(B * K)
        view_tokens = self.condition_views(emb, cams_flat, tok_flat)
        if cfg.use_diff_decoder:
            low = self.routed_view_masks(emb_flat, view_tokens,
                                         tok_flat == cfg.hseg_token_idx,
                                         tok_flat == cfg.oseg_token_idx)
        else:
            low = self.decode_view_masks(emb_flat, view_tokens)
        low = low.reshape((B, K) + low.shape[1:])
        return torch.where(valid[:, :, None, None, None], low, 0.0)

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
        ``oA_loss``, ``oC_loss`` and ``pred_masks`` (B, V, H, W), or
        (B, K, V, H, W) when ``max_seg_tokens`` K > 1."""
        cfg = self.config
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
        if cfg.use_fusion:
            B, V = image_emb.shape[:2]
            fused = self.fusion(
                image_emb.reshape((B * V,) + image_emb.shape[2:]),
                out.hidden.repeat_interleave(V, dim=0))
            image_emb = fused.reshape(image_emb.shape)
        if cfg.max_seg_tokens > 1:
            return self._forward_train_multiseg(batch, get, out, ce_loss,
                                                image_emb, is_h, is_oa, is_oc)

        emb, token_id, has_seg = self.seg_embeddings(out.hidden,
                                                     out.spliced_ids)
        view_tokens = self.condition_views(emb, get("cam_params"), token_id)
        if cfg.use_diff_decoder:
            # per-ROW routing by task (reference ModifiedSAM.forward selects
            # by ds_name, InteractVLM.py:46-54,429-435): hcontact rows the
            # human decoder, oafford / ocontact the object one, the rest the
            # default
            low_res = self.routed_view_masks(image_emb, view_tokens, is_h,
                                             is_oa | is_oc)
        else:
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
        hC, oA, oC = self._lift_losses(batch, get, pred_masks, pred_masks,
                                       is_h, is_oa, is_oc)
        return self._results(ce_loss, mask_bce, mask_dice, mask_l2, hC, oA,
                             oC, pred_masks)

    def _lift_losses(self, batch, get, pred_h, pred_o, row_h, row_oa, row_oc):
        """The 3D losses: the human lift of ``pred_h`` on ``row_h`` rows,
        the affordance and object-contact lifts of ``pred_o`` on ``row_oa``
        and ``row_oc`` rows, each where its weight and maps are there."""
        cfg = self.config
        hC = oA = oC = torch.zeros((), device=self.device)
        if cfg.hC_loss_weight > 0 and "human_p2v" in batch:
            gt = get("gt_hcontact")
            hC = cfg.hC_loss_weight * L.human_contact_3d_loss(
                pred_h, gt, get("human_p2v"), get("human_bary"), row_h,
                gt.shape[1])
        if cfg.oC_loss_weight > 0 and "obj_p2p" in batch:
            oA = cfg.oC_loss_weight * L.object_afford_3d_loss(
                torch.sigmoid(pred_o), get("gt_oafford"), get("obj_p2p"),
                row_oa)
        if cfg.oC_loss_weight > 0 and "obj_p2v" in batch:
            oC = cfg.oC_loss_weight * L.object_contact_3d_loss(
                pred_o, get("gt_ocontact"), get("obj_p2v"), get("obj_bary"),
                get("obj_valid_verts"), row_oc)
        return hC, oA, oC

    @staticmethod
    def _results(ce_loss, mask_bce, mask_dice, mask_l2, hC, oA, oC,
                 pred_masks):
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

    def _forward_train_multiseg(self, batch, get, out, ce_loss, image_emb,
                                is_h, is_oa, is_oc):
        """K seg-token slots a row (reference InteractVLM.py:389-442): one
        mask set and one loss contribution per slot, paired with the slot's
        gt masks (B, K, V, H, W) where ``seg_slot_has_mask`` (B, K) says it
        has one; the 2D losses are normalised per row. With distinct [HSEG]
        / [OSEG] ids (Gen-Hu-Obj) a slot is routed by its token, else by its
        row's task; the row-level 3D losses take the prediction of the
        row's human (object) slot."""
        cfg = self.config
        K = cfg.max_seg_tokens
        B = out.hidden.shape[0]
        emb_k, token_k, valid_k = self.seg_embeddings_k(out.hidden,
                                                        out.spliced_ids, K)
        view_tokens = self.condition_views(
            emb_k.reshape(B * K, -1),
            get("cam_params").repeat_interleave(K, dim=0),
            token_k.reshape(B * K))
        image_embf = image_emb.repeat_interleave(K, dim=0)

        distinct = (cfg.base_token_type == "Gen-Hu-Obj"
                    and cfg.hseg_token_idx != cfg.oseg_token_idx)
        if distinct:
            sh = token_k == cfg.hseg_token_idx
            so = token_k == cfg.oseg_token_idx
            slot_h = valid_k & (sh | (is_h[:, None] & ~so))
            slot_oa = valid_k & is_oa[:, None] & ~sh
            slot_oc = valid_k & is_oc[:, None] & ~sh
        else:
            slot_h = valid_k & is_h[:, None]
            slot_oa = valid_k & is_oa[:, None]
            slot_oc = valid_k & is_oc[:, None]
        slot_o = slot_oa | slot_oc

        if cfg.use_diff_decoder:
            low = self.routed_view_masks(image_embf, view_tokens,
                                         slot_h.reshape(B * K),
                                         slot_o.reshape(B * K))
        else:
            low = self.decode_view_masks(image_embf, view_tokens)

        gt = get("gt_masks")  # (B, K, V, H, W)
        pred = self.upsample_masks(low, gt.shape[-1])  # (B*K, V, H, W)
        validf = valid_k.reshape(B * K)
        pred = torch.where(validf[:, None, None, None], pred, 0.0)
        is_heatmap = slot_oa.reshape(B * K)
        pred_for_loss = torch.where(is_heatmap[:, None, None, None],
                                    torch.sigmoid(pred), pred)
        slot_gt = get("seg_slot_has_mask").bool()
        mask_bce, mask_dice, mask_l2 = L.combined_mask_losses(
            pred_for_loss, gt.reshape((B * K,) + gt.shape[2:]), is_heatmap,
            (valid_k & slot_gt).reshape(B * K), cfg.bce_loss_weight,
            cfg.bce_loss_alpha, cfg.dice_loss_weight, cfg.dice_loss_scale,
            n_rows=B)

        pred_k = pred.reshape((B, K) + pred.shape[1:])
        wh = slot_h.to(pred.dtype)[..., None, None, None]
        wo = slot_o.to(pred.dtype)[..., None, None, None]
        # at most one human and one object slot a K = 2 Gen-Hu-Obj row: the
        # sum selects that slot's prediction. The 3D targets are per row,
        # routed by task, so each loss also needs the matching slot.
        hC, oA, oC = self._lift_losses(
            batch, get, (pred_k * wh).sum(1), (pred_k * wo).sum(1),
            is_h & slot_h.any(1), is_oa & slot_oa.any(1),
            is_oc & slot_oc.any(1))
        return self._results(ce_loss, mask_bce, mask_dice, mask_l2, hC, oA,
                             oC, pred_k)

    def low_res_masks_from_image_emb(self, seg_hidden, token_id, image_emb,
                                     cam_params, domain: Optional[str] = None):
        """Inference tail from a precomputed SAM embedding (B|1, V, g, g, C):
        the hcontact views are fixed renders, so their embedding is a
        constant that can be encoded once (object views are per-sample
        renders and keep the streaming encode). ``token_id`` routes the
        splitter; ``domain`` selects the DifDe decoder."""
        emb = self.text_hidden_fcs(seg_hidden)
        view_tokens = self.condition_views(emb, cam_params, token_id)
        B = seg_hidden.shape[0]
        if image_emb.shape[0] == 1 and B > 1:
            image_emb = image_emb.expand((B,) + image_emb.shape[1:])
        return self.decode_view_masks(image_emb, view_tokens, domain)

    def low_res_masks_from_seg_hidden(self, seg_hidden, token_id, sam_images,
                                      cam_params,
                                      domain: Optional[str] = None):
        return self.low_res_masks_from_image_emb(
            seg_hidden, token_id, self.encode_sam_images(sam_images),
            cam_params, domain)

    def masks_from_seg_hidden(self, seg_hidden, token_id, sam_images,
                              cam_params, mask_size: int,
                              domain: Optional[str] = None):
        return self.upsample_masks(
            self.low_res_masks_from_seg_hidden(seg_hidden, token_id,
                                               sam_images, cam_params,
                                               domain),
            mask_size)


def lift_human(pred_masks, p2v3, bary3, num_vertices: int):
    """(B, V, H, W) logits -> (B, N) contact probabilities; corner-major
    (3, V, H, W) maps shared across the batch."""
    return torch.stack([lift_multiview_soft(m, p2v3, bary3, num_vertices)
                        for m in pred_masks])


def lift_object(pred_masks, p2v3, bary3, num_vertices: int,
                threshold: float = 0.3):
    """(B, V, H, W) logits -> (B, N) thresholded object lifts on one
    object's corner-major (3, V, H, W) maps (the demo's object path)."""
    return torch.stack([lift_multiview_thresholded(m, p2v3, bary3,
                                                   num_vertices, threshold)
                        for m in pred_masks])
