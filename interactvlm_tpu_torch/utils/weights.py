"""Weights of the PyTorch port: seeded initialisation on the device,
conversion of the JAX package's flax parameter trees, and the int8 and int4
serving and QLoRA training layouts.

The port's parameter names are the reference's torch checkpoint keys (HF
LLaMA / CLIP, the SAM ``.pth``, the merged InteractVLM checkpoint), so
``from_jax_params`` is the inverse of ``interactvlm_tpu/utils/weights.py``'s
converters: Dense ``kernel`` (in, out) -> ``weight`` (out, in); Conv HWIO ->
OIHW; ConvTranspose taps flipped back to torch's (in, out, kh, kw);
LayerNorm ``scale`` -> ``weight``; Embed ``embedding`` -> ``weight``. An
int8 Dense (``kernel_q`` (in, out) int8, ``kernel_scale`` (1, out) f32)
becomes ``weight`` (out, in) int8 and ``weight_scale`` (out,) f32; an int4
Dense (``kernel_q4`` (in/2, out), ``kernel_scale``, ``kernel_rf`` (in,))
becomes ``weight_q4`` (out, in/2), ``weight_scale`` and ``weight_rf``. A
LoRA Dense (``base/kernel``, or ``base/kernel_q`` for QLoRA, ``lora_a``
(in, r), ``lora_b`` (r, out)) becomes ``weight`` (and ``weight_scale``),
``lora_A.weight`` (r, in) and ``lora_B.weight`` (out, r).
Applied to a gradient tree of the JAX package, ``from_jax_params`` gives the
gradients under the port's names.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn as nn

from interactvlm_tpu_torch.models.layers import (
    Int4Linear,
    Int8Linear,
    LoraFactor,
    full_in_features,
)
from interactvlm_tpu_torch.models.llama import RMSNorm
from interactvlm_tpu_torch.ops.quant import quantize_int4, quantize_int8


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights, drawn on the parameters' own device: norm
    scales 1, biases 0, Linear/Conv weights lecun-normal (std
    fan_in^-1/2, as flax initialises them), int8 weights uniform integers
    in [-127, 127] with scales 1 / (127 fan_in^1/2) (the JAX package's
    ``Int8Dense`` init, QLoRA's base included), packed int4 weights the
    same bytes (two random nibbles each) with scales 1 / (7 fan_in^1/2)
    and row factors 1 (``Int4Dense``), every other parameter (embeddings, tokens,
    positional and rel-pos tables) N(0, 0.02), the SAM Fourier matrix
    N(0, 1), LoRA A N(0, 0.02) and LoRA B 0 (the JAX package's
    ``LoraDense``).

    A layer split over the model axis (``models/layers.py:shard_layer``)
    draws each of its parameters whole and keeps its rank's block
    (``parallel/mesh.py:shard_tensor``, by the parameter's name in the
    partition table), so every layout holds the unsharded model's weights
    and the generator moves as it does for the unsharded model. Such a
    layer's names must be in the table: call this on the whole LLaMA or
    the model that holds it."""
    from interactvlm_tpu_torch.parallel.mesh import full_shape, shard_tensor

    for prefix, mod in module.named_modules():
        tp = getattr(mod, "tp", None)
        for leaf, p in mod.named_parameters(recurse=False):
            if tp is None:
                _draw(mod, leaf, p, generator)
                continue
            name = f"{prefix}.{leaf}" if prefix else leaf
            full = torch.empty(full_shape(name, p.shape, tp.n),
                               dtype=p.dtype, device=p.device)
            _draw(mod, leaf, full, generator)
            p.copy_(shard_tensor(name, full, tp.n, tp.index))
        for leaf, b in mod.named_buffers(recurse=False):
            if leaf == "positional_encoding_gaussian_matrix":
                b.normal_(0.0, 1.0, generator=generator)
    return module


def _draw(mod, leaf: str, p, generator) -> None:
    """One parameter's draw of ``init_params`` (``p`` unsharded)."""
    fan_in = getattr(mod, "in_features", 0)
    if isinstance(mod, (Int8Linear, Int4Linear)):
        fan_in = full_in_features(mod)
    if isinstance(mod, LoraFactor):
        if mod.init_std:
            p.normal_(0.0, mod.init_std, generator=generator)
        else:
            p.zero_()
    elif isinstance(mod, Int8Linear) and leaf == "weight":
        p.random_(-127, 128, generator=generator)
    elif isinstance(mod, Int8Linear) and leaf == "weight_scale":
        p.fill_(1.0 / (127.0 * fan_in ** 0.5))
    elif isinstance(mod, Int4Linear):
        if leaf == "weight_q4":
            p.random_(-127, 128, generator=generator)
        elif leaf == "weight_scale":
            p.fill_(1.0 / (7.0 * fan_in ** 0.5))
        else:  # weight_rf
            p.fill_(1.0)
    elif isinstance(mod, (nn.LayerNorm, RMSNorm)) and leaf == "weight":
        p.fill_(1.0)
    elif leaf == "bias":
        p.zero_()
    elif isinstance(mod, nn.ConvTranspose2d):
        fan_in = p.shape[0] * p.shape[2] * p.shape[3]
        p.normal_(0.0, fan_in ** -0.5, generator=generator)
    elif isinstance(mod, (nn.Linear, nn.Conv2d)):
        p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)
    else:
        p.normal_(0.0, 0.02, generator=generator)


def _t(x) -> torch.Tensor:
    return torch.tensor(np.array(x, np.float32))


def linear_weight_from_jax(kernel, dtype=torch.float32) -> torch.Tensor:
    """A JAX Dense kernel (K, N) -> the port's weight (N, K) in ``dtype``
    (exact for a bf16 kernel, which passes through f32)."""
    return _t(np.asarray(kernel).T).to(dtype)


def int8_weight_from_jax(kernel_q, kernel_scale):
    """A JAX int8 weight (K, N) with per-column scales (1, N) -> the port's
    int8 (N, K) and f32 (N,), the same bytes and scales."""
    q = np.asarray(kernel_q)
    if q.dtype != np.int8:
        raise ValueError(f"kernel_q: expected int8, got {q.dtype}")
    return (torch.from_numpy(np.ascontiguousarray(q.T)),
            _t(np.asarray(kernel_scale).reshape(-1)))


def _dense(node, prefix, sd):
    if "lora_a" in node:  # LoraDense: {base: {kernel}, lora_a, lora_b}
        _dense(node["base"], prefix, sd)
        sd[prefix + "lora_A.weight"] = _t(np.asarray(node["lora_a"]).T)
        sd[prefix + "lora_B.weight"] = _t(np.asarray(node["lora_b"]).T)
    elif "int8" in node:  # the SAM encoder's int8 layout: {int8: {...}, bias}
        _dense(node["int8"], prefix, sd)
    elif "kernel_q" in node:
        sd[prefix + "weight"], sd[prefix + "weight_scale"] = \
            int8_weight_from_jax(node["kernel_q"], node["kernel_scale"])
    elif "kernel_q4" in node:  # Int4Dense: packed (K/2, N), (1, N), (K,)
        sd[prefix + "weight_q4"], sd[prefix + "weight_scale"] = \
            int8_weight_from_jax(node["kernel_q4"], node["kernel_scale"])
        sd[prefix + "weight_rf"] = _t(node["kernel_rf"])
    else:
        sd[prefix + "weight"] = linear_weight_from_jax(node["kernel"])
    if "bias" in node:
        sd[prefix + "bias"] = _t(node["bias"])


def _conv(node, prefix, sd):
    sd[prefix + "weight"] = _t(np.asarray(node["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in node:
        sd[prefix + "bias"] = _t(node["bias"])


def _conv_transpose(node, prefix, sd):
    # flax (kh, kw, in, out) with flipped taps -> torch (in, out, kh, kw)
    w = np.asarray(node["kernel"]).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    sd[prefix + "weight"] = _t(w)
    if "bias" in node:
        sd[prefix + "bias"] = _t(node["bias"])


def _ln(node, prefix, sd):
    sd[prefix + "weight"] = _t(node["scale"])
    sd[prefix + "bias"] = _t(node["bias"])


def _indexed(node, stem):
    """{stem_0: a, stem_1: b, ...} -> [(0, a), (1, b), ...]."""
    out = []
    for name, child in node.items():
        if name.startswith(stem + "_") and name[len(stem) + 1:].isdigit():
            out.append((int(name[len(stem) + 1:]), child))
    return sorted(out, key=lambda x: x[0])


def _llama(t, prefix, sd):
    m = t["model"]
    sd[prefix + "model.embed_tokens.weight"] = _t(m["embed_tokens"]["embedding"])
    sd[prefix + "model.norm.weight"] = _t(m["norm"]["weight"])
    _dense(t["lm_head"], prefix + "lm_head.", sd)
    for i, layer in _indexed(m, "layer"):
        p = f"{prefix}model.layers.{i}."
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _dense(layer["self_attn"][proj], f"{p}self_attn.{proj}.", sd)
        for proj in ("gate_proj", "up_proj", "down_proj"):
            _dense(layer["mlp"][proj], f"{p}mlp.{proj}.", sd)
        for norm in ("input_layernorm", "post_attention_layernorm"):
            sd[f"{p}{norm}.weight"] = _t(layer[norm]["weight"])


def _clip(t, prefix, sd):
    p = prefix + "vision_model."
    _conv(t["patch_embedding"], p + "embeddings.patch_embedding.", sd)
    sd[p + "embeddings.class_embedding"] = _t(t["class_embedding"])
    sd[p + "embeddings.position_embedding.weight"] = _t(t["position_embedding"])
    _ln(t["pre_layrnorm"], p + "pre_layrnorm.", sd)
    for i, layer in _indexed(t, "layer"):
        lp = f"{p}encoder.layers.{i}."
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense(layer["self_attn"][proj], f"{lp}self_attn.{proj}.", sd)
        _ln(layer["layer_norm1"], lp + "layer_norm1.", sd)
        _ln(layer["layer_norm2"], lp + "layer_norm2.", sd)
        _dense(layer["fc1"], lp + "mlp.fc1.", sd)
        _dense(layer["fc2"], lp + "mlp.fc2.", sd)


def _sam_attention(node, prefix, sd):
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _dense(node[proj], f"{prefix}{proj}.", sd)


def _sam(t, prefix, sd):
    e, p = t["image_encoder"], prefix + "image_encoder."
    _conv(e["patch_embed"], p + "patch_embed.proj.", sd)
    sd[p + "pos_embed"] = _t(e["pos_embed"])
    for i, blk in _indexed(e, "block"):
        bp = f"{p}blocks.{i}."
        _ln(blk["norm1"], bp + "norm1.", sd)
        _ln(blk["norm2"], bp + "norm2.", sd)
        _dense(blk["attn"]["qkv"], bp + "attn.qkv.", sd)
        _dense(blk["attn"]["proj"], bp + "attn.proj.", sd)
        sd[bp + "attn.rel_pos_h"] = _t(blk["attn"]["rel_pos_h"])
        sd[bp + "attn.rel_pos_w"] = _t(blk["attn"]["rel_pos_w"])
        _dense(blk["mlp"]["lin1"], bp + "mlp.lin1.", sd)
        _dense(blk["mlp"]["lin2"], bp + "mlp.lin2.", sd)
    _conv(e["neck_conv1"], p + "neck.0.", sd)
    _ln(e["neck_ln1"], p + "neck.1.", sd)
    _conv(e["neck_conv2"], p + "neck.2.", sd)
    _ln(e["neck_ln2"], p + "neck.3.", sd)

    pe, p = t["prompt_encoder"], prefix + "prompt_encoder."
    sd[p + "pe_layer.positional_encoding_gaussian_matrix"] = _t(
        pe["pe_layer"]["gaussian_matrix"])
    for i in range(4):
        sd[f"{p}point_embeddings.{i}.weight"] = _t(pe[f"point_embed_{i}"])[None]
    sd[p + "not_a_point_embed.weight"] = _t(pe["not_a_point_embed"])[None]
    sd[p + "no_mask_embed.weight"] = _t(pe["no_mask_embed"])[None]
    for j, layer in _indexed(pe.get("mask_downscaling", {}), "layers"):
        conv = "kernel" in layer
        (_conv if conv else _ln)(layer, f"{p}mask_downscaling.{j}.", sd)

    for name in ("mask_decoder", "human_mask_decoder", "object_mask_decoder"):
        if name in t:
            _mask_decoder(t[name], f"{prefix}{name}.", sd)


def _mask_decoder(d, p, sd):
    sd[p + "iou_token.weight"] = _t(d["iou_token"])
    sd[p + "mask_tokens.weight"] = _t(d["mask_tokens"])
    _conv_transpose(d["upscale_conv1"], p + "output_upscaling.0.", sd)
    _ln(d["upscale_ln"], p + "output_upscaling.1.", sd)
    _conv_transpose(d["upscale_conv2"], p + "output_upscaling.3.", sd)
    for j, layer in _indexed(d["iou_prediction_head"], "layer"):
        _dense(layer, f"{p}iou_prediction_head.layers.{j}.", sd)
    for i, mlp in _indexed(d, "hyper_mlp"):
        for j, layer in _indexed(mlp, "layer"):
            _dense(layer, f"{p}output_hypernetworks_mlps.{i}.layers.{j}.", sd)
    tr, tp = d["transformer"], p + "transformer."
    for i, blk in _indexed(tr, "layer"):
        bp = f"{tp}layers.{i}."
        for att in ("self_attn", "cross_attn_token_to_image",
                    "cross_attn_image_to_token"):
            _sam_attention(blk[att], f"{bp}{att}.", sd)
        for norm in ("norm1", "norm2", "norm3", "norm4"):
            _ln(blk[norm], f"{bp}{norm}.", sd)
        _dense(blk["mlp"]["lin1"], bp + "mlp.lin1.", sd)
        _dense(blk["mlp"]["lin2"], bp + "mlp.lin2.", sd)
    _sam_attention(tr["final_attn_token_to_image"],
                   tp + "final_attn_token_to_image.", sd)
    _ln(tr["norm_final_attn"], tp + "norm_final_attn.", sd)


def _llava(t, prefix, sd):
    _clip(t["vision_tower"], prefix + "vision_tower.", sd)
    _dense(t["mm_projector"], prefix + "mm_projector.", sd)
    _llama(t["lm"], prefix + "lm.", sd)


HEADS = ("cam_pose_encoder", "attention_splitter", "fusion", "uncertainty")


def _heads(t, sd):
    """The composite's heads that a tree holds: ``text_hidden_fcs``, and
    each Dense of the others under its JAX name (``linear1``, ``spatial1``,
    ``view_0``, ``query_human``, ``sam_proj`` ...) below the reference's
    attribute name."""
    if "text_hidden_fcs" in t:
        _dense(t["text_hidden_fcs"]["fc1"], "text_hidden_fcs.0.0.", sd)
        _dense(t["text_hidden_fcs"]["fc2"], "text_hidden_fcs.0.2.", sd)
    for head in HEADS:
        for name, node in t.get(head, {}).items():
            _dense(node, f"{head}.{name}.", sd)


def from_jax_params(tree: Dict) -> Dict[str, torch.Tensor]:
    """A flax parameter tree of the JAX package (numpy leaves, boxes
    unwrapped) -> the port's ``state_dict`` (f32 tensors; int8 weights
    stay int8).

    Takes the composite ``InteractVLM`` tree or the tree of one of its
    parts: ``LlavaModel``, ``LlamaForCausalLM``, ``CLIPVisionTower`` or
    ``Sam``. The SAM mask-downscaling convolutions, which the text-prompt
    path never initialises in the JAX package, are absent from the result
    unless the tree has them; so are the uncertainty head's parameters,
    which the JAX package builds and never calls (a port model loaded with
    ``strict=False`` keeps its own values for them, ``init_params``'s draw
    when it made one). Under DifDe the two domain decoders
    (``sam.human_mask_decoder.``, ``sam.object_mask_decoder.``) take
    ``mask_decoder.``'s layout.

    The heads other than ``text_hidden_fcs`` and ``simple``'s
    ``cam_pose_encoder.linear1`` (the two that the JAX package's checkpoint
    converter maps) are named by their JAX parameter names under the
    reference's attribute names: ``attention_splitter.``,
    ``cam_pose_encoder.`` (``view_index`` / ``vi_v1``), ``fusion.`` and
    ``uncertainty.``. Whether the reference checkpoint names them so could
    not be checked without that checkpoint.
    """
    t = tree.get("params", tree)
    sd: Dict[str, torch.Tensor] = {}
    if "llava" in t:
        _llava(t["llava"], "llava.", sd)
        _sam(t["sam"], "sam.", sd)
        _heads(t, sd)
    elif "vision_tower" in t:
        _llava(t, "", sd)
    elif "lm_head" in t:
        _llama(t, "", sd)
    elif "image_encoder" in t:
        _sam(t, "", sd)
    elif "patch_embedding" in t:
        _clip(t, "", sd)
    else:
        raise ValueError(f"unrecognised parameter tree: {sorted(t)}")
    return sd


INT8_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj",
                "gate_proj", "up_proj", "down_proj", "lm_head")
SAM_INT8_TARGETS = ("qkv", "proj", "lin1", "lin2")


def int8_serving_state_dict(sd: Dict[str, torch.Tensor],
                            targets: Sequence[str] = INT8_TARGETS
                            ) -> Dict[str, torch.Tensor]:
    """A port state dict with bf16/f32 LLaMA weights -> the layout of a
    model built with ``LlamaConfig(weights_int8=True)``: each targeted
    ``<name>.weight`` (out, in) becomes int8 ``weight`` plus f32
    ``weight_scale`` (out,), quantized per output column over its inputs.

    The port of ``interactvlm_tpu/utils/weights.py:int8_serving_params``: on
    the same weights it gives the same int8 bytes (transposed to the port's
    (out, in) layout) and the same f32 scales. Like it, it converts every
    target it is given, so pass the LLaMA's entries only.
    """
    return _convert(sd, lambda mod: mod.rpartition(".")[2] in targets, _int8)


def _int8(mod, w):
    q, scale = quantize_int8(w, axis=-1)
    return {mod + ".weight": q, mod + ".weight_scale": scale[:, 0]}


def _int4(mod, w):
    q4, scale, rf = quantize_int4(w)
    return {mod + ".weight_q4": q4, mod + ".weight_scale": scale,
            mod + ".weight_rf": rf}


def _convert(sd, chosen, fmt):
    """Replace each 2-D float ``<mod>.weight`` whose module ``chosen``
    picks by the entries ``fmt(mod, weight)`` makes; keep the rest."""
    out = {}
    for key, t in sd.items():
        mod, _, leaf = key.rpartition(".")
        if leaf == "weight" and chosen(mod) and t.dim() == 2 \
                and t.is_floating_point():
            out.update(fmt(mod, t))
        else:
            out[key] = t
    return out


def int4_serving_state_dict(sd: Dict[str, torch.Tensor],
                            targets: Sequence[str] = INT8_TARGETS
                            ) -> Dict[str, torch.Tensor]:
    """A port state dict with bf16/f32 LLaMA weights -> the layout of a
    model built with ``LlamaConfig(weights_int4=True)``: each targeted
    ``<name>.weight`` (out, in) becomes packed ``weight_q4`` (out, in/2),
    ``weight_scale`` (out,) and ``weight_rf`` (in,) (``ops/quant.py:
    quantize_int4``). The port of ``interactvlm_tpu/utils/weights.py:
    int4_serving_params``, over the same targets: the same bytes, scales and
    row factors. Merge LoRA first, and pass the LLaMA's entries only."""
    return _convert(sd, lambda mod: mod.rpartition(".")[2] in targets, _int4)


QLORA_INT8_TARGETS = ("k_proj", "o_proj", "gate_proj", "up_proj",
                      "down_proj")


def qlora_training_state_dict(sd: Dict[str, torch.Tensor]
                              ) -> Dict[str, torch.Tensor]:
    """A port state dict of a LLaMA with LoRA adapters (bf16/f32) -> the
    QLoRA training layout of ``LlamaConfig(weights_int8=True, lora_rank >
    0)``: the k, o, gate, up and down weights and the base weight of each
    LoRA projection (q and v) become int8 plus per-column scales; the
    adapters, the lm_head and the embeddings stay as they are. The port of
    ``interactvlm_tpu/utils/weights.py:qlora_training_params``, whose
    ``base`` target is here the module that has a ``lora_A.weight``
    beside its ``weight``. Pass the LLaMA's entries only."""
    bases = {k[:-len(".lora_A.weight")] for k in sd
             if k.endswith(".lora_A.weight")}
    return _convert(sd, lambda mod: (mod in bases or mod.rpartition(".")[2]
                                     in QLORA_INT8_TARGETS), _int8)


def int8_sam_encoder_state_dict(sd: Dict[str, torch.Tensor],
                                targets: Sequence[str] = SAM_INT8_TARGETS
                                ) -> Dict[str, torch.Tensor]:
    """A port state dict with a bf16/f32 SAM image encoder -> the layout of
    ``SAMConfig(weights_int8=True)``: the qkv, proj, lin1 and lin2 weights
    become int8 plus per-column scales, their biases stay as they are, and
    convolutions and norms are untouched. The port of
    ``interactvlm_tpu/utils/weights.py:int8_sam_encoder_params`` (same
    bytes and scales, (out, in) layout); pass the image encoder's entries
    only, as the decoder's MLP has linears of the same names."""
    return int8_serving_state_dict(sd, targets)


def merge_lora(sd: Dict[str, torch.Tensor], alpha: float,
               rank: int) -> Dict[str, torch.Tensor]:
    """Fold trained LoRA adapters into their base weights (the reference's
    merge_and_unload deployment step, merge_lora_weights_and_save_hf_model
    .py:152-161; the port of ``interactvlm_tpu/utils/weights.py:merge_lora``):
    each ``<p>.weight`` with ``<p>.lora_A.weight`` (r, in) and
    ``<p>.lora_B.weight`` (out, r) becomes W + (B A) alpha / rank, computed
    in f32 on the host and stored in W's dtype; the adapters' keys go.
    The result loads into the same model built with ``lora_rank=0``."""
    out = {}
    for key, val in sd.items():
        if ".lora_A." in key or ".lora_B." in key:
            continue
        prefix = key[:-len(".weight")] if key.endswith(".weight") else None
        if prefix is not None and f"{prefix}.lora_A.weight" in sd:
            a = sd[f"{prefix}.lora_A.weight"].detach().float().cpu().numpy()
            b = sd[f"{prefix}.lora_B.weight"].detach().float().cpu().numpy()
            w = val.detach().float().cpu().numpy()
            merged = w + (b @ a) * np.float32(alpha / rank)
            out[key] = torch.from_numpy(merged).to(val.dtype)
        else:
            out[key] = val
    return out


def resize_token_tables(sd: Dict[str, torch.Tensor],
                        new_vocab: int) -> Dict[str, torch.Tensor]:
    """Grow the token tables (every ``*embed_tokens.weight`` and
    ``*lm_head.weight``, (vocab, hidden)) for added seg tokens, in place:
    the rows up to ``new_vocab`` get the table's mean row (HF
    ``resize_token_embeddings``, used after ``add_new_tokens``, reference
    train.py:314), the rest zeros up to the next multiple of 128
    (``LlamaConfig.padded_vocab_size``; ``LlamaForCausalLM.logits`` masks
    those ids). Tables already that long stay as they are. The port of
    ``interactvlm_tpu/utils/weights.py:resize_token_tables``."""
    padded = -(-new_vocab // 128) * 128
    for key in [k for k in sd if k.endswith(("embed_tokens.weight",
                                             "lm_head.weight"))]:
        w = sd[key]
        old, dim = w.shape
        if padded <= old:
            continue
        n_real = max(new_vocab - old, 0)
        mean = w.float().mean(dim=0, keepdim=True).to(w.dtype)
        sd[key] = torch.cat([w, mean.expand(n_real, dim),
                             w.new_zeros(padded - old - n_real, dim)])
    return sd


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` / ``.bin`` / ``.safetensors`` state dict as CPU tensors
    under the file's keys (a ``state_dict`` entry is unwrapped)."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.get("state_dict", sd)


# the merged InteractVLM checkpoint's prefixes (the reference's deployment
# format, merge_lora_weights_and_save_hf_model.py:152-161) -> the port's;
# the first that matches renames a key
MERGED_PREFIXES = (("model.mm_projector.", "llava.mm_projector."),
                   ("model.visual_model.", "sam."),
                   ("model.text_hidden_fcs.", "text_hidden_fcs."),
                   ("model.", "llava.lm.model."),
                   ("lm_head.", "llava.lm.lm_head."))


def port_keys_of_merged(sd: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """A merged InteractVLM checkpoint's entries under the port's module
    names (keys of no listed prefix, such as ``cam_pose_encoder.*``, are
    the same in both)."""
    out = {}
    for key, val in sd.items():
        for old, new in MERGED_PREFIXES:
            if key.startswith(old):
                key = new + key[len(old):]
                break
        out[key] = val
    return out
