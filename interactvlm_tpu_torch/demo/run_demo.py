"""End-user inference CLI.

Port of ``interactvlm_tpu/demo/run_demo.py`` (the reference's
``run_demo.py``): per-image 3D contact prediction in the hcontact /
h2dcontact / oafford / ocontact modes with the reference's fixed prompts
(run_demo.py:217,254,282), canonical-view SAM preprocessing, and the output
bundle (contact npz with the SMPL-X transfer, contact-coloured OBJ, 2 x 2
overlay grid, the original-frame mask of h2dcontact).

    python -m interactvlm_tpu_torch.demo.run_demo --img_folder <dir>
        --output_folder <dir> [--contact_type hcontact] [--random_weights]
        [--model_dir <dir>] [--sam_renders_dir <dir>] [--human_maps <npz>]
        [--smpl_to_smplx <pkl>] [--body_template <obj>] [--device cpu]

``load_model`` builds the model and tokenizer, ``run_images`` runs the
per-image loop on them; ``main`` does both. ``--random_weights`` takes the
tiny preset with seeded weights (drawn on the CPU, so that every device
gets the same ones) and the whitespace tokenizer, for runs without a
released checkpoint. It runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from os.path import basename, join, splitext

import numpy as np
import torch

HCONTACT_PROMPT = (
    "Segment the area on the human's body that is in direct contact with "
    "the {object} in this image."
)
H2D_PROMPT = HCONTACT_PROMPT
OAFFORD_PROMPT = (
    "Segment the area on the {class_name} where the human is making direct "
    "contact in this image."
)
OBJECT_VIEW_TYPE = "4MV-Z_HM_MeshInf"


def parse_args(argv=None):
    p = argparse.ArgumentParser("interactvlm_tpu_torch demo")
    p.add_argument("--img_folder", required=True)
    p.add_argument("--output_folder", required=True)
    p.add_argument("--contact_type", default="hcontact",
                   choices=["hcontact", "h2dcontact", "oafford", "ocontact"])
    p.add_argument("--model_dir", default=None,
                   help="converted/merged HF checkpoint dir")
    p.add_argument("--sam_renders_dir", default=None,
                   help="canonical human renders (hcontact mode)")
    p.add_argument("--human_maps", default=None,
                   help="npz with p2v/bary lift maps (hcontact mode)")
    p.add_argument("--smpl_to_smplx", default=None,
                   help="mapping pkl for SMPL-X output")
    p.add_argument("--max_new_tokens", type=int, default=32)
    p.add_argument("--random_weights", action="store_true")
    p.add_argument("--mask_size", type=int, default=None)
    p.add_argument("--body_template", default=None,
                   help="OBJ of the body template mesh (SMPL/SMPL-X); "
                        "hcontact mode exports it with contact vertices "
                        "colored (reference process_smplx_mesh_with_"
                        "contacts, run_demo.py:455-462)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    return p.parse_args(argv)


def object_name_from(path: str) -> str:
    # reference: '<object>__<id>.jpg' file naming (run_demo.py:215)
    return basename(path).split("__")[0].lower()


def build_prompt(args, image_path: str) -> str:
    from interactvlm_tpu_torch.data.conversations import (
        get_conversation_template,
    )
    from interactvlm_tpu_torch.utils.constants import DEFAULT_IMAGE_TOKEN

    name = object_name_from(image_path)
    if args.contact_type in ("hcontact", "h2dcontact"):
        q = HCONTACT_PROMPT.format(object=name)
    else:
        q = OAFFORD_PROMPT.format(class_name=name)
    conv = get_conversation_template("llava_v1")
    conv.append_message(conv.roles[0], DEFAULT_IMAGE_TOKEN + "\n" + q)
    conv.append_message(conv.roles[1], None)
    return conv.get_prompt()


def load_model(args):
    """(model, tokenizer) on ``args.device``: the tiny preset with seeded
    weights under ``--random_weights``, else the 13B preset with the
    merged checkpoint of ``--model_dir`` (its token tables grown for the
    seg tokens)."""
    from interactvlm_tpu_torch import config as cfgs
    from interactvlm_tpu_torch.models.interactvlm import InteractVLM
    from interactvlm_tpu_torch.utils.device import resolve_device
    from interactvlm_tpu_torch.utils.weights import init_params

    dev = resolve_device(args.device)
    bf16 = torch.bfloat16
    if args.random_weights:
        from interactvlm_tpu_torch.utils.testing import WhitespaceTokenizer

        cfg = cfgs.interactvlm_tiny()
        tokenizer = WhitespaceTokenizer()
        tokenizer.vocab["[SEG]"] = cfg.seg_token_idx
        weights = init_params(InteractVLM(cfg, device="cpu"),
                              torch.Generator().manual_seed(0)).state_dict()
        if dev.type == "cuda":  # the SAM kernels take bf16
            cfg = dataclasses.replace(cfg, sam=cfgs.sam_tiny(dtype=bf16))
        model = InteractVLM(cfg, device=dev)
        model.load_state_dict(weights)
    else:
        from transformers import AutoTokenizer

        from interactvlm_tpu_torch.utils.constants import add_new_tokens
        from interactvlm_tpu_torch.utils.weights import (
            load_torch_state_dict,
            port_keys_of_merged,
            resize_token_tables,
        )

        cfg = cfgs.interactvlm_13b()
        tokenizer = AutoTokenizer.from_pretrained(args.model_dir)
        tokenizer, seg, hseg, oseg = add_new_tokens(tokenizer, cfg.token_type)
        llama = dataclasses.replace(cfg.llama, vocab_size=len(tokenizer))
        towers = {}
        if dev.type == "cuda":  # the SAM kernels take bf16
            towers = dict(clip=cfgs.clip_vit_l_14(dtype=llama.dtype),
                          sam=cfgs.sam_vit_h(dtype=llama.dtype))
        cfg = dataclasses.replace(cfg, llama=llama, seg_token_idx=seg,
                                  hseg_token_idx=hseg, oseg_token_idx=oseg,
                                  **towers)
        sd = port_keys_of_merged(load_torch_state_dict(
            join(args.model_dir, "pytorch_model.bin")))
        resize_token_tables(sd, llama.vocab_size)
        model = InteractVLM(cfg, device=dev)
        missing, unexpected = model.load_state_dict(sd, strict=False)
        print(f"checkpoint: {len(missing)} parameters missing, "
              f"{len(unexpected)} entries unused")
    return model.eval().requires_grad_(False), tokenizer


def _load_views(render_dir, names, S):
    """The raw renders (V, H, W, 3) uint8 and their SAM inputs (1, V, S, S,
    3)."""
    from interactvlm_tpu_torch.data.transforms import (
        load_image_rgb,
        sam_preprocess,
    )

    raws = [load_image_rgb(join(render_dir, f"{n}.png")) for n in names]
    return (np.stack(raws),
            np.stack([sam_preprocess(r, S)[0] for r in raws])[None])


def _host(x):
    return x.float().cpu().numpy()


def run_images(model, tokenizer, args):
    """The demo's per-image loop on a built model: each image of
    ``args.img_folder`` through ``evaluate_batch`` with the contact type's
    prompt and views, its output bundle written to ``args.output_folder``
    under the JAX package's file names. Returns [{image, has_seg}]."""
    from PIL import Image

    from interactvlm_tpu_torch.data.tokenization import (
        tokenizer_image_token,
        wrap_image_tokens,
    )
    from interactvlm_tpu_torch.data.transforms import (
        clip_preprocess,
        load_image_rgb,
        sam_preprocess,
    )
    from interactvlm_tpu_torch.demo import demo_utils
    from interactvlm_tpu_torch.eval.evaluate import evaluate_batch
    from interactvlm_tpu_torch.fit.data_io import load_obj_mesh
    from interactvlm_tpu_torch.geometry.lift import corner_major
    from interactvlm_tpu_torch.geometry.views import (
        HUMAN_VIEWS,
        OBJECT_VIEWS,
        normalize_cam_params,
    )
    from interactvlm_tpu_torch.utils.constants import IGNORE_INDEX

    cfg = model.config
    os.makedirs(args.output_folder, exist_ok=True)
    mask_size = args.mask_size or (64 if args.random_weights else 1024)
    V, S = cfg.multiview_channels, cfg.sam.img_size
    ctype = args.contact_type

    # canonical human views and lift maps
    human_maps = sam_views = fixed_renders = None
    cam_params = np.zeros((1, V, 5), np.float32)
    if ctype == "hcontact":
        vs = HUMAN_VIEWS[cfg.hC_sam_view_type]
        cam_params = normalize_cam_params(vs.cam_params())[None]
        if args.sam_renders_dir:
            fixed_renders, sam_views = _load_views(args.sam_renders_dir,
                                                   vs.names, S)
        if args.human_maps:
            m = np.load(args.human_maps)
            human_maps = {
                "p2v": torch.from_numpy(corner_major(np.asarray(m["p2v"]))),
                "bary": torch.from_numpy(corner_major(np.asarray(m["bary"]))),
                "num_vertices": int(m["p2v"].max()) + 1}
    mapping = None

    images = sorted(f for f in os.listdir(args.img_folder)
                    if f.lower().endswith((".jpg", ".jpeg", ".png")))
    results = []
    for fname in images:
        path = join(args.img_folder, fname)
        stem = splitext(fname)[0]
        prompt = wrap_image_tokens(build_prompt(args, path))
        ids = np.asarray([tokenizer_image_token(prompt, tokenizer)],
                         np.int32)
        clip_img = clip_preprocess(load_image_rgb(path),
                                   cfg.clip.image_size)[None]

        meta = obj_mesh = None
        raw_renders = fixed_renders
        if ctype in ("oafford", "ocontact"):
            obj_dir = join(os.path.dirname(path), "sam_inp_objs")
            obj_mesh = load_obj_mesh(join(os.path.dirname(path),
                                          "object_mesh.obj"))
            if not os.path.exists(join(obj_dir, "lift2d_dict.pkl")):
                demo_utils.generate_sam_inp_objs(
                    *obj_mesh, obj_dir, image_size=mask_size,
                    device=model.device)
            maps_kw = {"object_maps": demo_utils.load_lift2d_dict(
                join(obj_dir, "lift2d_dict.pkl"))}
            ovs = OBJECT_VIEWS[OBJECT_VIEW_TYPE]
            raw_renders, sam_imgs = _load_views(obj_dir, ovs.names, S)
            cams = normalize_cam_params(ovs.cam_params())[None]
        elif ctype == "h2dcontact":
            # SAM runs on the photo itself; the mask is scored in the
            # original frame (evaluate_batch's meta path)
            raw = load_image_rgb(path)
            t, resize = sam_preprocess(raw, S)
            sam_imgs = np.repeat(t[None], V, axis=0)[None]
            raw_renders = None
            cams = np.zeros((1, V, 5), np.float32)
            meta = {"resize_list": [resize],
                    "label_list": [np.zeros(raw.shape[:2], np.float32)]}
            maps_kw = {}
        else:
            sam_imgs = (sam_views if sam_views is not None
                        else np.zeros((1, V, S, S, 3), np.float32))
            cams = cam_params
            maps_kw = {"human_maps": human_maps}

        batch = {"input_ids": ids,
                 # all-IGNORE labels: no answer-start truncation at demo time
                 "labels": np.full_like(ids, IGNORE_INDEX),
                 "images_clip": torch.from_numpy(clip_img),
                 "sam_images": torch.from_numpy(sam_imgs),
                 "cam_params": torch.from_numpy(np.asarray(cams,
                                                           np.float32))}
        out = evaluate_batch(model, batch, mask_size, contact_type=ctype,
                             max_new_tokens=args.max_new_tokens, meta=meta,
                             **maps_kw)
        pm = _host(out["pred_masks"][0])  # (V, h, w) logits
        np.save(join(args.output_folder, f"{stem}_pred_masks.npy"), pm)

        # ---- the output bundle (reference run_demo.py:436-558) ----
        probs = 1.0 / (1.0 + np.exp(-pm))
        if raw_renders is not None and probs.shape[0] >= 4:
            # 2 x 2 mask-overlay grid over the view renders
            Hr, Wr = raw_renders.shape[1:3]
            masks_r = np.stack([
                np.asarray(Image.fromarray((p * 255).astype(np.uint8)).resize(
                    (Wr, Hr), Image.BILINEAR), np.float32) / 255.0
                for p in probs[:4]])
            grid = demo_utils.overlay_grid(raw_renders[:4], masks_r)
            Image.fromarray(grid).save(join(
                args.output_folder, f"{stem}_{ctype}_concat.jpg"))
        if out["pred_masks_original"] is not None:
            # h2dcontact: the mask in the photo's frame, and its overlay
            om = _host(out["pred_masks_original"][0])
            np.save(join(args.output_folder,
                         f"{stem}_pred_mask_original.npy"), om)
            photo = load_image_rgb(path)
            over = demo_utils.overlay_grid(
                photo[None], (1.0 / (1.0 + np.exp(-om)))[None])
            Image.fromarray(over[: photo.shape[0], : photo.shape[1]]).save(
                join(args.output_folder, f"{stem}_h2dcontact_overlay.jpg"))
        if out["pred_contact_3d"] is not None:
            contact = _host(out["pred_contact_3d"][0])
            save = {"contact": contact}
            if args.smpl_to_smplx and ctype == "hcontact":
                if mapping is None:
                    mapping = demo_utils.load_smpl_to_smplx_mapping(
                        args.smpl_to_smplx)
                save["contact_smplx"] = (
                    demo_utils.convert_contacts_smpl_to_smplx(contact,
                                                              mapping))
            np.savez(join(args.output_folder,
                          f"{stem}_{ctype}_vertices.npz"), **save)
            # contact-coloured OBJ (reference run_demo.py:455-478)
            if ctype in ("oafford", "ocontact") and obj_mesh:
                demo_utils.export_contact_obj(
                    join(args.output_folder,
                         f"{stem}_object_mesh_with_contacts_{ctype}.obj"),
                    obj_mesh[0], obj_mesh[1], contact[: len(obj_mesh[0])],
                    threshold=0.5)
            elif ctype == "hcontact" and args.body_template:
                bv, bf = load_obj_mesh(args.body_template)
                body_contact = save.get("contact_smplx", contact)
                if len(bv) == np.asarray(body_contact).size:
                    demo_utils.export_contact_obj(
                        join(args.output_folder,
                             f"{stem}_body_with_hcontacts.obj"),
                        bv, bf, body_contact, threshold=0.3)
                else:
                    print(f"body_template has {len(bv)} verts, contact "
                          f"{np.asarray(body_contact).size}; skipping OBJ")
        has_seg = bool(out["has_seg"][0])
        results.append({"image": fname, "has_seg": has_seg})
        print(f"{fname}: seg={has_seg}")
    print(f"demo done: {len(results)} images -> {args.output_folder}")
    return results


def main(argv=None):
    from interactvlm_tpu_torch.runtime.hostmem import tune_host_allocator

    args = parse_args(argv)
    tune_host_allocator()
    model, tokenizer = load_model(args)
    return run_images(model, tokenizer, args)


if __name__ == "__main__":
    main()
