"""Datagen CLI (reference ``scripts/run_datagen.sh`` ->
``preprocess_data/generate_*`` drivers); the port of
``interactvlm_tpu/datagen/__main__.py``, with its flags and defaults, plus
``--device`` (the card unless ``cpu``).

Usage:
  python -m interactvlm_tpu_torch.datagen damon --root ./data \
      --contact_pkl damon_contact.pkl --mesh body.npz --segm merged_segm.pkl
  python -m interactvlm_tpu_torch.datagen lemon-hu --root ./data \
      --contact_pkl lemon_contacts.pkl --mesh body.npz --segm merged_segm.pkl
  python -m interactvlm_tpu_torch.datagen rich  ... (same args as damon)
  python -m interactvlm_tpu_torch.datagen piad --root ./data \
      --points_dir piad_txt/ [--dataset piad|lemon] [--affordance sit]
  python -m interactvlm_tpu_torch.datagen pico --root ./data \
      --meshes_pkl pico.pkl
  (any of them with --device cpu to run on the CPU)

Input formats:
  --mesh        npz with ``verts`` (N, 3) f32 and ``faces`` (F, 3) i32
                (a posed Vitruvian body; see datagen.generate.vitruvian_pose)
  --contact_pkl damon/rich: {image: {obj: vertex ids}} / {image: ids}
                lemon-hu: {image_relpath: per-vertex contact (N,)}
  --segm        merged SMPL segmentation {part: vertex ids}
  --meshes_pkl  pico: {object_id: {verts, faces, contact, image, class_name}}

Prints one line of counts, as the JAX CLI does; returns the recipe's
output.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from interactvlm_tpu_torch.utils.device import resolve_device


def _load_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def parse_args(argv=None):
    p = argparse.ArgumentParser("interactvlm_tpu_torch datagen")
    p.add_argument("recipe",
                   choices=["damon", "lemon-hu", "rich", "piad", "pico"])
    p.add_argument("--root", required=True)
    p.add_argument("--contact_pkl")
    p.add_argument("--mesh")
    p.add_argument("--segm")
    p.add_argument("--points_dir")
    p.add_argument("--meshes_pkl")
    p.add_argument("--dataset", default="piad", choices=["piad", "lemon"])
    p.add_argument("--affordance", default="sit")
    p.add_argument("--split", default="train")
    p.add_argument("--view_type", default=None)
    p.add_argument("--image_size", type=int, default=1024)
    p.add_argument("--min_vertices", type=int, default=2)
    p.add_argument("--device", default="cuda",
                   help="where the rasterizers run: the card unless 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)

    from interactvlm_tpu_torch.datagen import recipes as R
    from interactvlm_tpu_torch.geometry.views import HUMAN_VIEWS, OBJECT_VIEWS

    if args.recipe in ("damon", "lemon-hu", "rich"):
        view = HUMAN_VIEWS[args.view_type or "4MV-Z_Vitru_mv2"]
        mesh = np.load(args.mesh)
        verts, faces = mesh["verts"], mesh["faces"]
        segm = _load_pickle(args.segm)
        contacts = _load_pickle(args.contact_pkl)
        if args.recipe == "damon":
            out = R.generate_damon_tree(
                args.root, contacts, verts, faces, view, args.image_size,
                segm, args.min_vertices, device=dev)
            print(f"damon: {len(out['annot'])} images")
        elif args.recipe == "rich":
            out = R.generate_rich_tree(
                args.root, contacts, verts, faces, view, args.image_size,
                segm, args.min_vertices, device=dev)
            print(f"rich: {len(out['annot'])} images")
        else:
            out = R.generate_lemon_human_tree(
                args.root, contacts, verts, faces, view, args.image_size,
                segm, split=args.split, min_vertices=args.min_vertices,
                device=dev)
            print(f"lemon-hu: {len(out['images'])} images")
        return out
    if args.recipe == "piad":
        view = OBJECT_VIEWS[args.view_type or "4MV-Z_HM"]
        files = {
            os.path.splitext(f)[0]: os.path.join(args.points_dir, f)
            for f in sorted(os.listdir(args.points_dir))
            if f.endswith(".txt")
        }
        recs = R.generate_piad_tree(
            args.root, files, view, args.image_size, split=args.split,
            dataset=args.dataset, affordance=args.affordance, device=dev)
        print(f"{args.dataset}: {len(recs)} objects")
        return recs
    view = OBJECT_VIEWS[args.view_type or "4MV-Z_HM_BM"]
    meshes = _load_pickle(args.meshes_pkl)
    recs = R.generate_pico_tree(
        args.root, meshes, view, args.image_size, split=args.split,
        min_vertices=args.min_vertices, device=dev)
    print(f"pico: {len(recs)} objects")
    return recs


if __name__ == "__main__":
    main()
