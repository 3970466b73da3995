"""Host-side IO of the fitting driver and its CLI.

Port of ``interactvlm_tpu/fit/data_io.py`` (the reference's
``optim/data_io.py``): loads the per-sample folder the demo pipeline
produces (the OSX human fit npz with vertices, faces and bbox; the object
mesh OBJ; the predicted contact npz files; the object mask) and assembles
the ``scene`` dict ``fit_human_object`` takes.

The intrinsics follow the reference's OSX convention: a virtual focal
length of 5000 px scaled by the detection bbox (``optim/data_io.py:96-109``,
``optim/constants.py:6-8``).

    python -m interactvlm_tpu_torch.fit.data_io --input_path <dir>
        [--output_path <dir>] [--num_steps 250] [--image_size 512]
        [--no_icp] [--no_scale] [--save_video] [--device cpu]

writes ``final_object.obj``, ``final_human.obj``, ``fit_result.npz`` and,
with ``--save_video``, ``fit_trajectory.gif``; it runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

OSX_VIRTUAL_FOCAL = 5000.0
OSX_INPUT_BODY_SHAPE = (256, 192)


def load_obj_mesh(path: str):
    """Minimal OBJ loader (v / f lines; 1-based indices; polygons
    triangulated by fanning). Returns (verts (N, 3) f32, faces (F, 3)
    int32)."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(t.split("/")[0]) - 1 for t in line.split()[1:]]
                for i in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[i], idx[i + 1]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def save_obj_mesh(path: str, verts, faces, colors=None):
    """Write an OBJ, optionally with per-vertex colors."""
    with open(path, "w") as f:
        for i, v in enumerate(np.asarray(verts)):
            if colors is not None:
                c = np.asarray(colors)[i]
                f.write(f"v {v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
            else:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for face in np.asarray(faces):
            f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")


def camera_from_bbox(bbox, image_hw):
    """Intrinsics from the OSX virtual camera scaled into the detection
    bbox (x0, y0, w, h) (reference optim/data_io.py:96-109)."""
    x0, y0, w, h = [float(v) for v in bbox]
    focal = np.array([OSX_VIRTUAL_FOCAL / OSX_INPUT_BODY_SHAPE[1] * w,
                      OSX_VIRTUAL_FOCAL / OSX_INPUT_BODY_SHAPE[0] * h],
                     np.float32)
    princpt = np.array([x0 + w / 2.0, y0 + h / 2.0], np.float32)
    return focal, princpt


def load_fit_inputs(sample_dir: str) -> Dict:
    """The scene dict of a demo-output folder (reference
    optim/data_io.py:134-218):
      human.npz: smpl_vertices (N, 3), smpl_faces (F, 3), bbox (4,)
      object_mesh.obj
      hcontact.npz: contact (N,)
      ocontact.npz: contact (Nobj,)
      object_mask.npy: (H, W) binary
    The object mesh's y and z are flipped, as the reference flips them
    (data_io.py:193-194)."""
    hum = np.load(os.path.join(sample_dir, "human.npz"))
    obj_v, obj_f = load_obj_mesh(os.path.join(sample_dir, "object_mesh.obj"))
    obj_v = obj_v * np.array([1, -1, -1], np.float32)
    hcontact = np.load(os.path.join(sample_dir, "hcontact.npz"))["contact"]
    ocontact = np.load(os.path.join(sample_dir, "ocontact.npz"))["contact"]
    mask = np.load(os.path.join(sample_dir, "object_mask.npy"))
    focal, princpt = camera_from_bbox(hum["bbox"], mask.shape)
    return {
        "obj_verts": obj_v,
        "obj_faces": obj_f,
        "hum_verts": hum["smpl_vertices"].astype(np.float32),
        "hum_faces": hum["smpl_faces"].astype(np.int32),
        "obj_contact_probs": ocontact.astype(np.float32),
        "hum_contact_probs": hcontact.astype(np.float32),
        "target_mask": mask.astype(np.float32),
        "focal": focal,
        "princpt": princpt,
        "centroid_offset": np.zeros(3, np.float32),
    }


def parse_args(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="joint human-object fitting")
    ap.add_argument("--input_path", required=True)
    ap.add_argument("--output_path", default=None)
    ap.add_argument("--num_steps", type=int, default=250)
    ap.add_argument("--image_size", type=int, default=512)
    ap.add_argument("--no_icp", action="store_true")
    ap.add_argument("--no_scale", action="store_true")
    ap.add_argument("--save_video", action="store_true",
                    help="write fit_trajectory.gif (Phong overlay per step)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    """The fit CLI. Returns (best FitParams, diagnostics) of
    ``fit_human_object``."""
    import torch

    from interactvlm_tpu_torch.fit.fit import fit_human_object
    from interactvlm_tpu_torch.fit.utils import apply_transformation
    from interactvlm_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    dev = resolve_device(args.device)
    scene = load_fit_inputs(args.input_path)
    out_dir = args.output_path or args.input_path
    os.makedirs(out_dir, exist_ok=True)
    best, diag = fit_human_object(
        scene, num_steps=args.num_steps, image_size=args.image_size,
        use_icp=not args.no_icp, optimize_scale=not args.no_scale,
        video_path=(os.path.join(out_dir, "fit_trajectory.gif")
                    if args.save_video else None), device=dev)
    final_obj = apply_transformation(
        torch.as_tensor(scene["obj_verts"], device=dev), best.rot6d,
        best.translation, torch.exp(best.log_scale))
    save_obj_mesh(os.path.join(out_dir, "final_object.obj"),
                  final_obj.cpu().numpy(), scene["obj_faces"])
    save_obj_mesh(os.path.join(out_dir, "final_human.obj"),
                  scene["hum_verts"], scene["hum_faces"])
    best_loss = float(diag["best_loss"])
    np.savez(os.path.join(out_dir, "fit_result.npz"),
             rot6d=best.rot6d.cpu().numpy(),
             translation=best.translation.cpu().numpy(),
             scale=np.exp(best.log_scale.cpu().numpy()),
             best_loss=best_loss)
    print(f"fit done: loss={best_loss:.4f} -> {out_dir}")
    return best, diag


if __name__ == "__main__":
    main()
