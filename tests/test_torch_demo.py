"""The port's demo chain (``demo/run_demo.py``, ``demo/demo_utils.py``),
its point rasterizer (``geometry/point_raster.py``) and the weight helpers
the demo loads through (``utils/weights.py:resize_token_tables``,
``load_torch_state_dict``) against the JAX package's, on the CPU at tiny
size: the same numpy inputs and files through both.

The demo loop runs the JAX package's tiny preset with weights initialised
once by JAX and carried to the port (``from_jax_params``), the answers
forced to [SEG] through the residual stream (a constant channel 0 and
[SEG]'s lm_head weight on it, as ``tests/test_torch_drivers.py`` forces
them), so every image decodes masks. The JAX demo draws its own weights:
its ``InteractVLM.init`` is replaced in the test by one that returns the
same forced tree.

Tolerances, with the reason for each:
- the point splats: pixel -> point maps equal (the test first checks that
  no point's rounded pixel differs between the two projections, which
  round ``verts @ R`` differently); depths within 1e-6 relative;
- ``generate_sam_inp_objs``: vertex maps equal, barycentrics within 1e-4
  (the two projections' rounding; ``tests/test_torch_geometry.py`` bounds
  it at 7e-5), render PNGs within one grey level (the shade of a pixel moves
  with its barycentrics);
- the demo's outputs: mask logits within 1e-4 and lifted contacts within
  1e-3 (``tests/test_torch_drivers.py``'s limits for the same pipeline),
  the SMPL-X contacts within 1e-3 times the mapping's largest row sum, the
  OBJ colours within 1e-3 (computed from the contacts), JPEGs the same
  size (their bytes come from masks that differ in rounding);
- the token tables within 1e-6 (the mean row sums in another order).
"""

import os
import pickle
import shutil
from os.path import join

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from PIL import Image

from interactvlm_tpu.config import interactvlm_tiny as jax_tiny
from interactvlm_tpu.demo import demo_utils as JDU
from interactvlm_tpu.demo import run_demo as JRD
from interactvlm_tpu.fit.data_io import save_obj_mesh
from interactvlm_tpu.geometry import cameras as JC
from interactvlm_tpu.geometry import point_raster as JP
from interactvlm_tpu.geometry.views import OBJECT_VIEWS
from interactvlm_tpu.models.interactvlm import InteractVLM as JaxIVLM
from interactvlm_tpu.utils import weights as JW
from interactvlm_tpu.utils.testing import make_synthetic_batch
from interactvlm_tpu_torch import config as C
from interactvlm_tpu_torch.demo import demo_utils as TDU
from interactvlm_tpu_torch.demo import run_demo as TRD
from interactvlm_tpu_torch.geometry import point_raster as TP
from interactvlm_tpu_torch.geometry.cameras import (
    camera_from_params,
    project_points,
)
from interactvlm_tpu_torch.geometry.rasterizer import build_lift_maps, uv_sphere
from interactvlm_tpu_torch.geometry.views import HUMAN_VIEWS
from interactvlm_tpu_torch.models.interactvlm import InteractVLM
from interactvlm_tpu_torch.utils import weights as TW

S = 64  # the tiny SAM's image size and the demo's mask size
SEG = 500  # [SEG] of the tiny preset
N_SMPLX = 200  # rows of the tiny SMPL -> SMPL-X mapping
MASK_TOL, LIFT_TOL = 1e-4, 1e-3
OBJ_VIEW_CAMS = OBJECT_VIEWS["4MV-Z_HM_MeshInf"].cam_params()


def sphere_points(n=512, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


# ------------------------------------------------------- point raster
def test_rasterize_points_and_renders_match_jax():
    pts = sphere_points()
    p2ps = []
    for cp in OBJ_VIEW_CAMS:
        pix_t, _ = project_points(torch.from_numpy(pts),
                                  *camera_from_params(cp), S)
        jp2p, jz = JP.rasterize_points(jnp.asarray(pts), jnp.asarray(cp), S)
        # the JAX package's projection, as its compiled splat computes it
        pix_j = jax.jit(lambda p, c: JC.project_points(
            p, *JC.camera_from_params(c), S)[0])(jnp.asarray(pts),
                                                  jnp.asarray(cp))
        np.testing.assert_array_equal(torch.round(pix_t).numpy(),
                                      np.round(np.asarray(pix_j)))
        tp2p, tz = TP.rasterize_points(torch.from_numpy(pts), cp, S)
        assert tp2p.dtype == torch.int32
        np.testing.assert_array_equal(tp2p.numpy(), np.asarray(jp2p))
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-6)
        assert 0.1 < (tp2p >= 0).float().mean() < 0.9
        p2ps.append(tp2p)
    values = np.random.default_rng(1).random(len(pts)).astype(np.float32)
    np.testing.assert_array_equal(
        TP.position_rgb_render(torch.from_numpy(pts), p2ps[0]).numpy(),
        np.asarray(JP.position_rgb_render(jnp.asarray(pts),
                                          jnp.asarray(p2ps[0].numpy()))))
    np.testing.assert_array_equal(
        TP.heatmap_render(torch.from_numpy(values), p2ps[1]).numpy(),
        np.asarray(JP.heatmap_render(jnp.asarray(values),
                                     jnp.asarray(p2ps[1].numpy()))))
    got = TP.lift_points_roundtrip(torch.from_numpy(values), p2ps, len(pts))
    want = JP.lift_points_roundtrip(jnp.asarray(values),
                                    [jnp.asarray(p.numpy()) for p in p2ps],
                                    len(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    seen = got.numpy() > 0
    np.testing.assert_allclose(got.numpy()[seen], values[seen], atol=1e-6)
    cloud = pts * 3.0 + 1.0
    np.testing.assert_allclose(
        TP.normalize_point_cloud(torch.from_numpy(cloud)).numpy(),
        np.asarray(JP.normalize_point_cloud(jnp.asarray(cloud))), atol=1e-6)


# ---------------------------------------------------------- demo utils
def test_generate_sam_inp_objs_matches_jax(tmp_path):
    verts, faces = uv_sphere(6, 8)
    verts = verts * 3.0 + 1.0
    jpaths, jpkl = JDU.generate_sam_inp_objs(verts, faces,
                                             str(tmp_path / "jax"),
                                             image_size=S)
    tpaths, tpkl = TDU.generate_sam_inp_objs(verts, faces,
                                             str(tmp_path / "port"),
                                             image_size=S, device="cpu")
    assert [os.path.basename(p) for p in tpaths] == [
        os.path.basename(p) for p in jpaths]
    for tp, jp in zip(tpaths, jpaths):
        got = np.asarray(Image.open(tp)).astype(int)
        want = np.asarray(Image.open(jp)).astype(int)
        assert got.shape == want.shape == (S, S, 3)
        assert np.abs(got - want).max() <= 1
        assert (got < 250).any()
    with open(tpkl, "rb") as f:
        got = pickle.load(f)
    with open(jpkl, "rb") as f:
        want = pickle.load(f)
    assert got["num_vertices"] == want["num_vertices"] == len(verts)
    for g, w in zip(got["pixel_to_vertices_map"],
                    want["pixel_to_vertices_map"]):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got["bary_coords_map"], want["bary_coords_map"]):
        np.testing.assert_allclose(g, w, atol=1e-4)
    # the loaders, corner-major, on the same pickle
    tl, jl = TDU.load_lift2d_dict(jpkl), JDU.load_lift2d_dict(jpkl)
    assert tl["num_vertices"] == jl["num_vertices"]
    assert tl["p2v"].shape == (3, 4, S, S)
    for k in ("p2v", "bary"):
        np.testing.assert_array_equal(tl[k].numpy(), np.asarray(jl[k]))


def test_contact_obj_smplx_and_overlays_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    verts, faces = uv_sphere(6, 8)
    contact = rng.random(len(verts)).astype(np.float32)
    JDU.export_contact_obj(str(tmp_path / "jax.obj"), verts, faces, contact)
    TDU.export_contact_obj(str(tmp_path / "port.obj"), verts, faces, contact)
    assert ((tmp_path / "port.obj").read_text()
            == (tmp_path / "jax.obj").read_text())
    n = np.testing.assert_array_equal
    n(TDU.normalize_mesh(verts * 2 + 3)[0], JDU.normalize_mesh(
        verts * 2 + 3)[0])
    m = sp.random(N_SMPLX, len(verts), density=0.05, random_state=3,
                  dtype=np.float32).tocsr()
    for i, data in enumerate(({"matrix": m}, m)):
        path = str(tmp_path / f"map{i}.pkl")
        with open(path, "wb") as f:
            pickle.dump(data, f)
        tm = TDU.load_smpl_to_smplx_mapping(path)
        n(tm, JDU.load_smpl_to_smplx_mapping(path))
        assert tm.shape == (N_SMPLX, len(verts)) and tm.dtype == np.float32
    for c in (contact, np.stack([contact, 1 - contact])):
        n(TDU.convert_contacts_smpl_to_smplx(c, tm),
          JDU.convert_contacts_smpl_to_smplx(c, tm))
    renders = rng.integers(0, 255, (4, 8, 8, 3), np.uint8)
    masks = rng.random((4, 8, 8))
    for k in (1, 3, 4):
        n(TDU.overlay_grid(renders[:k], masks[:k]),
          JDU.overlay_grid(renders[:k], masks[:k]))
    n(TDU.overlay_mask(renders[0], masks[0], 0.3),
      JDU.overlay_mask(renders[0], masks[0], 0.3))


# ------------------------------------------------------------- weights
def test_resize_token_tables_matches_jax():
    rng = np.random.default_rng(4)
    emb = rng.normal(size=(300, 16)).astype(np.float32)
    head = rng.normal(size=(16, 300)).astype(np.float32)  # JAX (in, out)
    for new_vocab in (303, 256, 384):
        want = JW.resize_token_tables(
            {"model": {"embed_tokens": {"embedding": emb.copy()}},
             "lm_head": {"kernel": head.copy()}}, new_vocab)
        got = TW.resize_token_tables(
            {"llava.lm.model.embed_tokens.weight": torch.from_numpy(emb),
             "llava.lm.lm_head.weight": torch.from_numpy(head.T.copy())},
            new_vocab)
        np.testing.assert_allclose(
            got["llava.lm.model.embed_tokens.weight"].numpy(),
            want["model"]["embed_tokens"]["embedding"], atol=1e-6)
        np.testing.assert_allclose(got["llava.lm.lm_head.weight"].numpy(),
                                   want["lm_head"]["kernel"].T, atol=1e-6)
    assert got["llava.lm.lm_head.weight"].shape == (384, 16)


@pytest.mark.parametrize("fmt", ["bin", "wrapped_bin", "safetensors"])
def test_load_torch_state_dict_round_trips_a_port_state_dict(tmp_path, fmt):
    sd = InteractVLM(C.interactvlm_tiny(), device="cpu").state_dict()
    sd = {k: v.contiguous() for k, v in sd.items()}
    path = str(tmp_path / ("sd.safetensors" if fmt == "safetensors"
                           else "pytorch_model.bin"))
    if fmt == "safetensors":
        safetensors = pytest.importorskip("safetensors.torch")
        safetensors.save_file(sd, path)
    else:
        torch.save({"state_dict": sd} if fmt == "wrapped_bin" else sd, path)
    got = TW.load_torch_state_dict(path)
    assert got.keys() == sd.keys()
    want = JW.load_torch_state_dict(path)  # the JAX package's, as numpy
    for k, v in sd.items():
        assert torch.equal(got[k], v), k
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_merged_checkpoint_keys_map_to_the_port():
    """The merged checkpoint's names (the layout
    ``convert_interactvlm_checkpoint`` reads, see
    ``tests/test_torch_isolation.py``) come back to the port's."""
    sd = InteractVLM(C.interactvlm_tiny(), device="cpu").state_dict()
    renames = [("llava.lm.model.", "model."), ("llava.lm.lm_head.", "lm_head."),
               ("llava.mm_projector.", "model.mm_projector."),
               ("sam.", "model.visual_model."),
               ("text_hidden_fcs.", "model.text_hidden_fcs.")]
    merged = {}
    for key, val in sd.items():
        if key.startswith("llava.vision_tower."):
            continue
        for old, new in renames:
            if key.startswith(old):
                key = new + key[len(old):]
                break
        merged[key] = val
    back = TW.port_keys_of_merged(merged)
    assert back.keys() == {k for k in sd if not k.startswith(
        "llava.vision_tower.")}
    assert any(k.startswith("cam_pose_encoder.") for k in back)


# ------------------------------------------------------- the demo loop
def force_seg(tree):
    tree = jax.tree.map(np.array, tree)
    p = tree["params"]["llava"]
    p["lm"]["model"]["embed_tokens"]["embedding"][:, 0] = 30.0
    p["mm_projector"]["bias"][0] = 30.0
    p["lm"]["lm_head"]["kernel"][0, SEG] = 5.0
    return tree


def make_demo_folders(root):
    """Three demo folders (hcontact and h2dcontact share one) and the
    hcontact inputs: canonical renders and lift maps of a 178-vertex
    sphere (outward faces) under ``4MV-Z_Vitru_mv2`` at 64^2, a sparse
    SMPL -> SMPL-X mapping and the body template in SMPL-X's vertex count
    (the sphere carried through the mapping)."""
    rng = np.random.default_rng(5)
    verts, faces = uv_sphere(12, 16)
    faces = np.ascontiguousarray(faces[:, ::-1])
    os.makedirs(join(root, "human"))
    Image.fromarray(rng.integers(0, 255, (40, 52, 3), np.uint8)).save(
        join(root, "human", "chair__001.jpg"))
    vs = HUMAN_VIEWS["4MV-Z_Vitru_mv2"]
    p2v, bary, p2f = build_lift_maps(verts, faces, vs.cam_params(), S, 8,
                                     device="cpu")
    os.makedirs(join(root, "renders"))
    for i, name in enumerate(vs.names):
        Image.fromarray(TDU.shaded_render(verts, faces, p2f[i], p2v[i].numpy(),
                                          bary[i].numpy())).save(
            join(root, "renders", f"{name}.png"))
    np.savez(join(root, "maps.npz"), p2v=p2v.numpy(), bary=bary.numpy())
    m = sp.random(N_SMPLX, len(verts), density=0.02, random_state=6,
                  dtype=np.float32).tocsr()
    with open(join(root, "smpl_to_smplx.pkl"), "wb") as f:
        pickle.dump({"matrix": m}, f)
    save_obj_mesh(join(root, "body.obj"), m @ verts, faces)
    os.makedirs(join(root, "object"))
    Image.fromarray(rng.integers(0, 255, (36, 30, 3), np.uint8)).save(
        join(root, "object", "mug__001.jpg"))
    ov, of = uv_sphere(6, 8)
    save_obj_mesh(join(root, "object", "object_mesh.obj"), ov,
                  np.ascontiguousarray(of[:, ::-1]))


def demo_argv(root, side, ctype):
    folder = "object" if ctype == "ocontact" else "human"
    argv = ["--img_folder", join(root, side, folder), "--output_folder",
            join(root, f"out_{side}_{ctype}"), "--contact_type", ctype,
            "--random_weights", "--max_new_tokens", "4"]
    if ctype == "hcontact":
        argv += ["--sam_renders_dir", join(root, "renders"), "--human_maps",
                 join(root, "maps.npz"), "--smpl_to_smplx",
                 join(root, "smpl_to_smplx.pkl"), "--body_template",
                 join(root, "body.obj")]
    return argv


@pytest.fixture(scope="module")
def demo_runs(tmp_path_factory):
    """The JAX demo (``run_demo.main``) and the port's loop on the same
    folders and forced weights, for hcontact, h2dcontact and ocontact. The
    port runs on a copy made after the JAX run, so that it reads the
    object views JAX wrote (``generate_sam_inp_objs`` has its own test)."""
    root = str(tmp_path_factory.mktemp("demo"))
    make_demo_folders(join(root, "inputs"))
    for name in ("renders", "maps.npz", "smpl_to_smplx.pkl", "body.obj"):
        src = join(root, "inputs", name)
        (shutil.copytree if os.path.isdir(src) else shutil.copy)(
            src, join(root, name))
    shutil.copytree(join(root, "inputs"), join(root, "jax"))
    cfg = jax_tiny()
    tree = jax.jit(JaxIVLM(cfg).init)(
        jax.random.PRNGKey(0), make_synthetic_batch(cfg, B=1, mask_size=S))
    forced = force_seg(nn.meta.unbox(tree))
    ctypes = ("hcontact", "h2dcontact", "ocontact")
    mp = pytest.MonkeyPatch()
    mp.setattr(JaxIVLM, "init", lambda self, *a, **k: forced)
    try:
        jax_out = {c: JRD.main(demo_argv(root, "jax", c)) for c in ctypes}
    finally:
        mp.undo()
    shutil.copytree(join(root, "jax"), join(root, "port"))
    port_out = {}
    for c in ctypes:
        args = TRD.parse_args(demo_argv(root, "port", c) + ["--device",
                                                            "cpu"])
        model, tok = TRD.load_model(args)
        missing, unexpected = model.load_state_dict(
            TW.from_jax_params(forced), strict=False)
        assert not unexpected and all("mask_downscaling" in k
                                      for k in missing)
        port_out[c] = TRD.run_images(model, tok, args)
    return root, jax_out, port_out


def _outs(root, side, ctype):
    d = join(root, f"out_{side}_{ctype}")
    return d, sorted(os.listdir(d))


@pytest.mark.parametrize("ctype", ["hcontact", "h2dcontact", "ocontact"])
def test_demo_loop_matches_jax_main(demo_runs, ctype):
    root, jax_out, port_out = demo_runs
    assert port_out[ctype] == jax_out[ctype]
    assert all(r["has_seg"] for r in port_out[ctype])
    (td, tfiles), (jd, jfiles) = (_outs(root, s, ctype)
                                  for s in ("port", "jax"))
    assert tfiles == jfiles
    want_files = {
        "hcontact": ["chair__001_body_with_hcontacts.obj",
                     "chair__001_hcontact_concat.jpg",
                     "chair__001_hcontact_vertices.npz",
                     "chair__001_pred_masks.npy"],
        "h2dcontact": ["chair__001_h2dcontact_overlay.jpg",
                       "chair__001_pred_mask_original.npy",
                       "chair__001_pred_masks.npy"],
        "ocontact": ["mug__001_object_mesh_with_contacts_ocontact.obj",
                     "mug__001_ocontact_concat.jpg",
                     "mug__001_ocontact_vertices.npz",
                     "mug__001_pred_masks.npy"]}[ctype]
    assert tfiles == want_files
    for name in tfiles:
        got, want = join(td, name), join(jd, name)
        if name.endswith(".npy"):
            g, w = np.load(got), np.load(want)
            assert g.dtype == np.float32 and g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=MASK_TOL, rtol=0)
            assert np.abs(w).max() > 0
        elif name.endswith(".npz"):
            g, w = np.load(got), np.load(want)
            assert g.files == w.files
            np.testing.assert_allclose(g["contact"], w["contact"],
                                       atol=LIFT_TOL, rtol=0)
            if "contact_smplx" in w.files:
                assert g["contact_smplx"].shape == (N_SMPLX,)
                rows = np.abs(TDU.load_smpl_to_smplx_mapping(join(
                    root, "smpl_to_smplx.pkl"))).sum(1).max()
                np.testing.assert_allclose(g["contact_smplx"],
                                           w["contact_smplx"],
                                           atol=LIFT_TOL * rows, rtol=0)
        elif name.endswith(".obj"):
            g, w = (np.array([ln.split()[1:] for ln in open(p)
                              if ln.startswith("v ")], float)
                    for p in (got, want))
            assert g.shape == w.shape and g.shape[1] == 6
            np.testing.assert_array_equal(g[:, :3], w[:, :3])
            np.testing.assert_allclose(g[:, 3:], w[:, 3:], atol=1e-3)
        else:
            assert Image.open(got).size == Image.open(want).size
    if ctype == "h2dcontact":
        assert np.load(join(td, "chair__001_pred_mask_original.npy")
                       ).shape == (40, 52)
