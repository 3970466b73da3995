"""The port's datagen (``datagen/generate.py``, ``datagen/recipes.py``, the
CLI ``datagen/__main__.py``) against the JAX package's, on the CPU at 64^2:
the same numpy inputs and files through both.

The human recipes render the 178-vertex sphere of ``tests/test_torch_data.py``
under the flagship's ``4MV-Z_Vitru`` views; the object recipes splat seeded
point clouds under ``4MV-Z_HM_BM`` (PIAD) and rasterize the sphere and a
42-vertex one under the same views (PICO).

Tolerances, with the reason for each:
- vertex, point and face maps, masks, contacts, pickles (by ``repr``) and
  text files equal;
- barycentrics within 1e-4, the rasterizer's stated rounding
  (``tests/test_torch_geometry.py``: XLA's vmapped ``build_lift_maps`` moves
  them by up to 7e-5 on the sphere's thinnest faces at 64^2);
- PNGs within one level: a grey render's shade moves with its normals
  (summed in another order), and a position-RGB level is a truncation
  ``(x * 255).astype(uint8)`` of a value that moves with the point cloud's
  normalisation (its mean and norm summed in another order, 1e-7 apart);
- the position-RGB renders as floats within 1e-6, for the same reason;
- the point splats' pixel -> point maps equal: the fixtures' clouds were
  checked first to put no point's rounded pixel on another side of a .5
  boundary in the two projections (``splat_pixels_agree``), which round
  ``verts @ R`` differently; a seed would be changed only for that.
"""

import os
import pickle
from os.path import join

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from interactvlm_tpu.datagen import __main__ as JCLI
from interactvlm_tpu.datagen import generate as JG
from interactvlm_tpu.datagen import recipes as JR
from interactvlm_tpu.geometry import cameras as JC
from interactvlm_tpu.geometry import point_raster as JP
from interactvlm_tpu.geometry.views import HUMAN_VIEWS as JAX_HUMAN
from interactvlm_tpu.geometry.views import OBJECT_VIEWS as JAX_OBJECT
from interactvlm_tpu_torch.datagen import __main__ as TCLI
from interactvlm_tpu_torch.datagen import generate as TG
from interactvlm_tpu_torch.datagen import recipes as TR
from interactvlm_tpu_torch.geometry.cameras import (
    camera_from_params,
    project_points,
)
from interactvlm_tpu_torch.geometry.point_raster import normalize_point_cloud
from interactvlm_tpu_torch.geometry.rasterizer import uv_sphere
from interactvlm_tpu_torch.geometry.views import HUMAN_VIEWS as PORT_HUMAN
from interactvlm_tpu_torch.geometry.views import OBJECT_VIEWS as PORT_OBJECT

from tests.test_datagen_recipes import sphere_mesh
from tests.test_torch_data import body_segmentation, damon_annotations

S = 64
HUMAN = "4MV-Z_Vitru"  # the flagship's hC_sam_view_type
OBJECT = "4MV-Z_HM_BM"  # its oC_sam_view_type
BARY_TOL = 1e-4
RECIPES = ("damon", "lemon-hu", "rich", "piad", "pico")


# ------------------------------------------------------------- inputs
def object_clouds(n=300, seed=0):
    """Three PIAD objects: a cube-ish 'Chair' whose top third affords
    'sit', a spherical 'Ball' whose bottom third does, and a 'Mug' that
    affords nothing (a zero-contact object)."""
    rng = np.random.default_rng(seed)
    cube = rng.uniform(-0.7, 0.7, (n, 3))
    theta, phi = rng.uniform(0, np.pi, n), rng.uniform(0, 2 * np.pi, n)
    ball = 0.7 * np.stack([np.sin(theta) * np.cos(phi), np.cos(theta),
                           np.sin(theta) * np.sin(phi)], 1)
    mug = rng.normal(size=(n, 3)) * [0.3, 0.5, 0.3]
    return {"chair_001": ("Chair", cube, cube[:, 1] > 0.25),
            "ball_001": ("Ball", ball, ball[:, 1] < -0.25),
            "mug_002": ("Mug", mug, np.zeros(n, bool))}


def write_piad_txt(path, cls, pts, sit):
    """A PIAD point file: ``<idx> <class> x y z`` and 17 affordance columns,
    'sit' set where ``sit`` is."""
    col = int(np.argwhere(TR.AFFORD_LIST_PIAD == "sit").item())
    lines = []
    for i, (p, a) in enumerate(zip(pts, sit)):
        aff = ["0"] * 17
        aff[col] = str(int(a))
        lines.append(f"{i} {cls} " + " ".join(f"{v:.4f}" for v in p) + " "
                     + " ".join(aff))
    with open(path, "w") as f:
        f.write("\n".join(lines))


def pico_meshes():
    """Two PICO objects of different vertex counts, each with a contact
    patch."""
    big, big_faces = sphere_mesh()
    small, small_faces = uv_sphere(6, 8)
    c_big = np.zeros(len(big), np.float32)
    c_big[10:60] = 1.0
    c_small = np.zeros(len(small), np.float32)
    c_small[:12] = 1.0
    return {"mug_009": {"verts": big, "faces": big_faces, "contact": c_big,
                        "image": "mug_img.jpg", "class_name": "Mug"},
            "cup_004": {"verts": small * 1.3, "faces": small_faces,
                        "contact": c_small, "image": "cup_img.jpg",
                        "class_name": "Cup"}}


def human_inputs():
    verts, faces = sphere_mesh()
    n = len(verts)
    lemon = {}
    for i, cls in enumerate(["mug", "bottle", "knife"]):
        c = np.zeros(n, np.float32)
        c[i * 30:i * 30 + 25] = 1.0
        lemon[f"lemon/Images/{cls}_{i:04d}.jpg"] = c
    lemon["lemon/Images/cup_0009.jpg"] = np.zeros(n, np.float32)  # skipped
    rich = {f"seq01/cam{i}/f{i:03d}.jpg": np.arange(i * 30, i * 30 + 50) % n
            for i in range(3)}
    return dict(verts=verts, faces=faces, segm=body_segmentation(n),
                damon=damon_annotations(n, 4), lemon=lemon, rich=rich)


def write_input_files(d):
    """The CLIs' input files under ``d``: the body npz, the segmentation
    and contact pickles, the PIAD txt folder and the PICO meshes pickle."""
    h = human_inputs()
    os.makedirs(join(d, "piad_txt"), exist_ok=True)
    np.savez(join(d, "body.npz"), verts=h["verts"], faces=h["faces"])
    for name in ("segm", "damon", "lemon", "rich"):
        with open(join(d, f"{name}.pkl"), "wb") as f:
            pickle.dump(h[name], f)
    for oid, (cls, pts, sit) in object_clouds().items():
        write_piad_txt(join(d, "piad_txt", f"{oid}.txt"), cls, pts, sit)
    with open(join(d, "pico.pkl"), "wb") as f:
        pickle.dump(pico_meshes(), f)
    return d


def run_recipe(recipe, root, files, port: bool):
    """One recipe of either package through its Python API, on the CPU,
    from the input files ``files``."""
    R = TR if port else JR
    kw = {"device": "cpu"} if port else {}
    human = (PORT_HUMAN if port else JAX_HUMAN)[HUMAN]
    obj = (PORT_OBJECT if port else JAX_OBJECT)[OBJECT]
    h = human_inputs()
    if recipe == "damon":
        return R.generate_damon_tree(root, h["damon"], h["verts"], h["faces"],
                                     human, S, h["segm"], **kw)
    if recipe == "rich":
        return R.generate_rich_tree(root, h["rich"], h["verts"], h["faces"],
                                    human, S, h["segm"], **kw)
    if recipe == "lemon-hu":
        return R.generate_lemon_human_tree(root, h["lemon"], h["verts"],
                                           h["faces"], human, S, h["segm"],
                                           **kw)
    if recipe == "piad":
        txt = {oid: join(files, "piad_txt", f"{oid}.txt")
               for oid in object_clouds()}
        out = []
        for split in ("train", "test"):
            out += R.generate_piad_tree(
                root, txt, obj, S, split=split,
                image_for={oid: f"{oid}.jpg" for oid in txt},
                object_matches={"chair_001": ["gone_000", "mug_002",
                                              "chair_001"],
                                "ball_001": ["ball_001"]},
                affordance="sit", **kw)
        return out
    return [rec for split in ("train", "test")
            for rec in R.generate_pico_tree(root, pico_meshes(), obj, S,
                                            split=split, **kw)]


def tree_files(root):
    return sorted(os.path.relpath(join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def assert_trees_match(got_root, want_root):
    """Same files; maps, masks, contacts equal; barycentrics within
    BARY_TOL; PNGs within one level; pickles equal by repr; text equal."""
    assert tree_files(got_root) == tree_files(want_root)
    for rel in tree_files(want_root):
        a, b = join(want_root, rel), join(got_root, rel)
        if rel.endswith(".png"):
            x = np.asarray(Image.open(a)).astype(int)
            y = np.asarray(Image.open(b)).astype(int)
            assert x.shape == y.shape, rel
            assert np.abs(x - y).max() <= 1, rel
        elif rel.endswith(".pkl"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert repr(pickle.load(fb)) == repr(pickle.load(fa)), rel
        elif rel.endswith(".npz"):
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(zb.files), rel
            for k in za.files:
                assert za[k].dtype == zb[k].dtype, (rel, k)
                if k == "bary" or os.path.basename(rel).startswith("bary"):
                    assert np.abs(zb[k] - za[k]).max() <= BARY_TOL, rel
                else:
                    np.testing.assert_array_equal(zb[k], za[k],
                                                  err_msg=f"{rel}:{k}")
        else:
            with open(a) as fa, open(b) as fb:
                assert fb.read() == fa.read(), rel


def splat_pixels_agree(points, cams):
    """Whether every point's rounded pixel is the same in the port's
    projection of its host-normalised cloud and in the JAX package's
    compiled projection of its own normalised cloud, under every camera."""
    pts_t = normalize_point_cloud(torch.as_tensor(
        np.asarray(points, np.float32)))
    pts_j = JP.normalize_point_cloud(jnp.asarray(points))
    project = jax.jit(lambda p, c: JC.project_points(
        p, *JC.camera_from_params(c), S)[0])
    for cam in cams:
        pix_t, _ = project_points(pts_t, *camera_from_params(cam), S)
        pix_j = np.asarray(project(pts_j, jnp.asarray(cam)))
        if not np.array_equal(torch.round(pix_t).numpy(), np.round(pix_j)):
            return False
    return True


@pytest.fixture(scope="module")
def input_files(tmp_path_factory):
    return write_input_files(str(tmp_path_factory.mktemp("inputs")))


# ------------------------------------------------------------- generate.py
def test_pose_helpers_equal():
    eul = np.random.default_rng(0).normal(size=(7, 3))
    np.testing.assert_array_equal(TG.euler_to_matrix(eul),
                                  JG.euler_to_matrix(eul))
    np.testing.assert_array_equal(TG.vitruvian_pose(), JG.vitruvian_pose())
    np.testing.assert_array_equal(TG.vitruvian_pose(12.0),
                                  JG.vitruvian_pose(12.0))


def test_generate_human_assets_and_verify_match_jax(tmp_path):
    h = human_inputs()
    contacts = {"img0": {"chair": np.arange(0, 40),
                         "cup": np.arange(100, 130)},
                "img1": {"ball": np.arange(60, 90)}}
    want = JG.generate_human_assets(h["verts"], h["faces"], JAX_HUMAN[HUMAN],
                                    S, contacts, out_dir=str(tmp_path / "j"))
    got = TG.generate_human_assets(h["verts"], h["faces"], PORT_HUMAN[HUMAN],
                                   S, contacts, out_dir=str(tmp_path / "t"),
                                   device="cpu")
    for k in ("p2v", "pix_to_face"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert np.abs(got["bary"] - want["bary"]).max() <= BARY_TOL
    assert got["masks"].keys() == want["masks"].keys()
    for key in want["masks"]:
        np.testing.assert_array_equal(got["masks"][key], want["masks"][key])
        assert got["verify"][key] == want["verify"][key], key
        assert got["verify"][key]["original_visible"] > 0
    assert_trees_match(str(tmp_path / "t"), str(tmp_path / "j"))
    assert tree_files(str(tmp_path / "t")) == [
        f"bary_coords_map_{S}.npz", f"pixel_to_vertex_map_{S}.npz"]
    # the round trip alone, on host arrays and on tensors
    cmask = np.zeros(len(h["verts"]), bool)
    cmask[5:70] = True
    views = np.stack([np.asarray(JR.contact_mask_from_fragments(
        jnp.asarray(f), jnp.asarray(h["faces"]), jnp.asarray(cmask)))
        for f in want["pix_to_face"]])
    ref = JG.verify_contact_reconstruction(views, want["p2v"], want["bary"],
                                           cmask)
    assert TG.verify_contact_reconstruction(
        views, got["p2v"], got["bary"], cmask, device="cpu") == ref
    assert TG.verify_contact_reconstruction(
        torch.from_numpy(views), torch.from_numpy(got["p2v"]),
        torch.from_numpy(got["bary"]), cmask) == ref


def test_generate_object_assets_match_jax(tmp_path):
    cams = PORT_OBJECT[OBJECT].cam_params()
    for oid, (_, pts, sit) in object_clouds().items():
        assert splat_pixels_agree(pts, cams), oid
        gt = sit.astype(np.float32)
        want = JG.generate_object_assets(pts, JAX_OBJECT[OBJECT], S,
                                         affordance=jnp.asarray(gt),
                                         out_dir=str(tmp_path / "j"),
                                         object_id=oid)
        got = TG.generate_object_assets(pts, PORT_OBJECT[OBJECT], S,
                                        affordance=gt,
                                        out_dir=str(tmp_path / "t"),
                                        object_id=oid, device="cpu")
        assert got["p2p"].dtype == want["p2p"].dtype == np.int32
        np.testing.assert_array_equal(got["p2p"], want["p2p"])
        assert 0.02 < (got["p2p"] >= 0).mean() < 0.9
        np.testing.assert_allclose(got["points"], want["points"], atol=1e-6)
        np.testing.assert_allclose(got["renders"], want["renders"],
                                   atol=1e-6)
        np.testing.assert_array_equal(got["heatmaps"], want["heatmaps"])
    assert_trees_match(str(tmp_path / "t"), str(tmp_path / "j"))
    no_heat = TG.generate_object_assets(pts, PORT_OBJECT[OBJECT], S,
                                        device="cpu")
    assert no_heat["heatmaps"] is None


# ------------------------------------------------------------- recipes
def test_point_file_parsers_and_vocabularies_equal(input_files, tmp_path):
    np.testing.assert_array_equal(TR.AFFORD_LIST_PIAD, JR.AFFORD_LIST_PIAD)
    np.testing.assert_array_equal(TR.AFFORD_LIST_LEMON, JR.AFFORD_LIST_LEMON)
    path = join(input_files, "piad_txt", "chair_001.txt")
    for a, b in zip(TR.extract_point_file_piad(path),
                    JR.extract_point_file_piad(path)):
        np.testing.assert_array_equal(a, b)
    lemon = tmp_path / "mug_7.txt"
    lemon.write_text("\n".join(
        f"{i * .1} {i * .2} {i * .3} " + " ".join(str((i + j) % 2)
                                                  for j in range(13))
        for i in range(4)))
    for a, b in zip(TR.extract_point_file_lemon(str(lemon)),
                    JR.extract_point_file_lemon(str(lemon))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("recipe", RECIPES)
def test_recipe_tree_matches_jax(recipe, input_files, tmp_path):
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    want = run_recipe(recipe, jroot, input_files, port=False)
    got = run_recipe(recipe, troot, input_files, port=True)
    if recipe in ("damon", "rich"):
        got, want = got["annot"], want["annot"]
    assert repr(got) == repr(want)
    assert_trees_match(troot, jroot)
    if recipe == "piad":  # the zero-sit mug and the match lists
        index = TR._load_index(join(troot, "rendered_points_heatmap",
                                    "index.pkl"))
        assert [len(index[s]) for s in ("train", "test")] == [3, 3]
        assert index["train"][1]["object_matches"][0] == "gone_000"


@pytest.mark.parametrize("recipe", RECIPES)
def test_cli_matches_jax(recipe, input_files, tmp_path, capsys):
    args = {"damon": ["--contact_pkl", "damon.pkl"],
            "rich": ["--contact_pkl", "rich.pkl"],
            "lemon-hu": ["--contact_pkl", "lemon.pkl", "--split", "val"],
            "piad": ["--points_dir", "piad_txt"],
            "pico": ["--meshes_pkl", "pico.pkl"]}[recipe]
    if recipe in ("damon", "rich", "lemon-hu"):
        args += ["--mesh", "body.npz", "--segm", "segm.pkl",
                 "--view_type", HUMAN]
    args = [join(input_files, a) if a.endswith((".pkl", ".npz", "_txt"))
            else a for a in args]
    argv = [recipe, "--image_size", str(S)] + args
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    JCLI.main(argv + ["--root", jroot])
    jline = capsys.readouterr().out
    TCLI.main(argv + ["--root", troot, "--device", "cpu"])
    tline = capsys.readouterr().out
    assert tline == jline and tline.strip().endswith(("images", "objects"))
    assert_trees_match(troot, jroot)


def test_port_tree_loads_in_the_jax_package_and_back(input_files, tmp_path):
    """A PICO and a PIAD tree written by the port load in the JAX datasets,
    and the JAX trees in the port's, giving the same samples."""
    from interactvlm_tpu.data import datasets as JD
    from interactvlm_tpu_torch.data import datasets as TD

    from tests.test_torch_data import assert_samples_equal

    for port_writes in (True, False):
        root = str(tmp_path / ("port" if port_writes else "jax"))
        os.makedirs(join(root, "images"))
        for name in ("mug_img.jpg", "cup_img.jpg", "chair_001.jpg",
                     "ball_001.jpg", "mug_002.jpg"):
            Image.fromarray(np.full((20, 24, 3), 90, np.uint8)).save(
                join(root, "images", name))
        for recipe in ("pico", "piad"):
            run_recipe(recipe, root, input_files, port=port_writes)
        for cls in ("OContactDataset", "OAffordDataset"):
            kw = dict(image_size=S, clip_size=28, view_type=OBJECT,
                      split="test")
            if cls == "OContactDataset":
                kw["split"] = "train"
            jd, td = getattr(JD, cls)(root, **kw), getattr(TD, cls)(root, **kw)
            assert len(td) == len(jd) > 0
            for i in range(len(td)):
                assert_samples_equal(td[i], jd[i])


def test_recipes_and_cli_default_to_the_card(input_files, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    h = human_inputs()
    for call in (
        lambda: TG.generate_human_assets(h["verts"], h["faces"],
                                         PORT_HUMAN[HUMAN], S),
        lambda: TG.generate_object_assets(h["verts"], PORT_OBJECT[OBJECT],
                                          S),
        lambda: TG.verify_contact_reconstruction(
            np.zeros((4, S, S), bool), np.zeros((4, S, S, 3), np.int32),
            np.zeros((4, S, S, 3), np.float32), np.zeros(3, bool)),
        lambda: TR.generate_pico_tree(str(tmp_path), pico_meshes(),
                                      PORT_OBJECT[OBJECT], S),
        lambda: TCLI.main(["piad", "--root", str(tmp_path), "--points_dir",
                           join(input_files, "piad_txt")]),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not os.listdir(tmp_path)
