"""The port's data layer against the JAX package's, on the CPU: the same
files and seeds through both give the same arrays.

Covered: conversations, the whitespace tokenizer and the seg-token
registry, tokenization, the image transforms, the native decoder (against
PIL; built into ``build/native``), the DAMON and LEMON ``HContactDataset``
samples, ``HContactSceneDataset``, ``ValDataset``, ``HybridDataset``,
``build_dataset``, ``collate`` (one-token, K-slot and multi-conversation),
``real_batch_iter``'s first two batches, the prefetch runtime, the metrics,
meters and DAMON reports, and the DAMON datagen recipe.

Tolerances: the data layer is exact (strings, ids, targets, images, masks,
batches equal element for element). The metrics and reports are numpy on
both sides: within 1e-6. The recipe's renders, masks and vertex ids are
equal; its barycentrics within 1e-4, the rasterizer's stated rounding
(``tests/test_torch_geometry.py``: XLA's vmapped ``build_lift_maps``
moves them by up to 7e-5 on the sphere's thinnest faces at 64^2). The
native decoder's fused SAM preprocess is held to the Python transform as
the JAX package holds its own (1e-2).
"""

import collections
import os
import pickle
import random
from argparse import Namespace
from os.path import join

import numpy as np
import pytest
import torch
from PIL import Image

from interactvlm_tpu.data import collate as JC
from interactvlm_tpu.data import conversations as JV
from interactvlm_tpu.data import datasets as JD
from interactvlm_tpu.data import tokenization as JT
from interactvlm_tpu.data import transforms as JX
from interactvlm_tpu.datagen.recipes import (
    generate_damon_tree as jax_damon_tree,
    generate_lemon_human_tree,
)
from interactvlm_tpu.eval import evaluate as JE
from interactvlm_tpu.eval import metrics as JM
from interactvlm_tpu.geometry.views import HUMAN_VIEWS
from interactvlm_tpu.utils import constants as JK
from interactvlm_tpu.utils import meters as JMT
from interactvlm_tpu.utils.testing import WhitespaceTokenizer as JaxTok
from interactvlm_tpu_torch.data import collate as TC
from interactvlm_tpu_torch.data import conversations as TV
from interactvlm_tpu_torch.data import datasets as TD
from interactvlm_tpu_torch.data import tokenization as TT
from interactvlm_tpu_torch.data import transforms as TX
from interactvlm_tpu_torch.datagen.recipes import (
    generate_damon_tree as port_damon_tree,
)
from interactvlm_tpu_torch.eval import evaluate as TE
from interactvlm_tpu_torch.eval import metrics as TM
from interactvlm_tpu_torch.geometry.views import HUMAN_VIEWS as PORT_VIEWS
from interactvlm_tpu_torch.runtime import native_image
from interactvlm_tpu_torch.runtime.prefetch import (
    ParallelSampler,
    PrefetchIterator,
    iter_sample_batches,
)
from interactvlm_tpu_torch.utils import constants as TK
from interactvlm_tpu_torch.utils import meters as TMT
from interactvlm_tpu_torch.utils.testing import WhitespaceTokenizer as PortTok

from tests.test_datagen_recipes import sphere_mesh

S = 64  # sam_tiny img_size
VIEWS = "4MV-Z_Vitru_mv2"


def damon_annotations(n_verts, n_images=6):
    """Contacts of ``n_images`` images: one object each, and a
    'supporting' contact on every other (which yields foot_ground)."""
    objs = ["chair", "bicycle", "cup", "skateboard", "bed", "ball"]
    annot = {}
    for i in range(n_images):
        a = {objs[i % len(objs)]: np.arange(i * 20, i * 20 + 40) % n_verts}
        if i % 2 == 0:
            a["supporting"] = np.concatenate(
                [np.arange(0, 8), np.arange(n_verts - 25, n_verts)])
        annot[f"img{i}.jpg"] = a
    return annot


def body_segmentation(n):
    return {"head": list(range(0, n // 4)),
            "torso": list(range(n // 4, n // 2)),
            "legs": list(range(n // 2, n - 20)),
            "left foot": list(range(n - 20, n - 10)),
            "right foot": list(range(n - 10, n))}


def make_damon_tree(root, n_images=6, generate=jax_damon_tree, **kw):
    """The JAX recipe's DAMON tree of the 178-vertex sphere at 64^2, with
    non-square JPEG photos (their CLIP resize runs both axes)."""
    verts, faces = sphere_mesh()
    rng = np.random.default_rng(0)
    os.makedirs(join(root, "images"), exist_ok=True)
    annot = damon_annotations(len(verts), n_images)
    for name in annot:
        Image.fromarray(rng.integers(0, 255, (40, 52, 3), np.uint8)).save(
            join(root, "images", name))
    views = (PORT_VIEWS if generate is port_damon_tree else HUMAN_VIEWS)[VIEWS]
    return generate(root, annot, verts, faces, views, S,
                    body_segmentation(len(verts)), **kw)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("damon"))
    make_damon_tree(root)
    # a LEMON-HU source beside it
    verts, faces = sphere_mesh()
    os.makedirs(join(root, "lemon", "Images"), exist_ok=True)
    contacts = {}
    for i, cls in enumerate(["mug", "bottle", "knife"]):
        name = f"lemon/Images/{cls}_{i:04d}.jpg"
        Image.fromarray(np.full((24, 30, 3), 40 * i, np.uint8)).save(
            join(root, name))
        c = np.zeros(len(verts), np.float32)
        c[i * 30:i * 30 + 25] = 1.0
        contacts[name] = c
    generate_lemon_human_tree(root, contacts, verts, faces,
                              HUMAN_VIEWS[VIEWS], S,
                              body_segmentation(len(verts)))
    return root


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_samples_equal(a, b):
    for f in ("image_path", "conversations", "resize", "questions",
              "sampled_classes", "ds_name", "mask_paths", "inference",
              "num_valid_verts"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("sam_images", "image_clip", "masks", "label", "gt_contact_3d",
              "cam_params"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def assert_batches_equal(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k, v in want.items():
        g = got[k]
        assert torch.is_tensor(g), k
        v = np.asarray(v)
        assert g.dtype == torch.from_numpy(v).dtype and tuple(g.shape) == \
            v.shape, (k, g.dtype, v.dtype, g.shape, v.shape)
        np.testing.assert_array_equal(g.numpy(), v, err_msg=k)


# ----------------------------------------------------------- text
@pytest.mark.parametrize("conv_type", ["llava_v1", "llava_llama_2"])
def test_conversation_prompts_equal(conv_type):
    for msgs in ([("q1", "a1")], [("q1", "a1"), ("q2", "")],
                 [("<image>\nq", "It is [SEG].")]):
        out = []
        for mod in (JV, TV):
            conv = mod.get_conversation_template(conv_type)
            for q, a in msgs:
                conv.append_message(conv.roles[0], q)
                conv.append_message(conv.roles[1], a)
            out.append(conv.get_prompt())
        assert out[0] == out[1]
    assert JD.build_conversation("q", "a") == TD.build_conversation("q", "a")


def test_constants_and_seg_token_registry_equal():
    for name in ("HCONTACT_QUESTION_LIST", "HCONTACT_ANSWER_LIST",
                 "HCONTACT_PARTS_QUESTION_LIST", "HCONTACT_PARTS_ANSWER_LIST",
                 "OAFFORD_QUESTION_LIST", "ANSWER_LIST", "SHORT_QUESTION_LIST",
                 "IGNORE_LABEL", "IGNORE_INDEX", "IMAGE_TOKEN_INDEX",
                 "SAM_MEAN_PIXEL", "CLIP_STD_PIXEL"):
        assert getattr(JK, name) == getattr(TK, name), name
    assert TK.TASK_IDS == JC.TASK_IDS
    from interactvlm_tpu.geometry.views import DAMON_CATEGORIES_MAPPING
    assert dict(TK.DAMON_CATEGORIES_MAPPING) == dict(DAMON_CATEGORIES_MAPPING)
    for tt in ("Gen", "Gen-Int", "Gen-Hu-Obj", "Gen-Hu-Obj-DifDe"):
        assert TK.seg_token_strings(tt) == JK.seg_token_strings(tt)
        text = "Sure, [HTOKEN] and [OTOKEN]."
        assert TK.substitute_seg_tokens(text, tt) == \
            JK.substitute_seg_tokens(text, tt)
        jt, *jids = JK.add_new_tokens(JaxTok(), tt)
        pt, *pids = TK.add_new_tokens(PortTok(), tt)
        assert pids == jids and pt.vocab == jt.vocab
    for name in ("vqa", "hcontact_scene", "oafford", "refer_seg_lisa", "x"):
        assert TC.task_id_for(name) == JC.task_id_for(name)


def _conversations():
    rng = random.Random(3)
    convs = []
    for _ in range(6):
        q = rng.choice(JK.HCONTACT_PARTS_QUESTION_LIST).format(
            class_name="chair")
        a = rng.choice(JK.HCONTACT_PARTS_ANSWER_LIST).format(
            body_parts="left foot, head")
        convs.append(JD.build_conversation(
            q, JK.substitute_seg_tokens(a, "Gen-Hu-Obj")))
    convs.append(JD.build_conversation("plain text, no image", "[SEG]."))
    return convs


@pytest.mark.parametrize("max_len", [384, 24])
def test_tokenizer_and_tokenization_equal(max_len):
    jt, pt = JaxTok(384), PortTok(384)
    JK.add_new_tokens(jt, "Gen-Hu-Obj")
    TK.add_new_tokens(pt, "Gen-Hu-Obj")
    convs = _conversations()
    for c in convs:
        w = JT.wrap_image_tokens(c)
        assert TT.wrap_image_tokens(c) == w
        assert pt(w).input_ids == jt(w).input_ids
        ids = JT.tokenizer_image_token(w, jt)
        assert TT.tokenizer_image_token(w, pt) == ids
        np.testing.assert_array_equal(TT.build_targets(w, ids, pt),
                                      JT.build_targets(w, ids, jt))
    got = TT.tokenize_conversations(convs, pt, max_len)
    want = JT.tokenize_conversations(convs, jt, max_len)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert pt.decode([4, 5, 6, 1]) == jt.decode([4, 5, 6, 1])


# ----------------------------------------------------------- images
@pytest.mark.parametrize("hw", [(37, 53), (64, 20), (8, 8)])
def test_transforms_equal(hw):
    rng = np.random.default_rng(sum(hw))
    img = rng.integers(0, 256, hw + (3,), np.uint8)
    mask = (rng.random(hw) > 0.6).astype(np.float32)
    for out in ((17, 29), (64, 64), (5, 3)):
        np.testing.assert_array_equal(TX._bilinear_resize(img, *out),
                                      JX._bilinear_resize(img, *out))
    np.testing.assert_array_equal(TX.resize_longest_side(img, 48),
                                  JX.resize_longest_side(img, 48))
    for a, b in zip(TX.sam_preprocess(img, 64), JX.sam_preprocess(img, 64)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TX.sam_label_preprocess(mask, 64),
                                  JX.sam_label_preprocess(mask, 64))
    np.testing.assert_array_equal(TX.clip_preprocess(img, 28),
                                  JX.clip_preprocess(img, 28))
    img[:3] = 255
    np.testing.assert_array_equal(TX.valid_region_mask(img),
                                  JX.valid_region_mask(img))


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    arr = np.random.default_rng(0).integers(0, 255, (37, 53, 3), np.uint8)
    files = {"png": str(d / "a.png"), "jpg": str(d / "b.jpg"),
             "gray": str(d / "g.png"), "rgba": str(d / "r.png")}
    Image.fromarray(arr).save(files["png"])
    Image.fromarray(arr).save(files["jpg"], quality=95)
    Image.fromarray(arr[..., 0]).save(files["gray"])
    Image.fromarray(np.dstack([arr, arr[..., :1]])).save(files["rgba"])
    return arr, files


def test_native_decoder_equals_pil(image_files):
    arr, files = image_files
    assert native_image.available(), native_image.build_error
    assert native_image.decoder() == "native"
    before = dict(native_image.loads)
    for kind in ("png", "gray", "rgba"):
        got = native_image.decode_rgb(files[kind])
        np.testing.assert_array_equal(got, JX.load_image_rgb(files[kind]),
                                      err_msg=kind)
        np.testing.assert_array_equal(native_image.load_rgb(files[kind]),
                                      got)
    # JPEGs load through PIL, as the JAX datasets load them
    np.testing.assert_array_equal(native_image.load_rgb(files["jpg"]),
                                  JX.load_image_rgb(files["jpg"]))
    assert native_image.loads["native_png"] - before.get("native_png",
                                                         0) == 6
    assert native_image.loads["pil_jpeg"] - before.get("pil_jpeg", 0) == 1
    assert native_image.loads["pil_png"] == before.get("pil_png", 0)
    fused, hw = native_image.sam_preprocess_native(files["png"], 64)
    ref, ref_hw = TX.sam_preprocess(arr, 64)
    assert hw == ref_hw
    assert np.abs(fused - ref).max() < 1e-2
    with pytest.raises(IOError):
        native_image.decode_rgb("/nonexistent/file.png")


def test_decoder_counts_and_hybrid_picks_hold_under_threads(image_files):
    """Many threads load PNGs and draw mixture picks at once, with the
    interpreter switching threads as often as it can: every load is
    counted and every pick is a valid (dataset, index) pair."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    _, files = image_files
    hybrid = TD.HybridDataset([list(range(10)), list(range(100))], [1, 3],
                              samples_per_epoch=64)
    before = sum(native_image.loads.values())
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=32) as pool:
            loads = [pool.submit(native_image.load_rgb, files["gray"])
                     for _ in range(320)]
            picks = [pool.submit(hybrid.pick) for _ in range(320)]
            for f in loads:
                assert f.result(timeout=60).shape == (37, 53, 3)
            for f in picks:
                ds, j = f.result(timeout=60)
                assert 0 <= j < len(ds)
    finally:
        sys.setswitchinterval(old)
    assert sum(native_image.loads.values()) - before == 320


# ----------------------------------------------------------- datasets
def _args(**kw):
    a = dict(image_size=S, clip_size=28, num_human_vertices=178,
             hC_sam_view_type=VIEWS, hC_question_type="parts",
             fixed_templates=False, num_conversations=1)
    a.update(kw)
    return Namespace(**a)


@pytest.mark.parametrize("fixed", [True, False], ids=["fixed", "seeded"])
@pytest.mark.parametrize("sources", ["damon", "lemon", "damon,lemon"])
def test_hcontact_samples_equal(tree, sources, fixed):
    kw = dict(image_size=S, clip_size=28, num_vertices=178, sources=sources)
    jd = JD.HContactDataset(tree, **kw)
    before = collections.Counter(native_image.loads)
    td = TD.HContactDataset(tree, **kw)
    if fixed:
        jd.rng, td.rng = JD.TemplateFixedRandom(42), TD.TemplateFixedRandom(42)
    assert jd.samples == td.samples and len(td) > 0
    for i in range(len(td)):
        assert_samples_equal(td[i], jd[i])
    # the V renders once, then a sample's V masks (PNG) and its photo (JPEG)
    V = len(td.sam_images)
    assert native_image.loads - before == {"native_png": V * (len(td) + 1),
                                           "pil_jpeg": len(td)}


def test_scene_val_and_build_dataset_equal(tree):
    kw = dict(image_size=S, clip_size=28, num_vertices=178)
    jd, td = JD.HContactSceneDataset(tree, **kw), \
        TD.HContactSceneDataset(tree, **kw)
    assert {s[3] for s in td.samples} == {"scene"}
    for i in range(len(td)):
        assert_samples_equal(td[i], jd[i])
    for fixed in (False, True):
        for name in ("hcontact", "hcontact_scene"):
            args = _args(fixed_templates=fixed)
            jv = JD.ValDataset(JD.build_dataset(name, tree, "test", args))
            tv = TD.ValDataset(TD.build_dataset(name, tree, "test", args))
            assert type(tv.dataset.rng).__name__ == type(
                jv.dataset.rng).__name__
            for i in (3, 0, len(tv) - 1, 3):  # re-seeded per index
                s = tv[i]
                assert s.inference
                assert_samples_equal(s, jv[i])


@pytest.fixture(scope="module")
def lisa_tree(tmp_path_factory):
    from interactvlm_tpu_torch.utils.lisa_tree import write_lisa_tree

    root = str(tmp_path_factory.mktemp("lisa"))
    write_lisa_tree(root, n_ade=3, n_refcoco=2, n_reason=3, n_vqa=1,
                    scale=1 / 16)
    return root


@pytest.mark.parametrize("name", ("reason_seg", "refer_seg",
                                  "refer_seg_lisa", "sem_seg",
                                  "sem_seg_lisa"))
def test_unported_datasets_raise_with_their_roadmap_item(lisa_tree, name):
    """The five LISA names, which raised until the port had them, build
    and give the JAX package's first items (the item by item tests are
    ``tests/test_torch_lisa_data.py``)."""
    args = _args()
    td = TD.build_dataset(name, lisa_tree, "train", args)
    jd = JD.build_dataset(name, lisa_tree, "train", args)
    assert type(td).__name__ == type(jd).__name__ and len(td) == len(jd)
    for i in range(min(2, len(td))):
        a, b = td[i], jd[i]
        assert a.conversations == b.conversations
        assert a.sampled_classes == b.sampled_classes
        np.testing.assert_array_equal(a.masks, b.masks)


def test_hybrid_picks_equal(tree):
    kw = dict(image_size=S, clip_size=28, num_vertices=178)
    jh = JD.HybridDataset([JD.HContactDataset(tree, **kw),
                           JD.HContactSceneDataset(tree, **kw)],
                          [3.0, 1.0], samples_per_epoch=16)
    th = TD.HybridDataset([TD.HContactDataset(tree, **kw),
                           TD.HContactSceneDataset(tree, **kw)],
                          [3.0, 1.0], samples_per_epoch=16)
    assert len(th) == 16
    for i in range(10):
        assert_samples_equal(th[i], jh[i])


# ----------------------------------------------------------- collate
def _samples(tree, n=4, **kw):
    args = dict(image_size=S, clip_size=28, num_vertices=178)
    args.update(kw)
    jd, td = JD.HContactDataset(tree, **args), TD.HContactDataset(tree, **args)
    return [jd[i] for i in range(n)], [td[i] for i in range(n)]


def _maps(tree):
    m = np.load(join(tree, "hcontact_vitruvian_mv2", "lift_maps.npz"))
    return {"p2v": np.ascontiguousarray(np.moveaxis(m["p2v"], -1, 0)),
            "bary": np.ascontiguousarray(np.moveaxis(m["bary"], -1, 0))}


@pytest.mark.parametrize("max_seg_tokens", [1, 2])
def test_collate_equal_key_by_key(tree, max_seg_tokens):
    js, ts = _samples(tree)
    # a K-slot sample: two mask sets for its two seg tokens
    js[1].masks_k = ts[1].masks_k = np.stack([ts[1].masks, ts[2].masks])
    jt, pt = JaxTok(384), PortTok(384)
    JK.add_new_tokens(jt, "Gen")
    TK.add_new_tokens(pt, "Gen")
    kw = dict(max_len=384, num_human_vertices=178, num_object_points=32,
              max_seg_tokens=max_seg_tokens)
    maps = _maps(tree)
    want, wmeta = JC.collate(js, jt, human_maps=maps, **kw)
    got, gmeta = TC.collate(ts, pt, human_maps=maps, **kw)
    assert_batches_equal(got, want)
    assert gmeta.keys() == wmeta.keys()
    for k in wmeta:
        if k != "label_list":
            assert gmeta[k] == wmeta[k], k
    for a, b in zip(gmeta["label_list"], wmeta["label_list"]):
        np.testing.assert_array_equal(a, b)
    # object maps ride along when asked for (rows without maps carry -1)
    want, _ = JC.collate(js, jt, include_object_maps=True,
                         max_object_vertices=64, **kw)
    got, _ = TC.collate(ts, pt, include_object_maps=True,
                        max_object_vertices=64, **kw)
    assert_batches_equal(got, want)


def test_multiconversation_collate_equal(tree):
    js, ts = _samples(tree, 3)
    for ss in (js, ts):  # two classes, one mask each, on the first sample
        ss[0].conversations = ss[0].conversations * 2
        ss[0].masks = ss[0].masks[:2]
        ss[0].sampled_classes = ss[0].sampled_classes * 2
    jt, pt = JaxTok(384), PortTok(384)
    want, wmeta = JC.collate(js, jt, max_len=384, num_conversations=2,
                             num_human_vertices=178, human_maps=_maps(tree))
    got, gmeta = TC.collate(ts, pt, max_len=384, num_conversations=2,
                            num_human_vertices=178, human_maps=_maps(tree))
    assert_batches_equal(got, want)
    assert gmeta["row_map"] == wmeta["row_map"]


def test_to_device_keeps_values_and_metadata():
    batch = {"a": torch.arange(4), "meta": ["x"]}
    out = TC.to_device(batch, "cpu")
    assert torch.equal(out["a"], batch["a"]) and out["meta"] == ["x"]


def _train_args(tree, **kw):
    from interactvlm_tpu.train.train import parse_args as jax_parse_args

    argv = ["--tokenizer", "whitespace", "--model_scale", "tiny",
            "--dataset_dir", tree, "--image_size", str(S),
            "--clip_size", "28", "--num_human_vertices", "178",
            "--model_max_length", "384", "--batch_size", "3",
            "--steps_per_epoch", "2", "--data_workers", "1",
            "--prefetch_depth", "1"]
    for k, v in kw.items():
        argv += [f"--{k}"] + ([] if v is True else [str(v)])
    return jax_parse_args(argv)


@pytest.mark.parametrize("fixed", [True, False], ids=["fixed", "seeded"])
def test_real_batch_iter_first_two_batches_equal(tree, fixed):
    """One worker: the mixture's picks, the templates and the parts
    dropout draw in the same order on both sides."""
    from interactvlm_tpu.train.train import real_batch_iter as jax_iter
    from interactvlm_tpu_torch.train.train import real_batch_iter

    kw = {"fixed_templates": True} if fixed else {}
    args = _train_args(tree, dataset="hcontact||hcontact_scene",
                       sample_rates="2,1", **kw)
    cfg = Namespace(num_human_vertices=178, num_object_points=2048,
                    max_seg_tokens=1)
    jt, pt = JaxTok(384), PortTok(384)
    JK.add_new_tokens(jt, "Gen")
    TK.add_new_tokens(pt, "Gen")
    jit_, pit = jax_iter(args, cfg, jt), real_batch_iter(args, cfg, pt)
    for _ in range(2):
        got, want = next(pit), next(jit_)
        assert_batches_equal(got, {k: np.asarray(v) for k, v in
                                   want.items()})


def test_closed_real_loader_leaves_nothing_decoding(tree):
    """After ``close``, every sample the loader started has finished (its
    V mask PNGs and its photo, after the dataset's V renders) and no
    look-ahead sample goes on decoding."""
    import time

    from interactvlm_tpu_torch.train.train import real_batch_iter

    args = _train_args(tree, data_workers=4, prefetch_depth=2)
    cfg = Namespace(num_human_vertices=178, num_object_points=2048,
                    max_seg_tokens=1)
    tok = PortTok(384)
    TK.add_new_tokens(tok, "Gen")
    before = collections.Counter(native_image.loads)
    loader = real_batch_iter(args, cfg, tok)
    next(loader)
    loader.close()
    done = native_image.loads - before
    time.sleep(0.2)
    assert native_image.loads - before == done
    assert done["native_png"] == 4 * (done["pil_jpeg"] + 1)
    assert done["pil_jpeg"] >= args.batch_size


# ----------------------------------------------------------- runtime
def test_prefetch_and_samplers():
    assert list(PrefetchIterator(iter(range(10)), depth=3)) == list(range(10))

    def boom():
        yield 1
        raise ValueError("boom")

    it = PrefetchIterator(boom())
    assert next(it) == 1
    with pytest.raises(ValueError):
        next(it)
    def endless():
        i = 0
        while True:
            yield i
            i += 1

    it = PrefetchIterator(endless(), depth=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()  # the producer stops and lets go of what it held
    assert not it.thread.is_alive() and it.q.empty() and it.it is None
    sampler = ParallelSampler(lambda i: i * i, num_workers=3)
    assert list(sampler.iterate(range(20))) == [i * i for i in range(20)]
    assert list(iter_sample_batches(list(range(7)), 3, num_workers=2)) == [
        [0, 1, 2], [3, 4, 5], [6]]


# ----------------------------------------------------------- metrics
def test_metrics_meters_and_damon_reports_equal():
    rng = np.random.default_rng(7)
    B, N = 6, 50
    gt = (rng.random((B, N)) > 0.7).astype(np.float32)
    pred = rng.random((B, N)).astype(np.float32)
    dist = rng.random((N, N))
    dist = (dist + dist.T) / 2
    logits = rng.normal(size=(4, 16, 16))
    masks = rng.integers(-1, 2, (4, 16, 16))
    np.testing.assert_allclose(TM.contact_f1(gt, pred, 0.4),
                               JM.contact_f1(gt, pred, 0.4), rtol=1e-6)
    np.testing.assert_allclose(TM.geodesic_contact_errors(pred, gt, dist),
                               JM.geodesic_contact_errors(pred, gt, dist),
                               rtol=1e-6)
    for a, b in zip(TM.segmentation_metrics(logits, masks),
                    JM.segmentation_metrics(logits, masks)):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    np.testing.assert_allclose(TM.affordance_metrics(gt, pred, N),
                               JM.affordance_metrics(gt, pred, N), rtol=1e-6)
    labels = rng.random(40) > 0.5
    scores = np.round(rng.random(40), 1)  # ties
    assert abs(TM.auc_score(labels, scores) - JM.auc_score(labels, scores)
               ) < 1e-6
    assert abs(TM.similarity(pred[0], gt[0]) - JM.similarity(pred[0], gt[0])
               ) < 1e-6
    for a, b in zip(TM.intersection_and_union(masks[0] > 0, masks[0]),
                    JM.intersection_and_union(masks[0] > 0, masks[0])):
        np.testing.assert_array_equal(a, b)

    tm, jm = TMT.AverageMeter("x"), JMT.AverageMeter("x")
    for v in (np.array([1.0, 0.5]), np.array([2.0, 3.0]),
              np.array([np.nan, 1.0]), np.array([4.0, np.inf]), 0.25):
        tm.update(v, n=2)
        jm.update(v, n=2)
    tm.all_reduce()  # one process: unchanged
    np.testing.assert_allclose(tm.avg, jm.avg, rtol=1e-6)
    assert tm.count == jm.count and str(tm) == str(jm)
    assert TMT.ProgressMeter(5, [tm], "ep").display(2) == \
        JMT.ProgressMeter(5, [jm], "ep").display(2)
    assert TMT.Summary.SUM.value == JMT.Summary.SUM.value

    objs = ["chair", "Bicycle", "cup", "chair", "unknownthing", "bed"]
    saved = {"imgnames": [[f"img{i // 2}"] for i in range(B)],
             "pred": list(pred >= 0.5), "gt": list(gt > 0),
             "f1": [JM.contact_f1(gt[i:i + 1], pred[i:i + 1])[0]
                    for i in range(B)],
             "geo": list(rng.random(B)),
             "objnames": [[[o]] for o in objs]}
    got = TE.damon_binary_contact(saved)
    want = JE.damon_binary_contact(saved)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) < 1e-6, k
    got, want = TE.damon_semantic_contact(saved), \
        JE.damon_semantic_contact(saved)
    assert abs(got["weighted_f1"] - want["weighted_f1"]) < 1e-6
    for part in ("objectwise", "categories"):
        assert got[part].keys() == want[part].keys()
        for k in want[part]:
            for m in want[part][k]:
                assert abs(got[part][k][m] - want[part][k][m]) < 1e-6


# ----------------------------------------------------------- datagen
def test_damon_recipe_equals_jax(tmp_path):
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    jout = make_damon_tree(jroot, n_images=4)
    tout = make_damon_tree(troot, n_images=4, generate=port_damon_tree,
                           device="cpu")
    assert "foot_ground" in tout["annot"]["img0.jpg"]

    def files(root):
        return sorted(os.path.relpath(join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert files(troot) == files(jroot)
    np.testing.assert_array_equal(tout["p2v"], np.asarray(jout["p2v"]))
    for rel in files(jroot):
        a, b = join(jroot, rel), join(troot, rel)
        if rel.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(b)),
                                          np.asarray(Image.open(a)),
                                          err_msg=rel)
        elif rel.endswith(".pkl"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert repr(pickle.load(fb)) == repr(pickle.load(fa)), rel
        elif rel.endswith(".npz"):
            za, zb = np.load(a), np.load(b)
            np.testing.assert_array_equal(zb["p2v"], za["p2v"])
            assert zb["bary"].dtype == za["bary"].dtype
            assert np.abs(zb["bary"] - za["bary"]).max() <= 1e-4
    # the port's tree loads into the port's dataset as the JAX tree does
    for i in range(3):
        a = JD.HContactDataset(jroot, image_size=S, num_vertices=178)[i]
        b = TD.HContactDataset(troot, image_size=S, num_vertices=178)[i]
        b.image_path = b.image_path.replace(troot, jroot)
        b.mask_paths = [m.replace(troot, jroot) for m in b.mask_paths]
        assert_samples_equal(b, a)
