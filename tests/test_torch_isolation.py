"""The port stands alone: it, ``chip_smoke.py`` and ``bench_torch.py``
import neither JAX nor any module of the JAX package, its entry points (the
CLIs and the ``bench.py`` twin among them) refuse to fall back to the CPU
when no GPU is present, its native decoder builds from its own copy of the
source under ``build/`` and leaves ``native/`` as it is, and its state dict
carries the reference's checkpoint keys (the JAX package's own converters
read it back into the tree ``from_jax_params`` took in)."""

import os
import subprocess
import sys

import flax.linen as nn
import numpy as np
import jax
import pytest
import torch

from interactvlm_tpu.config import interactvlm_tiny as jax_tiny
from interactvlm_tpu.models.interactvlm import InteractVLM as JaxIVLM
from interactvlm_tpu.utils.testing import make_synthetic_batch
from interactvlm_tpu.utils.weights import convert_interactvlm_checkpoint
from interactvlm_tpu_torch import config as C
from interactvlm_tpu_torch.datagen.__main__ import main as datagen_main
from interactvlm_tpu_torch.datagen.generate import (
    generate_human_assets,
    generate_object_assets,
)
from interactvlm_tpu_torch.datagen.recipes import (
    generate_damon_tree,
    generate_piad_tree,
    generate_pico_tree,
)
from interactvlm_tpu_torch.demo.demo_utils import generate_sam_inp_objs
from interactvlm_tpu_torch.demo.run_demo import main as demo_main
from interactvlm_tpu_torch.fit.data_io import main as fit_main
from interactvlm_tpu_torch.fit.fit import fit_human_object
from interactvlm_tpu_torch.eval.evaluate import main as eval_main
from interactvlm_tpu_torch.geometry.rasterizer import build_lift_maps, uv_sphere
from interactvlm_tpu_torch.geometry.views import HUMAN_VIEWS, OBJECT_VIEWS
from interactvlm_tpu_torch.models.clip_vit import CLIPVisionTower
from interactvlm_tpu_torch.models.interactvlm import InteractVLM
from interactvlm_tpu_torch.models.llama import LlamaForCausalLM
from interactvlm_tpu_torch.models.llava import LlavaModel
from interactvlm_tpu_torch.models.sam.image_encoder import ImageEncoderViT
from interactvlm_tpu_torch.models.sam.sam import Sam
from interactvlm_tpu_torch.parallel.mesh import Mesh
from interactvlm_tpu_torch.probes import data as data_probe
from interactvlm_tpu_torch.probes import decode as decode_probe
from interactvlm_tpu_torch.probes import int4 as int4_probe
from interactvlm_tpu_torch.probes import int8 as int8_probe
from interactvlm_tpu_torch.probes import lift as lift_probe
from interactvlm_tpu_torch.probes import sam as sam_probe
from interactvlm_tpu_torch.probes import train_step as train_step_probe
from interactvlm_tpu_torch.train.train import (
    build_model_and_config,
    main as train_main,
    parse_args,
)
from interactvlm_tpu_torch.utils.testing import (
    make_synthetic_batch as make_port_batch,
)
from interactvlm_tpu_torch.utils.weights import from_jax_params

import bench_torch
import graft_entry_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every head and decoder the port builds: the interaction token type with
# the DifDe decoders, vi_v1 cams, K = 2 slots, fusion and uncertainty
HOI = dict(token_type="Gen-Hu-Obj-DifDe", cam_encoder_type="vi_v1",
           hseg_token_idx=501, oseg_token_idx=502, max_seg_tokens=2,
           use_fusion=True, use_uncertainty=True)

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import interactvlm_tpu_torch
for info in pkgutil.walk_packages(interactvlm_tpu_torch.__path__,
                                  "interactvlm_tpu_torch."):
    importlib.import_module(info.name)
import chip_smoke
import graft_entry_torch
import bench_torch
bad = sorted(m for m in sys.modules
             if m == "interactvlm_tpu" or m.startswith("interactvlm_tpu."))
print("MODULES", len([m for m in sys.modules
                      if m.startswith("interactvlm_tpu_torch")]))
print("INT8", all(m in sys.modules for m in (
    "interactvlm_tpu_torch.ops.quant", "interactvlm_tpu_torch.ops.int8_matmul")))
print("TRAIN", all(m in sys.modules for m in (
    "interactvlm_tpu_torch.models.losses",
    "interactvlm_tpu_torch.train.optimizer",
    "interactvlm_tpu_torch.train.train_step",
    "interactvlm_tpu_torch.utils.testing")))
print("PROBES", all(m in sys.modules for m in (
    "interactvlm_tpu_torch.ops.serving_matmul", "interactvlm_tpu_torch.ops.mxu",
    "interactvlm_tpu_torch.probes.chain", "interactvlm_tpu_torch.probes.mxu",
    "interactvlm_tpu_torch.probes.winattn")))
print("GEOMETRY", all(m in sys.modules for m in (
    "interactvlm_tpu_torch.geometry.cameras",
    "interactvlm_tpu_torch.geometry.views",
    "interactvlm_tpu_torch.geometry.rasterizer")))
print("CLIS", all(m in sys.modules for m in (
    "interactvlm_tpu_torch.data.conversations",
    "interactvlm_tpu_torch.data.tokenization",
    "interactvlm_tpu_torch.data.transforms",
    "interactvlm_tpu_torch.data.collate",
    "interactvlm_tpu_torch.data.datasets",
    "interactvlm_tpu_torch.runtime.native_image",
    "interactvlm_tpu_torch.runtime.prefetch",
    "interactvlm_tpu_torch.runtime.hostmem",
    "interactvlm_tpu_torch.eval.metrics",
    "interactvlm_tpu_torch.utils.meters",
    "interactvlm_tpu_torch.utils.profiling",
    "interactvlm_tpu_torch.train.checkpoints",
    "interactvlm_tpu_torch.train.train",
    "interactvlm_tpu_torch.train.export",
    "interactvlm_tpu_torch.datagen.recipes",
    "interactvlm_tpu_torch.demo.demo_utils",
    "interactvlm_tpu_torch.fit.utils")))
print("FIT_DEMO", all(m in sys.modules for m in (
    "interactvlm_tpu_torch.fit.renderer",
    "interactvlm_tpu_torch.fit.icp",
    "interactvlm_tpu_torch.fit.optimizer",
    "interactvlm_tpu_torch.fit.fit",
    "interactvlm_tpu_torch.fit.data_io",
    "interactvlm_tpu_torch.geometry.point_raster",
    "interactvlm_tpu_torch.demo.run_demo")))
print("DATAGEN", all(m in sys.modules for m in (
    "interactvlm_tpu_torch.datagen.generate",
    "interactvlm_tpu_torch.datagen.recipes",
    "interactvlm_tpu_torch.datagen.__main__")))
print("PARALLEL", all(m in sys.modules for m in (
    "interactvlm_tpu_torch.parallel.mesh",
    "interactvlm_tpu_torch.parallel.collectives",
    "interactvlm_tpu_torch.parallel.launch",
    "interactvlm_tpu_torch.parallel.dryrun",
    "interactvlm_tpu_torch.utils.memory", "graft_entry_torch")))
print("ENTRY_PROBES", all(m in sys.modules for m in (
    "interactvlm_tpu_torch.probes.common", "interactvlm_tpu_torch.probes.sam",
    "interactvlm_tpu_torch.probes.int8", "interactvlm_tpu_torch.probes.int4",
    "interactvlm_tpu_torch.probes.decode", "interactvlm_tpu_torch.probes.lift",
    "interactvlm_tpu_torch.probes.data",
    "interactvlm_tpu_torch.probes.train_step",
    "interactvlm_tpu_torch.utils.lisa_tree")))
print("BENCH", "bench_torch" in sys.modules and "bench" not in sys.modules)
print("BAD", bad)
"""


def test_port_and_chip_smoke_import_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout
    n = int(res.stdout.split("MODULES ")[1].split()[0])
    assert n >= 45, res.stdout  # every submodule was imported
    assert "INT8 True" in res.stdout, res.stdout
    assert "TRAIN True" in res.stdout, res.stdout
    assert "PROBES True" in res.stdout, res.stdout
    assert "GEOMETRY True" in res.stdout, res.stdout
    assert "CLIS True" in res.stdout, res.stdout
    assert "FIT_DEMO True" in res.stdout, res.stdout
    assert "DATAGEN True" in res.stdout, res.stdout
    assert "PARALLEL True" in res.stdout, res.stdout
    assert "ENTRY_PROBES True" in res.stdout, res.stdout
    assert "BENCH True" in res.stdout, res.stdout


LAUNCHERS = ("train", "eval", "demo", "optim", "datagen", "prepare_weights")


@pytest.mark.parametrize("name", LAUNCHERS)
def test_launcher_twins_run_only_the_port(name):
    """Each ``scripts/run_<name>_torch.sh`` names the port's modules and no
    module of the JAX package."""
    import re

    with open(os.path.join(REPO, "scripts", f"run_{name}_torch.sh")) as f:
        text = f.read()
    modules = re.findall(r"python -m (\S+)", text)
    assert modules and all(m.startswith("interactvlm_tpu_torch.")
                           for m in modules), modules
    assert not re.search(r"interactvlm_tpu\.", text)
    assert "jax" not in text.lower()


_BUILD = r"""
from interactvlm_tpu_torch.runtime import native_image as n
print("AVAILABLE", n.available(), n.decoder(), n.build_error)
print("LIB", n.LIB_PATH)
print("SOURCE", n.SOURCE)
"""


def test_native_decoder_builds_under_build_and_leaves_native_alone(
        tmp_path):
    """In a fresh copy of the port and ``native/``, the port's decoder build
    compiles the port's own copy of the source (under
    ``interactvlm_tpu_torch/``) and writes its library under
    ``build/native`` and nothing else: ``native/`` (its sources and the JAX
    package's library) stays byte for byte."""
    import shutil

    for d in ("interactvlm_tpu_torch", "native"):
        shutil.copytree(os.path.join(REPO, d), tmp_path / d,
                        ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))

    def snapshot(root):
        return {os.path.relpath(os.path.join(d, f), root): open(
            os.path.join(d, f), "rb").read()
            for d, _, fs in os.walk(root) for f in fs
            if "__pycache__" not in d}

    before = snapshot(tmp_path)
    res = subprocess.run([sys.executable, "-c", _BUILD], cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=str(tmp_path)),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "AVAILABLE True native None" in res.stdout, res.stdout
    lib = os.path.join(str(tmp_path), "build", "native", "libivlm_io.so")
    assert f"LIB {lib}" in res.stdout
    source = res.stdout.split("SOURCE ")[1].strip()
    port = os.path.join(str(tmp_path), "interactvlm_tpu_torch") + os.sep
    assert source.startswith(port), source
    after = snapshot(tmp_path)
    new = sorted(set(after) - set(before))
    assert new == [os.path.join("build", "native", "libivlm_io.so")], new
    assert all(after[k] == v for k, v in before.items())


@pytest.mark.parametrize("build", [
    lambda: InteractVLM(C.interactvlm_tiny()),
    lambda: InteractVLM(C.interactvlm_tiny(**HOI)),
    lambda: LlavaModel(C.llama_tiny(), C.clip_tiny()),
    lambda: LlamaForCausalLM(C.llama_tiny()),
    lambda: CLIPVisionTower(C.clip_tiny()),
    lambda: Sam(C.sam_tiny()),
    lambda: LlamaForCausalLM(C.llama_tiny(weights_int8=True)),
    lambda: ImageEncoderViT(C.sam_tiny(weights_int8=True)),
    lambda: LlamaForCausalLM(C.llama_tiny(lora_rank=4)),
    lambda: make_port_batch(C.interactvlm_tiny()),
    lambda: LlamaForCausalLM(C.llama_tiny(weights_int8=True, lora_rank=4)),
    lambda: LlamaForCausalLM(C.llama_tiny(weights_int4=True)),
    lambda: build_lift_maps(*uv_sphere(8, 8), HUMAN_VIEWS[
        "4MV-Z_Vitru_mv2"].cam_params(), 16, 8),
    lambda: train_main(["--synthetic", "--log_base_dir", "/nonexistent"]),
    lambda: eval_main(["--run_dir", "/nonexistent"]),
    lambda: build_model_and_config(parse_args(["--model_scale", "tiny"])),
    lambda: generate_damon_tree("/nonexistent", {}, *uv_sphere(8, 8),
                                HUMAN_VIEWS["4MV-Z_Vitru_mv2"], 16, {}),
    lambda: fit_main(["--input_path", "/nonexistent"]),
    lambda: demo_main(["--img_folder", "/nonexistent", "--output_folder",
                       "/nonexistent", "--random_weights"]),
    lambda: fit_human_object({}),
    lambda: generate_sam_inp_objs(*uv_sphere(8, 8), "/nonexistent",
                                  image_size=16),
    lambda: datagen_main(["damon", "--root", "/nonexistent"]),
    lambda: generate_human_assets(*uv_sphere(8, 8), HUMAN_VIEWS[
        "4MV-Z_Vitru"], 16),
    lambda: generate_object_assets(uv_sphere(8, 8)[0], OBJECT_VIEWS[
        "4MV-Z_HM_BM"], 16),
    lambda: generate_piad_tree("/nonexistent", {}, OBJECT_VIEWS[
        "4MV-Z_HM_BM"], 16),
    lambda: generate_pico_tree("/nonexistent", {}, OBJECT_VIEWS[
        "4MV-Z_HM_BM"], 16),
    lambda: graft_entry_torch.entry(),
    lambda: graft_entry_torch.dryrun_multichip(2),
    lambda: LlamaForCausalLM(C.llama_tiny(), mesh=Mesh(1, 1)),
    lambda: sam_probe.main(["full"]),
    lambda: int8_probe.main(["qkv"]),
    lambda: int4_probe.main(["int8"]),
    lambda: decode_probe.main(["attn_dense"]),
    lambda: lift_probe.main(["resize_scatter"]),
    lambda: data_probe.main(["1"]),
    lambda: train_step_probe.main(),
    lambda: bench_torch.main(),
], ids=["InteractVLM", "InteractVLM-hoi", "LlavaModel", "LlamaForCausalLM", "CLIPVisionTower",
        "Sam", "LlamaForCausalLM-int8", "ImageEncoderViT-int8",
        "LlamaForCausalLM-lora", "make_synthetic_batch",
        "LlamaForCausalLM-qlora", "LlamaForCausalLM-int4",
        "build_lift_maps", "train_cli", "eval_cli",
        "build_model_and_config", "generate_damon_tree", "fit_cli",
        "demo_cli", "fit_human_object", "generate_sam_inp_objs",
        "datagen_cli", "generate_human_assets", "generate_object_assets",
        "generate_piad_tree", "generate_pico_tree", "graft_entry",
        "dryrun_multichip", "LlamaForCausalLM-mesh", "sam_probe",
        "int8_probe", "int4_probe", "decode_probe", "lift_probe",
        "data_probe", "train_step_probe", "bench_twin"])
def test_entry_points_default_to_the_gpu(build):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        build()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_state_dict_round_trips_through_the_jax_converters():
    """from_jax_params -> port state_dict -> the merged-checkpoint key
    layout -> ``convert_interactvlm_checkpoint`` (which runs
    ``convert_llama``, ``convert_sam`` and ``convert_clip_vision``) gives
    back every leaf of the original JAX tree, exactly."""
    jcfg = jax_tiny()
    batch = make_synthetic_batch(jcfg, B=2, L=12, mask_size=32)
    tree = jax.tree.map(np.asarray, nn.meta.unbox(
        JaxIVLM(jcfg).init(jax.random.PRNGKey(3), batch)))
    tm = InteractVLM(C.interactvlm_tiny(), device="cpu")
    tm.load_state_dict(from_jax_params(tree), strict=False)

    merged, clip_sd = {}, {}
    renames = [("llava.lm.model.", "model."), ("llava.lm.lm_head.", "lm_head."),
               ("llava.mm_projector.", "model.mm_projector."),
               ("sam.", "model.visual_model."),
               ("text_hidden_fcs.", "model.text_hidden_fcs."),
               ("cam_pose_encoder.", "cam_pose_encoder.")]
    for key, val in tm.state_dict().items():
        val = val.numpy()
        if key.startswith("llava.vision_tower."):
            clip_sd[key[len("llava.vision_tower."):]] = val
            continue
        for old, new in renames:
            if key.startswith(old):
                merged[new + key[len(old):]] = val
                break
        else:
            raise AssertionError(f"unmapped key {key}")
    back = _flat(convert_interactvlm_checkpoint(merged, jcfg, clip_sd))
    want = _flat(tree["params"])
    assert set(want) <= set(back), sorted(set(want) - set(back))
    for path, arr in want.items():
        np.testing.assert_array_equal(back[path], arr, err_msg=path)


def test_from_jax_params_fills_every_parameter_of_the_interaction_model():
    """Every parameter of a Gen-Hu-Obj-DifDe + vi_v1 + fusion port model
    gets a value from the JAX tree, and nothing is left over; the only keys
    missing are those the JAX tree cannot have: the mask-downscaling
    convolutions (no text-prompt path reaches them) and the uncertainty
    head (built, and called nowhere)."""
    jcfg = jax_tiny(**HOI)
    batch = make_synthetic_batch(jcfg, B=2, L=12, mask_size=32)
    tree = jax.tree.map(np.asarray, nn.meta.unbox(
        JaxIVLM(jcfg).init(jax.random.PRNGKey(4), batch)))
    assert "uncertainty" not in tree["params"]
    sd = from_jax_params(tree)
    tm = InteractVLM(C.interactvlm_tiny(**HOI), device="cpu")
    missing, unexpected = tm.load_state_dict(sd, strict=False)
    assert not unexpected
    assert missing and all("mask_downscaling" in k or k.startswith(
        "uncertainty.") for k in missing), missing
    assert {k.split(".")[0] for k in missing if "mask_downscaling" not in k
            } == {"uncertainty"}
    for head in ("attention_splitter.query_human", "cam_pose_encoder.view_3",
                 "fusion.sam_proj", "sam.human_mask_decoder.iou_token",
                 "sam.object_mask_decoder.transformer.layers.1.norm4"):
        assert any(k.startswith(head + ".") for k in sd), head
    # the values are the tree's, in the port's layout
    np.testing.assert_array_equal(
        sd["fusion.q_proj.weight"].numpy(),
        tree["params"]["fusion"]["q_proj"]["kernel"].T)
