"""Build, load and call the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. Libraries
are built at first use into ``build/kernels/`` at the repository root, named
by a hash of their sources and flags, so an edited source rebuilds and an
unchanged one is reused. Nothing here runs at import time: machines without
the CUDA toolkit import the package and use the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Callable, Dict, Iterable, Tuple

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
SOURCES = ("flash_attention", "flash_attention_bwd", "window_attention",
           "rel_attention", "int8_matmul", "int8_prequant", "int8_gemm_sm90",
           "int4_gemm_sm90", "serving_matmul", "mxu_probe", "window_copy")
_HEADERS = ("attention_core.cuh", "matmul_core.cuh", "sm90_core.cuh",
            "gemm_sm90.cuh", "flash_fwd_sm90.cuh", "flash_fwd_d16_sm90.cuh",
            "rel_attention_sm90.cuh",
            "flash_bwd_sm90.cuh", "window_attention_sm90.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_bound: Dict[Tuple[str, str], Callable] = {}


def _nvcc() -> str:
    cands = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    if os.environ.get("CUDA_HOME"):
        cands.insert(0, os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build only on a machine with the "
        "CUDA toolkit"
    )


def library_path(name: str) -> str:
    h = hashlib.sha256()
    for fn in (name + ".cu",) + _HEADERS:
        with open(os.path.join(CSRC, fn), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:12]}.so")


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile the named sources, one ``nvcc`` each, all started together.

    Returns each source's compiler report (``-Xptxas -v``: registers,
    shared memory, spills); empty for a library that was already built.
    Raises if any compile fails, after every compiler process has ended.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
               os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    reports = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(library_path(name))
        err = getattr(lib, f"ivlm_{name}_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        _loaded[name] = lib
    return lib


def _bind(name: str, fn: str, argtypes) -> Callable:
    lib = load(name)
    f = getattr(lib, fn)
    f.restype = ctypes.c_int
    f.argtypes = argtypes
    _bound[(name, fn)] = f
    return f


def launch(name: str, fn: str, argtypes, *args) -> None:
    """Call the C launcher ``fn`` of library ``name`` and raise if it
    reports a launch error. The library is built and loaded, and the
    function bound to its argument types, once, at its first launch: the
    int8 serving path launches thousands of times a batch."""
    f = _bound.get((name, fn)) or _bind(name, fn, argtypes)
    code = f(*args)
    if code != 0:
        msg = getattr(_loaded[name], f"ivlm_{name}_error_string")(code).decode()
        raise RuntimeError(f"{name} kernel launch failed ({code}): {msg}")


def require_kernel_inputs(kernel: str, *tensors: torch.Tensor,
                          dtype=torch.bfloat16) -> None:
    """Validate what a CUDA kernel takes; raise on anything else."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{kernel}: all inputs must be on one CUDA device")
        if t.dtype != dtype:
            raise ValueError(f"{kernel}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: inputs must be 16-byte aligned")


def require_strided_rows(kernel: str, *tensors: torch.Tensor,
                         dtype=torch.bfloat16) -> None:
    """Validate views a TMA kernel reads in place: one CUDA device, the
    dtype, unit stride on the last dim, every other stride a multiple of 16
    bytes, 16-byte aligned; raise on anything else."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{kernel}: all inputs must be on one CUDA device")
        if t.dtype != dtype:
            raise ValueError(f"{kernel}: expected {dtype}, got {t.dtype}")
        step = 16 // t.element_size()
        if t.stride(-1) != 1 or any(s % step for s in t.stride()[:-1]):
            raise ValueError(f"{kernel}: strides {t.stride()} are not unit "
                             f"on the last dim and 16-byte multiples")
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: inputs must be 16-byte aligned")


def refuse_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would need a gradient through a kernel that has
    no backward yet: its output would carry none, and the gradient would be
    cut without an error."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: no backward is ported; call it under torch.no_grad() "
            f"or on inputs that do not require grad")


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
