"""The tensor-core rate loop: the CUDA kernel ``csrc/mxu_probe.cu`` and its
plain PyTorch version.

Port of the Pallas TPU kernel ``scripts/mxu_probe.py:_kernel``: out =
f32(sum over ``loops`` of x @ W^T) for x (M, K) and W (N, K) in bf16, int8
or f32, accumulated in f32 or (int8 only) int32. Only the mxu probe runs it.
The kernel source says how it keeps the tensor cores busy on the H100.

Accumulation: a bf16 or f32 product accumulates in f32 (an f32 product,
never TF32); int8 x int8 accumulates in int32, wrapping as two's
complement, or in f32. For int8 -> f32 the TPU kernel and the plain version
add each product's exact int32 sum to the f32 accumulator once a loop; the
kernel adds the exact int32 sum of each 128-element K chunk, so it rounds
K / 128 times a loop. The two agree exactly while every sum stays below
2^24 (a few loops at the probe's shapes) and differ in rounding above it
(the probe's 2048 timed loops).
"""

from __future__ import annotations

import ctypes
import math

import torch

from interactvlm_tpu_torch.ops import _cuda

TILE = 64  # the f32 kernel's output tile: M and N must be multiples of it
CHUNK_BYTES = 128  # the kernel's K chunk: K must be a multiple of it in bytes
COMBOS = {(torch.bfloat16, torch.float32): 0, (torch.int8, torch.int32): 1,
          (torch.int8, torch.float32): 2, (torch.float32, torch.float32): 3}
F32_COMBO = 3  # on the CUDA cores; the others on wgmma
# each combination's output tile (mxu_probe.cu): two warpgroups of 64 rows
# by the widest wgmma product that fits in registers beside the sums
TILES = {0: (128, 256), 1: (128, 256), 2: (128, 128), 3: (TILE, TILE)}


def tile_count(combo: int, M: int, N: int) -> int:
    """Output tiles of the kernel for ``combo`` over an (M, N) output; the
    wgmma tiles cover a ragged edge, zero-filled."""
    bm, bn = TILES[combo]
    return -(-M // bm) * -(-N // bn)


def mxu_loop_plain(x, w, loops: int, acc_dtype=torch.float32):
    """Plain version of the kernel: the dot once (exactly, for int8), then
    summed ``loops`` times in the accumulator's type; int32 sums wrap."""
    if x.dtype == torch.int8:
        d = torch.matmul(x.double(), w.double().t())  # exact: |d| < 2^53
        if acc_dtype == torch.int32:
            total = d.long() * loops
            return ((total + 2 ** 31) % 2 ** 32 - 2 ** 31).float()
        d = d.float()
    else:
        d = torch.matmul(x.float(), w.float().t())
    acc = torch.zeros_like(d)
    for _ in range(loops):
        acc = acc + d
    return acc


_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def loop_slices(tiles: int, loops: int, sms: int) -> int:
    """How many slices the loops are split into over blocks: enough that
    tiles x slices is a multiple of the SM count (so every SM gets the same
    count of blocks), never more than the loops."""
    return max(1, min(loops, sms // math.gcd(tiles, sms)))


def mxu_loop(x, w, loops: int, acc_dtype=torch.float32):
    """f32(sum over ``loops`` of x (M, K) @ W (N, K)^T) -> (M, N) f32.

    CPU tensors run ``mxu_loop_plain``; CUDA tensors launch the kernel (x
    and W of one of bf16, int8, f32, contiguous; K a multiple of 128 bytes;
    for f32, M and N multiples of 64) or raise."""
    _cuda.refuse_grad("mxu_loop", x, w)
    if not x.is_cuda:
        return mxu_loop_plain(x, w, loops, acc_dtype)
    combo = COMBOS.get((x.dtype, acc_dtype))
    M, K = x.shape
    N = w.shape[0]
    if combo is None:
        raise ValueError(f"mxu_loop: no kernel for {x.dtype} -> {acc_dtype}")
    if (w.shape != (N, K) or (K * x.element_size()) % CHUNK_BYTES
            or loops < 0 or (combo == F32_COMBO and (M % TILE or N % TILE))):
        raise ValueError(f"mxu_loop: K a multiple of {CHUNK_BYTES} bytes (and "
                         f"for f32, M and N multiples of {TILE}), got "
                         f"{tuple(x.shape)} {tuple(w.shape)}")
    _cuda.require_kernel_inputs("mxu_loop", x, w, dtype=x.dtype)
    out = torch.zeros(M, N, dtype=acc_dtype, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    slices = loop_slices(tile_count(combo, M, N), loops, sms)
    with torch.cuda.device(x.device):
        _cuda.launch(
            "mxu_probe", "ivlm_mxu_loop", _ARGTYPES,
            _cuda.ptr(x), _cuda.ptr(w), _cuda.ptr(out), combo, M, N, K,
            loops, slices, _cuda.stream_handle(x.device),
        )
    mxu_loop.launches += 1
    return out.float()


mxu_loop.launches = 0
