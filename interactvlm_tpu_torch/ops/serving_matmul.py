"""The bf16 serving matmul with a fused bias + GELU epilogue: the CUDA kernel
``csrc/serving_matmul.cu`` and its plain PyTorch version.

Port of ``interactvlm_tpu/ops/serving_matmul.py`` (the Pallas TPU kernels
``_kernel``, ``_kernel_nobias``, ``_kernel_ksplit`` and
``_kernel_ksplit_nobias``, wrapper ``fused_dense``): one CUDA kernel covers
all four, the bias and the activation being its arguments and K a loop
inside it. Only the chain probe runs it. The kernel source says what bounds
it on the H100 and how its design answers that.

Semantics, for x (..., K) bf16 and W (N, K) bf16 (the port's layout; the
JAX function takes (K, N)): out = act(f32(x @ W^T) + f32(bias)), cast to
``dtype`` (x's dtype by default), with ``activation`` "none", "gelu" (exact
erf; the TPU kernel's Abramowitz-Stegun polynomial is within 1.5e-7 of it)
or "gelu_tanh".
"""

from __future__ import annotations

import ctypes

import torch

from interactvlm_tpu_torch.ops import _cuda
from interactvlm_tpu_torch.ops.int8_matmul import ACTIVATIONS, apply_activation

OUT_DTYPES = (torch.bfloat16, torch.float32)


def fused_dense_plain(x, w, b=None, activation: str = "none", dtype=None):
    """Plain version of the kernel: the f32 product of the inputs, plus the
    bias in f32, then the activation, cast to ``dtype``."""
    K, N = x.shape[-1], w.shape[0]
    out = torch.matmul(x.reshape(-1, K).float(), w.float().t())
    if b is not None:
        out = out + b.float()
    out = apply_activation(out, activation)
    return out.to(dtype or x.dtype).reshape(*x.shape[:-1], N)


_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def fused_dense(x, w, b=None, activation: str = "none", dtype=None):
    """x (..., K) @ W (N, K) + b with an optional fused GELU -> (..., N) in
    ``dtype`` (x's dtype by default): bf16 in, f32 accumulation.

    CPU tensors run ``fused_dense_plain``; CUDA tensors launch the kernel (x
    and W bf16 and contiguous, K and N multiples of 8, the output bf16 or
    f32) or raise. Forward only."""
    _cuda.refuse_grad("fused_dense", x, w, b)
    dtype = dtype or x.dtype
    if not x.is_cuda:
        return fused_dense_plain(x, w, b, activation, dtype)
    K, N = x.shape[-1], w.shape[0]
    if w.dim() != 2 or w.shape[1] != K or K % 8 or N % 8:
        raise ValueError(f"fused_dense: weight (N, {K}) with K and N "
                         f"multiples of 8, got {tuple(w.shape)}")
    if dtype not in OUT_DTYPES or activation not in ACTIVATIONS:
        raise ValueError(f"fused_dense: output {dtype}, activation "
                         f"{activation!r}")
    _cuda.require_kernel_inputs("fused_dense", x, w)
    bias = None
    if b is not None:
        if b.shape != (N,) or b.device != x.device:
            raise ValueError(f"fused_dense: bias ({N},) on x's device, got "
                             f"{tuple(b.shape)} on {b.device}")
        bias = b.to(torch.float32).contiguous()  # exact from bf16
    out = torch.empty(*x.shape[:-1], N, dtype=dtype, device=x.device)
    with torch.cuda.device(x.device):
        _cuda.launch(
            "serving_matmul", "ivlm_fused_dense", _ARGTYPES,
            _cuda.ptr(x), _cuda.ptr(w),
            _cuda.ptr(bias) if bias is not None else ctypes.c_void_p(None),
            _cuda.ptr(out), int(dtype == torch.float32),
            ACTIVATIONS[activation], x.numel() // K, N, K,
            _cuda.stream_handle(x.device),
        )
    fused_dense.launches += 1
    return out


fused_dense.launches = 0
