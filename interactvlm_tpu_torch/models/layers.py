"""Linear and LayerNorm layers that compute in their parameter dtype, and the
int8 linear layer of the serving path.

Like flax's ``nn.Dense(dtype=...)``, they cast the input to the layer's
dtype first, so an f32 positional encoding added to a bf16 stream feeds a
bf16 layer without a dtype error. State-dict keys are those of
``torch.nn.Linear`` / ``torch.nn.LayerNorm``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from interactvlm_tpu_torch.ops.int8_matmul import (
    apply_activation,
    int8_matmul_fused,
)
from interactvlm_tpu_torch.ops.quant import int8_matmul


class Linear(nn.Linear):
    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


class Int8Linear(nn.Module):
    """Linear layer with an int8 weight and per-output-column f32 scales:
    the port of ``interactvlm_tpu/models/llama.py:Int8Dense`` (and, with a
    bias, of the SAM encoder's ``_enc_dense`` int8 mode).

    ``weight`` is int8 (out, in), K-contiguous per output column, and
    ``weight_scale`` f32 (out,), both frozen; ``bias`` (out,) is f32. The
    ``activation`` ("none", "gelu", "gelu_tanh") follows the bias.

    On a CUDA tensor every call launches the fused int8 kernel
    (``ops/int8_matmul.py``), which quantizes x per row, multiplies on the
    int8 tensor cores and applies scale, bias and activation in f32 before
    the cast to the layer dtype. The JAX package's conditions for its TPU
    kernel (rows >= 4096, K * N <= 7 Mi) exist because that kernel keeps the
    whole weight in VMEM, which the card's kernel does not. On a CPU tensor
    it runs what the JAX package runs on the CPU: the composition
    ``ops/quant.int8_matmul`` cast to the layer dtype, then the bias and
    the exact or tanh GELU in that dtype. The kernel and the composition
    differ only where x * (127 / amax) and x / (amax / 127) fall on opposite
    sides of a rounding tie, and in where they round to the layer dtype.
    """

    def __init__(self, in_features: int, out_features: int, bias: bool = False,
                 activation: str = "none", dtype=torch.bfloat16, device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.activation = activation
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.zeros(out_features, in_features, dtype=torch.int8,
                        device=device), requires_grad=False)
        self.weight_scale = nn.Parameter(
            torch.ones(out_features, dtype=torch.float32, device=device),
            requires_grad=False)
        self.bias = nn.Parameter(
            torch.zeros(out_features, dtype=torch.float32, device=device),
            requires_grad=False) if bias else None

    def forward(self, x):
        x = x.to(self.dtype)
        if x.is_cuda:
            return int8_matmul_fused(
                x.reshape(-1, self.in_features), self.weight,
                self.weight_scale, self.bias, self.activation, self.dtype,
            ).reshape(*x.shape[:-1], self.out_features)
        y = int8_matmul(x, self.weight, self.weight_scale, dtype=self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return apply_activation(y, self.activation)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, "
                f"bias={self.bias is not None}, activation={self.activation}")
