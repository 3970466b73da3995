"""Linear, LayerNorm, transposed-convolution and embedding layers with a
compute dtype apart from their parameters' dtype, the LoRA linear of
training, the int8 linear layer (serving, and QLoRA's frozen base with an
adapter) and the int4 linear layer of serving.

Like flax's ``nn.Dense(dtype=...)``, each layer casts its input and its
parameters to its compute ``dtype`` at every call: the dtype it was built
in, whatever dtype its parameters are stored in later. Serving builds and
computes in one dtype; training keeps its trainable parameters in f32
(``train/optimizer.py``) while they compute in bf16, as the JAX package's
f32 params under bf16 modules do. State-dict keys are those of
``torch.nn.Linear`` / ``LayerNorm`` / ``ConvTranspose2d`` / ``Embedding``;
a LoRA linear adds peft's ``lora_A.weight`` and ``lora_B.weight``.

Tensor parallelism (``shard_layer``): a linear built at its local size and
given a ``TensorParallel`` is column-parallel (its out features split over
the model ranks; its input's gradient all-reduced, ``copy_to``) or
row-parallel (its in features split; its output all-reduced,
``reduce_from``); an embedding is vocab-parallel (ids outside the rank's
rows masked, the lookups all-reduced). A LoRA adapter on a column-parallel
linear keeps A whole on every rank and B split as the base: x A^T passes
``copy_to`` before B, so A's gradient, and x's through the adapter, are
summed over the ranks once. The int8 and int4 row-parallel linears quantize
with the whole row's absmax (``ops/quant.py:row_parallel_quantize``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from interactvlm_tpu_torch.ops import _cuda
from interactvlm_tpu_torch.ops.int8_matmul import (
    apply_activation,
    int8_matmul_fused,
)
from interactvlm_tpu_torch.ops.quant import (
    int4_matmul,
    int4_matmul_row_parallel,
    int8_matmul_row_parallel,
    int8_matmul_ste,
)
from interactvlm_tpu_torch.parallel.collectives import copy_to, reduce_from


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """How a layer is split over the model axis: ``kind`` "column" (out
    features), "row" (in features) or "vocab" (an embedding's rows), the
    axis's process group, its size ``n`` and this rank's ``index``. Which
    dim of each of its parameters is split is the partition table's
    (``parallel/mesh.py:param_spec``), by the parameter's name."""

    kind: str
    group: Any
    n: int
    index: int


def shard_layer(layer: nn.Module, kind: str, mesh) -> nn.Module:
    """Mark ``layer`` (built at its local size) as split over ``mesh``'s
    model axis; a LoRA layer's B factor splits with a column-parallel base.
    A mesh whose model axis has one rank leaves the layer as it is."""
    if mesh is None or mesh.n_model == 1:
        return layer
    tp = TensorParallel(kind, mesh.model_group, mesh.n_model,
                        mesh.model_index)
    layer.tp = tp
    if hasattr(layer, "lora_B"):
        if kind != "column":
            raise ValueError("LoRA is built on column-parallel linears only")
        layer.lora_B.tp = tp
    return layer


def _tp(layer) -> Optional[TensorParallel]:
    return getattr(layer, "tp", None)


def _col_in(layer, x):
    tp = _tp(layer)
    return copy_to(x, tp.group) if tp is not None and tp.kind == "column" \
        else x


def _row_out(layer, y):
    tp = _tp(layer)
    return reduce_from(y, tp.group) if tp is not None and tp.kind == "row" \
        else y


def _is_row(layer) -> bool:
    tp = _tp(layer)
    return tp is not None and tp.kind == "row"


def _lora(layer, x):
    """((x A^T) B^T) * alpha / r, with x A^T passed through ``copy_to``
    where B is split (column-parallel)."""
    a = layer.lora_A.weight.to(x.dtype)
    b = layer.lora_B.weight.to(x.dtype)
    return F.linear(_col_in(layer, F.linear(x, a)), b) * layer.scaling


def full_in_features(layer) -> int:
    """The in features of the unsharded layer."""
    return layer.in_features * (layer.tp.n if _is_row(layer) else 1)


class Linear(nn.Linear):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=None, device=None):
        super().__init__(in_features, out_features, bias=bias, dtype=dtype,
                         device=device)
        self.dtype = self.weight.dtype

    def forward(self, x):
        dt = self.dtype
        return _row_out(self, F.linear(_col_in(self, x).to(dt),
                                       self.weight.to(dt),
                                       _cast(self.bias, dt)))


class LayerNorm(nn.LayerNorm):
    def __init__(self, normalized_shape, eps: float = 1e-5, dtype=None,
                 device=None):
        super().__init__(normalized_shape, eps=eps, dtype=dtype, device=device)
        self.dtype = self.weight.dtype

    def forward(self, x):
        dt = self.dtype
        return F.layer_norm(x.to(dt), self.normalized_shape,
                            _cast(self.weight, dt), _cast(self.bias, dt),
                            self.eps)


class ConvTranspose2d(nn.ConvTranspose2d):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dtype=None, device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         dtype=dtype, device=device)
        self.dtype = self.weight.dtype

    def forward(self, x):
        dt = self.dtype
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt),
                                  _cast(self.bias, dt), self.stride)


class Embedding(nn.Embedding):
    """Lookup from the table, cast to the compute dtype: the rows of
    ``weight.to(dtype)`` (flax's ``nn.Embed(dtype=...)``) without casting
    the whole table."""

    def __init__(self, num_embeddings: int, embedding_dim: int, dtype=None,
                 device=None):
        super().__init__(num_embeddings, embedding_dim, dtype=dtype,
                         device=device)
        self.dtype = self.weight.dtype

    def forward(self, ids):
        tp = _tp(self)
        if tp is None:
            return F.embedding(ids, self.weight).to(self.dtype)
        rows = self.weight.shape[0]
        local = ids - tp.index * rows
        mine = (local >= 0) & (local < rows)
        out = F.embedding(torch.where(mine, local, 0), self.weight)
        out = torch.where(mine[..., None], out, 0.0).to(self.dtype)
        return reduce_from(out, tp.group)


class LoraFactor(nn.Module):
    """One low-rank factor, a module so that its parameter is named
    ``lora_A.weight`` / ``lora_B.weight``; ``init_std`` 0 draws zeros."""

    def __init__(self, rows: int, cols: int, init_std: float, dtype, device):
        super().__init__()
        self.init_std = init_std
        self.weight = nn.Parameter(torch.zeros(rows, cols, dtype=dtype,
                                               device=device))


class LoraLinear(Linear):
    """Bias-free linear plus a low-rank adapter,
    y = base(x) + ((x A^T) B^T) * alpha / r: the port of the JAX package's
    ``LoraDense`` (``interactvlm_tpu/models/llama.py:172-210``). A (r, K) and
    B (N, r) are cast to x's dtype; no dropout, as there. ``weight`` is the
    frozen base; init draws A ~ N(0, 0.02) and B = 0."""

    def __init__(self, in_features: int, out_features: int, rank: int,
                 alpha: float, dtype=None, device=None):
        super().__init__(in_features, out_features, bias=False, dtype=dtype,
                         device=device)
        self.scaling = alpha / rank
        self.lora_A = LoraFactor(rank, in_features, 0.02, dtype, device)
        self.lora_B = LoraFactor(out_features, rank, 0.0, dtype, device)

    def forward(self, x):
        return super().forward(x) + _lora(self, x)


class Int8Linear(nn.Module):
    """Linear layer with an int8 weight and per-output-column f32 scales:
    the port of ``interactvlm_tpu/models/llama.py:Int8Dense`` (and, with a
    bias, of the SAM encoder's ``_enc_dense`` int8 mode).

    ``weight`` is int8 (out, in), K-contiguous per output column, and
    ``weight_scale`` f32 (out,), both frozen; ``bias`` (out,) is f32. The
    ``activation`` ("none", "gelu", "gelu_tanh") follows the bias.

    The product is ``ops/quant.py:int8_matmul_ste`` on both devices: on a
    CUDA tensor kernel 6 (``ops/int8_matmul.py``), which quantizes x per
    row and multiplies on the int8 tensor cores, on a CPU tensor what the
    JAX package runs on the CPU, the composition ``ops/quant.int8_matmul``;
    the bias and the exact or tanh GELU follow in the layer dtype. Without
    grad, a CUDA call with a bias or an activation fuses them into the
    kernel's f32 epilogue instead (the serving encoder). The JAX package's
    conditions for its TPU kernel (rows >= 4096, K * N <= 7 Mi) exist
    because that kernel keeps the whole weight in VMEM, which the card's
    kernel does not. The kernel and the composition differ only where x *
    (127 / amax) and x / (amax / 127) fall on opposite sides of a rounding
    tie, and in where they round to the layer dtype.

    Under grad, x gets the straight-through gradient of the JAX package
    (``ops/quant.py:_int8_matmul_bwd``), and the frozen weight none: the
    QLoRA base.
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
        if _is_row(self):
            if self.bias is not None or self.activation != "none":
                raise ValueError("a row-parallel Int8Linear has no bias or "
                                 "activation")
            return int8_matmul_row_parallel(x, self.weight, self.weight_scale,
                                            self.tp.group, self.dtype)
        x = _col_in(self, x)
        fused = self.bias is not None or self.activation != "none"
        if fused and x.is_cuda and not (torch.is_grad_enabled()
                                        and x.requires_grad):
            return int8_matmul_fused(
                x.reshape(-1, self.in_features), self.weight,
                self.weight_scale, self.bias, self.activation, self.dtype,
            ).reshape(*x.shape[:-1], self.out_features)
        y = int8_matmul_ste(x, self.weight, self.weight_scale, self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return apply_activation(y, self.activation)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, "
                f"bias={self.bias is not None}, activation={self.activation}")


class Int8LoraLinear(Int8Linear):
    """A frozen bias-free int8 base plus a low-rank adapter, y = base(x) +
    ((x A^T) B^T) * alpha / r: the port of the JAX package's ``LoraDense(
    int8=True)`` (``interactvlm_tpu/models/llama.py:172-210``), QLoRA's
    q/v projection. ``weight`` (int8) and ``weight_scale`` are the base's,
    ``lora_A.weight`` (r, K) and ``lora_B.weight`` (N, r) the adapter's, as
    in ``LoraLinear``; the base's gradient to x is the straight-through
    one."""

    def __init__(self, in_features: int, out_features: int, rank: int,
                 alpha: float, dtype=torch.bfloat16, device=None):
        super().__init__(in_features, out_features, dtype=dtype, device=device)
        self.scaling = alpha / rank
        self.lora_A = LoraFactor(rank, in_features, 0.02, dtype, device)
        self.lora_B = LoraFactor(out_features, rank, 0.0, dtype, device)

    def forward(self, x):
        x = x.to(self.dtype)
        return super().forward(x) + _lora(self, x)


class Int4Linear(nn.Module):
    """Bias-free linear layer with a packed split-half int4 weight: the port
    of ``interactvlm_tpu/models/llama.py:Int4Dense``. ``weight_q4`` (out,
    in/2) int8 holds two nibbles a byte (``ops/quant.py``), ``weight_scale``
    (out,) f32 the per-column scales and ``weight_rf`` (in,) f32 the rank-1
    group row factor that multiplies x. Runs ``ops/quant.int4_matmul``:
    kernel 6 on the unpacked weight on a CUDA tensor, the JAX package's
    composition on a CPU one. Serving only: raises under grad."""

    def __init__(self, in_features: int, out_features: int,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.dtype = dtype
        self.weight_q4 = nn.Parameter(
            torch.zeros(out_features, in_features // 2, dtype=torch.int8,
                        device=device), requires_grad=False)
        self.weight_scale = nn.Parameter(
            torch.ones(out_features, dtype=torch.float32, device=device),
            requires_grad=False)
        self.weight_rf = nn.Parameter(
            torch.ones(in_features, dtype=torch.float32, device=device),
            requires_grad=False)

    def forward(self, x):
        _cuda.refuse_grad("Int4Linear", x)
        if _is_row(self):
            return int4_matmul_row_parallel(
                x, self.weight_q4, self.weight_scale, self.weight_rf,
                self.tp.group, self.dtype)
        return int4_matmul(x, self.weight_q4, self.weight_scale,
                           self.weight_rf, self.dtype)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")
