"""Int8 quantization: weights, activations and the KV cache.

Port of ``interactvlm_tpu/ops/quant.py`` (the int8 parts, forward only):
symmetric per-slice int8 with f32 scales, rounding half to even. Weights are
in the port's (N, K) layout, K-contiguous per output column, with one f32
scale per output column, (N,); the JAX package keeps (K, N) and (1, N).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

SCALE_FLOOR = 1e-8


def exact_div(num, den):
    """num / den rounded once, as IEEE division is, on every device; either
    side may be a Python float. torch rounds twice where one side is a
    Python number: ``x / 127.0`` runs as x * (1 / 127) on CUDA, and
    ``127.0 / x`` as reciprocal(x) * 127 everywhere. Both sides as tensors
    take the true division."""
    ref = num if torch.is_tensor(num) else den
    if not torch.is_tensor(num):
        num = ref.new_full((), num)
    if not torch.is_tensor(den):
        den = ref.new_full((), den)
    return num / den


def quantize_int8(x, axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-slice int8 quantization along ``axis``: scale =
    max(amax, 1e-8) / 127, q = clip(round(x / scale), -127, 127) with
    ``torch.round``'s half-to-even rule. Returns (q int8, scale f32 with
    ``axis`` kept as size 1)."""
    xf = x.float()
    amax = xf.abs().amax(dim=axis, keepdim=True)
    scale = exact_div(amax.clamp_min(SCALE_FLOOR), 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q, scale, dtype=torch.float32):
    return (q.float() * scale).to(dtype)


def int_matmul_exact(a_q, w_q):
    """(..., K) int8 @ (N, K) int8 -> (..., N) f32, the int32 sum exactly:
    products and partial sums of int8 values are exact in float64 for any K
    here (|sum| <= 127^2 K < 2^53), and float64 -> f32 rounds the exact sum
    as int32 -> f32 does."""
    return torch.matmul(a_q.double(), w_q.double().t()).float()


def int8_matmul(x, w_q, w_scale, dtype=torch.bfloat16):
    """x (..., K) @ int8 W (N, K) with per-output-column scales (N,): the
    JAX package's composition (quantize x per row, int8 x int8 -> int32,
    rescale by both scales), the path it takes on the CPU. Forward only."""
    x_q, x_scale = quantize_int8(x, axis=-1)
    return (int_matmul_exact(x_q, w_q) * x_scale * w_scale).to(dtype)


def init_kv_cache_int8(config, batch: int, max_len: int,
                       device) -> List[Dict]:
    """Fresh per-layer int8 KV caches: k/v (B, L, nkv, d) int8, k_scale/
    v_scale (B, L, nkv, 1) f32, the key-validity row (B, L) int8 and the
    cursor."""
    shape = (batch, max_len, config.num_kv_heads, config.head_dim)
    sshape = shape[:3] + (1,)
    return [
        {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
            "v_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
            "valid": torch.zeros(batch, max_len, dtype=torch.int8,
                                 device=device),
            "index": 0,
        }
        for _ in range(config.num_layers)
    ]


def append_kv_cache_int8(cache: Dict, k_new, v_new) -> Dict:
    """Quantize a (B, L, nkv, d) chunk per position and head and write it at
    the cache cursor, then advance the cursor by L.

    Unlike the JAX function, which returns a new cache, this writes the
    preallocated int8 tensors and scales in place (as the dense cache is
    written, ``models/llama.py``) and returns the same dict. The key-validity
    row is the caller's to write. K/V stay int8: the attention folds the
    scales into its logits and probabilities."""
    idx = cache["index"]
    L = k_new.shape[1]
    for name, new in (("k", k_new), ("v", v_new)):
        q, s = quantize_int8(new, axis=-1)
        cache[name][:, idx:idx + L] = q
        cache[name + "_scale"][:, idx:idx + L] = s
    cache["index"] = idx + L
    return cache
