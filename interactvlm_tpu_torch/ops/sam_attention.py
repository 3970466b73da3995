"""SAM encoder attention with the decomposed relative-position bias: the CUDA
kernels ``csrc/window_attention.cu`` and ``csrc/rel_attention.cu`` (at head
dim 80, ViT-H's, their wgmma + TMA routes ``csrc/window_attention_sm90.cuh``
and ``csrc/rel_attention_sm90.cuh``; ``window_route``, ``rel_route``) and
their plain PyTorch versions; and the window probe's copy kernel
``csrc/window_copy.cu``.

Ports of ``interactvlm_tpu/ops/sam_attention.py``: ``_window_kernel``
(wrapper ``fused_window_attention``) for the 14x14 windows and ``_kernel``
(wrapper ``fused_rel_attention``) for the 64x64 global grid. Both add

    bias[q, c] = rel_h[c // W, q] + rel_w[q, c % W]

to the scaled logits (reference ``add_decomposed_rel_pos``,
image_encoder.py:354-392). The factors come from two einsums outside the
kernels, in the input dtype with f32 accumulation; the kernels rebuild the
bias from them and never hold it as L x L in device memory. The kernel
sources say what bounds each on the H100 and how the design answers that.
"""

from __future__ import annotations

import ctypes

import torch

from interactvlm_tpu_torch.ops import _cuda

KERNEL_HEAD_DIMS = (16, 32, 64, 80)
MAX_WINDOW_FACTORS = 64  # H + W of a window (window_attention.cu MAXF)
MAX_GRID_SIDE = 64  # H and W of a global grid (rel_attention.cu MAXHW)
# the global kernel's routes, by head dim alone (rel_route), as the C
# launcher numbers them
REL_ROUTES = {"mma": 0, "sm90": 1}
SM90_HEAD_DIM = 80  # the ViT-H head dim (rel_attention_sm90.cuh kD)
# the window kernel's routes, by head dim and window (window_route), as the
# C launcher numbers them
WINDOW_ROUTES = {"mma": 0, "sm90": 1}
SM90_MAX_WINDOW_SIDE = 16  # window_attention_sm90.cuh kMaxSide


def rel_route(D: int) -> str:
    """The route of ``rel_attention`` for head dim D: "sm90" (the wgmma +
    TMA kernel of ``csrc/rel_attention_sm90.cuh``) at D = 80, "mma" (the
    mma.sync kernel of ``csrc/rel_attention.cu``) at 16, 32 and 64."""
    return "sm90" if D == SM90_HEAD_DIM else "mma"


def window_route(D: int, hw) -> str:
    """The route of ``window_attention`` for head dim D and window hw =
    (H, W): "sm90" (the wgmma + TMA kernel of
    ``csrc/window_attention_sm90.cuh``, which reads q, k and v as strided
    views) at D = 80 with H and W up to 16 (ViT-H's 14 x 14; for SAM's
    square windows every L <= 256), "mma" (the mma.sync kernel of
    ``csrc/window_attention.cu``, contiguous rows) otherwise. The sm90
    kernel lays keys out 16 slots a window row, hence the bound on each
    side rather than on L."""
    H, W = hw
    return ("sm90" if D == SM90_HEAD_DIM and max(H, W) <= SM90_MAX_WINDOW_SIDE
            else "mma")


def rel_tables(rel_pos, size: int):
    """(2*size-1, d) table -> (size, size, d) relative-position embeddings
    (reference ``get_rel_pos`` for equal q/k sizes)."""
    idx = torch.arange(size, device=rel_pos.device)
    return rel_pos[idx[:, None] - idx[None, :] + size - 1]


def window_factors(q, rel_pos_h, rel_pos_w, hw):
    """q (BW, nH, L, D) -> stacked factors (BW*nH, H+W, L) in q's dtype:
    rows [0, H) hold rel_h[kh, q], rows [H, H+W) hold rel_w[kw, q]."""
    H, W = hw
    BW, nH, L, D = q.shape
    r_q = q.reshape(BW, nH, H, W, D)
    rel_h = torch.einsum("bnhwc,hkc->bnkhw", r_q,
                         rel_tables(rel_pos_h, H).to(q.dtype))
    rel_w = torch.einsum("bnhwc,wkc->bnkhw", r_q,
                         rel_tables(rel_pos_w, W).to(q.dtype))
    return torch.cat(
        [rel_h.reshape(BW, nH, H, L), rel_w.reshape(BW, nH, W, L)], dim=2
    ).reshape(BW * nH, H + W, L)


def global_factors(q, rel_pos_h, rel_pos_w, hw):
    """q (B, nH, L, D) -> rel_h (B*nH, H, L) and rel_w (B*nH, L, W)."""
    H, W = hw
    B, nH, L, D = q.shape
    r_q = q.reshape(B, nH, H, W, D)
    rel_h = torch.einsum("bnhwc,hkc->bnkhw", r_q,
                         rel_tables(rel_pos_h, H).to(q.dtype))
    rel_w = torch.einsum("bnhwc,wkc->bnhwk", r_q,
                         rel_tables(rel_pos_w, W).to(q.dtype))
    return (rel_h.reshape(B * nH, H, L).contiguous(),
            rel_w.reshape(B * nH, L, W).contiguous())


def _attend(q, k, v, bias, scale):
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits + bias, dim=-1)
    return torch.matmul(probs.to(v.dtype), v).to(v.dtype)


def window_attention_plain(q, k, v, factors, hw):
    """Plain version of the window kernel: q/k/v (R, L, D) or (BW, nH, L, D)
    views of any strides, factors (R, H+W, L) with R = BW nH -> an output of
    q's shape."""
    H, W = hw
    L = q.shape[-2]
    c = torch.arange(L, device=q.device)
    f = factors.float().reshape(*q.shape[:-2], H + W, L)
    bias = (f[..., c // W, :] + f[..., H + c % W, :]).transpose(-1, -2)
    return _attend(q, k, v, bias, q.shape[-1] ** -0.5)


def rel_attention_plain(q, k, v, rel_h, rel_w, hw):
    """Plain version of the global kernel: q/k/v (R, L, D), rel_h (R, H, L),
    rel_w (R, L, W) -> (R, L, D)."""
    H, W = hw
    L = q.shape[1]
    c = torch.arange(L, device=q.device)
    bias = rel_h.float()[:, c // W, :].transpose(1, 2) + rel_w.float()[:, :, c % W]
    return _attend(q, k, v, bias, q.shape[-1] ** -0.5)


def _argtypes(n_ptrs, n_ints):
    return ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
            + [ctypes.c_float, ctypes.c_void_p])


def _check_qkv(kernel, q, k, v):
    R, L, D = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{kernel}: shapes {q.shape} {k.shape} {v.shape}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{kernel}: head dim {D} not in {KERNEL_HEAD_DIMS}")
    return R, L, D


_WINDOW_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                    + [ctypes.c_longlong] * 9
                    + [ctypes.c_float, ctypes.c_void_p])


def window_attention(q, k, v, factors, hw):
    """Window attention with stacked rel-pos factors (R, H+W, L) over q/k/v
    rows (R, L, D) or (BW, nH, L, D), R = BW nH.

    CPU tensors run ``window_attention_plain``; CUDA tensors launch the
    kernel of the route ``window_route(D, hw)`` names (bf16) or raise. The
    "sm90" route takes views of any strides with unit stride on D and the
    others multiples of 16 bytes (q, k and v as the qkv linear leaves them)
    and returns the (BW, nH, L, D) view of an output stored (BW, L, nH, D),
    whose ``transpose(1, 2)`` is contiguous; the "mma" route takes and
    returns contiguous tensors. Both raise under grad: the kernels have no
    backward, and their only caller is the frozen SAM encoder.
    ``launches`` counts the launches, ``route_launches`` each route's.
    """
    _cuda.refuse_grad("window_attention", q, k, v, factors)
    if not q.is_cuda:
        return window_attention_plain(q, k, v, factors, hw)
    H, W = hw
    if q.dim() not in (3, 4) or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"window_attention: shapes {q.shape} {k.shape} {v.shape}")
    q4, k4, v4 = (t if t.dim() == 4 else t.unsqueeze(1) for t in (q, k, v))
    BW, nH, L, D = q4.shape
    R = BW * nH
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"window_attention: head dim {D} not in "
                         f"{KERNEL_HEAD_DIMS}")
    if L != H * W or factors.shape != (R, H + W, L):
        raise ValueError(f"window_attention: factors {factors.shape} for {hw}")
    if H + W > MAX_WINDOW_FACTORS:
        raise ValueError(f"window_attention: window {hw} too large")
    _cuda.require_kernel_inputs("window_attention", factors)
    route = window_route(D, hw)
    if route == "sm90":
        _cuda.require_strided_rows("window_attention", q4, k4, v4)
        o = torch.empty(BW, L, nH, D, dtype=q.dtype, device=q.device)
        strides = [s for t in (q4, k4, v4) for s in t.stride()[:3]]
    else:
        _cuda.require_kernel_inputs("window_attention", q, k, v)
        o = torch.empty_like(q)
        strides = [0] * 9
    with torch.cuda.device(q.device):
        _cuda.launch(
            "window_attention", "ivlm_window_attn", _WINDOW_ARGTYPES,
            _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(factors),
            _cuda.ptr(o), BW, nH, L, H, W, D, WINDOW_ROUTES[route], *strides,
            float(D ** -0.5), _cuda.stream_handle(q.device),
        )
    window_attention.launches += 1
    window_attention.route_launches[route] += 1
    if route == "mma":
        return o
    out = o.transpose(1, 2)
    return out if q.dim() == 4 else out.squeeze(1)


window_attention.launches = 0
window_attention.route_launches = {r: 0 for r in WINDOW_ROUTES}


def rel_attention(q, k, v, rel_h, rel_w, hw):
    """Global attention with rel-pos factors over (R, L, D) rows.

    CPU tensors run ``rel_attention_plain``; CUDA tensors launch the kernel
    of the route ``rel_route(D)`` names (bf16, contiguous) or raise. Both
    raise under grad, as ``window_attention`` does. ``launches`` counts the
    launches, ``route_launches`` each route's.
    """
    _cuda.refuse_grad("rel_attention", q, k, v, rel_h, rel_w)
    if not q.is_cuda:
        return rel_attention_plain(q, k, v, rel_h, rel_w, hw)
    H, W = hw
    R, L, D = _check_qkv("rel_attention", q, k, v)
    if L != H * W or rel_h.shape != (R, H, L) or rel_w.shape != (R, L, W):
        raise ValueError(
            f"rel_attention: factors {rel_h.shape} {rel_w.shape} for {hw}")
    if H > MAX_GRID_SIDE or W > MAX_GRID_SIDE:
        raise ValueError(f"rel_attention: grid {hw} too large")
    _cuda.require_kernel_inputs("rel_attention", q, k, v, rel_h, rel_w)
    route = rel_route(D)
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _cuda.launch(
            "rel_attention", "ivlm_rel_attn", _argtypes(6, 6),
            _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(rel_h),
            _cuda.ptr(rel_w), _cuda.ptr(o), R, L, H, W, D, REL_ROUTES[route],
            float(D ** -0.5), _cuda.stream_handle(q.device),
        )
    rel_attention.launches += 1
    rel_attention.route_launches[route] += 1
    return o


rel_attention.launches = 0
rel_attention.route_launches = {r: 0 for r in REL_ROUTES}


def window_copy_plain(q, k, v):
    """Plain version of the copy kernel: q itself (k and v are only read)."""
    return q.clone()


def window_copy(q, k, v):
    """The window probe's copy (port of ``scripts/winattn_probe.py:_copy``):
    reads q, k and v (R, L, D) in the window kernel's grid and returns a copy
    of q, to time the memory floor under the window kernel.

    CPU tensors run ``window_copy_plain``; CUDA tensors launch the kernel
    (bf16, contiguous, D a multiple of 8 up to 128) or raise."""
    _cuda.refuse_grad("window_copy", q, k, v)
    if not q.is_cuda:
        return window_copy_plain(q, k, v)
    R, L, D = q.shape
    if k.shape != q.shape or v.shape != q.shape or D % 8 or D > 128:
        raise ValueError(f"window_copy: shapes {q.shape} {k.shape} {v.shape}")
    _cuda.require_kernel_inputs("window_copy", q, k, v)
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _cuda.launch(
            "window_copy", "ivlm_window_copy",
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
            _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(o), R, L, D,
            _cuda.stream_handle(q.device),
        )
    window_copy.launches += 1
    return o


window_copy.launches = 0


def fused_window_attention(q, k, v, rel_pos_h, rel_pos_w, hw):
    """(BW, nH, L, D) window attention with decomposed rel-pos bias
    (port of ``fused_window_attention``). On the "sm90" route q, k and v go
    to ``window_attention`` as they come (on the SAM encoder's path, views
    of the qkv linear's output), and the output is a (BW, nH, L, D) view of
    (BW, L, nH, D) storage; the "mma" route takes contiguous rows."""
    BW, nH, L, D = q.shape
    f = window_factors(q, rel_pos_h, rel_pos_w, hw)
    if window_route(D, hw) == "sm90":
        return window_attention(q, k, v, f, hw)
    rows = [t.reshape(BW * nH, L, D).contiguous() for t in (q, k, v)]
    return window_attention(*rows, f, hw).reshape(BW, nH, L, D)


def fused_rel_attention(q, k, v, rel_pos_h, rel_pos_w, hw):
    """(B, nH, L, D) global attention with decomposed rel-pos bias
    (port of ``fused_rel_attention``)."""
    B, nH, L, D = q.shape
    rel_h, rel_w = global_factors(q, rel_pos_h, rel_pos_w, hw)
    rows = [t.reshape(B * nH, L, D).contiguous() for t in (q, k, v)]
    out = rel_attention(*rows, rel_h, rel_w, hw)
    return out.reshape(B, nH, L, D)
