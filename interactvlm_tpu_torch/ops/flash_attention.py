"""Flash attention: the forward kernel ``csrc/flash_attention.cu`` (head dim
128: ``csrc/flash_fwd_sm90.cuh``; head dim 16: ``csrc/flash_fwd_d16_sm90.cuh``,
which reads q, k and v as strided views), the two backward kernels
``csrc/flash_attention_bwd.cu`` (head dim 128: ``csrc/flash_bwd_sm90.cuh``),
their plain PyTorch versions, and the autograd Function that joins them.

Ports of ``interactvlm_tpu/ops/flash_attention.py``: ``_flash_kernel`` (the
Pallas TPU kernel, wrapper ``_flash_forward``), ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel`` (wrapper ``_flash_backward``), and the ``custom_vjp``
that wires them (``FlashAttention`` here). The kernel sources say what
bounds each on the H100 and how its design answers that.

Semantics, for q (B, H, Lq, D) and k, v (B, H, Lk, D): scale defaults to
D^-1/2; key c is visible to query r iff c < kv_lengths[b] (when given) and,
under ``causal``, c <= r + (Lk - Lq); the output is the softmax-weighted sum
of the visible values, and the per-row logsumexp is returned as
(B*H, Lq) f32. A row that sees no key gives 0 and logsumexp 0. (The Pallas
kernel's masked logits are -1e30 rather than -inf, so for such a row it
returns the mean of its block-padded values instead; no caller reaches a
fully masked row.)
"""

from __future__ import annotations

import ctypes

import torch

from interactvlm_tpu_torch.ops import _cuda

KERNEL_HEAD_DIMS = (16, 32, 64, 128)
# the forward's routes: the wgmma + TMA kernels at 128 and at 16, the
# mma.sync core at 32 and 64
FWD_ROUTES = ("sm90", "sm90_d16", "mma")
# the head dim whose kernel reads strided views in place
VIEW_HEAD_DIM = 16
# the head-dim-16 kernel's widest key tile (wgmma's N; 256 spilled)
D16_MAX_KEY_WIDTH = 128


def _visible(B, Lq, Lk, causal, kv_lengths, device):
    kidx = torch.arange(Lk, device=device)
    vis = torch.ones(B, 1, Lq, Lk, dtype=torch.bool, device=device)
    if kv_lengths is not None:
        vis = vis & (kidx[None, None, None, :]
                     < kv_lengths.to(device)[:, None, None, None])
    if causal:
        qidx = torch.arange(Lq, device=device)
        vis = vis & (kidx[None, :] <= qidx[:, None] + (Lk - Lq))
    return vis


def flash_forward_plain(q, k, v, causal=False, scale=None, kv_lengths=None):
    """Plain version of the kernel: returns (o (B, H, Lq, D), lse (B*H, Lq))."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    scale = D ** -0.5 if scale is None else scale
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s.masked_fill(~_visible(B, Lq, Lk, causal, kv_lengths, q.device),
                      float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    seen = l > 0
    o = torch.where(seen, acc / torch.where(seen, l, torch.ones_like(l)), 0.0)
    lse = torch.where(seen, m + torch.log(torch.where(seen, l, 1.0)), 0.0)
    return o.to(v.dtype), lse.reshape(B * H, Lq)


def fwd_route(D):
    """The forward kernel's route, by head dim alone: "sm90" (the wgmma +
    TMA kernel of ``csrc/flash_fwd_sm90.cuh``) at 128, "sm90_d16" (the
    wgmma + TMA kernel of ``csrc/flash_fwd_d16_sm90.cuh``, on strided
    views) at 16, "mma" (the mma.sync core) at 32 and 64. Raises on any
    other head dim."""
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in "
                         f"{KERNEL_HEAD_DIMS}")
    return {128: "sm90", VIEW_HEAD_DIM: "sm90_d16"}.get(D, "mma")


def d16_key_tiles(D, Lk):
    """The head-dim-16 kernel's key tiling: (key width N, tiles). The
    fewest tiles of at most ``D16_MAX_KEY_WIDTH`` keys, each N = 16
    ceil(Lk / (16 tiles)) wide: one 16-key tile at the SAM decoder's
    Lk = 9 (a row runs 16 exponentials), four of 128 at the fusion's 512.
    S = Q K^T is one wgmma m64nNk16 a tile. Raises on another head dim."""
    if D != VIEW_HEAD_DIM:
        raise ValueError(f"flash_attention: the key tiling is the head dim "
                         f"{VIEW_HEAD_DIM} kernel's, not {D}'s")
    if Lk < 1:
        raise ValueError(f"flash_attention: Lk {Lk}")
    tiles = -(-Lk // D16_MAX_KEY_WIDTH)
    return 16 * -(-Lk // (16 * tiles)), tiles


def d16_blocks_per_sm(Lk, H, heads_per_cta=0):
    """The CTAs of the head-dim-16 kernel one SM holds at Lk keys, H heads
    and ``heads_per_cta`` heads a CTA (0: the kernel's choice), card only:
    what its launch plan reads from the occupancy API."""
    width, _ = d16_key_tiles(VIEW_HEAD_DIM, Lk)
    f = _cuda.load("flash_attention").ivlm_flash_fwd_d16_blocks_per_sm
    f.restype, f.argtypes = ctypes.c_int, [ctypes.c_int] * 4
    n = f(width, Lk, H, heads_per_cta)
    if n < 0:
        raise RuntimeError(f"flash_attention: occupancy query failed ({-n})")
    return n


_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_D16_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 9
                 + [ctypes.c_int] * 4
                 + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def flash_forward(q, k, v, causal=False, scale=None, kv_lengths=None,
                  cta_plan=(0, 0)):
    """Flash attention forward over (B, H, L, D): returns (o, lse).

    CPU tensors run ``flash_forward_plain``; CUDA tensors launch the kernel
    of ``fwd_route(D)`` (bf16, head dim in ``KERNEL_HEAD_DIMS``) or raise.
    At head dim 16 q, k and v may be views with unit stride on the head
    dim and the other strides 16-byte multiples (the projections' head
    splits), read in place, and o is a (B, H, Lq, 16) view of a (B, Lq, H,
    16) tensor, which the caller's transpose back to tokens reads without
    a copy; ``cta_plan`` = (query tiles, heads) sets how many 128-row
    query tiles and how many heads a CTA of that kernel takes (0: the
    kernel's own plan). Other head dims take contiguous tensors and give o
    contiguous.
    """
    if not q.is_cuda:
        return flash_forward_plain(q, k, v, causal, scale, kv_lengths)
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if k.shape != (B, H, Lk, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes {q.shape} {k.shape} {v.shape}")
    route = fwd_route(D)
    if route == "sm90_d16":
        _cuda.require_strided_rows("flash_attention", q, k, v)
    else:
        _cuda.require_kernel_inputs("flash_attention", q, k, v)
    lens = None
    if kv_lengths is not None:
        lens = kv_lengths.to(device=q.device, dtype=torch.int32).contiguous()
        if lens.shape != (B,):
            raise ValueError(f"flash_attention: kv_lengths shape {lens.shape}")
    scale = D ** -0.5 if scale is None else scale
    lse = torch.empty(B * H, Lq, dtype=torch.float32, device=q.device)
    lens_ptr = _cuda.ptr(lens) if lens is not None else ctypes.c_void_p(None)
    with torch.cuda.device(q.device):
        if route == "sm90_d16":
            if not scale > 0:
                # the kernel takes the row maximum of the raw logits
                raise ValueError(f"flash_attention: scale {scale} at head "
                                 f"dim {D} must be positive")
            width, _ = d16_key_tiles(D, Lk)
            o = torch.empty(B, Lq, H, D, dtype=q.dtype,
                            device=q.device).transpose(1, 2)
            _cuda.launch(
                "flash_attention", "ivlm_flash_fwd_d16", _D16_ARGTYPES,
                _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(o),
                _cuda.ptr(lse), lens_ptr, *q.stride()[:3], *k.stride()[:3],
                *v.stride()[:3], B, H, Lq, Lk, float(scale),
                int(bool(causal)), width, *(int(n) for n in cta_plan),
                _cuda.stream_handle(q.device))
        else:
            o = torch.empty_like(q)
            _cuda.launch(
                "flash_attention", "ivlm_flash_fwd", _ARGTYPES,
                _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(o),
                _cuda.ptr(lse), lens_ptr, B * H, H, Lq, Lk, D, float(scale),
                int(bool(causal)), _cuda.stream_handle(q.device))
    flash_forward.launches += 1
    flash_forward.route_launches[route] += 1
    return o, lse


flash_forward.launches = 0
flash_forward.route_launches = {r: 0 for r in FWD_ROUTES}


def flash_backward_plain(q, k, v, o, lse, do, causal=False, scale=None,
                         kv_lengths=None):
    """Plain version of the two backward kernels: the recompute formula of
    the JAX package's ``_flash_backward``. P = exp(S * scale - lse) on the
    visible keys (0 elsewhere), D = rowsum(dO * O) in f32,
    dS = P * (dP - D) with dP = dO V^T, all in f32; then dQ = scale * dS K,
    dK = scale * dS^T Q and dV = P^T dO with P and dS rounded to the
    inputs' dtype as the products' operands, as the kernels round them (the
    TPU dq kernel rounds dS so; its f32 dk/dv products run at the TPU's
    default one-pass bf16 precision). Accumulation in f32, or in f64 for
    f64 inputs. In f32 or f64 the rounding is none: f64 inputs give the
    exact value that the kernels approximate. Returns (dq, dk, dv) in the
    inputs' dtypes."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    scale = D ** -0.5 if scale is None else scale
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    qf, kf, dof = q.to(acc), k.to(acc), do.to(acc)
    dsum = (dof * o.to(acc)).sum(-1, keepdim=True)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    vis = _visible(B, Lq, Lk, causal, kv_lengths, q.device)
    p = torch.where(vis, torch.exp(s - lse.reshape(B, H, Lq, 1)), 0.0)
    ds = p * (torch.matmul(dof, v.to(acc).transpose(-1, -2)) - dsum)
    ds, p = ds.to(q.dtype).to(acc), p.to(q.dtype).to(acc)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bwd_route(D):
    """The backward kernels' route, by head dim alone (as the forward's and
    ``sam_attention.rel_route``): "sm90", the wgmma + TMA kernels of
    ``csrc/flash_bwd_sm90.cuh``, at 128 (the LLaMA shapes); "mma", the
    mma.sync kernels of ``csrc/flash_attention_bwd.cu``, at 16, 32 and 64
    (the SAM decoder's 16). Raises on any other head dim."""
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_backward: head dim {D} not in "
                         f"{KERNEL_HEAD_DIMS}")
    return "sm90" if D == 128 else "mma"


# the mma.sync dk/dv kernel's query tiles, and at Lk <= DKV_SPLIT_MAX_LK
# (one key tile) the most of them one block walks
DKV_QUERY_TILE, DKV_SPLIT_MAX_LK, DKV_SPLIT_TILES = 64, 64, 8


def dkv_split(Lq, Lk):
    """The mma.sync dk/dv kernel's plan: (splits, query tiles a split).

    Its blocks own 64 keys each and walk the query tiles. At Lk <= 64 one
    block per (batch*head) would walk every query alone (Lq = 4096 at the
    SAM decoder's Lk = 9: 256 blocks on 132 SMs), so the walk is cut into
    runs of at most ``DKV_SPLIT_TILES`` tiles, one block each (2048 blocks
    there), whose partial sums a second launch adds in order. Longer key
    sequences give blocks enough already: one split over every tile."""
    tiles = -(-Lq // DKV_QUERY_TILE)
    if Lk > DKV_SPLIT_MAX_LK:
        return 1, tiles
    per = min(tiles, DKV_SPLIT_TILES)
    return -(-tiles // per), per


_DQ_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_DKV_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                 + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _lens_ptr(kv_lengths):
    return (_cuda.ptr(kv_lengths) if kv_lengths is not None
            else ctypes.c_void_p(None))


def flash_bwd_dq(q, k, v, do, o, lse, causal, scale, kv_lengths):
    """Launch the dq kernel (CUDA only; ``flash_backward`` checks the
    inputs), which also forms D = rowsum(dO * O) in f32. lse is (B*H, Lq)
    f32, kv_lengths int32 or None. Returns (dq, dsum (B*H, Lq) f32)."""
    B, H, Lq, D = q.shape
    dq = torch.empty_like(q)
    dsum = torch.empty(B * H, Lq, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _cuda.launch(
            "flash_attention_bwd", "ivlm_flash_bwd_dq", _DQ_ARGTYPES,
            _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(do),
            _cuda.ptr(o), _cuda.ptr(lse), _cuda.ptr(dsum), _cuda.ptr(dq),
            _lens_ptr(kv_lengths), B * H, H, Lq, k.shape[2], D, float(scale),
            int(bool(causal)), _cuda.stream_handle(q.device))
    flash_bwd_dq.launches += 1
    flash_bwd_dq.route_launches[bwd_route(D)] += 1
    return dq, dsum


flash_bwd_dq.launches = 0
flash_bwd_dq.route_launches = {"sm90": 0, "mma": 0}


def flash_bwd_dkv(q, k, v, do, lse, dsum, causal, scale, kv_lengths):
    """Launch the dk/dv kernel (CUDA only, as ``flash_bwd_dq``) after the
    dq kernel that wrote dsum, on the same stream. On the mma.sync route
    with more than one split (``dkv_split``) it allocates the f32 partial
    sums and the C launcher adds a second launch that sums them."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    route = bwd_route(D)
    splits, tiles = dkv_split(Lq, Lk) if route == "mma" else (1, 1)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    part = (torch.empty(splits, 2, B * H, Lk, D, dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    with torch.cuda.device(q.device):
        _cuda.launch(
            "flash_attention_bwd", "ivlm_flash_bwd_dkv", _DKV_ARGTYPES,
            _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(do),
            _cuda.ptr(lse), _cuda.ptr(dsum), _cuda.ptr(dk), _cuda.ptr(dv),
            _cuda.ptr(part) if part is not None else ctypes.c_void_p(None),
            _lens_ptr(kv_lengths), B * H, H, Lq, Lk, D, float(scale),
            int(bool(causal)), splits, tiles, _cuda.stream_handle(q.device))
    flash_bwd_dkv.launches += 1
    flash_bwd_dkv.route_launches[route] += 1
    return dk, dv


flash_bwd_dkv.launches = 0
flash_bwd_dkv.route_launches = {"sm90": 0, "mma": 0}


def flash_backward(q, k, v, o, lse, do, causal=False, scale=None,
                   kv_lengths=None):
    """Flash attention backward: (dq, dk, dv) from the forward's inputs, its
    output o and logsumexp lse (B*H, Lq), and the output gradient do.

    CPU tensors run ``flash_backward_plain``; CUDA tensors launch the dq and
    the dk/dv kernels of ``bwd_route(D)`` (bf16, contiguous, head dim in
    ``KERNEL_HEAD_DIMS``) or raise. D = rowsum(dO * O), which the JAX
    package takes in jnp outside its kernels, is formed by the dq kernel;
    nothing here runs a torch operation on the card but allocations.
    """
    if not q.is_cuda:
        return flash_backward_plain(q, k, v, o, lse, do, causal, scale,
                                    kv_lengths)
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if (k.shape != (B, H, Lk, D) or v.shape != k.shape or o.shape != q.shape
            or do.shape != q.shape):
        raise ValueError(f"flash_backward: shapes q {q.shape} k {k.shape} "
                         f"v {v.shape} o {o.shape} do {do.shape}")
    bwd_route(D)  # raises on a head dim no kernel takes
    _cuda.require_kernel_inputs("flash_backward", q, k, v, o, do)
    _cuda.require_kernel_inputs("flash_backward", lse, dtype=torch.float32)
    if lse.shape != (B * H, Lq) or lse.device != q.device:
        raise ValueError(f"flash_backward: lse {tuple(lse.shape)} on "
                         f"{lse.device}, expected ({B * H}, {Lq})")
    lens = None
    if kv_lengths is not None:
        lens = kv_lengths.to(device=q.device, dtype=torch.int32).contiguous()
        if lens.shape != (B,):
            raise ValueError(f"flash_backward: kv_lengths shape {lens.shape}")
    scale = D ** -0.5 if scale is None else scale
    dq, dsum = flash_bwd_dq(q, k, v, do, o, lse, causal, scale, lens)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, dsum, causal, scale, lens)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient: the forward kernel, and on the
    backward the two backward kernels over the saved (q, k, v, o, lse), made
    contiguous
    (the JAX package's ``custom_vjp``, ``flash_attention.py:402-421``).
    CPU tensors take the plain versions both ways."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, kv_lengths):
        o, lse = flash_forward(q, k, v, causal, scale, kv_lengths)
        ctx.save_for_backward(q, k, v, o, lse, kv_lengths)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kv_lengths = ctx.saved_tensors
        # the head-dim-16 forward read views and wrote o as one; the
        # backward kernels take contiguous tensors (a copy in training only)
        q, k, v, o = (t.contiguous() for t in (q, k, v, o))
        dq, dk, dv = flash_backward(q, k, v, o, lse, do.contiguous(),
                                    ctx.causal, ctx.scale, kv_lengths)
        return dq, dk, dv, None, None, None


def padded_head_dim(D: int) -> int:
    """The head dim the kernel runs a head dim D at: the least of
    ``KERNEL_HEAD_DIMS`` not below D (SAM's 80 runs at 128, as the JAX
    kernel pads every head dim to its 128 lanes); D itself above them."""
    return next((d for d in KERNEL_HEAD_DIMS if d >= D), D)


def flash_attention(q, k, v, causal=False, scale=None, kv_lengths=None):
    """Flash attention over (B, H, L, D), the output only, differentiable
    in q, k and v through ``FlashAttention``. A head dim between the
    kernel's is zero-padded to ``padded_head_dim`` (the logits and the
    kept columns do not change; the scale stays D^-1/2) and the output cut
    back."""
    D = q.shape[-1]
    Dp = padded_head_dim(D)
    if Dp == D:
        return FlashAttention.apply(q, k, v, causal, scale, kv_lengths)
    scale = D ** -0.5 if scale is None else scale
    q, k, v = (torch.nn.functional.pad(t, (0, Dp - D)) for t in (q, k, v))
    return FlashAttention.apply(q, k, v, causal, scale,
                                kv_lengths)[..., :D]
