"""What the entry probes and ``chip_smoke.py`` share: the H100's bf16
peak, the analytic FLOP counts (the port's copies of
``bench.py:_llama_matmul_params`` and ``_flops_per_image``), the lift
probe's test body (``bench.py:_sphere``), the launch counters of every
hand-written kernel, the card's busy time and the host's issue time of a
call, and the checks every probe makes (unknown variants, non-finite
outputs)."""

from __future__ import annotations

import time
from typing import Dict, Iterable, Sequence

import torch

from interactvlm_tpu_torch.ops import flash_attention as FA
from interactvlm_tpu_torch.ops import int4_matmul as Q4
from interactvlm_tpu_torch.ops import int8_matmul as Q
from interactvlm_tpu_torch.ops import mxu as MX
from interactvlm_tpu_torch.ops import sam_attention as SA
from interactvlm_tpu_torch.ops import serving_matmul as SM
from interactvlm_tpu_torch.utils.profiling import ANNOTATIONS

# the H100 SXM's dense bf16 tensor-core peak, FLOP/s (NVIDIA data sheet)
BF16_PEAK = 989e12

# every hand-written kernel's wrapper, by kernel name: each adds one to its
# ``launches`` where it launches its kernel (``int8_gemm`` is pass 2 of
# ``int8_matmul``'s two-pass route; ``quantize_rows_given`` kernel 7's
# given-scale route; ``int4_gemm`` pass 2 of ``int4_matmul``'s two-pass
# route, whose pass 1 counts under ``quantize_rows``)
WRAPPERS = {
    "flash_attention": FA.flash_forward,
    "window_attention": SA.window_attention,
    "rel_attention": SA.rel_attention,
    "int8_matmul": Q.int8_matmul_fused,
    "flash_attention_bwd_dq": FA.flash_bwd_dq,
    "flash_attention_bwd_dkv": FA.flash_bwd_dkv,
    "quantize_rows": Q.quantize_rows,
    "int8_matmul_prequant": Q.int8_matmul_prequant,
    "fused_dense": SM.fused_dense,
    "mxu_loop": MX.mxu_loop,
    "window_copy": SA.window_copy,
    "quantize_rows_given": Q.quantize_rows_given,
    "int8_gemm": Q.int8_gemm,
    "int4_matmul": Q4.int4_matmul_fused,
    "int4_gemm": Q4.int4_gemm,
}
# the wrappers that also count their launches by route
ROUTES = {"int8_routes": Q.int8_matmul_fused,
          "int4_routes": Q4.int4_matmul_fused,
          "window_routes": SA.window_attention,
          "rel_routes": SA.rel_attention,
          "bwd_dq_routes": FA.flash_bwd_dq,
          "bwd_dkv_routes": FA.flash_bwd_dkv}


def reset_launches() -> None:
    """Every wrapper's count, and every route's, back to 0."""
    for w in WRAPPERS.values():
        w.launches = 0
    for w in ROUTES.values():
        for route in w.route_launches:
            w.route_launches[route] = 0


def read_launches() -> Dict[str, object]:
    """Each kernel's launches so far, and each routed wrapper's by route
    (``int8_routes``: {"one_launch", "two_pass"}, ...)."""
    return {**{n: w.launches for n, w in WRAPPERS.items()},
            **{k: dict(w.route_launches) for k, w in ROUTES.items()}}


def launch_counts() -> Dict[str, int]:
    """Each counted kernel's launches so far, and the int8 and int4
    matmuls' calls by route (``int8_one_launch``, ``int8_two_pass``,
    ``int4_one_launch``, ``int4_two_pass``)."""
    out = {n: w.launches for n, w in WRAPPERS.items()}
    for kind, w in (("int8_", Q.int8_matmul_fused),
                    ("int4_", Q4.int4_matmul_fused)):
        for route, n in w.route_launches.items():
            out[kind + route] = n
    return out


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """The launches made since ``before`` (``launch_counts()``), the
    kernels that launched only."""
    now = launch_counts()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def check_variants(probe: str, names: Sequence[str],
                   known: Iterable[str]) -> None:
    unknown = sorted(set(names) - set(known))
    if unknown:
        raise ValueError(f"{probe}: unknown variants {unknown}; known: "
                         f"{tuple(known)}")


def require_finite(probe: str, name: str, *tensors) -> None:
    for t in tensors:
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"{probe}: {name} gave non-finite values")


def sphere(n_lat: int = 60, n_lon: int = 80, radius: float = 0.8):
    """``bench.py:_sphere``, the ~4.7k-vertex test body (4722 vertices)."""
    from interactvlm_tpu_torch.geometry.rasterizer import uv_sphere

    return uv_sphere(n_lat, n_lon, radius)


def llama_matmul_params(cfg) -> int:
    """Matmul-visible parameter count (excl. the embedding gather)."""
    attn = cfg.hidden_size * cfg.head_dim * (
        2 * cfg.num_heads + 2 * cfg.num_kv_heads)
    mlp = 3 * cfg.hidden_size * cfg.intermediate_size
    head = cfg.hidden_size * cfg.vocab_size
    return cfg.num_layers * (attn + mlp) + head


def sam_encoder_flops(sc, views: int) -> float:
    """The SAM encoder's FLOPs for ``views`` images: its projections over
    the tokens, and the global and window attention logits."""
    e, depth = sc.encoder_embed_dim, sc.encoder_depth
    tokens = sc.image_embedding_size ** 2
    p_s = depth * (4 * e * e + 2 * e * int(e * sc.mlp_ratio))
    n_global = len(sc.encoder_global_attn_indexes)
    f_attn_global = n_global * 4 * tokens * tokens * e
    f_attn_win = (depth - n_global) * 4 * tokens * (sc.window_size ** 2) * e
    return views * (2 * p_s * tokens + f_attn_global + f_attn_win)


def flops_per_image(cfg, V: int, Lp: int, T: int, include_sam=True) -> float:
    """Analytic useful FLOPs an image (``bench.py:_flops_per_image``): the
    prefill of Lp tokens, T decode steps, CLIP, the SAM encoder over V
    views, and a 2 % pad for the mask decoder, upsample and lift."""
    lc, cc = cfg.llama, cfg.clip
    p_l = llama_matmul_params(lc)
    f_prefill = 2 * p_l * Lp
    f_decode = 2 * p_l * T
    p_c = cc.num_layers * (4 * cc.hidden_size ** 2
                           + 2 * cc.hidden_size * cc.intermediate_size)
    f_clip = 2 * p_c * (cc.num_patches + 1)
    f_sam = sam_encoder_flops(cfg.sam, V) if include_sam else 0
    return 1.02 * (f_prefill + f_decode + f_clip + f_sam)


def peak_gb(dev):
    """The card's peak allocated GB since the last reset; None on the
    CPU."""
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 1e9


def reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def _sync(dev):
    torch.cuda.synchronize(dev)


def issue_and_wall_ms(fn, dev=None):
    """(host ms until ``fn`` returns, before the card has finished;
    synchronised wall ms of the same call): where the two are close, the
    host sets the pace. ``dev`` None is the current card."""
    on_card = dev is None or dev.type == "cuda"
    if on_card:
        _sync(dev)
    t0 = time.perf_counter()
    fn()
    issue = (time.perf_counter() - t0) * 1e3
    if on_card:
        _sync(dev)
    return issue, (time.perf_counter() - t0) * 1e3


def on_card(e) -> bool:
    """Whether a profiler event on the card is the card's own work (a
    kernel, copy or memset) and not a ``record_function`` region
    (``utils/profiling.annotate``: the training step's phases and
    collectives), which the profiler mirrors onto the card's timeline over
    the kernels it spans."""
    name = e.name() if callable(e.name) else e.name
    user = getattr(e, "is_user_annotation", False)
    user = user() if callable(user) else user
    return not user and name not in ANNOTATIONS


def card_trace(fn, dev=None):
    """One synchronised call of ``fn`` under torch.profiler, tracing the
    card's activity alone and read from the profiler's raw events (a trace
    with the host's operations costs over a minute to read for one 13B
    batch): (wall ms of the call, [(name, start ns, duration ns)] of the
    card's own work, ``on_card``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
    evs = [(e.name(), e.start_ns(), e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA and on_card(e)]
    return ms, evs


def busy_ns(evs) -> int:
    """The union of the events' spans (``card_trace``), ns."""
    busy, end = 0, float("-inf")
    for _, a, d in sorted(evs, key=lambda x: x[1]):
        if a + d > end:
            busy += a + d - max(a, end)
            end = a + d
    return busy


def device_busy_ms(fn, dev=None):
    """The card's busy time in ms over one call of ``fn``: the union of the
    spans of its kernels, copies and memsets (``card_trace``). None on the
    CPU, or where the trace holds no device activity."""
    if dev is not None and dev.type != "cuda":
        return None
    _, evs = card_trace(fn, dev)
    return busy_ns(evs) / 1e6 if evs else None
