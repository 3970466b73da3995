"""Named collectives over one axis of the rank grid, and the autograd
functions of tensor parallelism.

Port of ``interactvlm_tpu/parallel/collectives.py``: ``all_reduce_sum`` /
``all_reduce_mean`` (gradient and metric reductions), ``all_gather_batch``
(eval predictions), ``psum_scatter`` (ZeRO's reduce-scatter),
``ppermute_ring`` and ``host_gather`` (the reference's
``all_gather_object``). Each takes the process group of one mesh axis
(``Mesh.data_group`` or ``Mesh.model_group``); None is an axis of one
rank, where each is the identity.

Under NCCL each is its native collective. Gloo takes only ``all_reduce``
and ``broadcast`` on CUDA tensors, so under gloo (the CPU, and ranks that
share one card) the others are composed from ``all_reduce``: an all-gather
is the all-reduce of a zero buffer with this rank's slice written in, a
reduce-scatter an all-reduce and then this rank's slice, the ring shift an
all-gather of one slot each.

Tensor parallelism's three autograd functions: ``copy_to`` (identity
forward, all-reduce backward: the input of a column-parallel layer, whose
ranks each take part of the input's gradient), ``reduce_from`` (all-reduce
forward, identity backward: the output of a row-parallel layer, and the
batch sums of a loss over data ranks) and ``gather_from`` (all-gather
forward along the last dim, this rank's slice backward: the vocab-parallel
logits). ``batch_group`` names the data axis whose ranks share one batch,
so that the losses' sums over rows (``batch_sum``, ``batch_any``) run over
the global batch.
"""

from __future__ import annotations

import contextlib
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from interactvlm_tpu_torch.utils.profiling import annotate


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def native(group) -> bool:
    """Whether ``group`` runs every collective natively (NCCL); gloo runs
    ``all_reduce`` and ``broadcast`` only, on CUDA tensors."""
    return group is not None and dist.get_backend(group) == "nccl"


def _all_reduce_(x, group, op=dist.ReduceOp.SUM):
    with annotate("all_reduce"):
        dist.all_reduce(x, op=op, group=group)
    return x


def all_reduce_sum(x, group):
    """The sum of ``x`` over the group's ranks, on every rank (a new
    tensor)."""
    if group is None:
        return x.clone()
    return _all_reduce_(x.clone(), group)


BUCKET_BYTES = 64 << 20


def all_reduce_coalesced_(tensors: List[torch.Tensor], group,
                          bucket_bytes: int = BUCKET_BYTES) -> None:
    """Sum each of ``tensors`` (contiguous) over the group's ranks, in
    place, with few collectives: the tensors of one dtype and device are
    packed into flat buckets of up to ``bucket_bytes``, one all-reduce a
    bucket; a tensor that fills a bucket alone is reduced where it lies,
    with no copy (a data-parallel gradient's hundreds of leaves in a few
    calls, with at most one bucket's bytes more on the card)."""
    if group is None:
        return
    buckets: dict = {}
    for t in tensors:
        open_ = buckets.setdefault((t.dtype, t.device), [[]])
        last = open_[-1]
        size = sum(x.numel() for x in last) * t.element_size()
        if last and size + t.numel() * t.element_size() > bucket_bytes:
            open_.append([t])
        else:
            last.append(t)
    for parts in (b for bs in buckets.values() for b in bs):
        if len(parts) == 1:
            _all_reduce_(parts[0], group)
            continue
        flat = torch.cat([t.reshape(-1) for t in parts])
        _all_reduce_(flat, group)
        for t, piece in zip(parts, flat.split([t.numel() for t in parts])):
            t.copy_(piece.view_as(t))


def all_reduce_mean(x, group):
    return all_reduce_sum(x, group) / group_size(group)


def all_reduce_max(x, group):
    """The element-wise max of ``x`` over the group's ranks."""
    if group is None:
        return x.clone()
    return _all_reduce_(x.clone(), group, dist.ReduceOp.MAX)


def all_gather_batch(x, group, dim: int = 0):
    """The ranks' ``x`` concatenated along ``dim`` in rank order (a tiled
    all-gather; the eval ``all_gather`` of predictions). Every rank's ``x``
    has one shape."""
    n = group_size(group)
    if n == 1:
        return x.clone()
    with annotate("all_gather"):
        if native(group):
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x.contiguous(), group=group)
            return torch.cat(parts, dim=dim)
        shape = list(x.shape)
        size = shape[dim]
        shape[dim] = size * n
        buf = x.new_zeros(shape)
        buf.narrow(dim, group_rank(group) * size, size).copy_(x)
        dist.all_reduce(buf, group=group)
    return buf


def psum_scatter(x, group, dim: int = 0):
    """Reduce-scatter along ``dim``: every rank holds a full partial ``x``;
    each ends up with its own block of the sum (ZeRO's gradient
    primitive)."""
    n = group_size(group)
    if n == 1:
        return x.clone()
    size = x.shape[dim] // n
    if x.shape[dim] % n:
        raise ValueError(f"psum_scatter: dim {dim} of {tuple(x.shape)} does "
                         f"not divide over {n} ranks")
    with annotate("reduce_scatter"):
        if native(group) and dim == 0:
            out = x.new_empty((size,) + tuple(x.shape[1:]))
            dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
            return out
        total = _all_reduce_(x.clone(), group)
    return total.narrow(dim, group_rank(group) * size, size).clone()


def ppermute_ring(x, group, shift: int = 1):
    """Ring rotation: rank i's ``x`` goes to rank (i + shift) mod n."""
    n = group_size(group)
    if n == 1:
        return x.clone()
    r = group_rank(group)
    with annotate("ppermute"):
        if native(group):
            out = torch.empty_like(x)
            ops = [dist.P2POp(dist.isend, x.contiguous(),
                              dist.get_global_rank(group, (r + shift) % n),
                              group),
                   dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, (r - shift) % n),
                              group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            return out
        slots = x.new_zeros((n,) + tuple(x.shape))
        slots[(r + shift) % n] = x
        dist.all_reduce(slots, group=group)
    return slots[r].clone()


def host_gather(value: Any, group=None) -> List[Any]:
    """Gather a picklable host value from every rank of ``group`` (the
    default group where None and one is initialised), in rank order;
    ``[value]`` in a single process."""
    if not dist.is_initialized() or (group is None
                                     and dist.get_world_size() == 1):
        return [value]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, value, group=group)
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.size = x.shape[-1]
        return all_gather_batch(x.contiguous(), group, dim=x.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        r = group_rank(ctx.group)
        return g.narrow(g.dim() - 1, r * ctx.size, ctx.size).contiguous(), None


def copy_to(x, group):
    """Identity forward, all-reduce of the gradient backward (the input of
    a column-parallel layer)."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x, group):
    """All-reduce (sum) forward, identity backward (the output of a
    row-parallel layer; a loss's batch sums over data ranks)."""
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_from(x, group):
    """All-gather along the last dim forward, this rank's slice of the
    gradient backward (vocab-parallel logits, whose consumers run on
    every rank)."""
    return x if group is None else _GatherFrom.apply(x, group)


_BATCH_GROUP: Optional[Any] = None


@contextlib.contextmanager
def batch_group(group):
    """Within the block, ``batch_sum`` and ``batch_any`` reduce over
    ``group``: the data ranks whose rows make up one global batch (None:
    this rank's rows are the batch)."""
    global _BATCH_GROUP
    before, _BATCH_GROUP = _BATCH_GROUP, group
    try:
        yield
    finally:
        _BATCH_GROUP = before


def batch_sum(x):
    """``x`` (already summed over this rank's rows) summed over the batch
    group's ranks, differentiable: each rank's gradient flows to its own
    rows, and the data ranks' gradients add up to the global batch's."""
    return reduce_from(x, _BATCH_GROUP)


def batch_count(n: float, like):
    """A count of rows ``n`` over the global batch: ``n`` itself (a Python
    number, so one rank divides by it as before) without a batch group, a
    tensor on ``like``'s device summed over the group's ranks with one."""
    if _BATCH_GROUP is None:
        return n
    return reduce_from(like.new_tensor(float(n)), _BATCH_GROUP)


def batch_any(x):
    """``x.any()`` over the global batch."""
    if _BATCH_GROUP is None:
        return x.any()
    return all_reduce_max(x.any().to(torch.int32).reshape(1),
                          _BATCH_GROUP)[0] > 0
