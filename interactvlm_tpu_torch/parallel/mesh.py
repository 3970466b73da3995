"""The (data, model) layout of ranks and the sharding rules of parameters.

Port of ``interactvlm_tpu/parallel/mesh.py``. The JAX package lays its
devices out as a ``(data, model)`` mesh: data parallelism over ``data``,
Adam's moments sharded over ``data`` (ZeRO), LLaMA's heads, MLP columns and
vocabulary over ``model``. Here the mesh is a grid of ``torch.distributed``
ranks, one process a card: rank = data index * n_model + model index (the
model axis varies fastest, as there), with one process group per row and
column of the grid. Collectives go by NCCL between cards and by gloo on the
CPU (``init_distributed``).

Flax carries each parameter's logical axis names in its boxes; the port has
none, so ``logical_axes`` keeps one table from the port's parameter names
(the reference's state-dict names) to the JAX leaf's logical axes, and
``LOGICAL_RULES`` maps them onto mesh axes as there. A torch weight is
(out, in), the transpose of the JAX kernel (in, out): ``param_spec`` gives
the spec in the torch layout, ``jax_spec`` in the JAX one.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# logical axis -> mesh axis (None = replicated), the JAX package's rules
LOGICAL_RULES: Sequence[Tuple[str, Optional[str]]] = (
    ("batch", "data"),
    ("vocab", "model"),
    ("embed", None),
    ("mlp", "model"),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("head_dim", None),
    ("seq", None),
    ("norm", None),
)


@dataclasses.dataclass
class Mesh:
    """This rank's place in an (n_data, n_model) grid of ranks and the
    process groups of its data axis (the ranks with its model index) and
    its model axis (the ranks with its data index); a group is None where
    its axis has one rank. ``Mesh(1, 1)`` is one process alone."""

    n_data: int = 1
    n_model: int = 1
    rank: int = 0
    backend: Optional[str] = None
    data_group: Any = None
    model_group: Any = None

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def env_rank() -> Tuple[int, int, int]:
    """(rank, world size, local rank) from the environment torchrun sets
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``); (0, 1, 0) without it."""
    return (int(os.environ.get("RANK", 0)),
            int(os.environ.get("WORLD_SIZE", 1)),
            int(os.environ.get("LOCAL_RANK", 0)))


def init_distributed(backend: str, init_method: str = "env://",
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     local_world_size: Optional[int] = None):
    """Join the process group over ``backend``: "nccl" (one rank a card,
    this rank's card ``LOCAL_RANK``) or "gloo" (the CPU, or ranks that
    share a card). Rank and world size default to the environment's
    (torchrun's). Returns this rank's device: its card under NCCL, the
    CPU under gloo.

    NCCL refuses two ranks on one card, and so does this function, before
    the group is made: it raises where the host's ranks
    (``LOCAL_WORLD_SIZE``) outnumber its cards."""
    env_r, env_w, local = env_rank()
    rank = env_r if rank is None else rank
    world_size = env_w if world_size is None else world_size
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: the nccl backend needs CUDA "
                               "cards and none is available")
        local_world = local_world_size or int(
            os.environ.get("LOCAL_WORLD_SIZE", world_size))
        cards = torch.cuda.device_count()
        if local_world > cards:
            raise RuntimeError(
                f"init_distributed: {local_world} nccl ranks on a host with "
                f"{cards} card(s): NCCL takes one rank a card and cannot put "
                f"two ranks on one card; run at most {cards} ranks, or use "
                f"the gloo backend for ranks that share a card")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    elif backend == "gloo":
        device = torch.device("cpu")
    else:
        raise ValueError(f"init_distributed: backend must be 'nccl' or "
                         f"'gloo', got {backend!r}")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size)
    return device


def join_launch(device: str, what: str) -> torch.device:
    """This rank's device in a CLI launched one rank a process (the
    training CLI's ``--n_model_shards``, the eval CLI's ``--distributed``,
    named by ``what``). The backend is the process group's own where one is
    already made (ranks spawned together, ``launch.spawn``), else gloo for
    ``device`` "cpu" and NCCL for cards. Under NCCL the rank runs on its
    card (``LOCAL_RANK``); under gloo on ``device``: the CPU, or a card the
    ranks share. Raises in a plain process: no torchrun environment
    (``WORLD_SIZE``) and no group."""
    from interactvlm_tpu_torch.utils.device import resolve_device

    if not dist.is_initialized() and "WORLD_SIZE" not in os.environ:
        raise ValueError(
            f"{what} runs one rank a process: launch it with torchrun "
            f"(torchrun --nproc_per_node <n> -m <module> ...), which gives "
            f"each process its RANK, WORLD_SIZE and LOCAL_RANK")
    if dist.is_initialized():
        backend = dist.get_backend()
    else:
        backend = "gloo" if torch.device(device).type == "cpu" else "nccl"
    dev = init_distributed(backend)
    return resolve_device(device) if backend == "gloo" else dev


def create_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The (n_data, n_model) grid over the initialised process group (or
    one process without one). ``n_data`` defaults to the world size over
    ``n_model``; their product must be the world size. Every rank must
    call this, in the same order as any other group it makes."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} does not tile {world} "
                         f"ranks; pick an n_model that divides the world size")
    mesh = Mesh(n_data, n_model, rank,
                dist.get_backend() if dist.is_initialized() else None)
    if world == 1:
        return mesh
    # every rank makes every group, in one order (new_group's contract)
    for m in range(n_model):
        ranks = [d * n_model + m for d in range(n_data)]
        g = dist.new_group(ranks) if n_data > 1 else None
        if m == mesh.model_index:
            mesh.data_group = g
    for d in range(n_data):
        ranks = [d * n_model + m for m in range(n_model)]
        g = dist.new_group(ranks) if n_model > 1 else None
        if d == mesh.data_index:
            mesh.model_group = g
    return mesh


def logical_to_mesh(logical_axes) -> Tuple[Optional[str], ...]:
    """A tuple of logical axis names -> mesh axes (the JAX package's
    ``logical_to_mesh``, a tuple for its PartitionSpec)."""
    rules = dict(LOGICAL_RULES)
    return tuple(rules.get(a, None) if a is not None else None
                 for a in logical_axes)


# --- the partition table ---------------------------------------------------
# A LLaMA projection's axes (in, out) as the JAX package's ``_dense`` and
# ``LoraDense`` annotate its kernel (models/llama.py).
PROJ_AXES = {
    "q_proj": ("embed", "heads"), "k_proj": ("embed", "kv_heads"),
    "v_proj": ("embed", "kv_heads"), "o_proj": ("heads", "embed"),
    "gate_proj": ("embed", "mlp"), "up_proj": ("embed", "mlp"),
    "down_proj": ("mlp", "embed"), "lm_head": ("embed", "vocab"),
}
# the LLaMA's parameters, by name: standalone (model., lm_head.) or inside
# the composite model (llava.lm.)
_LLAMA = re.compile(
    r"^(?:(?:.*\.)?lm\.)?(?:"
    r"model\.layers\.\d+\.(?:self_attn|mlp)\.(?P<proj>\w+_proj)\."
    r"(?P<leaf>weight|weight_q4|weight_scale|weight_rf|lora_A\.weight|"
    r"lora_B\.weight)"
    r"|(?P<head>lm_head)\.(?P<hleaf>weight|weight_q4|weight_scale|weight_rf)"
    r"|model\.(?P<embed>embed_tokens)\.weight"
    r"|model\.(?:layers\.\d+\.(?:input|post_attention)_layernorm|norm)"
    r"\.(?P<norm>weight))$")

# how a torch tensor lies against its JAX leaf
KERNEL, SAME, SCALE = "kernel", "same", "scale"


def logical_axes(name: str):
    """(the JAX leaf's logical axes, layout) for a port parameter, or None
    for one the JAX package leaves unannotated (replicated: CLIP, SAM, the
    InteractVLM heads, the mm_projector). Layout ``KERNEL``: the torch
    tensor is the JAX leaf transposed ((out, in) against (in, out));
    ``SAME``: the same layout; ``SCALE``: a (N,) vector of a (1, N) leaf.

    The JAX leaves: a projection's kernel (in, out) (an int8 ``kernel_q``
    and a packed int4 ``kernel_q4`` lie as it does); ``kernel_scale``
    (None, out); ``kernel_rf`` (in,); LoRA's ``lora_a`` ("embed", None) and
    ``lora_b`` (None, out); ``embed_tokens`` ("vocab", "embed"); the
    RMSNorm gains ("norm",)."""
    m = _LLAMA.match(name)
    if m is None:
        return None
    if m.group("embed"):
        return ("vocab", "embed"), SAME
    if m.group("norm"):
        return ("norm",), SAME
    proj = m.group("proj") or m.group("head")
    leaf = m.group("leaf") or m.group("hleaf")
    ax_in, ax_out = PROJ_AXES[proj]
    if leaf in ("weight", "weight_q4"):
        return (ax_in, ax_out), KERNEL
    if leaf == "weight_scale":
        return (None, ax_out), SCALE
    if leaf == "weight_rf":
        return (ax_in,), SAME
    if leaf == "lora_A.weight":
        return ("embed", None), KERNEL
    return (None, ax_out), KERNEL  # lora_B.weight


def jax_spec(name: str, ndim: int) -> Tuple[Optional[str], ...]:
    """The mesh axes of the JAX leaf of a port parameter, in the JAX
    layout, padded with None to its rank (``ndim``: the JAX leaf's)."""
    found = logical_axes(name)
    if found is None:
        return (None,) * ndim
    spec = logical_to_mesh(found[0])
    return spec + (None,) * (ndim - len(spec))


def jax_shape(name: str, shape: Sequence[int]) -> Tuple[int, ...]:
    """The JAX leaf's shape of a port parameter of torch ``shape``."""
    found = logical_axes(name)
    layout = found[1] if found else SAME
    if layout == KERNEL:
        return tuple(reversed(tuple(shape)))
    if layout == SCALE:
        return (1,) + tuple(shape)
    return tuple(shape)


def to_torch_spec(name: str, spec: Sequence[Optional[str]],
                  ndim: int) -> Tuple[Optional[str], ...]:
    """A spec in the JAX layout of ``name``'s leaf -> the torch layout."""
    found = logical_axes(name)
    layout = found[1] if found else SAME
    spec = tuple(spec)
    if layout == KERNEL:
        return tuple(reversed(spec))
    if layout == SCALE:
        return spec[1:]
    return spec + (None,) * (ndim - len(spec))


def param_spec(name: str, ndim: int) -> Tuple[Optional[str], ...]:
    """The mesh axes of a port parameter's dims, in the torch layout: the
    JAX leaf's spec moved onto the torch tensor."""
    found = logical_axes(name)
    if found is None:
        return (None,) * ndim
    return to_torch_spec(name, logical_to_mesh(found[0]), ndim)


def sharded_dim(name: str, ndim: int, axis: str = "model") -> Optional[int]:
    """The torch dim of ``name`` split over ``axis``, or None."""
    spec = param_spec(name, ndim)
    return spec.index(axis) if axis in spec else None


def full_shape(name: str, shape: Sequence[int], n_model: int) -> tuple:
    """The unsharded shape of parameter ``name`` whose block on one of
    ``n_model`` model ranks has ``shape``. Raises for a name the partition
    table does not know (a split layer's parameter named off the LLaMA's
    paths)."""
    if logical_axes(name) is None:
        raise ValueError(f"{name!r} is not a LLaMA parameter of the "
                         f"partition table (parallel/mesh.py:_LLAMA)")
    shape = list(shape)
    dim = sharded_dim(name, len(shape))
    if dim is not None:
        shape[dim] *= n_model
    return tuple(shape)


def take_block(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    """Block i of n of ``t`` along ``dim`` (a view)."""
    size = t.shape[dim]
    if size % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not divide "
                         f"over {n} ranks")
    return t.narrow(dim, i * (size // n), size // n)


def take_packed_block(t: torch.Tensor, n: int, i: int) -> torch.Tensor:
    """Block i of n of a packed int4 (N, K/2) weight along its K (a
    row-parallel ``weight_q4``: split-half nibbles over the whole K): the
    weight unpacked, cut into the rank's contiguous columns and packed
    again, so the rank multiplies its contiguous slice of the input."""
    from interactvlm_tpu_torch.ops.quant import pack_int4, unpack_int4

    return pack_int4(take_block(torch.cat(unpack_int4(t), dim=1), 1, n, i))


def shard_tensor(name: str, t: torch.Tensor, n_model: int,
                 model_index: int) -> torch.Tensor:
    """This model rank's block of the full tensor ``t`` of parameter
    ``name`` (``take_block`` along the dim ``param_spec`` splits)."""
    dim = sharded_dim(name, t.dim())
    if dim is None or n_model == 1:
        return t
    if name.endswith("weight_q4") and dim == 1:
        return take_packed_block(t, n_model, model_index)
    return take_block(t, dim, n_model, model_index)


def shard_params(state_dict: Dict[str, torch.Tensor],
                 mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Cut a full (one-card) state dict into this rank's shards: each
    tensor split over ``model`` as ``param_spec`` says, the rest whole.
    Returns contiguous copies of the shards and the replicated tensors as
    they are."""
    out = {}
    for name, t in state_dict.items():
        s = shard_tensor(name, t, mesh.n_model, mesh.model_index)
        out[name] = s.contiguous() if s is not t else t
    return out
