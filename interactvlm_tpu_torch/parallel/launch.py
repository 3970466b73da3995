"""Start n ranks from one process: ``spawn(fn, n, ...)`` runs
``fn(mesh, *args)`` on every rank of an (n / n_model, n_model) mesh and
returns the ranks' results in rank order.

Each rank is a fresh interpreter (``torch.multiprocessing`` with the
``spawn`` start method, so a card's context is never forked): it joins the
process group through ``init_method`` (a ``file://`` path by default, a new
file under a temporary directory, so concurrent launches never share a
port), builds the mesh, calls ``fn`` and writes its result with
``torch.save`` for the parent. ``fn`` must be importable by name (a module's
top-level function): the child imports the module that holds it.

``backend`` "gloo" runs the ranks on the CPU, or on one card that they
share (``fn`` puts its tensors there); "nccl" gives rank r card r and needs
n cards (``mesh.init_distributed`` refuses fewer). torchrun is the other
launcher: under it every process calls ``init_distributed`` and
``create_mesh`` itself (``train/train.py``, ``eval/evaluate.py``).
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from interactvlm_tpu_torch.parallel.mesh import create_mesh, init_distributed


def _rank_main(rank: int, fn: Callable, nprocs: int, n_model: int,
               backend: str, args: Sequence[Any], init_method: str,
               out_dir: str, threads: Optional[int]):
    if threads:
        torch.set_num_threads(threads)
    os.environ["RANK"] = str(rank)
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["WORLD_SIZE"] = str(nprocs)
    os.environ["LOCAL_WORLD_SIZE"] = str(nprocs)
    init_distributed(backend, init_method, rank, nprocs)
    try:
        mesh = create_mesh(nprocs // n_model, n_model)
        result = fn(mesh, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, n_model: int = 1,
          backend: str = "gloo", args: Sequence[Any] = (),
          init_method: Optional[str] = None,
          threads: Optional[int] = 1) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``nprocs`` ranks over ``backend`` and
    return their results in rank order; raises if a rank fails.
    ``threads``: each rank's ``torch.set_num_threads`` (None leaves it)."""
    if nprocs % n_model:
        raise ValueError(f"spawn: {nprocs} ranks do not tile n_model "
                         f"{n_model}")
    work = tempfile.mkdtemp(prefix="ivlm_spawn_")
    try:
        if init_method is None:
            init_method = "file://" + os.path.join(work, "rendezvous")
        mp.spawn(_rank_main, nprocs=nprocs, join=True,
                 args=(fn, nprocs, n_model, backend, tuple(args),
                       init_method, work, threads))
        return [torch.load(os.path.join(work, f"rank{r}.pt"),
                           weights_only=False) for r in range(nprocs)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
