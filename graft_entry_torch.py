"""Entry points of the PyTorch port (the counterparts of
``__graft_entry__.py``).

``entry(device)`` -> (fn, example_args): one forward of the flagship
composite model at the tiny preset (the architecture is the one of every
scale), ``fn(model, batch)`` -> (loss, pred_masks).

``dryrun_multichip(n_devices, device)`` -> spawns ``n_devices`` ranks on an
(n / 2, 2) layout and runs one ZeRO-sharded, tensor-parallel training step
of the interaction flagship (Gen-Hu-Obj-DifDe, K = 2, LoRA 4) and a
tensor-parallel greedy decode on tiny shapes
(``interactvlm_tpu_torch/parallel/dryrun.py``). The ranks talk over NCCL
where the host has ``n_devices`` cards and the ranks run on them; over
gloo otherwise: on the CPU (``device="cpu"``), or with every rank on the
one card.

    python graft_entry_torch.py [n_devices] [--device cpu]
"""

from __future__ import annotations

import sys

import torch


def entry(device="cuda"):
    from interactvlm_tpu_torch.models.interactvlm import InteractVLM
    from interactvlm_tpu_torch.parallel.dryrun import small_config
    from interactvlm_tpu_torch.utils.device import resolve_device
    from interactvlm_tpu_torch.utils.testing import make_synthetic_batch
    from interactvlm_tpu_torch.utils.weights import init_params

    dev = resolve_device(device)
    cfg = small_config(dev)
    model = InteractVLM(cfg, device=dev)
    init_params(model, torch.Generator(device=dev).manual_seed(0))
    batch = make_synthetic_batch(cfg, B=2, device=dev)

    def fn(model, batch):
        out = model(batch)
        return out["loss"], out["pred_masks"]

    return fn, (model, batch)


def dryrun_multichip(n_devices: int, device="cuda"):
    """One sharded training step and a tensor-parallel decode on
    ``n_devices`` ranks; returns the ranks' results ({"loss", "tokens"})."""
    from interactvlm_tpu_torch.parallel.dryrun import dryrun_rank, layout
    from interactvlm_tpu_torch.parallel.launch import spawn
    from interactvlm_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    n_data, n_model = layout(n_devices)
    nccl = dev.type == "cuda" and torch.cuda.device_count() >= n_devices
    per_rank = "cuda" if dev.type == "cuda" else "cpu"
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    results = spawn(dryrun_rank, n_devices, n_model=n_model,
                    backend="nccl" if nccl else "gloo",
                    args=(per_rank, nccl), threads=None)
    losses = {r["loss"] for r in results}
    if len(losses) != 1:
        raise RuntimeError(f"dryrun: the ranks' losses differ: {losses}")
    print(f"dryrun_multichip({n_devices}): mesh=({n_data}x{n_model}) "
          f"backend={'nccl' if nccl else 'gloo'} "
          f"loss={results[0]['loss']:.4f} "
          f"tp_decode={results[0]['tokens'][:2]}... ok", flush=True)
    return results


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    device = "cpu" if "--device" in sys.argv and "cpu" in sys.argv else "cuda"
    fn, (model, batch) = entry(device)
    loss, _ = fn(model, batch)
    print("entry() run ok, loss =", loss.item())
    dryrun_multichip(int(args[0]) if args else 2, device)
