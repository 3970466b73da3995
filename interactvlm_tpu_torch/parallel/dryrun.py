"""The multi-rank dry run: one sharded training step of the flagship
interaction model and a tensor-parallel greedy decode, on tiny shapes (the
port of ``__graft_entry__.py:dryrun_multichip``'s body). ``dryrun_rank``
runs on every rank of ``launch.spawn``; ``graft_entry_torch.py`` launches
it."""

from __future__ import annotations


import torch

from interactvlm_tpu_torch.config import (
    clip_tiny,
    interactvlm_tiny,
    llama_tiny,
    sam_tiny,
)


def small_config(device: torch.device):
    """The tiny preset at the flagship's interaction shapes: Gen-Hu-Obj
    with the DifDe decoders and K = 2 seg-token slots a row, LoRA rank 4
    (``scripts/run_train.sh`` hcontact-ocontact). SAM computes in bf16 on
    the card (its kernels take bf16 only)."""
    sam = sam_tiny(dtype=torch.bfloat16) if device.type == "cuda" \
        else sam_tiny()
    return interactvlm_tiny(
        llama=llama_tiny(lora_rank=4), clip=clip_tiny(), sam=sam,
        token_type="Gen-Hu-Obj-DifDe", hseg_token_idx=501,
        oseg_token_idx=502, max_seg_tokens=2)


def dryrun_rank(mesh, device: str, nccl: bool = False):
    """On one rank: the flagship's ZeRO + tensor-parallel training step on
    a batch of one row a data rank, then a tensor-parallel greedy decode of
    its LLaMA (5 prompt tokens, 8 in all). ``device`` "cuda" puts rank r
    on card r under NCCL (``nccl``), every rank on card 0 under gloo.
    Returns {"loss", "tokens"}."""
    from interactvlm_tpu_torch.models.interactvlm import InteractVLM
    from interactvlm_tpu_torch.models.llama import (
        LlamaForCausalLM,
        init_kv_cache,
    )
    from interactvlm_tpu_torch.train.train_step import TrainStep
    from interactvlm_tpu_torch.utils.device import resolve_device
    from interactvlm_tpu_torch.utils.testing import (
        greedy_decode_lm,
        make_synthetic_batch,
    )
    from interactvlm_tpu_torch.utils.weights import init_params

    if device == "cuda":
        device = f"cuda:{mesh.rank}" if nccl else "cuda:0"
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    cfg = small_config(dev)
    model = InteractVLM(cfg, device=dev, mesh=mesh)
    init_params(model, torch.Generator(device=dev).manual_seed(0))
    batch = make_synthetic_batch(cfg, B=mesh.n_data, device=dev)
    step = TrainStep(model, mesh=mesh, lr=1e-3, warmup_steps=2,
                     total_steps=10)
    loss = float(step(batch)["loss"])
    if not (loss == loss and abs(loss) < 1e9):
        raise RuntimeError(f"dryrun: bad loss {loss}")

    lm = LlamaForCausalLM(cfg.llama, device=dev, mesh=mesh)
    init_params(lm, torch.Generator(device=dev).manual_seed(2))
    ids = torch.randint(0, cfg.llama.vocab_size, (mesh.n_data, 5),
                        generator=torch.Generator().manual_seed(1)).to(dev)
    caches = init_kv_cache(cfg.llama, mesh.n_data, 8, dev,
                           n_model=mesh.n_model)
    with torch.no_grad():
        toks = greedy_decode_lm(lm, ids, caches, total_steps=8)[:, -1]
    toks = [int(t) for t in toks]
    if not all(0 <= t < cfg.llama.vocab_size for t in toks):
        raise RuntimeError(f"dryrun: token out of the vocabulary {toks}")
    return {"loss": loss, "tokens": toks}


def layout(n_devices: int):
    """(n_data, n_model): the model axis 2 where n is even, as the JAX dry
    run lays it out."""
    n_model = 2 if n_devices % 2 == 0 else 1
    return n_devices // n_model, n_model


