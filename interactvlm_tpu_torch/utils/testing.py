"""Synthetic training batches and an offline tokenizer for tests, the
card's smoke run and benchmarks.

Port of ``interactvlm_tpu/utils/testing.py``: ``make_synthetic_batch``, the
batch dict of the data pipeline (the reference ``collate_fn``'s keys), drawn
from ``np.random.default_rng(seed)`` in the JAX package's order, so the same
arguments give the same arrays (images are zeros, as there);
``WhitespaceTokenizer``, which gives the JAX package's ids bit for bit; and
``greedy_decode_lm``, a greedy KV-cache decode of the LLaMA alone.
"""

from __future__ import annotations

import hashlib
import re

import numpy as np
import torch

from interactvlm_tpu_torch.config import InteractVLMConfig
from interactvlm_tpu_torch.utils.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from interactvlm_tpu_torch.utils.device import resolve_device


def make_synthetic_batch(cfg: InteractVLMConfig, B: int = 2, L: int = 12,
                         tasks=(2, 3), mask_size: int = 32, seed: int = 0,
                         device="cuda"):
    """Random ids with ``<image>`` at position 1 and the seg token at
    ``L - 2`` (``[HSEG]`` / ``[OSEG]`` at ``L - 4`` / ``L - 2`` when
    ``max_seg_tokens > 1``), labels on the last three positions, random GT
    masks with two IGNORE rows, camera parameters, task ids cycling through
    ``tasks``, 3D contact and affordance targets, and random corner-major
    lift maps. Returns a dict of tensors on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    V = cfg.multiview_channels
    vocab = cfg.llama.vocab_size
    ids = rng.integers(4, min(vocab, 32000) - 1, (B, L)).astype(np.int32)
    ids[:, 1] = IMAGE_TOKEN_INDEX
    K = cfg.max_seg_tokens
    if K > 1:
        hseg = cfg.hseg_token_idx if cfg.hseg_token_idx > 0 else cfg.seg_token_idx
        oseg = cfg.oseg_token_idx if cfg.oseg_token_idx > 0 else cfg.seg_token_idx
        ids[:, L - 4] = hseg
        ids[:, L - 2] = oseg
    else:
        ids[:, L - 2] = cfg.seg_token_idx
    labels = np.full((B, L), IGNORE_INDEX, np.int32)
    labels[:, L - 3:] = ids[:, L - 3:]
    labels[:, L - 3] = 9
    Nh, P = cfg.num_human_vertices, cfg.num_object_points
    S, Sc, M = cfg.sam.img_size, cfg.clip.image_size, mask_size

    gt_masks = (rng.random((B, V, M, M)) > 0.7).astype(np.float32)
    gt_masks[:, :, :2] = -1.0
    extra = {}
    if K > 1:
        # slot 0 the row's primary mask, slot 1 a second mask set, the
        # other slots IGNORE (the collate's max_seg_tokens layout)
        gtk = np.full((B, K, V, M, M), -1.0, np.float32)
        gtk[:, 0] = gt_masks
        second = (rng.random((B, V, M, M)) > 0.6).astype(np.float32)
        second[:, :, :2] = -1.0
        gtk[:, 1] = second
        gt_masks = gtk
        has = np.zeros((B, K), np.float32)
        has[:, :2] = 1.0
        extra["seg_slot_has_mask"] = has

    p2v = rng.integers(0, Nh, (V, M, M, 3)).astype(np.int32)
    p2v[:, :M // 2] = -1
    bary = rng.dirichlet([1, 1, 1], (V, M, M)).astype(np.float32)
    p2p = rng.integers(-1, P, (B, V, M, M)).astype(np.int32)
    arrays = {
        **extra,
        "input_ids": ids,
        "labels": labels,
        "gt_masks": gt_masks,
        "cam_params": rng.random((B, V, 5)).astype(np.float32),
        "task_ids": np.resize(np.array(tasks), B).astype(np.int32),
        "gt_hcontact": (rng.random((B, Nh)) > 0.8).astype(np.float32),
        "gt_oafford": rng.random((B, P)).astype(np.float32),
        # corner-major (3, V, H, W): see geometry/lift.corner_major
        "human_p2v": np.ascontiguousarray(np.moveaxis(p2v, -1, 0)),
        "human_bary": np.ascontiguousarray(np.moveaxis(bary, -1, 0)),
        "obj_p2p": p2p,
    }
    batch = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
    batch["images_clip"] = torch.zeros((B, Sc, Sc, 3), device=dev)
    batch["sam_images"] = torch.zeros((B, V, S, S, 3), device=dev)
    return batch


class _TokOut:
    def __init__(self, ids):
        self.input_ids = ids

    def __getitem__(self, key):  # HF BatchEncoding dict access
        if key == "input_ids":
            return self.input_ids
        raise KeyError(key)


class WhitespaceTokenizer:
    """Deterministic stand-in for an HF tokenizer, for offline runs:
    whitespace / punctuation word pieces, bos / eos / pad specials and
    ``add_tokens``.

    Word ids are stable hashes (sha1), not first-seen order, so a train and
    an eval process map the same words to the same ids. Specials sit at
    0-3, added tokens at 4-15 in call order (``add_new_tokens`` fixes it at
    start-up), hashed words at 16..max_vocab-1 (collisions are accepted)."""

    _ADDED_BASE = 4
    _HASH_BASE = 16

    def __init__(self, model_max_length: int = 512, max_vocab: int = 512):
        self.model_max_length = model_max_length
        self.max_vocab = max_vocab
        self.vocab = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3}
        self._next_added = self._ADDED_BASE
        self.bos_token_id = 1
        self.eos_token_id = 2
        self.pad_token_id = 0

    def _pieces(self, text: str):
        out = []
        for part in text.replace("</s>", " </s> ").split():
            if part == "</s>":
                out.append(part)
                continue
            out.extend(re.findall(r"\[[A-Z]+\]|\w+|[^\w\s]", part))
        return out

    def _id(self, piece: str) -> int:
        if piece not in self.vocab:
            h = int(hashlib.sha1(piece.encode()).hexdigest()[:8], 16)
            self.vocab[piece] = self._HASH_BASE + h % (
                self.max_vocab - self._HASH_BASE)
        return self.vocab[piece]

    def __call__(self, text: str, add_special_tokens: bool = True):
        ids = [self._id(p) for p in self._pieces(text)]
        if add_special_tokens:
            ids = [self.bos_token_id] + ids
        return _TokOut(ids)

    def add_tokens(self, token: str):
        if token not in self.vocab:
            self.vocab[token] = self._next_added
            self._next_added += 1

    def convert_ids_to_tokens(self, idx: int) -> str:
        for k, v in self.vocab.items():
            if v == idx:
                return k
        return "<unk>"

    def decode(self, ids) -> str:
        return " ".join(self.convert_ids_to_tokens(int(i)) for i in ids)


@torch.no_grad()
def greedy_decode_lm(model, ids, caches, total_steps: int,
                     top2: bool = False):
    """Greedy KV-cache decode of a ``LlamaForCausalLM``: prefill ``ids``
    (B, L0) over the fresh ``caches``, then emit ``total_steps - L0`` more
    tokens; returns the (B, total_steps - L0 + 1) emitted ids, int32 numpy
    (the JAX package's ``greedy_decode_lm``, which the multichip dry run
    and the quantization tests share). With ``top2`` also returns each
    step's two largest logits, (B, steps, 2) f32: their gap says how near
    a tie each choice was."""
    B, L0 = ids.shape
    dev = ids.device
    pos = torch.arange(L0, device=dev)[None].expand(B, L0)
    lg, _, caches = model.forward_embeds(model.embed(ids), pos, None, caches)
    toks, tops = [], []

    def take(last):
        tops.append(torch.topk(last.float(), 2, dim=-1).values.cpu().numpy())
        tok = last.argmax(-1).to(torch.int32)
        toks.append(tok.cpu().numpy())
        return tok

    tok = take(lg[:, -1])
    for t in range(L0, total_steps):
        lg, _, caches = model.forward_embeds(
            model.embed(tok[:, None]), torch.full((B, 1), t, device=dev),
            None, caches)
        tok = take(lg[:, -1])
    out = np.stack(toks, axis=1)
    return (out, np.stack(tops, axis=1)) if top2 else out
