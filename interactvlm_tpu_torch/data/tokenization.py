"""Tokenization utilities: image-token splitting, causal-LM target
construction, fixed-shape padding (a copy of
``interactvlm_tpu/data/tokenization.py``: the same ids and targets).

Rebuild of ``model/llava/mm_utils.py:19-44`` (tokenizer_image_token) and the
target-building half of the reference ``collate_fn``
(``datasets/dataset.py:112-157``): instruction spans are masked with
IGNORE_INDEX by parsing the conversation separators, and sequences are
padded/truncated to a static length (fixed-shape batches: the
reference's dynamic max-in-batch padding becomes pad-to-``max_len``).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from interactvlm_tpu_torch.utils.constants import (
    DEFAULT_IM_END_TOKEN,
    DEFAULT_IM_START_TOKEN,
    DEFAULT_IMAGE_TOKEN,
    IGNORE_INDEX,
    IMAGE_TOKEN_INDEX,
)
from interactvlm_tpu_torch.data.conversations import get_conversation_template


def tokenizer_image_token(
    prompt: str, tokenizer, image_token_index: int = IMAGE_TOKEN_INDEX
) -> List[int]:
    """Tokenize a prompt containing ``<image>`` placeholders, inserting the
    sentinel index (reference mm_utils.py:19-44)."""
    chunks = [tokenizer(c).input_ids for c in prompt.split(DEFAULT_IMAGE_TOKEN)]

    input_ids: List[int] = []
    offset = 0
    if chunks and chunks[0] and chunks[0][0] == tokenizer.bos_token_id:
        offset = 1
        input_ids.append(chunks[0][0])

    sep = [image_token_index] * (offset + 1)
    merged = []
    for i, c in enumerate(chunks):
        merged.append(c)
        if i < len(chunks) - 1:
            merged.append(sep)
    for x in merged:
        input_ids.extend(x[offset:])
    return input_ids


def wrap_image_tokens(text: str, use_mm_start_end: bool = True) -> str:
    """Wrap ``<image>`` with im_start/im_end (reference
    dataset.py:93-103)."""
    if not use_mm_start_end:
        return text
    return text.replace(
        DEFAULT_IMAGE_TOKEN,
        DEFAULT_IM_START_TOKEN + DEFAULT_IMAGE_TOKEN + DEFAULT_IM_END_TOKEN,
    )


def build_targets(
    conversation: str,
    input_ids: Sequence[int],
    tokenizer,
    conv_type: str = "llava_v1",
) -> np.ndarray:
    """Mask instruction spans with IGNORE_INDEX (reference
    dataset.py:112-150): for each ``sep2``-separated round, everything up to
    and including ``"<sep><ASSISTANT-role>: "`` is masked; only answers
    supervise."""
    conv = get_conversation_template(conv_type)
    if conv_type == "llava_v1":
        sep = conv.sep + conv.roles[1] + ": "
    else:
        sep = "[/INST] "

    target = np.asarray(input_ids, dtype=np.int64).copy()
    rounds = conversation.split(conv.sep2)
    cur = 1
    target[:cur] = IGNORE_INDEX
    for rou in rounds:
        if rou == "":
            break
        parts = rou.split(sep)
        assert len(parts) == 2, (len(parts), rou)
        head = parts[0] + sep
        if DEFAULT_IMAGE_TOKEN in conversation:
            round_len = len(tokenizer_image_token(rou, tokenizer))
            instruction_len = len(tokenizer_image_token(head, tokenizer)) - 2
        else:
            round_len = len(tokenizer(rou).input_ids)
            instruction_len = len(tokenizer(head).input_ids) - 2
        target[cur : cur + instruction_len] = IGNORE_INDEX
        cur += round_len
    target[cur:] = IGNORE_INDEX
    return target


def pad_and_stack(
    sequences: Sequence[Sequence[int]],
    max_len: int,
    pad_value: int,
):
    """Right-pad to a static ``max_len`` (truncating longer). Returns
    (ids (B, max_len) int32, attention (B, max_len) int32)."""
    B = len(sequences)
    out = np.full((B, max_len), pad_value, np.int32)
    attn = np.zeros((B, max_len), np.int32)
    for i, seq in enumerate(sequences):
        L = min(len(seq), max_len)
        out[i, :L] = np.asarray(seq[:L], np.int32)
        attn[i, :L] = 1
    return out, attn


def tokenize_conversations(
    conversations: Sequence[str],
    tokenizer,
    max_len: int,
    conv_type: str = "llava_v1",
    use_mm_start_end: bool = True,
):
    """Full path: wrap image tokens, tokenize with the image sentinel, build
    masked targets, pad to static shape. Returns dict of numpy arrays."""
    wrapped = [wrap_image_tokens(c, use_mm_start_end) for c in conversations]
    ids = [tokenizer_image_token(c, tokenizer) for c in wrapped]
    targets = [
        build_targets(c, i, tokenizer, conv_type)
        for c, i in zip(wrapped, ids)
    ]
    input_ids, attn = pad_and_stack(ids, max_len, tokenizer.pad_token_id)
    labels, _ = pad_and_stack(targets, max_len, IGNORE_INDEX)
    # padded positions never supervise
    labels = np.where(attn > 0, labels, IGNORE_INDEX)
    return {
        "input_ids": input_ids,
        "labels": labels.astype(np.int32),
        "attn_mask": attn,
    }
