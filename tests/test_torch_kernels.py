"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one; the file imports
no JAX, so it runs on a machine that has only PyTorch (``--noconftest``
skips ``tests/conftest.py``, which sets up JAX):

    python -m pytest --noconftest tests/test_torch_kernels.py

Tolerance: the kernels and the plain versions both take bf16 inputs and
accumulate in f32, but round the probabilities to bf16 at different points
(the kernel against its running maximum, the plain version against the row
maximum) and write bf16 outputs, whose rounding step is up to 2^-8 of the
value. So each element is held to 4e-3 + 2e-2 of the plain value's
magnitude (the absolute part covers outputs near zero; 2e-2 for the window
kernel, whose plain version rounds the normalised probabilities, as the TPU
window kernel does, where the CUDA kernel rounds them against its running
maximum: over 196 keys with the rel-pos bias the softmax is peaked, and one
weight's rounding step moves an output by up to ~2^-6), and the RMS error
over the output to 1e-2 of the plain output's RMS, which a systematic error
of a percent fails even where every element passes. The logsumexp is f32 on
both sides and differs only in summation order, so 1e-3.
"""

import numpy as np
import pytest
import torch

from interactvlm_tpu_torch.ops import flash_attention as F
from interactvlm_tpu_torch.ops import sam_attention as S

ATOL, WINDOW_ATOL, RTOL, RMS_TOL = 4e-3, 2e-2, 2e-2, 1e-2
LSE_TOL = 1e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bf16(rng, shape, dev, scale=1.0):
    x = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(dev, torch.bfloat16)


def _close(got, want, atol=ATOL):
    g, w = got.float(), want.float()
    err = (g - w).abs()
    rms = (err.square().mean() / w.square().mean().clamp_min(1e-30)).sqrt()
    return bool((err <= atol + RTOL * w.abs()).all()) and rms.item() <= RMS_TOL


@pytest.mark.parametrize("B,H,Lq,Lk,D,causal,lens", [
    (2, 3, 319, 319, 128, True, (319, 200)),  # LLaMA prefill, ragged rows
    (4, 8, 300, 9, 16, False, None),  # SAM image -> token, Lk = 9
    (1, 2, 70, 130, 64, True, None),  # Lq < Lk: bottom-right offset
    (2, 2, 100, 100, 32, True, (0, 37)),  # row 0 sees no key
])
def test_flash_kernel_matches_plain(dev, B, H, Lq, Lk, D, causal, lens):
    rng = np.random.default_rng(0)
    q = _bf16(rng, (B, H, Lq, D), dev)
    k, v = _bf16(rng, (B, H, Lk, D), dev), _bf16(rng, (B, H, Lk, D), dev)
    kv = None if lens is None else torch.tensor(lens, device=dev)
    before = F.flash_forward.launches
    o, lse = F.flash_forward(q, k, v, causal, None, kv)
    torch.cuda.synchronize()
    assert F.flash_forward.launches == before + 1
    o2, lse2 = F.flash_forward_plain(q, k, v, causal, None, kv)
    assert _close(o, o2)
    assert (lse - lse2).abs().max().item() < LSE_TOL


def test_window_kernel_matches_plain(dev):
    rng = np.random.default_rng(1)
    R, hw, D = 40, (14, 14), 80
    q, k, v = (_bf16(rng, (R, 196, D), dev) for _ in range(3))
    f = _bf16(rng, (R, 28, 196), dev, 0.5)
    before = S.window_attention.launches
    out = S.window_attention(q, k, v, f, hw)
    torch.cuda.synchronize()
    assert S.window_attention.launches == before + 1
    assert _close(out, S.window_attention_plain(q, k, v, f, hw), WINDOW_ATOL)


@pytest.mark.parametrize("side", [32, 64])
def test_global_kernel_matches_plain(dev, side):
    rng = np.random.default_rng(2)
    R, L, D = 2, side * side, 80
    q, k, v = (_bf16(rng, (R, L, D), dev) for _ in range(3))
    rh = _bf16(rng, (R, side, L), dev, 0.5)
    rw = _bf16(rng, (R, L, side), dev, 0.5)
    before = S.rel_attention.launches
    out = S.rel_attention(q, k, v, rh, rw, (side, side))
    torch.cuda.synchronize()
    assert S.rel_attention.launches == before + 1
    want = S.rel_attention_plain(q, k, v, rh, rw, (side, side))
    assert _close(out, want)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """A CUDA tensor reaches the kernel or the call raises: no fallback."""
    rng = np.random.default_rng(3)
    q = _bf16(rng, (1, 2, 64, 16), dev)
    with pytest.raises(ValueError, match="bfloat16"):
        F.flash_forward(q.float(), q.float(), q.float())
    with pytest.raises(ValueError, match="head dim"):
        F.flash_forward(*(_bf16(rng, (1, 2, 64, 48), dev),) * 3)
    with pytest.raises(ValueError, match="contiguous"):
        t = q.transpose(2, 3).contiguous().transpose(2, 3)
        F.flash_forward(t, t, t)
