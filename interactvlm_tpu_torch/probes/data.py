"""Host input-pipeline probe: data seconds a batch at real image sizes
(B = 8 rows of V = 4 views at 1024^2) through the port's dataset ->
``collate`` -> ``runtime/prefetch.ParallelSampler`` path, serial against
thread pools.

Port of ``scripts/data_probe.py``. The DAMON tree is written once by the
port's own recipe (``datagen/recipes.py:generate_damon_tree``, a 12 x 16
UV sphere under the ``4MV-Z_Vitru_mv2`` cameras, seeded JPEG photos) and
reused. Each line gives the seconds a batch, their share of a training
step (PROBE_STEP_S), and which image decoder read the batches' images
(``runtime/native_image``: the native PNG decoder, or PIL), with each
decoder's loads by format.

Usage: python -m interactvlm_tpu_torch.probes.data [workers ...]
(default 1 4 8 16). Env: PROBE_IMAGES (16), PROBE_BATCHES (6),
PROBE_SIZE (1024), PROBE_BATCH (8), PROBE_STEP_S (1.56: the 13B LoRA
training step at B = 8 on one H100), PROBE_ROOT (where the tree is kept;
a folder under the temporary directory by default). The recipe
rasterizes on the card; ``main(..., device="cpu")`` rasterizes on the CPU.
The loader itself is host work either way. A worker count below 1
raises.
"""

from __future__ import annotations

import collections
import os
import sys
import tempfile
import time

import numpy as np

from interactvlm_tpu_torch.utils.device import resolve_device


def build_tree(root: str, size: int, n_images: int, device) -> None:
    """A DAMON tree under ``root``: ``n_images`` seeded photos, each with
    a 30-vertex 'chair' contact, through the port's recipe."""
    from PIL import Image

    from interactvlm_tpu_torch.datagen.recipes import generate_damon_tree
    from interactvlm_tpu_torch.geometry.rasterizer import uv_sphere
    from interactvlm_tpu_torch.geometry.views import HUMAN_VIEWS

    verts, faces = uv_sphere(12, 16)
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    annot = {}
    for i in range(n_images):
        name = f"img{i}.jpg"
        Image.fromarray(
            rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
        ).save(os.path.join(root, "images", name), quality=85)
        start = (i * 23) % (len(verts) - 40)
        annot[name] = {"chair": np.arange(start, start + 30)}
    segm = {"head": list(range(len(verts) // 2)),
            "legs": list(range(len(verts) // 2, len(verts)))}
    generate_damon_tree(root, annot, verts, faces,
                        HUMAN_VIEWS["4MV-Z_Vitru_mv2"], size, segm,
                        device=device)


def main(argv=None, device="cuda", size=None, n_images=None,
         n_batches=None, B=None, root=None):
    """Time each worker count; returns {"decoder", "tree_s", workers:
    {"s_per_batch", "step_share", "loads"}}."""
    from interactvlm_tpu_torch.data.collate import collate
    from interactvlm_tpu_torch.data.datasets import HContactDataset
    from interactvlm_tpu_torch.runtime import native_image
    from interactvlm_tpu_torch.runtime.hostmem import tune_host_allocator
    from interactvlm_tpu_torch.runtime.prefetch import ParallelSampler
    from interactvlm_tpu_torch.utils.testing import WhitespaceTokenizer

    dev = resolve_device(device)
    print(f"[data] host allocator tuned: {tune_host_allocator()}",
          flush=True)
    size = size or int(os.environ.get("PROBE_SIZE", "1024"))
    n_images = n_images or int(os.environ.get("PROBE_IMAGES", "16"))
    n_batches = n_batches or int(os.environ.get("PROBE_BATCHES", "6"))
    B = B or int(os.environ.get("PROBE_BATCH", "8"))
    step_s = float(os.environ.get("PROBE_STEP_S", "1.56"))
    counts = [int(w) for w in argv] if argv else [1, 4, 8, 16]
    if min(counts) < 1:
        raise ValueError(f"data: worker counts must be >= 1, got {counts}")
    root = root or os.environ.get("PROBE_ROOT") or os.path.join(
        tempfile.gettempdir(), f"ivlm_torch_data_probe_{size}_{n_images}")
    results = {"decoder": native_image.decoder(), "tree_s": None}
    if not os.path.exists(os.path.join(root, "hcontact_vitruvian_mv2")):
        t0 = time.perf_counter()
        build_tree(root, size, n_images, dev)
        results["tree_s"] = time.perf_counter() - t0
        print(f"[data] tree built in {results['tree_s']:.1f}s at {root}",
              flush=True)
    ds = HContactDataset(root, image_size=size, clip_size=224)
    tok = WhitespaceTokenizer()
    print(f"[data] image decoder: {results['decoder']}", flush=True)
    def drained_sampler(workers):
        return ParallelSampler(lambda i: ds[i % len(ds)],
                               num_workers=workers,
                               lookahead=max(2 * B, workers))

    for workers in counts:
        # warm (page cache, allocator) on a pool of its own, drained before
        # the clock starts: its look-ahead would otherwise decode the timed
        # samples before the timed loop, and into the load count's start
        warm = drained_sampler(workers)
        it = warm.iterate(iter(range(10 ** 9)))
        samples = [next(it) for _ in range(B)]
        collate([samples[0]], tok, max_len=512)
        warm.pool.shutdown(wait=True, cancel_futures=True)
        sampler = drained_sampler(workers)
        it = sampler.iterate(iter(range(B, 10 ** 9)))
        loads0 = collections.Counter(native_image.loads)
        t0 = time.perf_counter()
        for _ in range(n_batches):
            samples = [next(it) for _ in range(B)]
            collate(samples, tok, max_len=512)
        dt = (time.perf_counter() - t0) / n_batches
        # drain before reading the count: every sample the timed loop took
        # has been decoded, and no look-ahead decodes into the next count's
        # timed loop
        sampler.pool.shutdown(wait=True, cancel_futures=True)
        loads = dict(native_image.loads - loads0)
        results[workers] = {"s_per_batch": dt, "step_share": dt / step_s,
                            "loads": loads}
        print(f"[data] workers={workers}: {dt:.2f} s/batch (B={B}, V=4, "
              f"{size}px) -> {dt / step_s * 100:.0f}% of a {step_s}s "
              f"step; loads {loads}", flush=True)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
