"""Host allocator tuning for the input pipeline (a copy of
``interactvlm_tpu/runtime/hostmem.py``).

glibc returns large free blocks to the kernel immediately (mmap/munmap per
allocation above ``M_MMAP_THRESHOLD``, heap trim above ``M_TRIM_THRESHOLD``).
A collate step allocates a few hundred MB of fresh batch arrays
(B x V x 1024^2 images), so every batch re-faults ~100k pages; under
some container runtimes a minor fault costs ~0.5 ms and the batch
spends most of its wall time in the kernel (the JAX package measured
``np.stack`` of a (8,4,1024,1024,3) f32 batch at 47 s cold and 0.04 s once
the heap is reused on such a runtime). The reference sidesteps this by
accident -- torch DataLoader workers are long-lived processes whose caching
allocator reuses pinned buffers (reference ``train.py:334-352``).

``tune_host_allocator()`` keeps large blocks in the main heap and stops
trimming, so steady-state batches reuse already-faulted pages. Call it once
at start-up (the train and eval CLIs do). No-op on non-glibc platforms.
"""

from __future__ import annotations

import ctypes
import ctypes.util

# glibc mallopt parameter numbers (malloc.h)
_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3
_M_MMAP_MAX = -4

_INT_MAX = 2**31 - 1

_done = False


def tune_host_allocator() -> bool:
    """Keep big malloc blocks heap-resident and never trim. Idempotent.
    Returns True if mallopt was applied."""
    global _done
    if _done:
        return True
    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6",
                           use_errno=True)
        mallopt = libc.mallopt
    except (OSError, AttributeError):
        return False
    mallopt.argtypes = (ctypes.c_int, ctypes.c_int)
    mallopt.restype = ctypes.c_int
    ok = True
    # route every allocation through the (reused) heap, never munmap
    ok &= bool(mallopt(_M_MMAP_MAX, 0))
    ok &= bool(mallopt(_M_MMAP_THRESHOLD, _INT_MAX))
    ok &= bool(mallopt(_M_TRIM_THRESHOLD, _INT_MAX))
    _done = bool(ok)
    return _done
