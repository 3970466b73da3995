"""Knock-out variants of the sm90 window kernel, built side by side and
timed in one process on the card: where kernel 2's time goes.

    python -m interactvlm_tpu_torch.probes.kernel_variants [variant ...]

Each variant is the kernel's sources under ``csrc/`` with a few text edits
(``VARIANTS``), compiled by ``nvcc`` into ``build/variants/<name>/`` (all
started together) and launched through its own C entry point at ViT-H's
window block, R = 12 800 rows of L = 196 at D = 80, on contiguous rows and
on the views of one qkv tensor (the layout the SAM encoder gives it). Each
prints one JSON line: its ms by CUDA events on both inputs, in two rounds
over all variants, and whether its output still matches the plain version
(knock-outs that cut work do not). ``stamps`` also prints, for CTA 0, the
clocks each phase of a row took in each consumer warpgroup (``clock64``).
Needs one CUDA card and ``nvcc``; compare variants only within one run.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

from interactvlm_tpu_torch.ops import _cuda
from interactvlm_tpu_torch.ops import sam_attention as SA

HEADER = "window_attention_sm90.cuh"
_TILE_CALL = "      tile<kH, kQRows>(b, t, fs, orow, p, warp, g, tig, turns);"
_STAMP = """namespace win_sm90 {

using namespace ivlm::sm90;
"""
# a stamp a phase: 0 row start, 1 its stage landed, then for each of the
# warpgroup's two tiles: S issued, S done, softmax done, P V issued, P V
# done, rows stored
STAMP_PHASES = ("stage_wait", "s_issue", "s_wait", "softmax", "pv_issue",
                "pv_wait", "store")
VARIANTS = {
    "base": {},
    # the turns between the consumer warpgroups taken out
    "no_turns": {HEADER: [
        ["  __device__ __forceinline__ void take() const { bar_sync(mine, "
         "256); }", "  __device__ __forceinline__ void take() const {}"],
        ["    if (n++ < last || !wg1) bar_arrive(other, 256);", "    n++;"],
        ["  if (wg == 1) bar_arrive(kBarTurn, 256);\n", ""]]},
    # the warpgroup index straight from threadIdx.x: ptxas serializes
    "wg_from_tid": {HEADER: [
        ["  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);",
         "  const int wg = threadIdx.x / 128;"]]},
    # no loads: the stages are marked full with nothing in them
    "no_loads": {HEADER: [
        ["      mbar_arrive_expect_tx(bar, bytes + fn);\n"
         "      bulk_load(factors + st * (Lay::kFactors / 2),\n"
         "                reinterpret_cast<const void*>(fa), fn, bar);\n",
         "      mbar_arrive(bar);\n      if (fn) continue;\n"]]},
    # no compute: the consumers release each stage as it lands
    "no_compute": {HEADER: [
        ["    for (int t = wg; t < ntiles; t += 2)\n" + _TILE_CALL,
         "    (void)b; (void)fs; (void)orow; (void)ntiles;"]]},
    # the exps replaced by a multiply
    "no_exps": {HEADER: [
        ["        x = exp2_ftz(x - ((i & 2) ? m1 : m0));",
         "        x = (x - ((i & 2) ? m1 : m0)) * 0.001f;"]]},
    "stamps": {
        HEADER: [
            [_STAMP, _STAMP + "__device__ long long dbg_t[2][16][16];\n"
             "__device__ __forceinline__ void stamp(int wg, int it, int i) {\n"
             "  if (blockIdx.x == 0 && (threadIdx.x & 127) == 0 && it < 16)\n"
             "    dbg_t[wg][it][i] = clock64();\n}\n"],
            ["int g, int tig, Turns& turns) {",
             "int g, int tig, Turns& turns, int dwg, int dit, int dk) {"],
            ["  wgmma_commit();\n  turns.pass();\n\n",
             "  wgmma_commit();\n  turns.pass();\n"
             "  stamp(dwg, dit, 2 + 6 * dk);\n\n"],
            ["  wgmma_wait<0>();\n  fence_regs(s);\n",
             "  wgmma_wait<0>();\n  fence_regs(s);\n"
             "  stamp(dwg, dit, 3 + 6 * dk);\n"],
            ["  turns.take();\n  wgmma_fence();\n#pragma unroll\n  for (int kh",
             "  stamp(dwg, dit, 4 + 6 * dk);\n  turns.take();\n"
             "  wgmma_fence();\n#pragma unroll\n  for (int kh"],
            ["  turns.pass();\n  wgmma_wait<0>();\n",
             "  turns.pass();\n  stamp(dwg, dit, 5 + 6 * dk);\n"
             "  wgmma_wait<0>();\n"],
            ["  fence_regs(oa);\n  fence_regs(ob);\n",
             "  fence_regs(oa);\n  fence_regs(ob);\n"
             "  stamp(dwg, dit, 6 + 6 * dk);\n"],
            ["          pack_f32(ob[4 * j + 2 * r] * inv, ob[4 * j + 2 * r + 1] "
             "* inv);\n  }\n}",
             "          pack_f32(ob[4 * j + 2 * r] * inv, ob[4 * j + 2 * r + 1] "
             "* inv);\n  }\n  stamp(dwg, dit, 7 + 6 * dk);\n}"],
            ["    mbar_wait(&full[st], (it / kStages) & 1);\n",
             "    stamp(wg, it, 0);\n    mbar_wait(&full[st], (it / kStages) "
             "& 1);\n    stamp(wg, it, 1);\n"],
            [_TILE_CALL, _TILE_CALL.replace("turns);",
                                            "turns, wg, it, t >> 1);")]],
        "window_attention.cu": [
            ["IVLM_EXPORT_ERROR_STRING(ivlm_window_attention)",
             'extern "C" int ivlm_dbg_read(void* dst) {\n'
             "  return (int)cudaMemcpyFromSymbol(\n"
             "      dst, ivlm::win_sm90::dbg_t, sizeof(ivlm::win_sm90::dbg_t));"
             "\n}\nIVLM_EXPORT_ERROR_STRING(ivlm_window_attention)"]]},
}


def edited_sources(name: str) -> dict:
    """The variant's edited files, by name: each edit must match once."""
    out = {}
    for fn, pairs in VARIANTS[name].items():
        with open(os.path.join(_cuda.CSRC, fn)) as f:
            text = f.read()
        for old, new in pairs:
            if text.count(old) != 1:
                raise ValueError(f"{name}: {fn} holds {text.count(old)} "
                                 f"copies of {old[:60]!r}")
            text = text.replace(old, new)
        out[fn] = text
    return out


def build(names, root):
    procs = {}
    for name in names:
        d = os.path.join(root, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_cuda.CSRC, d)
        for fn, text in edited_sources(name).items():
            with open(os.path.join(d, fn), "w") as f:
                f.write(text)
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", d, "-o",
               os.path.join(d, "lib.so"),
               os.path.join(d, "window_attention.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(os.path.abspath(os.path.join(root, name,
                                                              "lib.so")))
    return libs


def _time_ms(fn, iters=10):
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None):
    names = list(argv) if argv else list(VARIANTS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi.stdout.strip()}), flush=True)
    root = os.path.join(os.path.dirname(_cuda.BUILD_DIR), "variants")
    libs = build(names, root)
    gen = torch.Generator(device="cuda").manual_seed(0)
    R, L, D, nH, hw = 12800, 196, 80, 16, (14, 14)

    def draw(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(torch.bfloat16)

    q, k, v = (draw((R, 1, L, D)) for _ in range(3))
    f = draw((R, 28, L), 0.5)
    qkv = draw((R // nH, L, 3 * nH * D))
    views = qkv.view(R // nH, L, 3, nH, D).permute(2, 0, 3, 1, 4).unbind(0)
    cases = {"contiguous": (q, k, v), "qkv_views": views}
    want = {c: SA.window_attention_plain(*t, f, hw) for c, t in cases.items()}

    def launcher(lib, t):
        fn = lib.ivlm_window_attn
        fn.restype, fn.argtypes = ctypes.c_int, SA._WINDOW_ARGTYPES
        BW, H_, L_, D_ = t[0].shape
        o = torch.empty(BW, L_, H_, D_, dtype=torch.bfloat16, device="cuda")
        strides = [s for x in t for s in x.stride()[:3]]

        def go():
            code = fn(*(_cuda.ptr(x) for x in (*t, f, o)), BW, H_, L_, *hw,
                      D_, SA.WINDOW_ROUTES["sm90"], *strides,
                      float(D_ ** -0.5), _cuda.stream_handle(o.device))
            if code:
                raise RuntimeError(f"launch failed ({code})")
        return go, o

    res = {n: {c: [] for c in cases} for n in names}
    for _ in range(2):
        for n in names:
            for c, t in cases.items():
                go, o = launcher(libs[n], t)
                res[n][c].append(_time_ms(go))
                err = (o.transpose(1, 2).float() - want[c].float()).abs()
                res[n][c + "_matches_plain"] = bool(
                    (err <= 2e-2 + 2e-2 * want[c].float().abs()).all())
    for n in names:
        print(json.dumps({"variant": n, "ms": res[n]}), flush=True)
    if "stamps" in names:
        import numpy as np

        lib = libs["stamps"]
        go, _ = launcher(lib, cases["contiguous"])
        go()
        torch.cuda.synchronize()
        buf = np.zeros((2, 16, 16), dtype=np.int64)
        lib.ivlm_dbg_read.argtypes = [ctypes.c_void_p]
        if lib.ivlm_dbg_read(buf.ctypes.data):
            raise RuntimeError("reading the stamps failed")
        for wg in range(2):
            for it in range(2, 8):  # rows past the pipeline's fill
                d = np.diff(buf[wg, it, :14]).tolist()
                tiles = [dict(zip(STAMP_PHASES[1:], d[1 + 6 * i:7 + 6 * i]))
                         for i in range(2)]
                print(json.dumps({"stamps_clocks": {
                    "warpgroup": wg, "row": it, "stage_wait": d[0],
                    "tiles": tiles}}), flush=True)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
