#!/usr/bin/env python3
"""Where a chunk's time goes inside the bf16 Mamba-2 SSD kernel.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/ssd_phases.py

It copies ``ssd_kernel_wgmma`` (``src/repro_torch/kernels/mamba2_ssd/csrc/
mamba2_ssd_wgmma.cu``) into a temporary directory, puts a ``clock64()``
stamp before each of the anchors in ``PHASES`` (straight-line code in every
thread, so that it adds no branch to the loop), builds the copy with the
f32 form's source into a library of its own, runs it through the wrapper at
zamba2's prefill shape (B = 1 and 2, S = 2048, 80 heads of 64, state 64,
``chip_smoke.ssd_inputs``) and prints the mean cycles a chunk of each
phase, for thread 0 (warp 0, which also forms the next chunk's scan) and
thread 32, in block 0, and the instrumented kernel's time.  An anchor that
is missing from the source (the kernel was edited) raises.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNELS = ROOT / "src" / "repro_torch" / "kernels"
#: (phase, anchor): the phase ends at the stamp right before the anchor
PHASES = [
    ("mbarrier wait", "        // S's decay, then (a) G = C B^T and (c)"),
    ("issue (a), (c)", "        // (d)'s A: x^T with x's rows i scaled"),
    ("kdec x", "        // (d) S = exp(cum_L) S"),
    ("issue (d)", "        // W in registers once (a) is done"),
    ("wait (a)", "        const float cum_t[2] = {step_scalar(sc, 0, r0),"),
    ("W", "        // (b) Y = exp(cum_t) Y"),
    ("wait (c), issue (b)", "        // S's bf16 hi and lo for the next chunk's (c)"),
    ("S out", "        if (warp == 0) {                          // the next"),
    ("scan (warp 0)", "        // y, rounded once, into y tile s"),
    ("wait (b), y out", "        fence_proxy_async();\n        if (tid == 0) bulk_wait_read();"),
]
LOOP = "    for (int c = 0; c < n_chunks; ++c) {\n"
LOOP_END = ("                load_chunk(&tm_x, &tm_b, &tm_c, base, bar, c + 2, h, b);"
            "\n        }\n")
N = len(PHASES) + 1                    # and the barrier, TMA issue at the end


def stamp(k: int) -> str:
    return (f"        {{ const long long now = clock64(); "
            f"prof_acc[{k}] += now - prof_t; prof_t = now; }}\n")


def instrumented() -> str:
    src = (KERNELS / "mamba2_ssd" / "csrc" / "mamba2_ssd_wgmma.cu").read_text()
    src = src.replace('"../../csrc/hopper.cuh"',
                      f'"{KERNELS / "csrc" / "hopper.cuh"}"')
    for k, (name, anchor) in enumerate(PHASES):
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor of phase {name!r} not found once")
        src = src.replace(anchor, stamp(k) + anchor)
    for anchor in (LOOP, LOOP_END, "    if (tid == 0) bulk_wait();\n}"):
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor {anchor!r} not found once")
    src = src.replace(LOOP, f"    long long prof_t = clock64(), prof_acc[{N}] = {{}};\n"
                      + LOOP)
    src = src.replace(LOOP_END, LOOP_END + stamp(N - 1))
    src = src.replace(
        "    if (tid == 0) bulk_wait();\n}",
        "    if (tid == 0) bulk_wait();\n"
        "    if (blockIdx.x == 0 && (tid == 0 || tid == 32))\n"
        f"        for (int k = 0; k < {N}; ++k)\n"
        f"            g_prof[(tid ? {N} : 0) + k] = prof_acc[k];\n}}")
    return (f"__device__ unsigned long long g_prof[{2 * N}];\n" + src + f"""
extern "C" int prof_read(unsigned long long* out) {{
    return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}}
""")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ssd_phases: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.kernels.build import NVCC_FLAGS, find_nvcc
    from repro_torch.kernels.mamba2_ssd import ops

    with tempfile.TemporaryDirectory() as tmp:
        cu, lib = Path(tmp) / "ssd_phases.cu", Path(tmp) / "libssd_phases.so"
        cu.write_text(instrumented())
        subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(lib),
                        str(KERNELS / "mamba2_ssd" / "csrc" / "mamba2_ssd.cu"),
                        str(cu)], check=True, capture_output=True)
        so = ctypes.CDLL(str(lib))
    fn = so.mamba2_ssd_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    ops._launcher = lambda: fn        # the wrapper launches the copy
    gen = torch.Generator(device="cuda").manual_seed(2)
    names = [name for name, _ in PHASES] + ["barrier, TMA issue"]
    print(chip_smoke.nvidia_smi())
    for B in (1, 2):
        args = chip_smoke.ssd_inputs(gen, B, 2048, 80, 64, 64, torch.bfloat16,
                                     "mixed")
        ops.ssd(*args)
        torch.cuda.synchronize()
        out = (ctypes.c_ulonglong * (2 * N))()
        so.prof_read(out)
        chunks = 2048 // ops.CHUNK
        for tid, off in ((0, 0), (32, N)):
            per = {n: round(out[off + k] / chunks) for k, n in enumerate(names)}
            print(json.dumps({"B": B, "thread": tid, "cycles_per_chunk": per,
                              "total": sum(per.values())}))
        ms, _ = chip_smoke.time_ms(lambda: ops.ssd(*args), reps=10, warmup=2)
        print(json.dumps({"B": B, "instrumented_ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
