#!/usr/bin/env python3
"""Where a CGRA cycle's time goes inside the ``cgra_exec`` kernel.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/cgra_phases.py

It copies ``cgra_exec_kernel`` (``src/repro_torch/kernels/cgra_exec/csrc/
cgra_exec.cu``) into a temporary directory, puts a ``clock64()`` stamp
before each of the anchors in ``PHASES`` (straight-line code in every
thread, so that it adds no branch to the cycle loop), builds the copy with
the kernel's own flags into a library of its own, runs it through the
wrapper on gemm mapped on HyCUBE 4x4 (M = 8192 words, ``n_iters`` = 16) at
B = 1, 128 and 4096 with the default launch plan, and prints the mean SM
clocks a CGRA cycle of each phase for thread 0 of warp 0 (the memory pass)
and of warp 1 (ALU records and staged register writes) in block 0, and the
instrumented kernel's time.  An anchor that is missing from the source (the
kernel was edited) raises.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "cgra_exec" / "csrc" / \
    "cgra_exec.cu"
#: (phase, anchor): the phase ends at the stamp right before the anchor
PHASES = [
    ("loop, slot", "        // ---- phase 1: memory pass"),
    ("memory pass (warp 0)", "        if (W == 1 || y > 0) {"),
    ("ALU, staging (warps 1..)", "        // the next slot's header"),
    ("next header", "        if (W > 1) __syncthreads();\n\n        // ---- phase 2"),
    ("barrier 1", "        // ---- phase 2: register writes"),
    ("register writes, latches", "        if (W > 1) __syncthreads();\n    }\n}\n"),
    ("barrier 2", "    }\n}\n\ntemplate <bool kS, bool kT>"),
]
LOOP = "    for (int t = 0; t < a.total; ++t) {\n"
LOOP_END = "    }\n}\n\ntemplate <bool kS, bool kT>"
N = len(PHASES)


def stamp(k: int) -> str:
    return (f"        {{ const long long now = clock64(); "
            f"prof_acc[{k}] += now - prof_t; prof_t = now; }}\n")


def instrumented() -> str:
    src = SOURCE.read_text()
    for k, (name, anchor) in enumerate(PHASES):
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor of phase {name!r} not found once")
        src = src.replace(anchor, stamp(k) + anchor)
    for anchor in (LOOP, LOOP_END):
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor {anchor!r} not found once")
    src = src.replace(LOOP, f"    long long prof_t = clock64(), "
                            f"prof_acc[{N}] = {{}};\n" + LOOP)
    src = src.replace(LOOP_END, "    }\n"
                      "    if (blockIdx.x == 0 && x == 0 && y < 2)\n"
                      f"        for (int k = 0; k < {N}; ++k)\n"
                      f"            g_prof[y * {N} + k] = prof_acc[k];\n"
                      + LOOP_END[len("    }\n"):])
    return (f"__device__ unsigned long long g_prof[{2 * N}];\n" + src + f"""
extern "C" int prof_read(unsigned long long* out) {{
    return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}}
""")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("cgra_phases: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np

    import chip_smoke
    from repro_torch import ual
    from repro_torch.kernels import build
    from repro_torch.kernels.cgra_exec import ops

    with tempfile.TemporaryDirectory() as tmp:
        cu, lib = Path(tmp) / "cgra_phases.cu", Path(tmp) / "libcgra_phases.so"
        cu.write_text(instrumented())
        subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS,
                        *build._define_flags(ops.defines()), "-o", str(lib),
                        str(cu)], check=True, capture_output=True)
        so = ctypes.CDLL(str(lib))
    fn = so.cgra_exec_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 15
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    ops._launcher = lambda: fn        # the wrapper launches the copy
    program = ual.Program.from_kernel("gemm")
    exe = ual.compile(program, ual.Target.from_name("hycube", rows=4,
                                                    cols=4))
    dev = torch.device("cuda", 0)
    tables = ops.upload_tables(exe.lowered, dev)
    rng = np.random.default_rng(0)
    flats = program.flatten_batch([program.random_inputs(rng)
                                   for _ in range(4096)])
    cycles = exe.lowered.total_cycles(program.n_iters)
    names = [name for name, _ in PHASES]
    print(chip_smoke.nvidia_smi())
    for B in (1, 128, 4096):
        memT = torch.from_numpy(np.ascontiguousarray(flats[:B].T)).to(dev)
        ops.cgra_exec(tables, memT, program.n_iters)
        torch.cuda.synchronize()
        out = (ctypes.c_ulonglong * (2 * N))()
        if so.prof_read(out) != 0:
            raise RuntimeError("reading the stamps failed")
        for warp in (0, 1):
            per = {n: round(out[warp * N + k] / cycles)
                   for k, n in enumerate(names)}
            print(json.dumps({"B": B, "warp": warp, "cycles": cycles,
                              "sm_clocks_per_cycle": per,
                              "total": sum(per.values())}))
        ms, _ = chip_smoke.time_ms(
            lambda: ops.cgra_exec(tables, memT, program.n_iters), reps=20,
            warmup=3)
        print(json.dumps({"B": B, "plan": ops.plan_launch(tables.layout).form,
                          "instrumented_ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
