#!/usr/bin/env python3
"""SM clocks a block by phase of the WKV backward's bf16 product kernel, and
the form's local memory by source line.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/wkv_bwd_phases.py

It copies ``wkv6_bwd_wgmma.cu`` with ``clock64()`` stamps written by thread
0 of each warpgroup of ``wkv6_bwd_chunk_kernel_wgmma`` at the phases'
boundaries (``ANCHORS``: lines of the source, so an edit there may need
them updated), builds the copy under a name of its own, runs it through
``ops.wkv6_bwd`` at rwkv6-1.6b's bf16 training shape (B 4 x 2048, 32 heads
of 64) on the model's slow decays and with every log_w at the clamp of -8,
and prints one JSON line a run: the call's ms (CUDA events over 5 calls;
the stamps cost a little) and, per warpgroup, the mean clocks a block of
each phase (``PHASES``: after the shared preamble, warpgroup 0's dk state
term, A^T and dv; warpgroup 1's dr and dk, each its products and its
epilogue).  Then it builds the form as it is with ``-lineinfo`` and prints
each kernel's LDL and STL by source line (``nvdisasm -g``), none where it
keeps everything in registers.  The last line is the card's name and power
limit (``nvidia-smi``).
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "rwkv6" / "csrc"
HOPPER = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "hopper.cuh"

#: (text in wkv6_bwd_wgmma.cu, stamp before or after it, slot); slots 5-8
#: mark different points in the two warpgroups' branches
ANCHORS = [
    ("    const bool slow = scan_cum<kChunkThreads>(W, v_xs);", "before", 1),
    ("    // ---- tiles: S, G as hi, mid, lo", "before", 2),
    ("    // ---- the slow path (warpgroup 1)", "before", 3),
    ("    if (wg == 0) {\n", "before", 4),
    ("        // ---- A^T [i][t], by row sub-chunk p of t", "before", 5),
    ("        // ---- dv = A^T do + kdec G", "before", 6),
    ("        store_tile(base + kOffDV, &tm_dv, 2);\n", "after", 7),
    ("            esum<false>(z, da, tK3, v_gv, warp, cq);", "before", 5),
    ("            // times Rs; the slow diagonal;", "before", 6),
    ("        // ---- dk = Ks sum_p Gv[p][w]", "before", 7),
    ("            named_bar(1, kChunkThreads);          // warpgroup 0's FP",
     "before", 8),
    ("    __syncthreads();\n\n    // ---- dlog_w_s", "before", 9),
]
END = "    if ((tid & 127) == 0) bulk_wait();       // the staged tiles are out\n}"
#: per warpgroup, (slot, the phase from it to the next listed slot)
PHASES = {
    0: [(0, "loads of log_w"), (1, "scan, vectors, sums"), (2, "tiles"),
        (3, "slow path"), (4, "dk's state term"), (5, "A^T"), (6, "dv"),
        (7, "wait for warpgroup 1"), (9, "final scan"), (10, None)],
    1: [(0, "loads of log_w"), (1, "scan, vectors, sums"), (2, "tiles"),
        (3, "slow path"), (4, "z and dA"), (5, "dr's sums over E"),
        (6, "dr's epilogue"), (7, "dk's sums over E"), (8, "dk's epilogue"),
        (9, "final scan"), (10, None)],
}


def stamp(slot: int) -> str:
    return ("    if ((threadIdx.x & 127) == 0) g_stamps[((blockIdx.x + gridDim.x"
            " * (blockIdx.y + gridDim.y * blockIdx.z)) * 2 + (threadIdx.x >> 7))"
            f" * 16 + {slot}] = clock64();\n")


def stamped_source() -> str:
    """wkv6_bwd_wgmma.cu with the stamps and an entry point that copies
    them out."""
    w = (CSRC / "wkv6_bwd_wgmma.cu").read_text().replace(
        '#include "../../csrc/hopper.cuh"', '#include "hopper.cuh"')
    w = w.replace("namespace {\n\nusing namespace hopper;",
                  "__device__ long long g_stamps[1 << 18];\n"
                  "namespace {\n\nusing namespace hopper;", 1)
    head = w.index("    extern __shared__ uint8_t smem_raw[];",
                   w.index("wkv6_bwd_chunk_kernel_wgmma("))
    w = w[:head] + w[head:].replace(
        "    extern __shared__ uint8_t smem_raw[];\n",
        "    extern __shared__ uint8_t smem_raw[];\n" + stamp(0), 1)
    for text, where, slot in ANCHORS:
        if text not in w:
            raise SystemExit(f"anchor not found in wkv6_bwd_wgmma.cu: {text!r}")
        w = w.replace(text, text + stamp(slot) if where == "after"
                      else stamp(slot) + text, 1)
    if END not in w:
        raise SystemExit("the chunk kernel's end not found")
    w = w.replace(END, END[:-1] + stamp(10) + "}", 1)
    return w + ("\nextern \"C\" int wkv_stamps(long long* host, int n) {\n"
                "    return (int)cudaMemcpyFromSymbol(host, g_stamps,\n"
                "                                     n * sizeof(long long));\n}\n")


def phases(tmp: Path) -> None:
    """One line per run (slow decays, the clamp) of the stamped copy."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.rwkv6 import ops
    for name, text in (("wkv6_bwd.cu", (CSRC / "wkv6_bwd.cu").read_text()),
                       ("wkv6_bwd_wgmma.cu", stamped_source()),
                       ("hopper.cuh", HOPPER.read_text())):
        (tmp / name).write_text(text)
    lib = ctypes.CDLL(str(build.build(
        "rwkv6_bwd_phases", [tmp / "wkv6_bwd.cu", tmp / "wkv6_bwd_wgmma.cu",
                             tmp / "hopper.cuh"], {})))
    real = build.load
    build.load = lambda n, s, d: lib if n == "rwkv6_bwd" else real(n, s, d)
    ops._bwd_launcher.cache_clear()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(6)
    B, S, H, K = 4, 2048, 32, 64
    r, k, v, log_w, u = cs.wkv_inputs(gen, B, S, H, K, torch.bfloat16, "slow")
    do = torch.randn(r.shape, generator=gen, device=dev).to(torch.bfloat16)
    blocks = B * H * (S // 64)
    for decay in ("slow", "clamp"):
        lw = log_w if decay == "slow" else torch.full_like(log_w, -8.0)
        ms = cs.time_ms(lambda: ops.wkv6_bwd(r, k, v, lw, u, do), reps=5,
                        warmup=2)[0]
        host = (ctypes.c_longlong * (blocks * 32))()
        lib.wkv_stamps(host, blocks * 32)
        t = torch.tensor(list(host), dtype=torch.float64).reshape(
            blocks, 2, 16)
        per = {f"wg{wg}": {name: round(float((t[:, wg, b] - t[:, wg, a])
                                             .mean()))
                           for (a, name), (b, _) in zip(PHASES[wg],
                                                        PHASES[wg][1:])}
               for wg in (0, 1)}
        print(json.dumps({"decay": decay, "ms": ms, "blocks": blocks,
                          "block_clocks": float((t[:, 0, 10] - t[:, 0, 0])
                                                .mean()),
                          "clocks_by_phase": per}), flush=True)
    build.load = real
    ops._bwd_launcher.cache_clear()


def local_memory(tmp: Path) -> None:
    """Each kernel's LDL and STL by the line of its source."""
    from repro_torch.kernels.build import NVCC_FLAGS, find_nvcc
    nvcc = Path(find_nvcc())
    lib = tmp / "liblocal.so"
    subprocess.run([str(nvcc), *NVCC_FLAGS, "-lineinfo", "-o", str(lib),
                    str(CSRC / "wkv6_bwd.cu"), str(CSRC / "wkv6_bwd_wgmma.cu")],
                   check=True, capture_output=True)
    tools = [nvcc.with_name(t) for t in ("cuobjdump", "nvdisasm")]
    if not all(t.exists() for t in tools):
        print(json.dumps({"local_memory": "not available"}), flush=True)
        return
    subprocess.run([str(tools[0]), "-xelf", "all", str(lib)], cwd=tmp,
                   check=True, capture_output=True)
    src = (CSRC / "wkv6_bwd_wgmma.cu").read_text().splitlines()
    for cubin in sorted(tmp.glob("*.cubin")):
        text = subprocess.run([str(tools[1]), "-g", "-c", str(cubin)],
                              capture_output=True, text=True).stdout
        func, where, rows = None, "unknown", {}
        for ln in text.splitlines():
            head = re.search(r"\.text\.(_Z\w+)", ln)
            if head:
                func = head.group(1)
                continue
            loc = re.search(r'//##\s*File "([^"]+)", line (\d+)', ln)
            if loc:
                where = f"{Path(loc.group(1)).name}:{loc.group(2)}"
                continue
            op = re.search(r"\b(LDL|STL)\b", ln)
            if op and func:
                row = rows.setdefault(func, {}).setdefault(
                    where, {"LDL": 0, "STL": 0})
                row[op.group(1)] += 1
        for func, by_line in rows.items():
            out = []
            for where, n in sorted(by_line.items()):
                name, _, num = where.partition(":")
                text_ = (src[int(num) - 1].strip()
                         if name == "wkv6_bwd_wgmma.cu" and num.isdigit()
                         else "")
                out.append({"at": where, **n, "source": text_})
            print(json.dumps({"local_memory": func, "by_line": out}),
                  flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("wkv_bwd_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    with tempfile.TemporaryDirectory(dir=ROOT / "artifacts") as tmp:
        phases(Path(tmp))
        local_memory(Path(tmp))
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
