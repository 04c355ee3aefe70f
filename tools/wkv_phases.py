#!/usr/bin/env python3
"""Where a chunk's time goes inside the bf16 RWKV-6 WKV kernel.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/wkv_phases.py [--geometry G] [--old PATH]

It copies ``wkv6_kernel_wgmma`` (``src/repro_torch/kernels/rwkv6/csrc/
wkv6_wgmma.cu``) into a temporary directory, puts a ``clock64()`` stamp
before each of the anchors in ``CHAIN`` and ``PREP`` (straight-line code in
every thread, so that it adds no branch to the loops), builds the copy with
the f32 form's source into a library of its own, runs it through the wrapper
(its kept geometry, or ``--geometry``) at rwkv6-1.6b's prefill shape (B = 1
and 2, S = 2048, 32 heads of 64, ``chip_smoke.wkv_inputs``, mixed decays) and
prints the mean SM clocks a chunk of each phase, in block 0: for thread 0
(the chain warpgroup, which runs the products on S) and threads 128 and 224
(warps 0 and 3 of the first of the two warpgroups that form the chunks'
operands, each every second chunk), and the instrumented kernel's time.

The copy also counts, in the first block of each (batch, head), the chunks
whose diagonal sub-blocks it forms per (t, i, d) (``slow``: a sub-chunk's
cum falls more than ``kRange`` in some channel) and the chunks it runs.
With them the tool drives rwkv6-1.6b's prefill at full width as
``chip_smoke.py``'s ``lm_prefill`` does (B = 2 prompts of 2048 tokens,
random weights from ``--seed``, the same prompts) through the copy and
prints, a layer at a time and in all, the share of its chunks that took the
per-(t, i, d) path and the largest fall of a sub-chunk's cum it was given
(log2 units, against ``kRange``).

Last, it builds the form as it is with ``-lineinfo`` and prints, per
instantiation of ``wkv6_kernel_wgmma``, its local-memory loads and stores
(SASS ``LDL``, ``STL``) by the source line they come from (``nvdisasm -g``),
so that what lives in local memory can be named.

With ``--old PATH`` it does the same for the earlier bf16 form on the CUDA
cores at PATH (a ``wkv6.cu`` whose entry point takes bf16 and has no form
argument, from ``git archive`` of a commit before the tensor-core form),
with the phases of ``OLD`` for its thread 0.  An anchor that is missing from a source (the
kernel was edited) raises.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "rwkv6" / "csrc"
HOPPER = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "hopper.cuh"
SLOTS = 16                             # phases a recorded thread, at most

#: a role of a kernel: where its accumulators are declared, its phases
#: (phase, anchor: the phase ends at the stamp right before the anchor), the
#: last phase's name and the anchor that closes its loop ("    }" and what
#: follows: the last stamp goes before it, the clocks are written out right
#: after the loop), its recorded threads (threadIdx.x -> slot), and the
#: share of the chunks it takes (every second one: each of the two prep
#: warpgroups)
CHAIN = dict(
    decl="    float st[NA];",
    phases=[
        ("wait full, v", "        // S's decay by rows d; kdec^T as A"),
        ("decay, kdec fragments", "        // (a) O = r~ S, (b) O += A v"),
        ("products (a) (b) (c)", "        if (tid == 0) bulk_wait_read();"),
        ("barrier, release, v load", "        // S^T's bf16 hi and lo for the next"),
        ("S^T out", "        // o, rounded once, into the o tile"),
    ],
    last=("o out, barrier, store",
          "    }\n    if (tid == 0) bulk_wait();\n"),
    threads={0: 0},
    every=1,
)
PREP = dict(
    decl="    int dst[4];",
    phases=[
        ("wait in", "        // ---- the scan: thread (d, half)"),
        ("scan, vectors", "        // R^ = r exp(cum_{t-1} - c_{p-1}) of fragment f"),
        ("diagonal sub-block per (t, i, d), if taken", "        // R^, for both rounds below"),
        ("R^", "        if (c >= 2) mbar_wait(empty"),
        ("wait empty (the chain's chunk c - 2)", "        // ---- the k side: K~ = k exp"),
        ("k side (K~, kdec, bonus)", "        // ---- the r side, in fragment layout"),
        ("r~, fragments (both rounds)", "#pragma unroll\n            for (int jj = 0; jj < 2; ++jj)\n#pragma unroll\n                for (int e = 0; e < 8; ++e) acc[2 * half + jj][e] = 0.f;"),
        ("A's products and their wait (both rounds)", "        }\n\n        // ---- A, split, into the chunk's A tiles"),
        ("A out", "        fence_proxy_async();\n        named_bar(2 + w, 128);                        // chunk c's"),
    ],
    last=("barrier, arrive",
          "    }\n}\n\ntemplate <int NV>\n__global__"),
    threads={128: 1, 224: 2},
    every=2,
)
#: the earlier bf16 form on the CUDA cores (one role, 256 threads)
OLD = dict(
    decl="    const int n_chunks = (S + kL - 1) / kL;\n    fetch(0);",
    phases=[
        ("stage in shared memory (2 barriers)", "        fetch(c + 1);\n"),
        ("issue the next chunk's loads", "        // cum: thread d scans channel d"),
        ("scan, barrier", "        // A[t][i] = sum_d r_t k_i exp"),
        ("A, barrier", "        // r_t <- r_t exp(cum_{t-1}), k_i <- k_i exp"),
        ("scale r and k, barrier", "        // o[t][c] = (r exp(cum_{t-1}) S)[t][c]"),
        ("o, barrier", "        // S[d][c] <- exp(cum_L[d]) S[d][c]"),
    ],
    last=("state update", "    }\n}\n\ntemplate <typename T>\nint launch("),
    threads={0: 0},
    every=1,
)


def stamp(k: int) -> str:
    return (f"        {{ const long long now = clock64(); "
            f"prof_acc[{k}] += now - prof_t; prof_t = now; }}\n")


def once(src: str, anchor: str, what: str) -> None:
    if src.count(anchor) != 1:
        raise RuntimeError(f"anchor of {what!r} not found once")


def instrument(src: str, role: dict) -> str:
    """``src`` with one role's stamps, accumulators and write-out."""
    names = [n for n, _ in role["phases"]] + [role["last"][0]]
    for name, anchor in role["phases"]:
        once(src, anchor, name)
        src = src.replace(anchor, stamp(names.index(name)) + anchor)
    for anchor in (role["decl"], role["last"][1]):
        once(src, anchor, anchor)
    src = src.replace(role["decl"], "    long long prof_t = clock64(), "
                      f"prof_acc[{SLOTS}] = {{}};\n" + role["decl"])
    write = "".join(
        f"    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == {t})\n"
        f"        for (int k = 0; k < {SLOTS}; ++k)\n"
        f"            g_prof[{slot * SLOTS} + k] = prof_acc[k];\n"
        for t, slot in role["threads"].items())
    close = "    }\n"
    assert role["last"][1].startswith(close)
    return src.replace(role["last"][1], stamp(len(names) - 1) + close + write
                       + role["last"][1][len(close):])


def build(sources, name: str, tmp: Path):
    from repro_torch.kernels.build import NVCC_FLAGS, find_nvcc
    lib = tmp / f"lib{name}.so"
    subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(lib),
                    *map(str, sources)], check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


PROF_DECL = f"__device__ unsigned long long g_prof[{3 * SLOTS}];\n"
PROF_READ = """
extern "C" int prof_read(unsigned long long* out) {
    return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}
"""
#: the count of chunks that take the per-(t, i, d) diagonal, and of chunks,
#: in the first block of each (batch, head), by each chunk's prep warpgroup
#: once it has decided; read and zeroed by slow_read
SLOW_AFTER = "                                || cv[15] - cv[31] > kRange);\n"
SLOW_COUNT = """            if (ptid == 0 && blockIdx.y == 0) {
                atomicAdd(&g_slow[0], slow ? 1ull : 0ull);
                atomicAdd(&g_slow[1], 1ull);
            }
"""
SLOW_DECL = "__device__ unsigned long long g_slow[2];\n"
SLOW_READ = """
extern "C" int slow_read(unsigned long long* out) {
    cudaError_t e = cudaMemcpyFromSymbol(out, g_slow, sizeof(g_slow));
    const unsigned long long zero[2] = {0, 0};
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_slow, zero, sizeof(zero));
    return (int)e;
}
"""


def count_slow(src: str) -> str:
    """``src`` with the slow-chunk counter after the prep's decision."""
    once(src, SLOW_AFTER, "the slow decision")
    return SLOW_DECL + src.replace(SLOW_AFTER, SLOW_AFTER + SLOW_COUNT)


def max_fall(log_w, chunk: int, sub: int = 16) -> float:
    """The largest fall of the cum of log_w over one sub-chunk of a chunk,
    in log2 units, as the kernel measures it against ``kRange``."""
    import torch
    import torch.nn.functional as F
    B, S, H, K = log_w.shape
    n = -(-S // chunk)
    lw = F.pad(log_w.float(), (0, 0, 0, 0, 0, n * chunk - S))
    cum = torch.cumsum(lw.reshape(B, n, chunk, H, K) * 1.4426950408889634,
                       dim=2)
    ends = cum[:, :, sub - 1::sub]
    fall = F.pad(ends, (0, 0, 0, 0, 1, 0))[:, :, :-1] - ends
    return float(fall.max())


def prefill_slow_share(so, dev, seed: int) -> None:
    """rwkv6-1.6b's prefill, as ``chip_smoke.lm_phases`` drives it, through
    the instrumented copy: per layer and in all, the chunks that took the
    per-(t, i, d) diagonal and the largest fall of a sub-chunk's cum."""
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv6 import ops
    from repro_torch.models import rwkv6 as model
    from repro_torch.models.common import init_params
    from repro_torch.serve.serve_step import prefill_fn

    cfg = get_config("rwkv6-1.6b")
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (chip_smoke.PREFILL_B, chip_smoke.PREFILL_S))
        .astype(np.int32)).to(dev)
    params = init_params(torch.Generator(device=dev).manual_seed(seed), cfg,
                         dev)
    chunk = ops.FORM_CHUNK[torch.bfloat16]
    layers, inner = [], model.wkv6

    def counted(r, k, v, log_w, u):
        out = inner(r, k, v, log_w, u)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 2)()
        if so.slow_read(buf):
            raise RuntimeError("slow_read failed")
        layers.append({"slow_chunks": buf[0], "chunks": buf[1],
                       "max_fall_log2": max_fall(log_w, chunk)})
        return out

    so.slow_read((ctypes.c_ulonglong * 2)())          # zero the counters
    model.wkv6 = counted
    try:
        prefill_fn(cfg)(params, {"tokens": tokens})
        torch.cuda.synchronize()
    finally:
        model.wkv6 = inner
    slow = sum(x["slow_chunks"] for x in layers)
    total = sum(x["chunks"] for x in layers)
    print(json.dumps({"prefill": cfg.name, "B": chip_smoke.PREFILL_B,
                      "S": chip_smoke.PREFILL_S, "seed": seed,
                      "launches": len(layers), "slow_chunks": slow,
                      "chunks": total, "slow_share": slow / max(total, 1),
                      "max_fall_log2": max(x["max_fall_log2"]
                                           for x in layers),
                      "k_range_log2": 100.0, "per_layer": layers}),
          flush=True)


def report(so, form: str, roles, B: int, chunks: int) -> None:
    out = (ctypes.c_ulonglong * (3 * SLOTS))()
    so.prof_read(out)
    for role in roles:
        names = [n for n, _ in role["phases"]] + [role["last"][0]]
        for tid, slot in role["threads"].items():
            per = {n: round(out[slot * SLOTS + k] * role["every"] / chunks)
                   for k, n in enumerate(names)}
            print(json.dumps({"form": form, "B": B, "thread": tid,
                              "cycles_per_chunk": per,
                              "total": sum(per.values())}), flush=True)


def local_memory(tmp: Path) -> None:
    """One line per instantiation of the bf16 form: its LDL and STL by the
    line of its source (file:line and the line's text) they come from."""
    import re

    from repro_torch.kernels.build import NVCC_FLAGS, find_nvcc
    nvcc = Path(find_nvcc())
    lib = tmp / "liblocal.so"
    subprocess.run([str(nvcc), *NVCC_FLAGS, "-lineinfo", "-o", str(lib),
                    str(CSRC / "wkv6.cu"), str(CSRC / "wkv6_wgmma.cu")],
                   check=True, capture_output=True)
    tools = [nvcc.with_name(t) for t in ("cuobjdump", "nvdisasm")]
    if not all(t.exists() for t in tools):
        print(json.dumps({"local_memory": "not available"}), flush=True)
        return
    subprocess.run([str(tools[0]), "-xelf", "all", str(lib)], cwd=tmp,
                   check=True, capture_output=True)
    lines = {}
    for cubin in sorted(tmp.glob("*.cubin")):
        text = subprocess.run([str(tools[1]), "-g", "-c", str(cubin)],
                              capture_output=True, text=True,
                              check=True).stdout
        func, where = None, "unknown"
        for ln in text.splitlines():
            head = re.search(r"\.text\.(_Z\w+)", ln)
            if head and "wkv6_kernel_wgmma" in head.group(1):
                func = head.group(1)
                lines.setdefault(func, {})
                continue
            loc = re.search(r'//##\s*File "([^"]+)", line (\d+)', ln)
            if loc:
                where = f"{Path(loc.group(1)).name}:{loc.group(2)}"
                continue
            op = re.search(r"\b(LDL|STL)\b", ln)
            if op and func is not None:
                row = lines[func].setdefault(where, {"LDL": 0, "STL": 0})
                row[op.group(1)] += 1
    sources = {p.name: p.read_text().splitlines()
               for p in (CSRC / "wkv6_wgmma.cu", HOPPER)}
    for func, rows in lines.items():
        out = []
        for where, n in sorted(rows.items()):
            name, _, num = where.partition(":")
            text = (sources[name][int(num) - 1].strip()
                    if name in sources and num.isdigit() else "")
            out.append({"at": where, **n, "source": text})
        print(json.dumps({"local_memory": func,
                          "LDL": sum(r["LDL"] for r in out),
                          "STL": sum(r["STL"] for r in out),
                          "by_line": out}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--geometry", default=None,
                    help="a geometry of the bf16 form (ops.GEOMETRIES); "
                         "the kept one by default")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the prefill's prompts and random weights, "
                         "as chip_smoke.py's --seed")
    ap.add_argument("--old", type=Path, default=None,
                    help="an earlier wkv6.cu (bf16 on the CUDA cores) to time "
                         "by phase as well")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("wkv_phases: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.kernels.rwkv6 import ops

    print(chip_smoke.nvidia_smi(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(3)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        src = (CSRC / "wkv6_wgmma.cu").read_text().replace(
            '"../../csrc/hopper.cuh"', f'"{HOPPER}"')
        src = count_slow(instrument(instrument(src, CHAIN), PREP))
        (tmp / "wkv6_wgmma.cu").write_text(PROF_DECL + src + PROF_READ
                                           + SLOW_READ)
        so = build([CSRC / "wkv6.cu", tmp / "wkv6_wgmma.cu"], "wkv_phases",
                   tmp)
        old = None
        if args.old is not None:
            osrc = instrument(args.old.read_text(), OLD)
            (tmp / "wkv6_old.cu").write_text(PROF_DECL + osrc + PROF_READ)
            old = build([tmp / "wkv6_old.cu"], "wkv_phases_old", tmp)
        local_memory(tmp)
    fn = so.wkv6_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                      ctypes.c_void_p])
    ops._launcher = lambda: fn        # the wrapper launches the copy
    chunks = 2048 // ops.FORM_CHUNK[torch.bfloat16]
    geometry = args.geometry
    label = geometry or ops.kept_geometry()
    for B in (1, 2):
        wargs = chip_smoke.wkv_inputs(gen, B, 2048, 32, 64, torch.bfloat16,
                                      "mixed")
        ops.wkv6(*wargs, geometry=geometry)
        torch.cuda.synchronize()
        report(so, f"wgmma ({label})", (CHAIN, PREP), B, chunks)
        ms, _ = chip_smoke.time_ms(
            lambda: ops.wkv6(*wargs, geometry=geometry), reps=10, warmup=2)
        print(json.dumps({"form": "wgmma", "B": B, "instrumented_ms": ms}),
              flush=True)
        if old is None:
            continue
        ofn = old.wkv6_launch
        ofn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                        + [ctypes.POINTER(ctypes.c_longlong),
                           ctypes.c_void_p])
        r, k, v, lw, u = wargs
        uf = u.float().contiguous()
        o = torch.empty_like(r)
        st = (ctypes.c_longlong * 12)(*r.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3], *lw.stride()[:3])

        def run_old():
            stream = torch.cuda.current_stream().cuda_stream
            err = ofn(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                      lw.data_ptr(), uf.data_ptr(), o.data_ptr(), 1, B, 2048,
                      32, 64, st, stream)
            if err:
                raise RuntimeError(f"old form: CUDA error {err}")
        run_old()
        torch.cuda.synchronize()
        report(old, "cuda cores (earlier)", (OLD,), B, 2048 // 32)
        ms, _ = chip_smoke.time_ms(run_old, reps=10, warmup=2)
        print(json.dumps({"form": "cuda cores (earlier)", "B": B,
                          "instrumented_ms": ms}), flush=True)
    prefill_slow_share(so, torch.device("cuda", 0), args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
