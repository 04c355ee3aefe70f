#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the hand-written kernels from the checkout's sources, holds each
against its plain PyTorch version on the card, drives the port's main path
(``ual.compile`` -> ``Executable.validate`` / ``run_batch`` on the ``cuda``
backend) at the sizes the paper's users run — the benchmark kernels on
HyCUBE 4x4 and PACE 8x8, an 8192-word scratchpad, batches of 4096 test
vectors — and times the kernels.  Each phase prints one JSON line:

  device           the card's name and power limit (``nvidia-smi``), versions
  build            the kernels' build time and ptxas resource lines
  kernel_vs_plain  per pair: kernel vs plain version, bit-exact at B = 4096,
                   4 lanes vs the scalar reference simulator; the
                   hand-built edge-case table
  main_path        per pair: validate vs the interp oracle, run_batch(4096)
                   vs the sim backend, throughput, traces, launches
  timing           per pair: kernel and plain ms per launch, the bound
  breakdown        gemm on HyCUBE: run_batch(4096) split on the host clock,
                   device time by kernel and the device's idle share
                   (torch.profiler)
  kernels          the summary line of every kernel

The raw ``nvidia-smi`` line comes next, and the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
without that line; so does a machine without a CUDA device, or a directory
that holds this script and nothing else of the repo.  It imports nothing of
JAX or of the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: (kernel, fabric, fabric kwargs) of the smoke set: the paper's kernels on
#: HyCUBE 4x4 and PACE 8x8 (dct is left out: it takes minutes to map)
PAIRS = ([(k, "hycube", {"rows": 4, "cols": 4})
          for k in ("gemm", "fft", "aes", "nw", "adpcm", "disparity")]
         + [(k, "pace", {}) for k in ("gemm", "fft", "nw")])
BATCH = 4096
#: the engine's largest bucket: the shape every main-path launch has
BUCKET = 128
#: H100 SXM peaks (NVIDIA data sheet; Hopper white paper for the int32
#: lanes): HBM3 bytes/s, and 132 SMs x 64 INT32 lanes x 1.98 GHz
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def bound_ms(linked, M: int, B: int, n_iters: int):
    """Least time the card needs for one launch: the images read and
    written once plus the tables, or cycles * P int32 ops per lane."""
    bytes_moved = 8 * M * B + linked.cm_bytes()
    ops = linked.total_cycles(n_iters) * linked.n_pes * B
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, reps: int, warmup: int = 1):
    """Mean ms per call over ``reps`` calls: on the device (CUDA events)
    and on the host (the time to enqueue them).  Where the host time
    reaches the device time, the card waited on the host."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host_ms


def breakdown(program, exe, rng) -> dict:
    """One warm ``run_batch`` of BATCH vectors on the ``cuda`` backend,
    split on the host clock into flatten / engine / unflatten, and once
    more under ``torch.profiler``: device time by kernel name and the
    device's idle share of that profiled call's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import ual
    mems = [program.random_inputs(rng) for _ in range(BATCH)]
    exe.run_batch(mems)                                     # warm
    engine = ual.default_engine()
    t0 = time.perf_counter()
    flats = program.flatten_batch(mems)
    t1 = time.perf_counter()
    out, _ = engine.run(exe.lowered, flats, program.n_iters)
    t2 = time.perf_counter()
    program.unflatten_batch(out)
    t3 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        p0 = time.perf_counter()
        exe.run_batch(mems)
        torch.cuda.synchronize()
        p1 = time.perf_counter()
    # device-side events only (kernels, copies): a CPU op's device time
    # repeats the time of the kernels it launched
    device = [ev for ev in prof.key_averages()
              if ev.device_type != DeviceType.CPU
              and ev.device_time_total > 0]
    busy_s = sum(ev.device_time_total for ev in device) / 1e6
    wall_p = p1 - p0
    top = sorted(device, key=lambda ev: -ev.device_time_total)[:6]
    return {
        "flatten_s": t1 - t0, "engine_run_s": t2 - t1,
        "unflatten_s": t3 - t2, "run_batch_s": t3 - t0,
        "profiled_wall_s": wall_p,
        "device_busy_s": busy_s if device else None,
        "device_idle_share": 1 - busy_s / wall_p if device else None,
        # name (cut to 60 characters): [calls, total device ms]
        "device_ms_by_kernel": {ev.key[:60]: [ev.count,
                                              ev.device_time_total / 1e3]
                                for ev in top},
    }


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: run from the root of a repo checkout "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run on the "
              "card only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch import ual
    from repro_torch.core.lowering import link_config
    from repro_torch.core.simulator import simulate_reference
    from repro_torch.kernels.cgra_exec import ops
    from repro_torch.kernels.cgra_exec.edge_cases import (edge_case_config,
                                                          edge_case_images)
    from repro_torch.kernels.cgra_exec.ref import cgra_exec_torch

    check("jax" not in sys.modules and "repro" not in sys.modules,
          "the port imported jax or the JAX package")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit("device", name=kind, nvidia_smi=smi, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    # ---- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    lib = ops.build()
    ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text()
             .splitlines() if "registers" in ln or "spill" in ln]
    emit("build", kernel="cgra_exec", seconds=round(time.perf_counter() - t0, 3),
         library=lib.name, ptxas=ptxas)

    # ---- compile every pair through the port's own toolchain -----------------
    rng = np.random.default_rng(0)
    compiled = {}
    for kname, fab, kw in PAIRS:
        program = ual.Program.from_kernel(kname)
        target = ual.Target.from_name(fab, backend="cuda", **kw)
        exe = ual.compile(program, target)
        check(exe.success, f"{kname} failed to map on {fab}")
        compiled[(kname, fab)] = (program, exe)

    def to_dev(flats):
        return torch.from_numpy(flats).to(dev).t().contiguous()

    # ---- kernel vs plain version -------------------------------------------
    max_err = 0
    mismatched = 0
    for (kname, fab), (program, exe) in compiled.items():
        linked = link_config(exe.map_result.config)
        tables = ops.upload_tables(linked, dev)
        flats = program.flatten_batch([program.random_inputs(rng)
                                       for _ in range(BATCH)])
        memT = to_dev(flats)
        n = program.n_iters
        got = ops.cgra_exec(tables, memT, n)
        want = cgra_exec_torch(linked, memT, n)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        bad = int((got != want).sum())
        got_h = got.t().cpu().numpy()
        ref_bad = 0
        for b in range(4):
            ref, _ = simulate_reference(exe.map_result.config, flats[b], n,
                                        check_ports=False)
            ref_bad += int((ref != got_h[b]).sum())
        max_err, mismatched = max(max_err, err), mismatched + bad + ref_bad
        emit("kernel_vs_plain", kernel=kname, fabric=exe.target.fabric.name,
             II=linked.II, P=linked.n_pes, M=int(memT.shape[0]), B=BATCH,
             cycles=linked.total_cycles(n), cm_bytes=linked.cm_bytes(),
             max_abs_err=err, mismatched_words=bad,
             ref_lanes_mismatched_words=ref_bad)
        check(bad == 0 and ref_bad == 0,
              f"{kname}@{fab}: kernel disagrees ({bad} words vs plain, "
              f"{ref_bad} vs simulate_reference)")
    edge = edge_case_config()
    edge_tables = ops.upload_tables(edge, dev)
    memT = to_dev(edge_case_images(rng, BATCH, 8192))
    got = ops.cgra_exec(edge_tables, memT, 6)
    want = cgra_exec_torch(edge, memT, 6)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    bad = int((got != want).sum())
    max_err, mismatched = max(max_err, err), mismatched + bad
    emit("kernel_vs_plain", kernel="edge_cases", P=edge.n_pes, II=edge.II,
         M=8192, B=BATCH, max_abs_err=err, mismatched_words=bad)
    check(bad == 0, f"edge-case table: kernel disagrees in {bad} words")

    # ---- the main path, through the user's entry points ---------------------
    ops.reset_launches()
    main_launches = 0
    for (kname, fab), (program, exe) in compiled.items():
        before = ops.launches()
        rep = exe.validate(backends=("cuda", "sim"), n_vectors=64)
        check(rep.passed, f"{kname}@{fab}: validate failed: "
                          f"{rep.backend_results}, {rep.mismatches} words")
        mems = [program.random_inputs(rng) for _ in range(BATCH)]
        outs = exe.run_batch(mems)
        sps = exe.last_info["throughput_sps"]
        wall = exe.last_info["wall_s"]
        sims = exe.run_batch(mems, backend="sim")
        diff = sum(int((o[a] != s[a]).sum()) for o, s in zip(outs, sims)
                   for a in program.outputs)
        check(diff == 0, f"{kname}@{fab}: run_batch(cuda) != sim in "
                         f"{diff} words")
        stats = ual.default_engine().engine_for(exe.lowered).stats()
        launched = ops.launches() - before
        check(stats["traces"] <= len(stats["buckets"]),
              f"{kname}@{fab}: {stats['traces']} traces > buckets")
        check(launched > 0, f"{kname}@{fab}: the kernel never launched")
        emit("main_path", kernel=kname, fabric=exe.target.fabric.name,
             II=exe.II, validate=rep.passed, n_vectors=64,
             run_batch=BATCH, agrees_with_sim=True, wall_s=wall,
             throughput_sps=sps, traces=stats["traces"],
             buckets=list(stats["buckets"]),
             bucket_calls=stats["bucket_calls"], launches=launched)
    main_launches = ops.launches()
    check(main_launches > 0, "the main path never launched cgra_exec")

    # ---- timing --------------------------------------------------------------
    rows = {}
    for (kname, fab), (program, exe) in compiled.items():
        linked = exe.lowered
        tables = ops.upload_tables(linked, dev)
        n = program.n_iters
        flats = program.flatten_batch([program.random_inputs(rng)
                                       for _ in range(BATCH)])
        row = {"kernel": kname, "fabric": exe.target.fabric.name,
               "M": flats.shape[1], "n_iters": n}
        for B in (BUCKET, BATCH):
            memT = to_dev(flats[:B])
            row[f"ms_B{B}"], row[f"host_ms_B{B}"] = time_ms(
                lambda: ops.cgra_exec(tables, memT, n), reps=20, warmup=3)
            row[f"plain_ms_B{B}"], _ = time_ms(
                lambda: cgra_exec_torch(linked, memT, n), reps=2)
            row[f"bound_ms_B{B}"], row["bound_by"] = bound_ms(
                linked, flats.shape[1], B, n)
        rows[(kname, fab)] = row
        emit("timing", **row)

    # ---- where run_batch's time goes ----------------------------------------
    program, exe = compiled[("gemm", "hycube")]
    emit("breakdown", kernel="gemm", fabric=exe.target.fabric.name,
         B=BATCH, **breakdown(program, exe, rng))

    # ---- summary -------------------------------------------------------------
    lead = rows[("gemm", "hycube")]
    print(json.dumps({"kernels": [{
        "name": "cgra_exec", "route": "cuda",
        "source": "src/repro_torch/kernels/cgra_exec/csrc/cgra_exec.cu",
        "replaces": "src/repro/kernels/cgra_exec/kernel.py:83",
        "launches": main_launches, "max_abs_err": max_err,
        "max_mismatch": mismatched,
        "ms": lead[f"ms_B{BUCKET}"], "plain_ms": lead[f"plain_ms_B{BUCKET}"],
        "bound_ms": lead[f"bound_ms_B{BUCKET}"], "bound_by": lead["bound_by"],
        "library_ms": None,
        "shape": f"gemm on {lead['fabric']}, M={lead['M']}, B={BUCKET}, "
                 f"n_iters={lead['n_iters']}"}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
