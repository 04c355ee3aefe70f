#!/usr/bin/env python3
"""Time the SSD and WKV backward kernels at zamba2-2.7b's and rwkv6-1.6b's
training shapes, beside their forward kernels and their bounds.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/scan_bwd_probe.py [--reps N] [--old PATH]

It builds the four libraries (the SSD and WKV forwards and backwards),
makes ``chip_smoke.py``'s inputs at the training shapes in bf16 (the SSD:
B 4 x 2048, 80 heads of 64, state 64, Mamba-2's slow decays; the WKV:
B 4 x 2048, 32 heads of 64, the model's slow decays, and again with every
log_w at the model's clamp of -8, where every chunk of the WKV backward's
bf16 form takes its per-(t, i, d) diagonal) and prints one JSON line a
kernel: its ms a call (CUDA events over ``--reps`` calls after one
warm-up), the bound (``chip_smoke.ssd_bwd_bound`` / ``wkv_bwd_bound`` for
the backwards, ``ssd_bound`` / ``wkv_bound`` for the forwards, at this
shape), and the device ms of each of its kernels under ``torch.profiler``
(the backward's kernels: for the WKV's bf16 form the walks, the product
kernel and du's sum).  With ``--old PATH`` (the root of an earlier source
tree, e.g. ``git archive`` of an earlier commit unpacked under ``trees/``)
it also builds that tree's SSD and WKV backward libraries under names of
their own and times each bf16 call in turns with this tree's (this, old,
old, this), each held to the plain version (``ssd_bwd_torch``,
``wkv6_bwd_torch``) under ``chip_smoke.py``'s per-element bound, on one
card in one process: one ``mamba2_ssd_bwd_vs_old`` and one
``wkv6_bwd_vs_old`` line with both forms' times and their kernels' ms.
The last line is the card's name and power limit (``nvidia-smi``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def event_ms(fn, reps: int) -> float:
    """Mean device ms a call of ``fn`` over ``reps`` calls after one."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn) -> dict:
    """Device ms of each kernel one call of ``fn`` launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import torch
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {ev.key[:60]: ev.device_time_total / 1e3
            for ev in prof.key_averages()
            if ev.device_type != DeviceType.CPU and ev.device_time_total > 0}


def old_ssd_bwd(tree: Path):
    """A function of (x, dt, A_log, B, C, D, dy) that runs ``tree``'s SSD
    backward library (built under a name of its own) as that tree's
    wrapper called it: the entry point of a tree with the tensor-core form
    takes the dtype in its scratch size and dy's strides, an earlier one
    neither."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.mamba2_ssd import ops
    csrc = tree / "src" / "repro_torch" / "kernels" / "mamba2_ssd" / "csrc"
    sources = [csrc / "mamba2_ssd_bwd.cu"]
    wgmma = csrc / "mamba2_ssd_bwd_wgmma.cu"
    if wgmma.exists():
        sources += [wgmma, csrc.parents[1] / "csrc" / "hopper.cuh"]
    lib = build.load("mamba2_ssd_bwd_old", sources, {})
    fn = lib.mamba2_ssd_bwd_launch
    n_strides = 13 if wgmma.exists() else 10
    fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    size = lib.mamba2_ssd_bwd_scratch_floats
    size.argtypes = [ctypes.c_int] * (6 if wgmma.exists() else 5)
    size.restype = ctypes.c_longlong

    def run(x, dt, A_log, B, C, D, dy):
        Bsz, S, H, P = x.shape
        N = B.shape[-1]
        if wgmma.exists():
            x, B, C, dy = (ops._tma_readable(t) for t in (x, B, C, dy))
        dx = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
        ddt = torch.empty((Bsz, S, H), dtype=torch.float32, device=x.device)
        dB = torch.empty((Bsz, S, N), dtype=x.dtype, device=x.device)
        dC = torch.empty_like(dB)
        dA, dD = (torch.empty((H,), dtype=torch.float32, device=x.device)
                  for _ in range(2))
        dims = (Bsz, S, H, P, N)
        n = size(1, *dims) if wgmma.exists() else size(*dims)
        scratch = torch.empty((n,), dtype=torch.float32, device=x.device)
        strides = (ctypes.c_longlong * n_strides)(*(
            *x.stride()[:3], *dt.stride(), *B.stride()[:2], *C.stride()[:2],
            *dy.stride()[:3])[:n_strides])
        err = fn(x.data_ptr(), dt.data_ptr(), A_log.data_ptr(), B.data_ptr(),
                 C.data_ptr(), D.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                 ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
                 dD.data_ptr(), scratch.data_ptr(), 1, *dims, strides,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"old SSD backward: error {err}")
        return dx, ddt, dA, dB, dC, dD
    return run


def old_wkv_bwd(tree: Path):
    """A function of (r, k, v, log_w, u, do) that runs ``tree``'s WKV
    backward library (built under a name of its own) as that tree's wrapper
    called it: the entry point of a tree with the tensor-core form takes
    the dtype in its scratch size and do's strides, an earlier one
    neither."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.rwkv6 import ops
    csrc = tree / "src" / "repro_torch" / "kernels" / "rwkv6" / "csrc"
    sources = [csrc / "wkv6_bwd.cu"]
    wgmma = csrc / "wkv6_bwd_wgmma.cu"
    if wgmma.exists():
        sources += [wgmma, csrc.parents[1] / "csrc" / "hopper.cuh"]
    lib = build.load("rwkv6_bwd_old", sources, {})
    fn = lib.wkv6_bwd_launch
    n_strides = 15 if wgmma.exists() else 12
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    size = lib.wkv6_bwd_scratch_floats
    size.argtypes = [ctypes.c_int] * (5 if wgmma.exists() else 4)
    size.restype = ctypes.c_longlong

    def run(r, k, v, log_w, u, do):
        B, S, H, K = r.shape
        do = do.contiguous()
        lw, uf = log_w.float(), u.float().contiguous()
        if wgmma.exists():
            r, k, v, lw, do = map(ops._tma_readable, (r, k, v, lw, do))
        dr, dk, dv = (torch.empty((B, S, H, K), dtype=r.dtype,
                                  device=r.device) for _ in range(3))
        dlw = torch.empty((B, S, H, K), dtype=torch.float32, device=r.device)
        du = torch.empty((H, K), dtype=torch.float32, device=r.device)
        n = size(1, B, S, H, K) if wgmma.exists() else size(B, S, H, K)
        scratch = torch.empty((n,), dtype=torch.float32, device=r.device)
        strides = (ctypes.c_longlong * n_strides)(*(
            *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *lw.stride()[:3], *do.stride()[:3])[:n_strides])
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
                 uf.data_ptr(), do.data_ptr(), dr.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), dlw.data_ptr(), du.data_ptr(),
                 scratch.data_ptr(), 1, B, S, H, K, strides,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"old WKV backward: error {err}")
        return dr, dk, dv, dlw, du
    return run


def versus_old(this, old, plain, reps: int) -> dict:
    """Two forms of one backward on the same inputs: each against the
    plain version, then timed in turns (this, old, old, this)."""
    import torch
    import chip_smoke as cs
    forms = {"this": this, "old": old}
    want = plain()
    out = {}
    for form, run in forms.items():
        got = run()
        torch.cuda.synchronize()
        out[form] = {"excess": max(cs.excess(g, w, "bfloat16")
                                   for g, w in zip(got, want)),
                     "ms_all": []}
        del got
    del want
    for form in ("this", "old", "old", "this"):
        out[form]["ms_all"].append(
            cs.time_ms(forms[form], reps=reps, warmup=2)[0])
    for form in forms:
        out[form]["ms"] = min(out[form]["ms_all"])
        out[form]["kernels_ms"] = kernel_ms(forms[form])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--old", type=Path, default=None,
                    help="root of an earlier source tree to time beside")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("scan_bwd_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
    from repro_torch.kernels.rwkv6 import ops as wkv_ops

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    B, S, H, P, N = 4, 2048, 80, 64, 64
    x, dt, A_log, Bm, Cm, D = cs.ssd_inputs(gen, B, S, H, P, N,
                                            torch.bfloat16, "slow")
    dy = torch.randn(x.shape, generator=gen, device=dev).to(torch.bfloat16)
    ssd_args = (x, dt, A_log, Bm, Cm, D)
    B2, S2, H2, K = 4, 2048, 32, 64
    wkv_args = cs.wkv_inputs(gen, B2, S2, H2, K, torch.bfloat16, "slow")
    do = torch.randn(wkv_args[0].shape, generator=gen,
                     device=dev).to(torch.bfloat16)
    clamp_args = (*wkv_args[:3], torch.full_like(wkv_args[3], -8.0),
                  wkv_args[4])
    runs = {
        "mamba2_ssd_bwd": (lambda: ssd_ops.ssd_bwd(*ssd_args, dy),
                           cs.ssd_bwd_bound(B, S, H, P, N, "bfloat16")),
        "mamba2_ssd": (lambda: ssd_ops.ssd(*ssd_args),
                       cs.ssd_bound(B, S, H, P, N, "bfloat16")),
        "wkv6_bwd": (lambda: wkv_ops.wkv6_bwd(*wkv_args, do),
                     cs.wkv_bwd_bound(B2, S2, H2, K, "bfloat16")),
        "wkv6_bwd_clamp": (lambda: wkv_ops.wkv6_bwd(*clamp_args, do),
                           cs.wkv_bwd_bound(B2, S2, H2, K, "bfloat16")),
        "rwkv6": (lambda: wkv_ops.wkv6(*wkv_args),
                  cs.wkv_bound(B2, S2, H2, K, "bfloat16")),
    }
    for name, (fn, bound) in runs.items():
        print(json.dumps({"probe": name, "dtype": "bfloat16",
                          "ms": event_ms(fn, args.reps),
                          "bound_ms": bound[0], "bound_by": bound[1],
                          "kernels_ms": kernel_ms(fn)}), flush=True)
    if args.old is not None:
        from repro_torch.kernels.mamba2_ssd.ref import ssd_bwd_torch
        from repro_torch.kernels.rwkv6.ref import wkv6_bwd_torch
        old_ssd, old_wkv = old_ssd_bwd(args.old), old_wkv_bwd(args.old)
        pairs = {
            "mamba2_ssd_bwd": (
                lambda: ssd_ops.ssd_bwd(*ssd_args, dy),
                lambda: old_ssd(*ssd_args, dy),
                lambda: ssd_bwd_torch(*ssd_args, dy, chunk=ssd_ops.CHUNK)),
            "wkv6_bwd": (
                lambda: wkv_ops.wkv6_bwd(*wkv_args, do),
                lambda: old_wkv(*wkv_args, do),
                lambda: wkv6_bwd_torch(*wkv_args, do, chunk=wkv_ops.CHUNK)),
        }
        for name, (this, old, plain) in pairs.items():
            print(json.dumps({"probe": f"{name}_vs_old", "dtype": "bfloat16",
                              "old_tree": str(args.old),
                              "bound_ms": runs[name][1][0],
                              **versus_old(this, old, plain, args.reps)}),
                  flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
