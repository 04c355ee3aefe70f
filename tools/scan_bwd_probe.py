#!/usr/bin/env python3
"""Time the SSD and WKV backward kernels at zamba2-2.7b's and rwkv6-1.6b's
training shapes, beside their forward kernels and their bounds.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/scan_bwd_probe.py [--reps N]

It builds the four libraries (the SSD and WKV forwards and backwards),
makes ``chip_smoke.py``'s inputs at the training shapes in bf16 (the SSD:
B 4 x 2048, 80 heads of 64, state 64, Mamba-2's slow decays; the WKV:
B 4 x 2048, 32 heads of 64, the model's slow decays) and prints one JSON
line a kernel: its ms a call (CUDA events over ``--reps`` calls after one
warm-up), the bound (``chip_smoke.ssd_bwd_bound`` / ``wkv_bwd_bound`` for
the backwards, ``ssd_bound`` / ``wkv_bound`` for the forwards, at this
shape), and the device ms of each of its kernels under ``torch.profiler``
(the backward's main kernel and its ``sum_parts_kernel``).  The last line
is the card's name and power limit (``nvidia-smi``).
"""
from __future__ import annotations

import argparse
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
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
    runs = {
        "mamba2_ssd_bwd": (lambda: ssd_ops.ssd_bwd(*ssd_args, dy),
                           cs.ssd_bwd_bound(B, S, H, P, N, "bfloat16")),
        "mamba2_ssd": (lambda: ssd_ops.ssd(*ssd_args),
                       cs.ssd_bound(B, S, H, P, N, "bfloat16")),
        "wkv6_bwd": (lambda: wkv_ops.wkv6_bwd(*wkv_args, do),
                     cs.wkv_bwd_bound(B2, S2, H2, K, "bfloat16")),
        "rwkv6": (lambda: wkv_ops.wkv6(*wkv_args),
                  cs.wkv_bound(B2, S2, H2, K, "bfloat16")),
    }
    for name, (fn, bound) in runs.items():
        print(json.dumps({"probe": name, "dtype": "bfloat16",
                          "ms": event_ms(fn, args.reps),
                          "bound_ms": bound[0], "bound_by": bound[1],
                          "kernels_ms": kernel_ms(fn)}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
