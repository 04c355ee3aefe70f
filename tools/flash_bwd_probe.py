#!/usr/bin/env python3
"""Time the flash-attention backward kernel at h2o-danube-1.8b's training
shape, beside an earlier form of it, SDPA's backward and its bound.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/flash_bwd_probe.py [--old PATH] [--reps N]

At danube's bf16 training shape (B 4 x 2048, 32 query and 8 KV heads of
80, causal; ``chip_smoke.FLASH_BWD_CASES``' "danube-train" inputs from the
same generator) it prints one JSON line per measurement:

- ``form``: this checkout's backward (``ops.flash_attention_bwd``) against
  the plain version within ``chip_smoke.KERNEL_TOL`` bf16, its ms a call
  (CUDA events) in turns with the earlier form's (this, old, old, this),
  SDPA backward's ms, the bound, TFLOP/s of the algorithm's 10 D flops a
  kept pair, and the device ms of each of its kernels (``torch.profiler``).
- with ``--old PATH``: the same for the backward library built from PATH's
  ``src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu``
  (and any ``flash_attention_bwd_wgmma.cu`` and ``kernels/csrc/hopper.cuh``
  beside it), a tree unpacked with ``git archive`` of an earlier commit
  whose C entry point ``flash_attention_bwd_launch`` takes the same
  arguments; it is called with the earlier wrapper's arguments (the
  caller's own D, a (B, H, Sq) Drow scratch when it has no bf16 tensor-core
  form, else a padded one).

The last line is the card's name and power limit (``nvidia-smi``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CASE = "danube-train"


def emit(kind: str, **fields) -> None:
    print(json.dumps({"probe": kind, **fields}), flush=True)


def old_launcher(tree: Path):
    """The C entry point of the backward library built from ``tree``'s
    sources (under a name of its own), and whether it has a bf16
    tensor-core form."""
    from repro_torch.kernels import build
    csrc = tree / "src" / "repro_torch" / "kernels" / "flash_attention" / "csrc"
    sources = [csrc / "flash_attention_bwd.cu"]
    wgmma = csrc / "flash_attention_bwd_wgmma.cu"
    if wgmma.exists():
        sources += [wgmma, csrc.parents[1] / "csrc" / "hopper.cuh"]
    fn = build.load("flash_attention_bwd_old", sources,
                    {}).flash_attention_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, wgmma.exists()


def run_old(fn, tensor_core: bool, q, k, v, o, do, lse, causal, window,
            prefix):
    """dq, dk, dv from the earlier library, as its wrapper called it (D a
    multiple of 8 here, so no padding)."""
    import torch
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if tensor_core:
        scratch = torch.empty(2 * B * H * -(-Sq // 128) * 128,
                              dtype=torch.float32, device=q.device)
    else:
        scratch = torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), 1, B, Sq, Skv, H,
             KV, D, int(causal), window, prefix, 1.0 / math.sqrt(D),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"old backward: error {err}")
    return dq, dk, dv


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, default=None,
                    help="root of an earlier source tree to time beside")
    ap.add_argument("--reps", type=int, default=20,
                    help="calls per timing")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_probe: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bwd_torch

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    (name, B, S, H, KV, D, dt, causal, window, prefix), = [
        c for c in cs.FLASH_BWD_CASES if c[0] == CASE]
    gen = torch.Generator(device=dev).manual_seed(2)
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev).bfloat16()
                   for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D),
                                 (B, S, H, D)))
    mask = {"causal": causal, "window": window, "prefix_len": prefix}
    o, lse = ops._forward(q, k, v, causal, window, prefix, True)
    want = flash_attention_bwd_torch(q, k, v, o, do, lse, **mask)
    b_ms, b_by, flops, _ = cs.attention_bwd_bound(B, S, H, KV, D, dt, causal,
                                                  window, prefix)
    forms = {"this": lambda: ops.flash_attention_bwd(q, k, v, o, do, lse,
                                                     **mask)}
    if args.old is not None:
        fn, tc = old_launcher(args.old)
        forms["old"] = lambda: run_old(fn, tc, q, k, v, o, do, lse, causal,
                                       window, prefix)
    checks = {}
    for form, run in forms.items():
        got = run()
        torch.cuda.synchronize()
        checks[form] = {
            "excess": max(cs.excess(g, w, dt) for g, w in zip(got, want)),
            "max_abs_err": max(float((g.float() - w.float()).abs().max())
                               for g, w in zip(got, want))}
        del got
    order = ["this", "old", "old", "this"] if "old" in forms else ["this"]
    times = {form: [] for form in forms}
    for form in order:
        times[form].append(cs.time_ms(forms[form], reps=args.reps,
                                      warmup=2)[0])
    sdpa_ms = cs.sdpa_bwd_ms(q, k, v, do, causal, window, prefix)
    for form in forms:
        prof = cs.device_profile(forms[form])
        ms = min(times[form])
        emit("form", form=form, case=name, ms=ms, ms_all=times[form],
             **checks[form], bound_ms=b_ms, bound_by=b_by,
             tflop_s=flops / ms / 1e9, sdpa_bwd_ms=sdpa_ms,
             device_ms_by_kernel=prof["device_ms_by_kernel"])
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
