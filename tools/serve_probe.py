#!/usr/bin/env python3
"""Prefill and decode wall times of the LM families at full width, this
tree beside an earlier one.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/serve_probe.py [--old PATH] [--reps N] [ARCH ...]

For each architecture (default ``chip_smoke.py``'s ``LM_ARCHS``) it builds
the published configuration in bf16 with random weights from a seed, then
times ``prefill_fn`` on B = 2 prompts of 2048 tokens (paligemma's behind
256 image embeddings, hubert's 2048 frames of features) and
``greedy_generate`` for 4 requests of 16 new tokens (not for hubert, an
encoder), as ``chip_smoke.py``'s ``lm_prefill`` and ``lm_serve`` phases
do: one cold call, then the median of ``--reps`` warm ones, on the host
clock after a synchronize.  Each turn runs in a process of its own that
imports only its tree's ``src``.  With ``--old PATH`` (the root of an
earlier source tree, e.g. ``git archive`` of an earlier commit unpacked
under ``trees/``) the turns go this, old, old, this.  It prints one JSON
line a (turn, architecture), then one a architecture with each tree's
turns, and last the card's name and power limit (``nvidia-smi``).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: chip_smoke.py's serving shapes
ARCHS = ("qwen3-8b", "zamba2-2.7b", "rwkv6-1.6b", "deepseek-moe-16b",
         "paligemma-3b", "hubert-xlarge")
PREFILL_B, PREFILL_S, PREFILL_IMAGE = 2, 2048, 256
SERVE_REQUESTS, SERVE_NEW = 4, 16


def wall_ms(fn, reps: int):
    """(cold ms, median warm ms over ``reps``) of ``fn`` on the host clock,
    each call followed by a synchronize."""
    import torch
    times = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times[0], statistics.median(times[1:])


def worker(tree: Path, archs, reps: int, seed: int) -> None:
    """One turn: every architecture through ``tree``'s port."""
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.models.common import init_params
    from repro_torch.serve.serve_step import prefill_fn

    dev = torch.device("cuda", 0)
    for arch in archs:
        cfg = get_config(arch)
        rng = np.random.default_rng(seed)
        gen = torch.Generator(device=dev).manual_seed(seed + 2)
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab, (PREFILL_B, PREFILL_S)).astype(np.int32)).to(dev)
        prompts = [rng.integers(0, cfg.vocab, rng.integers(4, 12))
                   .astype(np.int32) for _ in range(SERVE_REQUESTS)]
        batch = {"tokens": tokens}
        if cfg.family == "paligemma":
            batch["img_embeds"] = torch.randn(
                (PREFILL_B, PREFILL_IMAGE, cfg.d_model), generator=gen,
                device=dev)
        elif cfg.family == "hubert":
            batch = {"features": torch.randn(
                (PREFILL_B, PREFILL_S, cfg.d_model), generator=gen,
                device=dev)}
        params = init_params(torch.Generator(device=dev).manual_seed(seed),
                             cfg, dev)
        prefill = prefill_fn(cfg)
        row = {"tree": str(tree), "arch": arch}
        with torch.no_grad():
            row["prefill_ms_cold"], row["prefill_ms"] = wall_ms(
                lambda: prefill(params, batch), reps)
            if cfg.family != "hubert":
                steps = max(len(p) for p in prompts) + SERVE_NEW
                cold, warm = wall_ms(lambda: greedy_generate(
                    params, cfg, prompts, SERVE_NEW,
                    max_len=64 + SERVE_NEW), reps)
                row["decode_ms_per_step_cold"] = cold / steps
                row["decode_ms_per_step"] = warm / steps
        print(json.dumps(row), flush=True)
        del params, batch, tokens
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("archs", nargs="*", default=list(ARCHS))
    ap.add_argument("--old", type=Path, default=None)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", type=Path, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        worker(args.worker.resolve(), args.archs, args.reps, args.seed)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("serve_probe: needs a CUDA card", file=sys.stderr)
        return 2
    trees = [ROOT]
    if args.old is not None:
        old = args.old.resolve()
        trees = [ROOT, old, old, ROOT]
    rows = []
    for turn, tree in enumerate(trees):
        out = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), *args.archs,
             "--reps", str(args.reps), "--seed", str(args.seed),
             "--worker", str(tree)],
            cwd=tree, capture_output=True, text=True,
            env={**os.environ, "PYTHONPATH": str(tree / "src")})
        sys.stderr.write(out.stderr)
        if out.returncode != 0:
            print(f"serve_probe: turn {turn} in {tree} failed "
                  f"(rc {out.returncode})", file=sys.stderr)
            return 1
        for line in out.stdout.splitlines():
            row = {"turn": turn, **json.loads(line)}
            rows.append(row)
            print(json.dumps(row), flush=True)
    for arch in args.archs:
        summary = {"arch": arch}
        for name, tree in (("this", ROOT), ("old", args.old and old)):
            mine = [r for r in rows if r["arch"] == arch
                    and tree is not None and r["tree"] == str(tree)]
            for key in ("prefill_ms", "decode_ms_per_step"):
                if mine and key in mine[0]:
                    summary[f"{key}_{name}"] = [r[key] for r in mine]
        print(json.dumps(summary), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else "nvidia-smi: no output", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
