#!/usr/bin/env python3
"""Where a served request's time goes: the in-process ``Service`` beside
``ClusterService`` with one and two workers, on the same load.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/cluster_probe.py [--rounds N]

It compiles the four tenant classes of ``chip_smoke.py``'s service phase
(gemm, fft and nw on HyCUBE 4x4, gemm on PACE 8x8; M = 8192 words) on the
``cuda`` backend into the port's default mapping cache, then, ``--rounds``
times (default 2), drives the same 4096 single-vector requests from 8
client threads (``chip_smoke.cluster_drive``) through:

  * ``Service(max_batch=512, max_wait_ms=2)`` in this process, traced,
  * ``ClusterService(workers=1)`` and ``ClusterService(workers=2)``,
    traced (every worker on the one card, the artifacts warm off the
    shared cache directory),
  * ``ClusterService(workers=2)`` untraced.

One JSON line a run: wall, samples/s, p50/p99, the median of each stage of
a request (``queue_ms``, ``coalesce_ms``, ``exec_ms``, ``resolve_ms``, from
``fut.info["trace"]``) and, per worker, mean batch, batches and
``exec_samples_per_s``.  The card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def median(xs):
    xs = sorted(x for x in xs if x is not None)
    return xs[len(xs) // 2] if xs else None


def report(run: str, futs, wall: float, stats) -> None:
    traces = [f.info.get("trace") or {} for f in futs]
    row = {"run": run, "wall_s": wall, "samples_per_s": len(futs) / wall,
           "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"]}
    for stage in ("queue_ms", "coalesce_ms", "exec_ms", "resolve_ms"):
        row["median_" + stage] = median([t.get(stage) for t in traces])
    workers = stats.get("per_worker") or {0: stats}
    row["workers"] = {i: {k: s.get(k) for k in ("mean_batch", "batches",
                                                "exec_samples_per_s")}
                      for i, s in workers.items()}
    print(json.dumps(row), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("cluster_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    import chip_smoke as cs
    from repro_torch import obs, ual
    from repro_torch.kernels.cgra_exec import ops

    torch.cuda.set_device(0)
    print(cs.nvidia_smi(), flush=True)
    ops.build()
    classes = []
    for kname, fab in cs.SERVICE_CLASSES:
        kw = {"rows": 4, "cols": 4} if fab == "hycube" else {}
        program = ual.Program.from_kernel(kname)
        classes.append((program, ual.compile(program, ual.Target.from_name(
            fab, backend="cuda", **kw))))
    rng = np.random.default_rng(0)
    mems = [classes[i % len(classes)][0].random_inputs(rng)
            for i in range(cs.CLUSTER_REQUESTS)]
    cache_dir = str(ual.default_cache_dir())
    for r in range(args.rounds):
        obs.enable_tracing(True)
        svc = ual.Service(max_batch=512, max_wait_ms=2,
                          max_queue=cs.CLUSTER_REQUESTS)
        try:
            futs, _, wall = cs.cluster_drive(svc, classes, mems)
            stats = svc.stats()
        finally:
            svc.shutdown()
        obs.enable_tracing(False)
        report(f"service-traced-{r}", futs, wall, stats)
        for workers, trace in ((1, True), (2, True), (2, False)):
            with ual.ClusterService(workers=workers, max_batch=512,
                                    max_wait_ms=2,
                                    max_queue=cs.CLUSTER_REQUESTS,
                                    cache_dir=cache_dir, trace=trace) as c:
                futs, _, wall = cs.cluster_drive(c, classes, mems)
                stats = c.stats(timeout=120)
            report(f"cluster-w{workers}-{'traced' if trace else 'plain'}"
                   f"-{r}", futs, wall, stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
