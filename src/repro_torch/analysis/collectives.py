"""Per-op collective profile of a dry-run cell (the JAX package's
``analysis/collectives.py``, in PyTorch).

    PYTHONPATH=src python -m repro_torch.analysis.collectives \\
        --arch gemma3-27b --shape train_4k [--multi-pod] [--top 15]

Traces the cell on the production mesh (``launch.dryrun.lower_cell``
under a fake process group) and prints the top collectives by wire bytes
with their result shapes, group sizes and counts — the dry-run equivalent
of reading a comm profile.  ``memory_main`` (``analysis/memprof``) prints
the top ops by bytes moved.
"""
from __future__ import annotations

import argparse
import json


def _lower(args, multi_pod: bool):
    from repro_torch.launch.dryrun import (fake_group, lower_cell,
                                           make_production_mesh)
    mesh = make_production_mesh(multi_pod=multi_pod)
    overrides = json.loads(args.overrides) if args.overrides else None
    with fake_group(mesh.size):
        return lower_cell(args.arch, args.shape, mesh,
                          "pod2x16x16" if multi_pod else "pod16x16",
                          overrides)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--overrides", default=None)
    args = ap.parse_args(argv)
    _, _, cost, _ = _lower(args, args.multi_pod)
    acc = cost["top_collectives"]
    rows = sorted(acc.items(), key=lambda kv: -kv[1]["wire_bytes"])
    total = sum(v["wire_bytes"] for v in acc.values())
    print(f"\n{args.arch} {args.shape}: total wire {total / 1e9:.1f} GB/dev")
    print(f"{'kind':18s} {'g':>4s} {'count':>7s} {'wire GB':>9s}  shape")
    for (kind, shp, g), v in rows[:args.top]:
        print(f"{kind:18s} {g:4d} {v['count']:7.0f} "
              f"{v['wire_bytes'] / 1e9:9.2f}  {shp}")


def memory_main(argv=None):
    ap = argparse.ArgumentParser(prog="memprof")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--overrides", default=None)
    args = ap.parse_args(argv)
    _, _, cost, _ = _lower(args, False)
    acc = cost["top_memory"]
    rows = sorted(acc.items(), key=lambda kv: -kv[1]["bytes"])
    total = sum(v["bytes"] for v in acc.values())
    print(f"\n{args.arch} {args.shape}: total HBM traffic "
          f"{total / 1e12:.2f} TB/dev")
    print(f"{'opcode':22s} {'count':>8s} {'GB':>9s}  shape")
    for (kind, shp), v in rows[:args.top]:
        print(f"{kind:22s} {v['count']:8.0f} {v['bytes'] / 1e9:9.1f}  {shp}")


if __name__ == "__main__":
    main()
