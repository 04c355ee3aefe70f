"""Markdown report of dry-run records (the JAX package's
``analysis/report.py``; the text is the same but for the name of the
matrix units).

    PYTHONPATH=src python -m repro_torch.analysis.report [--dir artifacts/dryrun_torch]

Emits the §Dry-run and §Roofline tables: per (arch x shape x mesh) cell the
compile status, per-device memory, the three roofline terms, the dominant
bottleneck, useful-FLOPs ratio and roofline fraction, plus a one-line
improvement note derived from the dominant term.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _note(r: dict) -> str:
    b = r["bottleneck"]
    if b == "memory":
        if r.get("useful_flops_ratio", 1) < 0.5:
            return "cut remat re-reads (checkpoint policy) / fuse scan body"
        return "reduce activation traffic: larger microbatch tiles, fused ops"
    if b == "collective":
        colls = r.get("collectives", {})
        top = max(colls, key=lambda k: colls[k].get(
            "wire_bytes", colls[k].get("bytes", 0))) if colls else "?"
        return f"dominant {top}: reshard to shrink it or overlap with compute"
    return "compute-bound: good; push tensor-core utilization (layout, fusion)"


def load(dry_dir: Path, tag: str = ""):
    cells = []
    for f in sorted(dry_dir.glob("*.json")):
        rec = json.loads(f.read_text())
        if "cell" not in rec:
            continue                     # modeled/aux artifacts
        is_tagged = bool(rec.get("overrides"))
        if (tag == "") != (not is_tagged):
            continue
        cells.append(rec)
    return cells


def dryrun_table(cells) -> str:
    out = ["| cell | status | compile s | args GB/dev | temp GB/dev | note |",
           "|---|---|---|---|---|---|"]
    for rec in cells:
        cell = rec["cell"]
        if rec["status"] == "skipped":
            out.append(f"| {cell} | skipped | — | — | — | {rec['reason']} |")
            continue
        if rec["status"] == "error":
            out.append(f"| {cell} | ERROR | — | — | — |"
                       f" {rec.get('error', '')[:60]} |")
            continue
        m = rec.get("memory_analysis", {})
        args_gb = m.get("argument_size_in_bytes", 0) / 2**30
        temp_gb = m.get("temp_size_in_bytes", 0) / 2**30
        out.append(f"| {cell} | ok | {rec['compile_s']:.0f} "
                   f"| {args_gb:.2f} | {temp_gb:.2f} | |")
    return "\n".join(out)


def roofline_table(cells, mesh: str = "pod16x16") -> str:
    out = ["| arch | shape | bound | t_comp s | t_mem s | t_coll s "
           "| useful | roofline | what would move the dominant term |",
           "|---|---|---|---|---|---|---|---|---|"]
    for rec in cells:
        if rec["status"] != "ok" or rec["mesh"] != mesh:
            continue
        r = rec["roofline"]
        out.append(
            f"| {rec['arch']} | {rec['shape']} | **{r['bottleneck']}** "
            f"| {r['t_compute_s']:.2e} | {r['t_memory_s']:.2e} "
            f"| {r['t_collective_s']:.2e} "
            f"| {r['useful_flops_ratio']:.2f} | {r['roofline_fraction']:.3f} "
            f"| {_note(r)} |")
    return "\n".join(out)


def summary(cells) -> dict:
    ok = [c for c in cells if c["status"] == "ok"]
    skipped = [c for c in cells if c["status"] == "skipped"]
    err = [c for c in cells if c["status"] == "error"]
    bn = {}
    fracs = []
    for c in ok:
        if c["mesh"] != "pod16x16":
            continue
        b = c["roofline"]["bottleneck"]
        bn[b] = bn.get(b, 0) + 1
        fracs.append((c["roofline"]["roofline_fraction"], c["cell"]))
    fracs.sort()
    return {"ok": len(ok), "skipped": len(skipped), "errors": len(err),
            "bottlenecks_single_pod": bn,
            "worst_cells": fracs[:5], "best_cells": fracs[-5:]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun_torch")
    ap.add_argument("--mesh", default="pod16x16")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    cells = load(Path(args.dir), args.tag)
    print("## Dry-run status\n")
    print(dryrun_table(cells))
    print("\n## Roofline (single-pod 16x16 unless noted)\n")
    print(roofline_table(cells, args.mesh))
    print("\n## Summary\n")
    print(json.dumps(summary(cells), indent=1))


if __name__ == "__main__":
    main()
