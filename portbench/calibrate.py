"""Read what the correctness limits are set from, on the card, in one
process: the program's numbers on many seeds (each a whole run: set-up, a
short window, the comparison), the control's (the reference in fp8 in the
program's place) on some, and each planted fault's (``faults.py``) on
some.

    python3 portbench/calibrate.py --workload zamba2-train \\
        --seeds 1,2,3 --control 1,2,3 --faults half_batch:4,5,6 \\
        --seconds 2 --out calib.jsonl

One JSON line a reading: the cell, the seed, what ran (``program``,
``control`` or a fault's name) and the numbers compared."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def _ints(text: str):
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control", type=_ints, default=[])
    ap.add_argument("--faults", action="append", default=[],
                    help="name:seed,seed,...")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    import torch

    from portbench import faults, harness
    cell = harness.resolve(harness.read_json(ROOT / "BENCHMARK.json"),
                           args.workload)
    device = torch.device("cuda", 0)
    table = {**faults.TRAIN, **faults.PREFILL}
    jobs = [(s, None) for s in dict.fromkeys(args.seeds + args.control)]
    for spec in args.faults:
        name, seeds = spec.split(":")
        jobs += [(s, name) for s in _ints(seeds)]
    with open(args.out, "a") as out:
        for seed, what in jobs:
            notes = {"control": what is None and seed in args.control}
            t0 = time.perf_counter()
            res = harness.run(cell, seed, args.seconds, False, device,
                              t0, wrap=table.get(what), notes=notes)
            line = {"cell": cell.name, "seed": seed,
                    "ran": what or "program",
                    "checks": notes["numbers"],
                    "attempted": res["attempted"],
                    "readings": notes.get("readings"),
                    "s": time.perf_counter() - t0}
            out.write(json.dumps(line) + "\n")
            print(json.dumps(line), flush=True)
            if isinstance(notes.get("control"), dict):
                ctl = {k: v for k, v in notes["control"].items()
                       if k != "worst"}
                cline = {"cell": cell.name, "seed": seed, "ran": "control",
                         "checks": ctl,
                         "worst": notes["control"].get("worst")}
                out.write(json.dumps(cline) + "\n")
                print(json.dumps(cline), flush=True)
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
