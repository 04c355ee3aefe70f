"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  It needs the port (``src/repro_torch``) and
as many CUDA cards as the cell asks for; without them it prints no result
and exits with a code other than 0 (2: no port, 3: too few cards, 4: a
module of JAX or of the JAX package was loaded).  The last lines of
standard error, and the result's last key, ``checks``, give each number
the correctness check compared with its limit; the last line of standard
output is the result."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _paths() -> bool:
    """Put the checkout and its ``src`` on the path; False without the
    port."""
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        return False
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    return True


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's kernel libraries already go to ``artifacts/repro_torch/
    build``); libraries that could pull JAX in are told not to."""
    cache = ROOT / "artifacts" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not _paths():
        print("portbench: no src/repro_torch beside BENCHMARK.json: the "
              "program under test is missing", file=sys.stderr)
        return 2
    _caches()
    from portbench import guard, harness
    bench = harness.read_json(ROOT / "BENCHMARK.json")
    cell = harness.resolve(bench, args.workload)
    import torch
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    notes: dict = {}
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      device, T_START, notes=notes)
    bad = guard.foreign(sys.modules)
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    print(json.dumps(out), flush=True)
    print("timing: " + json.dumps(notes.get("timing_s")), file=sys.stderr)
    print("readings: " + json.dumps({**(notes.get("readings") or {}),
                                     "numbers": notes.get("numbers")}),
          file=sys.stderr)
    print(harness.check_line(out["checks"]), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
