"""One run of one cell: resolve the cell by name, drive the program
through set-up, the measured window and the comparison that decides
``correct``, and assemble the result line.

The runner of a traffic mix's ``kind`` (``kinds/<kind>.py``) provides
``setup(ctx)``, ``window(ctx, prog, seconds, tracer)`` and
``verify(ctx, prog, record)``; everything else is here.  Metrics are read
by their own files (``metrics/<name>.py``, each a ``read(ctx, run)``
returning a number, or None where it finds nothing to read)."""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import subprocess
import time
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, Dict, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_file(path: Path, name: Optional[str] = None) -> ModuleType:
    """The module in ``path``, by file (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        name or "portbench._loaded." + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path):
    return json.loads(path.read_text())


@dataclasses.dataclass
class Cell:
    """A cell of ``BENCHMARK.json`` with what it names, resolved."""
    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def model(self) -> dict:
        return self.config["model"]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(bench: dict, name: str, root: Path = ROOT,
            pkg: Path = HERE) -> Cell:
    """The cell ``name`` of ``bench`` with its configuration, traffic,
    limits and metrics (files under ``root`` and the harness's folder
    ``pkg``); raises ``KeyError`` naming what is missing."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r}; have {sorted(cells)}")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[entry["config"]]
    config = read_json(root / cfg_entry["file"])
    traffic = read_json(pkg / "traffic" / f"{entry['traffic']}.json")
    limits = read_json(pkg / "limits" / f"{name}.json")
    return Cell(name, entry, config, traffic, limits,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def kind_module(cell: Cell) -> ModuleType:
    return load_file(HERE / "kinds" / f"{cell.traffic['kind']}.py",
                     f"portbench.kinds.{cell.traffic['kind']}")


def family_module(cell: Cell, part: str) -> ModuleType:
    """``reference/<family>.py`` or ``work/<family>.py``."""
    fam = cell.config["family"]
    return load_file(HERE / part / f"{fam}.py", f"portbench.{part}.{fam}")


def metric_reader(name: str) -> Callable:
    return load_file(HERE / "metrics" / f"{name}.py").read


@dataclasses.dataclass
class Ctx:
    """What a kind's runner and a metric's reader see of a run."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    ref: ModuleType
    work: ModuleType
    #: a test's hook around the program's timed call: ``wrap(fn) -> fn``
    wrap: Optional[Callable] = None
    notes: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def model(self) -> dict:
        return self.cell.model


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def check_line(checks: dict) -> str:
    """The numbers compared, each beside its limit, on one line."""
    return "checks: " + ", ".join(
        f"{k} {v['value']:.6g} (limit {v['limit']:.6g})"
        for k, v in checks.items())


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, wrap: Optional[Callable] = None,
        notes: Optional[dict] = None) -> dict:
    """One run of ``cell``; returns the result line's object (without
    printing it).  ``t_start`` is the process's start on the
    ``time.perf_counter`` clock.  ``wrap`` breaks the program's timed call
    for a test (``faults.py``); ``notes`` receives the comparison's
    readings, and with ``notes["control"]`` set, the control's numbers
    too (``calibrate.py``)."""
    import torch

    from portbench.trace import Tracer
    ctx = Ctx(cell, seed, seconds, trace, device,
              family_module(cell, "reference"), family_module(cell, "work"),
              wrap, {} if notes is None else notes)
    kind = kind_module(cell)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    prog = kind.setup(ctx)
    tracer = None
    if trace:
        t = cell.traffic["trace"]
        tracer = Tracer(t["start"] * seconds, t["count"], device)
    setup_s = time.perf_counter() - t_start
    t_window = time.perf_counter()
    record = kind.window(ctx, prog, seconds, tracer)
    if tracer:
        tracer.close()
    t_verify = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    record["peak_bytes"] = peak
    summary = tracer.summary() if tracer else None
    ctx.notes["summary"] = summary
    checks = kind.verify(ctx, prog, record)
    del prog
    gc.collect()
    ctx.notes["timing_s"] = {"setup": setup_s,
                             "window": t_verify - t_window,
                             "verify": time.perf_counter() - t_verify}
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    runinfo = {"setup_s": setup_s, "record": record, "summary": summary}
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = metric_reader(m["name"])(ctx, runinfo)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak,
           "power_limit": power_limit() if cuda else None}
    out = {"correct": correct, "attempted": record["attempted"],
           "failed": record["failed"], "metrics": metrics, "device": dev}
    if trace:
        if summary is None:
            raise RuntimeError("the traced stretch did not complete inside "
                               "the window: lengthen --seconds")
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["wall_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    out["checks"] = checks
    return out
