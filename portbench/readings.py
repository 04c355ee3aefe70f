"""Helpers of the metrics' readers (``metrics/<name>.py``): each reader
takes the run's context and ``run`` ({"setup_s", "record", "summary"})
and returns a number, or None where it finds nothing to read: no traced
stretch, no device events (a CPU run), or no kernel of its group."""
from __future__ import annotations

import functools
import math

from portbench.work.peaks import PEAK_FLOPS


def on_device(ctx, run) -> bool:
    s = run.get("summary")
    return (ctx.device.type == "cuda" and s is not None
            and s["device_events"] > 0)


def units(run) -> int:
    return len(run["summary"]["units"])


def stretch_tokens(run) -> int:
    return sum(u["tokens"] for u in run["summary"]["units"])


def outside_ms(run, groups) -> float:
    """Device ms of the stretch outside ``groups`` and outside the
    harness's ``adamw`` span."""
    s = run["summary"]
    return 1e3 * (s["busy_s"] - sum(s["group_s"].get(g, 0.0) for g in groups)
                  - s["span_s"].get("adamw", 0.0))


def nearest_rank(values, q: float) -> float:
    xs = sorted(values)
    return xs[max(1, math.ceil(q * len(xs))) - 1]


def share_of_peak(flops: float, seconds: float) -> float:
    return 100.0 * flops / seconds / PEAK_FLOPS["bfloat16"]


@functools.lru_cache(maxsize=None)
def _forward_flops(work, model_items, B: int, S: int) -> int:
    return work.forward_flops(dict(model_items), B, S)


def forward_flops(ctx, B: int, S: int) -> int:
    """The configuration's forward model FLOPs (``work/<family>.py``)."""
    return _forward_flops(ctx.work, tuple(sorted(ctx.model.items())), B, S)


def untraced(run):
    """(units, wall seconds) of the window's steps or requests that ran
    with no profiler in the process: all of an untraced run's, and those
    before the traced stretch of a traced run."""
    r, s = run["record"], run.get("summary")
    if s is None:
        return r["units"], r["wall_s"]
    return r["units"][:s["pre_units"]], s["pre_s"]


def idle_pct(run) -> float:
    """The device's idle share of the window's untraced work: its busy time
    a token from the trace against the untraced tokens a second."""
    s = run["summary"]
    units, wall = untraced(run)
    rate = sum(u["tokens"] for u in units) / wall
    return 100.0 * (1.0 - s["busy_s"] / stretch_tokens(run) * rate)
