"""The traced stretch of a run: ``torch.profiler`` over a few steady steps
or requests inside the window, read into a summary that the per-layer
metrics' readers take.

The summary holds the stretch's wall time, the device's busy time (the
union of its kernels, copies and sets), the device time of each kernel
group (``groups/<name>.json``: substrings of lower-cased kernel names), the
device time of the kernels launched inside each of the harness's own
spans (``pb.<name>``, ``record_function`` ranges around the calls into the
program), the device operations that took most time, and the device's idle
gaps labelled by what the host was doing when it launched the work that
ended each gap: the harness's span and the program's op."""
from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path

import torch

GROUPS_DIR = Path(__file__).resolve().parent / "groups"
SPAN_PREFIX = "pb."
TOP = 10


def load_groups():
    return {p.stem: [s.lower() for s in json.loads(p.read_text())["contains"]]
            for p in sorted(GROUPS_DIR.glob("*.json"))}


def span(name: str):
    """A harness span, ``pb.<name>``, seen by the profiler."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


class Tracer:
    """Profiles ``count`` units of a window (steps or requests), from the
    first unit that starts ``start_s`` or more into the window: ``at(i,
    elapsed)`` before unit i starts, ``done(i)`` after it ends;
    ``summary()`` once the stretch has ended.  The units before the
    stretch ran with no profiler in the process and give the traced run
    its untraced rate (``pre_units`` of them in ``pre_s`` seconds): those
    after it run slower than an untraced run's."""

    def __init__(self, start_s: float, count: int, device):
        self.start_s, self.count, self.device = start_s, count, device
        self.prof = None
        self.wall_s = None
        #: the first traced unit, and the window's seconds before it
        self.first = self.pre_s = None
        self.units = []
        self._t0 = None

    def active(self, i: int) -> bool:
        return self.first is not None and \
            self.first <= i < self.first + self.count

    def at(self, i: int, elapsed: float) -> None:
        if self.first is None and elapsed >= self.start_s:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.first, self.pre_s = i, elapsed
            self._sync()
            self.prof.start()
            self._t0 = time.perf_counter()

    def done(self, i: int, **unit) -> None:
        if self.active(i):
            self.units.append(unit)
            if i == self.first + self.count - 1:
                self.close()

    def close(self) -> None:
        """End the stretch (at its last unit, or where the window ended
        inside it); the units recorded so far are the stretch."""
        if self.prof is None or self.wall_s is not None:
            return
        self._sync()
        self.wall_s = time.perf_counter() - self._t0
        self.prof.stop()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def summary(self):
        if self.prof is None or self.wall_s is None or not self.units:
            return None
        out = summarize(self.prof, self.wall_s, self.units)
        out["pre_units"], out["pre_s"] = self.first, self.pre_s
        return out


def _events(prof):
    """(device events, cpu events) as plain tuples, from the profiler's
    kineto results: device (name, start_ns, end_ns, linked correlation),
    cpu (name, start_ns, end_ns, correlation)."""
    from torch.autograd import DeviceType
    dev, cpu = [], []
    for ev in prof.profiler.kineto_results.events():
        a = ev.start_ns()
        z = a + ev.duration_ns()
        name = ev.name()
        if ev.device_type() == DeviceType.CPU:
            cpu.append((name, a, z, ev.correlation_id()))
        elif not name.startswith(SPAN_PREFIX) and z > a:
            dev.append((name, a, z, ev.linked_correlation_id()))
    return dev, cpu


def summarize(prof, wall_s: float, units) -> dict:
    dev, cpu = _events(prof)
    groups = load_groups()
    spans = sorted((a, z, n[len(SPAN_PREFIX):]) for n, a, z, _ in cpu
                   if n.startswith(SPAN_PREFIX))
    ops = {c: (n, a) for n, a, z, c in cpu
           if c and not n.startswith(SPAN_PREFIX)}

    def span_at(t):
        inner = None
        for a, z, n in spans:
            if a <= t <= z and (inner is None or a >= inner[0]):
                inner = (a, z, n)
        return inner[2] if inner else "outside"

    group_s = {g: 0.0 for g in groups}
    span_s: dict = {}
    by_name: dict = {}
    launched = []
    for name, a, z, corr in dev:
        s = (z - a) / 1e9
        low = name.lower()
        for g, keys in groups.items():
            if any(k in low for k in keys):
                group_s[g] += s
        op = ops.get(corr)
        where = span_at(op[1]) if op else "outside"
        span_s[where] = span_s.get(where, 0.0) + s
        by_name[name] = by_name.get(name, 0.0) + s
        launched.append((a, z, where, op[0] if op else "?"))
    launched.sort()
    busy, end, gaps = 0.0, None, {}
    for a, z, where, op in launched:
        if end is not None and a > end:
            label = f"{where}:{op}"
            gaps[label] = gaps.get(label, 0.0) + (a - end) / 1e9
        if end is None or a > end:
            busy += z - a
            end = z
        elif z > end:
            busy += z - end
            end = z
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {"wall_s": wall_s, "busy_s": busy / 1e9,
            "device_events": len(dev),
            "group_s": group_s, "span_s": span_s,
            "units": list(units),
            "device_ops": [[n[:120], s] for n, s in top],
            "idle_gaps": [[n[:120], s] for n, s in top_gaps]}


@contextlib.contextmanager
def no_span(_name: str):
    yield
