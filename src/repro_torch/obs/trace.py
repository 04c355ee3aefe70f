"""Flight-recorder tracing: nested spans, a bounded ring buffer, and
Chrome-trace/Perfetto export.

The tracer is the "where did request X spend its 40 ms?" half of the
telemetry subsystem (the metrics registry in ``repro_torch.obs.metrics`` is the
aggregate half).  Design constraints, in order:

  1. **Disabled must be free.**  Every hot path guards on ``tracer.enabled``
     (a plain attribute read); a disabled ``span()`` returns a shared
     no-op singleton without reading the clock or allocating a ``Span``.
  2. **Cross-thread requests.**  A service request is born on the caller
     thread, pulled by the dispatcher thread and executed on a worker
     thread, so context-manager nesting cannot describe it.  Producers
     instead capture raw ``perf_counter`` stamps and materialize spans
     retrospectively with :meth:`Tracer.record`.
  3. **Cross-process timelines.**  ``perf_counter`` epochs differ between
     processes, so every tracer remembers ``epoch = time.time() -
     perf_counter()`` at birth; :meth:`Tracer.ingest` re-bases foreign
     spans onto the local clock so a cluster export renders one aligned
     timeline with one track per worker.
  4. **Flight recorder, not a log.**  The buffer is a bounded ring:
     old entries fall off, ``stats()["dropped"]`` says how many spans
     they carried, and memory stays bounded no matter how long the
     service runs.  Hot producers buffer whole request trees as single
     compact entries (:meth:`Tracer.record_tree`) and ``Span`` objects
     only materialize on the read side.

Spans export as Chrome trace-event JSON (``ph:"X"`` complete events plus
``ph:"M"`` track-name metadata) — load the file at https://ui.perfetto.dev
or ``chrome://tracing``.  ``python -m repro_torch.obs.trace`` is the CLI: it
traces a demo service run end to end, or ``--inspect``\\ s an existing
trace file.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional

__all__ = ["Span", "Tracer"]


@dataclass
class Span:
    """One completed interval.  ``t0``/``dur_s`` are in the *owning
    tracer's* ``perf_counter`` timebase; ``Tracer.ingest`` re-bases them
    when a span crosses a process boundary (plain dataclass — picklable,
    so cluster workers ship these over the result pipe as-is)."""
    name: str
    t0: float
    dur_s: float
    trace_id: str
    span_id: str
    parent_id: Optional[str] = None
    cat: str = "default"
    track: Optional[str] = None
    args: Dict[str, object] = field(default_factory=dict)


class _PendingTree:
    """A whole request span tree buffered as ONE flight-recorder entry.

    The serving hot path records six spans per completed request;
    building six ``Span`` objects eagerly costs ~15 us on a loaded host
    — most of the enabled-tracing overhead.  Producers instead hand over
    raw ``(name, t0, t1, cat, args)`` tuples (root first) and the tracer
    materializes real spans lazily on the read side (``spans()`` /
    ``drain()`` / export), which is cold.  Expansion is cached so a
    tree's span ids are stable across reads."""
    __slots__ = ("trace_id", "track", "items", "_spans")

    def __init__(self, trace_id: str, track: str, items) -> None:
        self.trace_id = trace_id
        self.track = track
        self.items = items
        self._spans: Optional[List[Span]] = None

    def weight(self) -> int:
        return len(self.items)

    def expand(self, tracer: "Tracer") -> List[Span]:
        if self._spans is None:
            root_id = tracer.new_span_id()
            out = []
            for i, (name, t0, t1, cat, args) in enumerate(self.items):
                out.append(Span(
                    name=name, t0=t0, dur_s=max(0.0, t1 - t0),
                    trace_id=self.trace_id,
                    span_id=root_id if i == 0 else tracer.new_span_id(),
                    parent_id=None if i == 0 else root_id,
                    cat=cat, track=self.track,
                    args=args if args is not None else {}))
            self._spans = out
        return self._spans


def _entry_weight(entry) -> int:
    return 1 if isinstance(entry, Span) else entry.weight()


class _NullSpan:
    """The shared disabled-tracer span: ``with tracer.span(...)`` costs one
    attribute read and nothing else.  All fields are inert placeholders."""
    __slots__ = ()
    trace_id = ""
    span_id = ""

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **kwargs) -> None:
        return None


_NULL_SPAN = _NullSpan()


class _ActiveSpan:
    """A live context-manager span: pushed on the owning tracer's
    thread-local stack on ``__enter__`` (so children find their parent),
    recorded on ``__exit__``."""
    __slots__ = ("_tracer", "name", "cat", "trace_id", "span_id",
                 "parent_id", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 trace_id: Optional[str], parent_id: Optional[str],
                 args: Optional[dict]) -> None:
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.args = dict(args) if args else {}
        self._t0 = 0.0

    def set(self, **kwargs) -> None:
        """Attach attributes to the span while it is open."""
        self.args.update(kwargs)

    def __enter__(self) -> "_ActiveSpan":
        tr = self._tracer
        stack = tr._stack()
        if self.trace_id is None:
            if stack:
                top = stack[-1]
                self.trace_id = top.trace_id
                if self.parent_id is None:
                    self.parent_id = top.span_id
            else:
                self.trace_id = tr.new_trace_id()
        self.span_id = tr.new_span_id()
        stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        t1 = time.perf_counter()
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:            # tolerate interleaved exits
            stack.remove(self)
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        self._tracer._record(Span(
            name=self.name, t0=self._t0, dur_s=t1 - self._t0,
            trace_id=self.trace_id, span_id=self.span_id,
            parent_id=self.parent_id, cat=self.cat,
            track=threading.current_thread().name, args=self.args))


class Tracer:
    """Process-wide span recorder with a bounded ring buffer.

    ``enabled`` is the single hot-path gate: producers read it as a plain
    attribute and skip all capture work when False.  The buffer, counters
    and id generators are guarded by one lock — span *recording* is one
    deque append under that lock, span *capture* (timestamps) is lock-free
    on the producer's stack.
    """

    def __init__(self, enabled: bool = False, capacity: int = 32768) -> None:
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        # Wall-clock anchor for this tracer's perf_counter timebase: lets
        # export and cross-process ingest align spans from different
        # processes on one absolute timeline.
        self.epoch = time.time() - time.perf_counter()
        self._lock = threading.Lock()
        self._buf = _RingList(self.capacity)
        self._recorded = 0
        self._dropped = 0
        self._ids = itertools.count(1)
        self._local = threading.local()

    # -- lifecycle ----------------------------------------------------------
    def enable(self) -> "Tracer":
        self.enabled = True
        return self

    def disable(self) -> "Tracer":
        self.enabled = False
        return self

    # -- id minting ---------------------------------------------------------
    # lock-free: next() on itertools.count is atomic under CPython, and
    # id minting sits on the traced-request hot path (one trace id + six
    # span ids per served request)
    def new_trace_id(self) -> str:
        return f"t{next(self._ids):08x}"

    def new_span_id(self) -> str:
        return f"s{next(self._ids):08x}"

    # -- capture ------------------------------------------------------------
    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current(self) -> Optional[_ActiveSpan]:
        """The innermost open span on this thread, or None."""
        stack = getattr(self._local, "stack", None)
        return stack[-1] if stack else None

    def span(self, name: str, cat: str = "default", *,
             trace: Optional[str] = None, parent: Optional[str] = None,
             args: Optional[dict] = None):
        """Context-manager span.  Nested uses inherit trace/parent from the
        enclosing span on this thread.  When the tracer is disabled this
        returns a shared no-op singleton (no clock read, no allocation)."""
        if not self.enabled:
            return _NULL_SPAN
        return _ActiveSpan(self, name, cat, trace, parent, args)

    def record(self, name: str, t0: float, t1: float, *,
               cat: str = "default", trace: Optional[str] = None,
               parent: Optional[str] = None, track: Optional[str] = None,
               args: Optional[dict] = None) -> str:
        """Retrospectively record a span from two ``perf_counter`` stamps —
        the cross-thread producer API (service requests capture stamps on
        three different threads, then materialize the spans at resolve
        time).  Returns the new span id so callers can parent children
        under it."""
        if trace is None:
            cur = self.current()
            if cur is not None:
                trace = cur.trace_id
                if parent is None:
                    parent = cur.span_id
            else:
                trace = self.new_trace_id()
        sid = self.new_span_id()
        self._record(Span(
            name=name, t0=t0, dur_s=max(0.0, t1 - t0), trace_id=trace,
            span_id=sid, parent_id=parent, cat=cat,
            track=track or threading.current_thread().name,
            args=dict(args) if args else {}))
        return sid

    def _record(self, span: Span) -> None:
        with self._lock:
            evicted = self._buf.append(span)
            self._recorded += 1
            if evicted is not None:
                self._dropped += _entry_weight(evicted)

    def record_many(self, spans: Iterable[Span]) -> None:
        """Record pre-built spans under ONE lock acquisition — the bulk
        producer API for paths that materialize several spans at once."""
        with self._lock:
            for s in spans:
                evicted = self._buf.append(s)
                self._recorded += 1
                if evicted is not None:
                    self._dropped += _entry_weight(evicted)

    def record_tree(self, trace_id: str, items, *,
                    track: Optional[str] = None) -> None:
        """Buffer a whole span tree — ``(name, t0, t1, cat, args)`` tuples,
        root first — as ONE ring entry, deferring ``Span`` construction to
        the read side.  This is the serving hot path's producer API: cost
        is one small object plus one append, ~5x cheaper than recording
        the six spans eagerly."""
        entry = _PendingTree(
            trace_id, track or threading.current_thread().name, items)
        with self._lock:
            evicted = self._buf.append(entry)
            self._recorded += len(items)
            if evicted is not None:
                self._dropped += _entry_weight(evicted)

    # -- readout ------------------------------------------------------------
    def spans(self, trace_id: Optional[str] = None) -> List[Span]:
        """Snapshot of the buffer (oldest first), optionally filtered to
        one trace.  Pending trees materialize here (under the lock, so
        their span ids are minted exactly once)."""
        with self._lock:
            out: List[Span] = []
            for e in self._buf.items():
                if isinstance(e, Span):
                    out.append(e)
                else:
                    out.extend(e.expand(self))
        if trace_id is not None:
            out = [s for s in out if s.trace_id == trace_id]
        return out

    def drain(self) -> List[Span]:
        """Pop and return everything buffered — the cluster-worker shipping
        primitive (each span leaves the worker exactly once)."""
        with self._lock:
            out: List[Span] = []
            for e in self._buf.items():
                if isinstance(e, Span):
                    out.append(e)
                else:
                    out.extend(e.expand(self))
            self._buf.clear()
        return out

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._recorded = 0
            self._dropped = 0

    def ingest(self, spans: Iterable[Span], *, epoch: Optional[float] = None,
               track_prefix: Optional[str] = None) -> int:
        """Adopt spans recorded by another tracer (typically another
        process).  ``epoch`` is the foreign tracer's wall-clock anchor;
        span timestamps are re-based onto this tracer's timebase so one
        export renders an aligned timeline.  ``track_prefix`` namespaces
        the foreign tracks (``worker0/engine-0`` …).  Works regardless of
        ``self.enabled`` — ingest is recorder input, not a hot path."""
        shift = 0.0 if epoch is None else epoch - self.epoch
        n = 0
        for s in spans:
            track = s.track or "main"
            if track_prefix:
                track = f"{track_prefix}/{track}"
            self._record(Span(
                name=s.name, t0=s.t0 + shift, dur_s=s.dur_s,
                trace_id=s.trace_id, span_id=s.span_id,
                parent_id=s.parent_id, cat=s.cat, track=track,
                args=s.args))
            n += 1
        return n

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "enabled": self.enabled,
                "capacity": self.capacity,
                "buffered": sum(_entry_weight(e) for e in self._buf.items()),
                "recorded": self._recorded,
                "dropped": self._dropped,
            }

    # -- structure ----------------------------------------------------------
    def tree(self, trace_id: str) -> List[dict]:
        """Nested view of one trace: a list of root nodes, each
        ``{"name", "dur_ms", "args", "children": [...]}``."""
        spans = self.spans(trace_id)
        nodes = {s.span_id: {"name": s.name, "dur_ms": s.dur_s * 1e3,
                             "t0": s.t0, "args": s.args, "children": []}
                 for s in spans}
        roots = []
        for s in spans:
            node = nodes[s.span_id]
            parent = nodes.get(s.parent_id) if s.parent_id else None
            (parent["children"] if parent else roots).append(node)
        for node in nodes.values():
            node["children"].sort(key=lambda n: n["t0"])
        roots.sort(key=lambda n: n["t0"])
        return roots

    @staticmethod
    def render_tree(roots: List[dict], indent: int = 0) -> str:
        lines = []
        for node in roots:
            extra = ""
            if node["args"]:
                pairs = ", ".join(f"{k}={v}" for k, v in node["args"].items())
                extra = f"  [{pairs}]"
            lines.append(f"{'  ' * indent}{node['name']:<28s} "
                         f"{node['dur_ms']:8.3f} ms{extra}")
            if node["children"]:
                lines.append(Tracer.render_tree(node["children"], indent + 1))
        return "\n".join(lines)

    # -- export -------------------------------------------------------------
    def to_chrome(self) -> Dict[str, object]:
        """Chrome trace-event representation of the buffer: one ``ph:"X"``
        complete event per span plus ``ph:"M"`` metadata naming each
        track.  Tracks map to (pid, tid) rows — the local process is pid 0
        with one tid per thread; ingested ``prefix/...`` tracks get their
        own pid per prefix so Perfetto renders one lane per worker."""
        spans = self.spans()
        events: List[dict] = []
        pids: Dict[str, int] = {}
        tids: Dict[tuple, int] = {}
        t_base = min((s.t0 for s in spans), default=0.0)
        for s in spans:
            track = s.track or "main"
            group, _, lane = track.partition("/")
            if not lane:
                group, lane = "proc", track
            pid = pids.get(group)
            if pid is None:
                pid = pids[group] = len(pids)
                events.append({"name": "process_name", "ph": "M", "pid": pid,
                               "tid": 0, "args": {"name": group}})
            tid = tids.get((group, lane))
            if tid is None:
                tid = tids[(group, lane)] = sum(
                    1 for k in tids if k[0] == group)
                events.append({"name": "thread_name", "ph": "M", "pid": pid,
                               "tid": tid, "args": {"name": lane}})
            args = {"trace_id": s.trace_id, "span_id": s.span_id}
            if s.parent_id:
                args["parent_id"] = s.parent_id
            args.update({k: _jsonable(v) for k, v in s.args.items()})
            events.append({
                "name": s.name, "cat": s.cat, "ph": "X",
                "ts": (s.t0 - t_base) * 1e6, "dur": s.dur_s * 1e6,
                "pid": pid, "tid": tid, "args": args,
            })
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "producer": "repro_torch.obs",
                "epoch_unix_s": self.epoch + t_base,
            },
        }

    def export_chrome(self, path) -> Path:
        """Write the buffer as Chrome trace-event JSON; open the file at
        https://ui.perfetto.dev (or chrome://tracing)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with path.open("w") as f:
            json.dump(self.to_chrome(), f)
        return path


class _RingList:
    """Ring buffer over a plain list — append returns the entry it
    evicted, if any (the deque API hides evictions, and the drop counter
    is part of the flight-recorder contract).  Entries are ``Span``s or
    ``_PendingTree``s."""
    __slots__ = ("_cap", "_items", "_head")

    def __init__(self, capacity: int) -> None:
        self._cap = max(1, capacity)
        self._items: list = []
        self._head = 0

    def append(self, item):
        if len(self._items) < self._cap:
            self._items.append(item)
            return None
        evicted = self._items[self._head]
        self._items[self._head] = item
        self._head = (self._head + 1) % self._cap
        return evicted

    def items(self) -> list:
        return self._items[self._head:] + self._items[:self._head]

    def clear(self) -> None:
        self._items = []
        self._head = 0

    def __len__(self) -> int:
        return len(self._items)


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return str(v)


def validate_chrome(doc: dict) -> List[str]:
    """Schema check for an exported trace document; returns a list of
    problems (empty = valid).  Used by the smoke telemetry gate and the
    CLI ``--inspect`` mode."""
    problems: List[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "M"):
            problems.append(f"event {i}: unexpected ph {ph!r}")
            continue
        for key in ("name", "pid", "tid"):
            if key not in ev:
                problems.append(f"event {i}: missing {key!r}")
        if ph == "X":
            for key in ("ts", "dur"):
                if not isinstance(ev.get(key), (int, float)):
                    problems.append(f"event {i}: {key!r} not numeric")
    return problems


def _main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.trace",
        description="Trace a demo service run end to end and export "
                    "Chrome-trace JSON, or inspect an existing trace file.")
    ap.add_argument("--out", default="artifacts/trace/demo_trace.json",
                    help="output path for the Chrome-trace JSON")
    ap.add_argument("--requests", type=int, default=16,
                    help="demo requests to trace (default 16)")
    ap.add_argument("--inspect", metavar="FILE",
                    help="validate + summarize an existing trace file "
                         "instead of running the demo")
    args = ap.parse_args(argv)

    if args.inspect:
        with open(args.inspect) as f:
            doc = json.load(f)
        problems = validate_chrome(doc)
        events = [e for e in doc.get("traceEvents", ())
                  if isinstance(e, dict)]
        spans = [e for e in events if e.get("ph") == "X"]
        names: Dict[str, int] = {}
        for ev in spans:
            names[ev["name"]] = names.get(ev["name"], 0) + 1
        print(f"{args.inspect}: {len(spans)} spans, "
              f"{len(events) - len(spans)} metadata events")
        for name, n in sorted(names.items(), key=lambda kv: -kv[1]):
            print(f"  {n:6d}  {name}")
        for p in problems:
            print(f"  PROBLEM: {p}")
        return 1 if problems else 0

    # Demo: trace one service run on the sim backend.
    import numpy as np
    from repro_torch import obs, ual

    tracer = obs.Tracer(enabled=True)
    prev = obs.set_tracer(tracer)
    try:
        target = ual.Target.from_name("hycube", rows=4, cols=4,
                                      backend="sim")
        program = ual.Program.from_kernel(
            "gemm", n_banks=target.fabric.n_mem_ports)
        rng = np.random.default_rng(0)
        with ual.Service(max_batch=8, max_wait_ms=2.0) as svc:
            futs = [svc.submit(program, target, program.random_inputs(rng),
                               tenant=f"tenant{i % 2}")
                    for i in range(args.requests)]
            for fut in futs:
                fut.result(timeout=60.0)
        first = futs[0].info.get("trace", {})
        if first:
            print("request 0 breakdown:",
                  {k: round(v, 3) for k, v in first.items()
                   if isinstance(v, (int, float))})
            print(Tracer.render_tree(tracer.tree(first["trace_id"])))
        out = tracer.export_chrome(args.out)
        n = len(tracer.spans())
        print(f"wrote {n} spans -> {out} "
              f"(open at https://ui.perfetto.dev)")
    finally:
        obs.set_tracer(prev)
    return 0


if __name__ == "__main__":               # pragma: no cover
    raise SystemExit(_main())
