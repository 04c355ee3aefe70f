"""Typed metrics instruments and the process-wide registry.

Three instrument kinds — :class:`Counter` (monotonic), :class:`Gauge`
(point-in-time, optionally a read-through callable) and
:class:`Histogram` (bounded sample window with percentiles) — live in a
:class:`MetricsRegistry` keyed by dotted name.  Producers across the
stack (``ServiceMetrics``, the cuda engine cache, the mapping cache,
the cluster router) register into the same registry, so
``obs.registry().snapshot()`` is one JSON-schema view of the whole
process where there used to be four bespoke dicts.  The bespoke
``stats()`` surfaces keep their existing shapes — they now *read
through* these instruments instead of private counters.

Namespacing: each producer instance calls ``registry.namespace("service")``
and gets a unique prefix (``service``, ``service#1`` …) so two services in
one process never collide; ``Namespace.drop()`` removes the instruments on
shutdown so the registry never grows without bound.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "Namespace"]


def percentile(samples: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile of an unsorted sample list (None when
    empty) — the one percentile definition every surface shares, so the
    service, cluster merge and benches can't drift apart."""
    if not samples:
        return None
    xs = sorted(samples)
    idx = min(len(xs) - 1, max(0, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[idx]


class Counter:
    """Monotonic count (requests completed, samples executed …)."""
    kind = "counter"
    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> Dict[str, object]:
        v = self._value
        return {"type": "counter", "value": int(v) if v == int(v) else v}


class Gauge:
    """Point-in-time value.  Pass ``fn=`` for a read-through gauge that
    samples a live source (queue depth, cache size) at snapshot time."""
    kind = "gauge"
    __slots__ = ("name", "_value", "_fn")

    def __init__(self, name: str,
                 fn: Optional[Callable[[], float]] = None) -> None:
        self.name = name
        self._value = 0.0
        self._fn = fn

    def set(self, v: float) -> None:
        self._value = v

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:
                return float("nan")
        return self._value

    def snapshot(self) -> Dict[str, object]:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Bounded-window distribution: keeps the last ``window`` observations
    for percentiles plus lifetime count/total (so means survive window
    eviction).  ``samples()`` exposes the raw window — that is what the
    cluster merge ships between processes to compute *real* cluster
    percentiles instead of max-of-p99."""
    kind = "histogram"
    __slots__ = ("name", "window", "_buf", "_n", "_count", "_total",
                 "_max", "_lock")

    def __init__(self, name: str, window: int = 4096) -> None:
        self.name = name
        self.window = max(1, int(window))
        self._buf: List[float] = []
        self._n = 0                      # ring cursor
        self._count = 0
        self._total = 0.0
        self._max: Optional[float] = None
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            if len(self._buf) < self.window:
                self._buf.append(v)
            else:
                self._buf[self._n % self.window] = v
            self._n += 1
            self._count += 1
            self._total += v
            if self._max is None or v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def total(self) -> float:
        return self._total

    def samples(self) -> List[float]:
        with self._lock:
            return list(self._buf)

    def mean(self) -> Optional[float]:
        return (self._total / self._count) if self._count else None

    def percentile(self, q: float) -> Optional[float]:
        return percentile(self.samples(), q)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            xs = list(self._buf)
            count, total, mx = self._count, self._total, self._max
        return {
            "type": "histogram",
            "count": count,
            "mean": (total / count) if count else None,
            "p50": percentile(xs, 50),
            "p99": percentile(xs, 99),
            "max": mx,
            "window": len(xs),
        }


class Namespace:
    """A producer's private prefix inside the registry: instrument names
    are ``<prefix>.<name>``, and ``drop()`` removes them all when the
    producer shuts down."""

    def __init__(self, registry: "MetricsRegistry", prefix: str) -> None:
        self.registry = registry
        self.prefix = prefix

    def _full(self, name: str) -> str:
        return f"{self.prefix}.{name}"

    def counter(self, name: str) -> Counter:
        return self.registry.counter(self._full(name))

    def gauge(self, name: str,
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        return self.registry.gauge(self._full(name), fn)

    def histogram(self, name: str, window: int = 4096) -> Histogram:
        return self.registry.histogram(self._full(name), window)

    def drop(self) -> None:
        self.registry.drop_prefix(self.prefix)


class MetricsRegistry:
    """Dotted-name instrument registry with get-or-create semantics.

    Besides owned instruments, external aggregates can attach as
    *sources* — named callables sampled at snapshot time
    (``register_source("engine", engine.stats)``) — which is how the
    engine cache, mapping cache and router appear in the unified view
    without rewriting their internals.
    """

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._instruments: Dict[str, object] = {}
        self._sources: Dict[str, Callable[[], object]] = {}
        self._ns_counts: Dict[str, int] = {}
        self.created_at = time.time()

    def _get_or_create(self, name: str, kind, *args):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = kind(name, *args)
            elif not isinstance(inst, kind):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).kind}, requested {kind.kind}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str,
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        g = self._get_or_create(name, Gauge)
        if fn is not None:
            g._fn = fn
        return g

    def histogram(self, name: str, window: int = 4096) -> Histogram:
        return self._get_or_create(name, Histogram, window)

    def get(self, name: str):
        return self._instruments.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._instruments)

    # -- namespaces ---------------------------------------------------------
    def namespace(self, base: str) -> Namespace:
        """A unique prefix for one producer instance: first caller gets
        ``base``, later ones ``base#1``, ``base#2`` …"""
        with self._lock:
            n = self._ns_counts.get(base, 0)
            self._ns_counts[base] = n + 1
            prefix = base if n == 0 else f"{base}#{n}"
        return Namespace(self, prefix)

    def drop_prefix(self, prefix: str) -> int:
        dot = prefix + "."
        with self._lock:
            doomed = [k for k in self._instruments
                      if k == prefix or k.startswith(dot)]
            for k in doomed:
                del self._instruments[k]
            for k in [k for k in self._sources
                      if k == prefix or k.startswith(dot)]:
                del self._sources[k]
                doomed.append(k)
        return len(doomed)

    # -- sources ------------------------------------------------------------
    def register_source(self, name: str, fn: Callable[[], object], *,
                        replace: bool = False) -> None:
        with self._lock:
            if name in self._sources and not replace:
                raise ValueError(f"source {name!r} already registered")
            self._sources[name] = fn

    def unregister_source(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)

    # -- unified view -------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """One JSON-serializable view of everything registered:
        ``{"metrics": {name: typed-dict}, "sources": {name: value}}``."""
        with self._lock:
            instruments = dict(self._instruments)
            sources = dict(self._sources)
        out: Dict[str, object] = {
            "metrics": {name: inst.snapshot()
                        for name, inst in sorted(instruments.items())},
            "sources": {},
            "uptime_s": time.time() - self.created_at,
        }
        for name, fn in sorted(sources.items()):
            try:
                out["sources"][name] = fn()
            except Exception as e:                # a dead source must not
                out["sources"][name] = {          # poison the whole view
                    "error": f"{type(e).__name__}: {e}"}
        return out
