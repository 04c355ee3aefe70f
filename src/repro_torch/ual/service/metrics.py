"""The service's metrics surface: what ``Service.stats()`` reports.

The recording API is unchanged (``record_batch``, ``record_completed``,
``record_reject``, ``record_error``, ``record_stream_span``,
``snapshot``) but the storage now lives in the process-wide metrics
registry (``repro_torch.obs``): every instance claims a unique ``service``
namespace and registers typed instruments, so ``obs.registry().snapshot()``
shows this service alongside the engine cache, the mapping cache and the
cluster router in one JSON schema.  ``snapshot()`` *reads through* those
instruments and keeps its historical dict shape.

Latency and batch-size samples live in bounded histogram windows so a
long-running service reports recent behavior at constant memory;
counters (completed, samples, rejects by reason, per-tenant totals) are
cumulative.  ``snapshot()`` folds the samples into the serving numbers
that matter: p50/p99 request latency (submit -> resolve), achieved
micro-batch size (mean/max — *the* dynamic-batching health number: 1.0
means the coalescer buys nothing), samples/s two ways (wall-clock
service throughput since start, and engine throughput over sweep wall
time alone), queue depth, and rejects keyed by reason.

Mid-sweep batch errors are attributed per tenant: every tenant row
carries an ``"errors"`` key next to ``"completed"``/``"rejected"``
(``record_error`` takes the failed batch's tenant names, not a bare
count, so a multi-tenant batch failure shows up on every tenant it
actually hit).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, List, Optional

from repro_torch import obs


class ServiceMetrics:
    def __init__(self, window: int = 4096,
                 registry: Optional[obs.MetricsRegistry] = None) -> None:
        reg = registry if registry is not None else obs.registry()
        ns = self._ns = reg.namespace("service")
        self.namespace = ns.prefix
        self._completed = ns.counter("completed")
        self._samples = ns.counter("samples")
        self._batches = ns.counter("batches")
        self._exec_wall = ns.counter("exec_wall_s")
        self._errors = ns.counter("errors")
        self._lat_ms = ns.histogram("latency_ms", window)
        self._batch_sizes = ns.histogram("batch_size", window)
        self._stream_spans = ns.counter("stream.spans")
        self._stream_chunks = ns.counter("stream.chunks")
        self._stream_samples = ns.counter("stream.samples")
        self._stream_wall = ns.counter("stream.wall_s")
        self._overlap = ns.histogram("stream.overlap_frac", window)
        # circuit-breaker activity (repro_torch.ual.service.breaker): trips
        # land here so the registry view shows degradation cluster-wide
        self._breaker_trips = ns.counter("breaker.trips")
        self._degraded_samples = ns.counter("breaker.degraded_samples")
        # per-reason / per-tenant breakdowns stay plain dicts (dynamic
        # key sets; one lock, cheap updates)
        self._lock = threading.Lock()
        self.rejects: Dict[str, int] = {}
        self.tenants: Dict[str, Dict[str, int]] = {}
        self._t0 = time.perf_counter()

    def close(self) -> None:
        """Drop this instance's instruments from the registry (call on
        service shutdown so the registry never grows without bound).
        The instruments themselves stay usable — ``snapshot()`` after
        ``close()`` still works, it just no longer appears in the
        registry view."""
        self._ns.drop()

    def _tenant(self, tenant: str) -> Dict[str, int]:
        return self.tenants.setdefault(
            tenant, {"completed": 0, "rejected": 0, "errors": 0})

    def record_batch(self, size: int, wall_s: float) -> None:
        self._batches.inc()
        self._samples.inc(size)
        self._exec_wall.inc(wall_s)
        self._batch_sizes.observe(size)

    def record_completed(self, tenant: str, latency_s: float) -> None:
        self._completed.inc()
        self._lat_ms.observe(latency_s * 1e3)
        with self._lock:
            self._tenant(tenant)["completed"] += 1

    def record_reject(self, tenant: str, reason: str) -> None:
        with self._lock:
            self.rejects[reason] = self.rejects.get(reason, 0) + 1
            self._tenant(tenant)["rejected"] += 1

    def record_error(self, tenants: Iterable[str]) -> None:
        """One failed batch: ``tenants`` is the tenant name of every
        request that rode it (duplicates count — two failed requests from
        one tenant are two errors)."""
        tenants = list(tenants)
        self._errors.inc(len(tenants))
        with self._lock:
            for t in tenants:
                self._tenant(t)["errors"] += 1

    def record_breaker_trip(self) -> None:
        """The breaker tripped (or re-opened) one class."""
        self._breaker_trips.inc()

    def record_degraded(self, samples: int) -> None:
        """One sweep of ``samples`` requests executed on a fallback
        backend instead of its class's primary."""
        self._degraded_samples.inc(samples)

    def record_stream_span(self, chunks: int, samples: int, wall_s: float,
                           overlap: object = None) -> None:
        """One executed ``submit_stream`` span: its samples and engine
        time count toward the service-wide throughput numbers; the span
        itself is tracked separately (not in the micro-batch-size window
        — a pipelined span is not a coalesced batch)."""
        self._stream_spans.inc()
        self._stream_chunks.inc(chunks)
        self._stream_samples.inc(samples)
        self._stream_wall.inc(wall_s)
        self._samples.inc(samples)
        self._exec_wall.inc(wall_s)
        if overlap is not None:
            self._overlap.observe(float(overlap))

    # -- readout ------------------------------------------------------------
    @property
    def completed(self) -> int:
        return int(self._completed.value)

    @property
    def errors(self) -> int:
        return int(self._errors.value)

    def latency_window_ms(self) -> List[float]:
        """The raw bounded latency window (ms) — what a cluster worker
        ships upstream so the parent can merge *samples* into real
        cluster percentiles instead of taking a max of per-worker p99s."""
        return self._lat_ms.samples()

    def snapshot(self, queue_depth: int = 0) -> Dict[str, object]:
        lat = self._lat_ms.samples()
        sizes = self._batch_sizes.samples()
        overlap = self._overlap.samples()
        samples = self._samples.value
        exec_wall = self._exec_wall.value
        stream_samples = self._stream_samples.value
        stream_wall = self._stream_wall.value
        elapsed = time.perf_counter() - self._t0
        with self._lock:
            rejects = dict(self.rejects)
            tenants = {t: dict(c) for t, c in self.tenants.items()}
        p50 = obs.percentile(lat, 50)
        p99 = obs.percentile(lat, 99)
        return {
            "completed": int(self._completed.value),
            "rejected": sum(rejects.values()),
            "rejects": rejects,
            "errors": int(self._errors.value),
            "queue_depth": queue_depth,
            "batches": int(self._batches.value),
            "p50_ms": round(p50, 3) if p50 is not None else None,
            "p99_ms": round(p99, 3) if p99 is not None else None,
            "mean_batch": (round(sum(sizes) / len(sizes), 2)
                           if sizes else None),
            "max_batch": int(max(sizes)) if sizes else None,
            "samples_per_s": (round(samples / elapsed, 1)
                              if elapsed > 0 else 0.0),
            "exec_samples_per_s": (round(samples / exec_wall, 1)
                                   if exec_wall > 0 else 0.0),
            "uptime_s": round(elapsed, 3),
            "tenants": tenants,
            "stream": {
                "spans": int(self._stream_spans.value),
                "chunks": int(self._stream_chunks.value),
                "samples": int(stream_samples),
                "overlap_frac": (round(sum(overlap) / len(overlap), 4)
                                 if overlap else None),
                "samples_per_s": (round(stream_samples / stream_wall, 1)
                                  if stream_wall > 0 else 0.0),
            },
        }
