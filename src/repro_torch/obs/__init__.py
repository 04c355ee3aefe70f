"""Process-wide telemetry: flight-recorder tracing + a unified metrics
registry (see ``docs/observability.md``).

Two singletons, both swappable for tests::

    from repro_torch import obs

    obs.tracer().enable()              # or REPRO_TRACE=1 in the env
    ...                                # run traced work
    obs.tracer().export_chrome("trace.json")   # open in Perfetto

    obs.registry().snapshot()          # every instrument + source, one dict

Tracing is off by default and a disabled tracer is a strict no-op on the
hot paths (``tracer().enabled`` is the one attribute producers check).
Set ``REPRO_TRACE=1`` to start the process with tracing on — that is also
how ``ClusterService(trace=True)`` turns it on inside spawned workers.
"""
from __future__ import annotations

import os
from typing import Optional

from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                                     Namespace, percentile)
from repro_torch.obs.trace import Span, Tracer, validate_chrome

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Namespace",
    "Span", "Tracer", "enable_tracing", "percentile", "registry",
    "set_registry", "set_tracer", "tracer", "validate_chrome",
]

TRACE_ENV = "REPRO_TRACE"

_tracer: Optional[Tracer] = None
_registry: Optional[MetricsRegistry] = None


def tracer() -> Tracer:
    """The process-wide tracer (created on first use; enabled at birth
    when ``REPRO_TRACE`` is a truthy env value)."""
    global _tracer
    if _tracer is None:
        on = os.environ.get(TRACE_ENV, "").strip().lower()
        _tracer = Tracer(enabled=on not in ("", "0", "false", "off"))
    return _tracer


def set_tracer(new: Optional[Tracer]) -> Tracer:
    """Swap the process-wide tracer (tests, benches); returns the previous
    one so callers can restore it."""
    global _tracer
    prev = tracer()
    _tracer = new
    return prev


def enable_tracing(on: bool = True) -> Tracer:
    """Convenience: flip the global tracer's enabled flag."""
    t = tracer()
    t.enabled = bool(on)
    return t


def registry() -> MetricsRegistry:
    """The process-wide metrics registry (created on first use)."""
    global _registry
    if _registry is None:
        _registry = MetricsRegistry()
    return _registry


def set_registry(new: Optional[MetricsRegistry]) -> MetricsRegistry:
    """Swap the process-wide registry (tests); returns the previous one."""
    global _registry
    prev = registry()
    _registry = new
    return prev
