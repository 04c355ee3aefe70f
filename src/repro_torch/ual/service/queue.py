"""Admission layer of the execution service: requests, futures, the queue.

A ``Request`` is one single-sample execution wish: a ``Program``, a
``Target``, the named input arrays, and admission metadata (tenant,
submit time, absolute deadline).  Requests are grouped by ``Request.key``
— ``(program.digest, target.digest, backend, n_iters)`` — the exact
compatibility class that can ride one ``run_batch`` sweep: same lowered
artifact, same backend, same trip count.

The caller gets a ``Response`` back immediately: a minimal Future —
``result(timeout)`` blocks for the outputs, ``done()``/``exception()``
inspect without blocking, and admission-control verdicts surface as
``ServiceRejected`` (``response.rejected`` / ``response.reason``) so an
overloaded or expired request is a *value*, not a lost thread.

``StreamResponse`` is the handle for ``submit_stream``: one chunked
request pipelined through a warm trace — member ``Response`` futures per
sample, ``chunks()`` for streaming consumption, and an aggregated stream
``info`` (overlap, chunks, throughput).

``AdmissionQueue`` is the thread-safe FIFO between ``submit()`` and the
dispatcher.  It is deliberately unbounded here — the *service* enforces
the bound by counting in-flight requests and rejecting at submit time
(``queue-full``), which keeps the overload contract in one place instead
of splitting it between two queues.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.ual.program import Program
from repro_torch.ual.target import Target


class ServiceRejected(RuntimeError):
    """The service declined a request; ``reason`` says why.

    Raised out of ``Response.result()`` for admission-control verdicts:
    ``queue-full`` (backpressure), ``deadline-exceeded`` (the request
    aged out before execution), ``compile-failed`` (its key cannot map),
    ``verifier-error`` (its key maps but the lowered config fails static
    verification — the detail carries the ``CheckReport`` summary),
    ``shutdown`` (the service stopped with the request still queued).
    """

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"{reason}: {detail}" if detail else reason)
        self.reason = reason


class Response:
    """Future-style handle for one submitted request.

    ``result(timeout)`` blocks until the micro-batch carrying the request
    has executed, then returns the named output arrays (same shape as
    ``Executable.run``) or raises the failure.  ``info`` carries per-call
    execution metadata once done (``latency_ms``, ``batch`` — the
    achieved micro-batch size, ``throughput_sps`` of the sweep).
    """

    __slots__ = ("_event", "_out", "_exc", "info", "_cb_lock", "_callbacks")

    def __init__(self) -> None:
        self._event = threading.Event()
        self._out: Optional[Dict[str, np.ndarray]] = None
        self._exc: Optional[BaseException] = None
        self.info: Dict[str, object] = {}
        self._cb_lock = threading.Lock()
        self._callbacks: List = []

    def done(self) -> bool:
        return self._event.is_set()

    @property
    def rejected(self) -> bool:
        """Whether admission control declined this request (vs. a normal
        completion or an execution error)."""
        return isinstance(self._exc, ServiceRejected)

    @property
    def reason(self) -> Optional[str]:
        """The rejection reason, or None for accepted requests."""
        return self._exc.reason if self.rejected else None

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        if not self._event.wait(timeout):
            raise TimeoutError("response not ready")
        return self._exc

    def result(self, timeout: Optional[float] = None
               ) -> Dict[str, np.ndarray]:
        if not self._event.wait(timeout):
            raise TimeoutError("response not ready")
        if self._exc is not None:
            raise self._exc
        return self._out

    def add_done_callback(self, fn) -> None:
        """Run ``fn(self)`` once this response resolves — immediately if
        it already has.  Callbacks fire on the resolving thread (or the
        caller's, for an already-done response), so keep them short; the
        cluster front-end's workers use this to forward results without
        one blocked thread per in-flight request.  Registration and
        resolution are serialized under a lock, so a callback is invoked
        exactly once however the two race."""
        with self._cb_lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    # -- resolution (service-side) -------------------------------------------
    def _resolve(self, out: Optional[Dict[str, np.ndarray]] = None,
                 exc: Optional[BaseException] = None,
                 **info: object) -> None:
        self.info.update(info)
        self._out = out
        self._exc = exc
        with self._cb_lock:
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            fn(self)


class StreamResponse:
    """Handle for one ``Service.submit_stream`` call: a chunked request
    pipelined through a single warm trace.

    Wraps one member ``Response`` per sample.  ``chunks()`` yields lists
    of named-output dicts chunk-by-chunk as they drain from the engine
    (earlier chunks are consumable while later ones still compute);
    ``results()`` blocks for the flat list.  Admission verdicts surface
    exactly like ``Response``: ``rejected`` / ``reason`` report the first
    rejection among the members (all-or-nothing at submit time, per-
    request ``deadline-exceeded`` afterwards).

    ``info`` aggregates the executed spans' stream summaries —
    ``stream_chunks``, ``samples``, ``overlap_frac`` (wall-weighted),
    ``throughput_sps`` — and grows as spans finish; read it after
    ``results()`` for the final numbers.
    """

    __slots__ = ("_responses", "chunk", "_lock", "_spans")

    def __init__(self, responses: List[Response], chunk: int) -> None:
        self._responses = list(responses)
        self.chunk = max(1, int(chunk))
        self._lock = threading.Lock()
        self._spans: List[Dict[str, object]] = []

    def __len__(self) -> int:
        return len(self._responses)

    @property
    def responses(self) -> List[Response]:
        """The member futures, submission order (one per sample)."""
        return list(self._responses)

    def done(self) -> bool:
        return all(r.done() for r in self._responses)

    @property
    def rejected(self) -> bool:
        return any(r.rejected for r in self._responses)

    @property
    def reason(self) -> Optional[str]:
        for r in self._responses:
            if r.rejected:
                return r.reason
        return None

    def chunks(self, timeout: Optional[float] = None):
        """Yield ``chunk``-sized lists of output dicts as they resolve,
        submission order — the streaming consumption loop."""
        group: List[Response] = []
        for r in self._responses:
            group.append(r)
            if len(group) >= self.chunk:
                yield [g.result(timeout) for g in group]
                group = []
        if group:
            yield [g.result(timeout) for g in group]

    def results(self, timeout: Optional[float] = None
                ) -> List[Dict[str, np.ndarray]]:
        """Block for every sample; the flat list, submission order."""
        return [r.result(timeout) for r in self._responses]

    # -- service-side ---------------------------------------------------------
    def _merge_span(self, summary: Dict[str, object]) -> None:
        """Record one executed span's stream summary (worker thread)."""
        with self._lock:
            self._spans.append(dict(summary))

    @property
    def info(self) -> Dict[str, object]:
        """Aggregate stream summary over the spans executed so far."""
        with self._lock:
            spans = list(self._spans)
        n_chunks = sum(int(s.get("stream_chunks", 0)) for s in spans)
        samples = sum(int(s.get("batch", s.get("samples", 0)))
                      for s in spans)
        wall = sum(float(s.get("wall_s", 0.0)) for s in spans)
        weighted = [(float(s["overlap_frac"]), float(s.get("wall_s", 0.0)))
                    for s in spans if s.get("overlap_frac") is not None]
        wsum = sum(w for _, w in weighted)
        overlap = (round(sum(o * w for o, w in weighted) / wsum, 4)
                   if wsum > 0 else
                   (round(sum(o for o, _ in weighted) / len(weighted), 4)
                    if weighted else None))
        return {
            "spans": len(spans),
            "stream_chunks": n_chunks,
            "samples": samples,
            "wall_s": round(wall, 6),
            "overlap_frac": overlap,
            "throughput_sps": (round(samples / wall, 1) if wall > 0
                               else None),
        }


class RequestTrace:
    """Per-request trace stamps, attached to a ``Request`` only while the
    process tracer is enabled (``repro_torch.obs``).

    A request crosses three threads (caller -> dispatcher -> worker), so
    its spans cannot nest as context managers; instead each stage stamps
    a raw ``perf_counter`` here and the worker materializes the span tree
    retrospectively at resolve time.  Stage boundaries:

        t_submit  admission (``Service.submit``)
        t_pulled  dispatcher pulled it off the admission FIFO
        t_emit    its micro-batch left the coalescer (flush/steal)
        t_exec0   worker started the engine sweep
        t_exec1   sweep done (outputs materialized)

    and the derived breakdown on ``fut.info["trace"]`` is
    ``queue_ms`` (submit -> pulled), ``coalesce_ms`` (pulled -> exec
    start: coalescer wait + batch-FIFO/dispatch wait), ``exec_ms``
    (sweep) and ``resolve_ms`` (sweep end -> future resolved), so
    queue + coalesce + exec sums to the end-to-end latency exactly.
    """

    __slots__ = ("trace_id", "t_submit", "t_pulled", "t_emit",
                 "t_exec0", "t_exec1", "exec_args")

    def __init__(self, trace_id: str, t_submit: float) -> None:
        self.trace_id = trace_id
        self.t_submit = t_submit
        self.t_pulled: Optional[float] = None
        self.t_emit: Optional[float] = None
        self.t_exec0: Optional[float] = None
        self.t_exec1: Optional[float] = None
        self.exec_args: Dict[str, object] = {}


@dataclass
class Request:
    """One admitted single-sample request, en route to a micro-batch."""

    tenant: str
    program: Program
    target: Target
    mem: Dict[str, np.ndarray]
    n_iters: int
    t_submit: float                       # perf_counter at admission
    deadline: Optional[float] = None      # absolute perf_counter, or None
    response: Response = field(default_factory=Response)
    trace: Optional[RequestTrace] = None  # set only while tracing is on

    @property
    def key(self) -> Tuple[str, str, str, int]:
        """The batching compatibility class: requests sharing this key
        execute on one lowered artifact in one ``run_batch`` sweep."""
        return (self.program.digest, self.target.digest,
                self.target.backend, self.n_iters)

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline


class AdmissionQueue:
    """Thread-safe FIFO between ``submit()`` and the dispatcher.

    ``get(timeout)`` returns None on timeout so the dispatcher can wake
    to flush aged micro-batches even when no new requests arrive.
    """

    def __init__(self) -> None:
        self._dq: deque = deque()
        self._cond = threading.Condition()

    def put(self, item: object) -> None:
        with self._cond:
            self._dq.append(item)
            self._cond.notify()

    def get(self, timeout: Optional[float] = None) -> Optional[object]:
        with self._cond:
            if timeout is None:
                while not self._dq:
                    self._cond.wait()
                return self._dq.popleft()
            deadline = time.perf_counter() + timeout
            while not self._dq:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    return None
                self._cond.wait(remaining)
            return self._dq.popleft()

    def drain(self) -> List[object]:
        """Non-blocking: everything currently queued, FIFO order."""
        with self._cond:
            items = list(self._dq)
            self._dq.clear()
            return items

    def __len__(self) -> int:
        with self._cond:
            return len(self._dq)
