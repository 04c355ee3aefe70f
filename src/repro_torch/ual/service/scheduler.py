"""``Service`` — queue -> coalesce -> batched sweep.

The serving layer the ROADMAP's north star asks for: callers submit
*single-sample* requests and the platform — not each user — assembles the
micro-batches that saturate the vectorized engines.  Three thread roles
share the work:

  * **submit()** (caller threads) — admission control: bound the
    in-flight count (``queue-full`` rejection beats unbounded memory),
    stamp tenant + deadline, hand a ``Response`` future back,
  * **dispatcher** (one thread) — pull admitted requests into the
    ``Coalescer``; dispatch a micro-batch when a compatibility bucket
    fills to ``max_batch`` or its oldest request has waited
    ``max_wait_ms``, whichever first,
  * **workers** (``workers`` threads) — resolve the batch's shared warm
    ``Executable`` (compiled through the mapping cache: a cold tenant
    pays one mapping + one lowering, every later request rides the
    artifact), drop requests whose deadline passed, run ONE
    ``run_batch`` sweep, resolve every future.

Executables are shared across workers — safe because execution info is
returned per call (``Executable.run_batch_with_info``), never read back
through ``last_info``.  ``stats()`` is the observability surface:
p50/p99 latency, achieved batch size, samples/s, queue depth, rejects by
reason, plus the mapping cache's aggregate view.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.analysis.verifier import VerifyError
from repro_torch.ual import faults
from repro_torch.ual.backends import get_backend
from repro_torch.ual.cache import MappingCache, default_cache
from repro_torch.ual.compiler import compile as ual_compile
from repro_torch.ual.engine import default_engine
from repro_torch.ual.executable import Executable
from repro_torch.ual.program import Program
from repro_torch.ual.service.breaker import CircuitBreaker
from repro_torch.ual.service.coalescer import Coalescer
from repro_torch.ual.service.metrics import ServiceMetrics
from repro_torch.ual.service.queue import (AdmissionQueue, Request, RequestTrace,
                                     Response, ServiceRejected,
                                     StreamResponse)
from repro_torch.ual.target import Target

_STOP = object()


class _StreamSpan:
    """A bounded run of one stream's chunks, riding the admission FIFO as
    a single item.  Spans are the anti-monopolization unit: a long
    ``submit_stream`` request is cut into spans of at most ``span``
    chunks, so other tenants' micro-batches interleave between them in
    FIFO order instead of waiting out the whole stream."""

    __slots__ = ("requests", "chunk", "stream")

    def __init__(self, requests: List[Request], chunk: int,
                 stream: StreamResponse) -> None:
        self.requests = requests
        self.chunk = chunk
        self.stream = stream

    @property
    def key(self):
        return self.requests[0].key

#: dispatcher wake-up period while the coalescer is empty (no deadline to
#: honor — this only bounds how fast a shutdown sentinel is noticed)
_IDLE_TICK_S = 0.05


class Service:
    """Dynamic-batching execution service over the UAL.

        svc = ual.Service(max_batch=32, max_wait_ms=5)
        fut = svc.submit(program, target, A=a, B=b, tenant="gemm-app")
        out = fut.result(timeout=30)      # named arrays, like exe.run
        print(svc.stats())                # p50/p99, batch size, samples/s

        sr = svc.submit_stream(program, target, mems, tenant="bulk")
        for outs in sr.chunks(timeout=30):    # chunks drain while later
            consume(outs)                     # ones still compute
        sr.info["overlap_frac"]           # aggregated stream summary
        svc.shutdown()

    ``submit_stream`` is the bulk path: one tenant's chunked request
    pipelined through a single warm trace (the engine's double-buffered
    streaming mode), cut into bounded *spans* that interleave with other
    tenants' micro-batches in the admission FIFO — streaming throughput
    without coalescer monopolization.  Stream activity is reported under
    ``stats()["stream"]``.

    ``max_queue`` bounds admitted-but-unexecuted requests: past it,
    ``submit`` returns an already-rejected future (``queue-full``)
    instead of growing memory.  Deadlines (per request, per tenant via
    ``deadlines_ms``, or service-wide via ``default_deadline_ms``) drop
    requests that aged out before execution (``deadline-exceeded``).

    **Graceful degradation**: micro-batches on degradable backends run
    under a per-class circuit breaker (``repro_torch.ual.service.breaker``).
    After ``breaker_threshold`` consecutive primary-backend exec
    failures a class trips to its bit-exact fallback (``cuda`` or
    ``torch`` -> ``sim``: all consume the same lowered artifact); a
    failed sweep is
    also retried in place on the fallback, so callers see degraded
    latency (``fut.info["degraded_to"]``), not errors.  After
    ``breaker_cooldown_s`` a single half-open probe tries the primary
    again and restores the class on success.  ``stats()["breaker"]``
    reports per-class state; ``breaker_threshold=0`` disables the
    breaker.

    **Replicated mode** (``replicas > 1`` or ``devices=...``): worker
    threads become ``ReplicaSlot``s behind a ``Router``
    (``repro_torch.ual.cluster.replica``) — flush-ready micro-batches go to
    the least-loaded slot (class-affinity tiebreak), an idle slot steals
    the oldest batch from the most-loaded sibling, and the dispatcher
    additionally flushes a *partial* coalescer bucket early when a
    replica idles (after ``max_wait_ms / 4`` of bucket age — batching
    only pays while capacity is busy).  ``devices`` pins slot ``i`` to
    ``devices[i]``; backends advertising ``supports_device`` (``cuda``,
    ``torch``) then execute each slot's sweeps on its own device through
    device-pinned engines.  ``workers`` is superseded by ``replicas`` in
    this mode (one thread per slot).  ``stats()["router"]`` reports
    per-replica samples/s, routing decisions and steal counts.
    """

    def __init__(self, max_batch: int = 32, max_wait_ms: float = 2.0,
                 max_queue: int = 1024, workers: int = 1,
                 replicas: int = 1, devices: Optional[Sequence] = None,
                 cache: Optional[MappingCache] = None,
                 default_deadline_ms: Optional[float] = None,
                 deadlines_ms: Optional[Dict[str, float]] = None,
                 warmup_buckets: Optional[Sequence[int]] = None,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 5.0,
                 breaker_fallbacks: Optional[Dict[str, str]] = None,
                 start: bool = True) -> None:
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if devices is not None and replicas == 1:
            replicas = len(list(devices))
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.max_queue = max_queue
        self.replicas = replicas
        self.default_deadline_ms = default_deadline_ms
        self.deadlines_ms = dict(deadlines_ms or {})
        self.warmup_buckets = warmup_buckets
        self._cache = cache
        #: per-class circuit breaker over degradable backends (cuda and
        #: torch -> sim by default — same lowered artifact, bit-exact fallback);
        #: breaker_threshold=0 disables the breaker entirely
        self._breaker: Optional[CircuitBreaker] = (
            CircuitBreaker(breaker_threshold, breaker_cooldown_s,
                           breaker_fallbacks)
            if breaker_threshold > 0 else None)

        if replicas > 1 or devices is not None:
            from repro_torch.ual.cluster.replica import Router
            self._router: Optional[object] = Router(replicas,
                                                    devices=devices)
            self.n_workers = replicas       # one thread per slot
        else:
            self._router = None
            self.n_workers = workers
        #: minimum bucket age before idle capacity may flush it early
        self._steal_age_s = (max_wait_ms / 1e3) * 0.25

        self._admission = AdmissionQueue()
        self._coalescer = Coalescer(max_batch, max_wait_ms / 1e3)
        self._batches = AdmissionQueue()
        self._metrics = ServiceMetrics()

        self._lock = threading.Lock()
        self._pending = 0            # admitted, not yet handed to a worker
        self._closed = False
        self._started = False
        self._exes: Dict[Tuple[str, str, str, int], Executable] = {}
        self._threads: List[threading.Thread] = []
        if start:
            self.start()

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "Service":
        # threads are created, started AND recorded under the lock:
        # a shutdown() racing this sees either no service at all or the
        # complete thread list, never a half-built one
        with self._lock:
            if self._started or self._closed:
                return self
            self._started = True
            d = threading.Thread(target=self._dispatch_loop,
                                 name="ual-service-dispatch", daemon=True)
            d.start()
            self._threads.append(d)
            for i in range(self.n_workers):
                w = threading.Thread(target=self._worker_loop, args=(i,),
                                     name=f"ual-service-worker-{i}",
                                     daemon=True)
                w.start()
                self._threads.append(w)
            if self._router is not None:
                # replicated mode: the router's per-replica stats join
                # the unified registry view next to this service's
                # instruments (dropped again on shutdown)
                obs.registry().register_source(
                    f"{self._metrics.namespace}.router",
                    self._router.stats, replace=True)
        return self

    def shutdown(self, timeout: Optional[float] = None) -> None:
        """Stop admitting, flush every pending micro-batch, join threads.

        Pending requests on a never-started service are rejected
        (``shutdown``) rather than left unresolved.
        """
        with self._lock:
            if self._closed:
                return
            self._closed = True
            started = self._started
        if not started:
            for item in self._admission.drain():
                reqs = (item.requests if isinstance(item, _StreamSpan)
                        else [item])
                with self._lock:
                    self._pending -= len(reqs)
                for req in reqs:
                    self._finish_rejected(req, "shutdown",
                                          "service stopped before execution")
            self._release_registry()
            return
        # the dispatcher enqueues the worker stop sentinels itself, after
        # its final flush — so flushed batches always precede the
        # sentinels in the batch FIFO even if this join times out early
        self._admission.put(_STOP)
        for t in self._threads:
            t.join(timeout)
        self._release_registry()

    def _release_registry(self) -> None:
        """Drop this service's instruments (and router source) from the
        process-wide registry — ``stats()`` keeps working afterwards, the
        registry just stops listing a dead service."""
        if self._router is not None:
            obs.registry().unregister_source(
                f"{self._metrics.namespace}.router")
        self._metrics.close()

    def __enter__(self) -> "Service":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- admission ------------------------------------------------------------
    def submit(self, program: Program, target: Target,
               mem: Optional[Dict[str, np.ndarray]] = None, *,
               n_iters: Optional[int] = None, tenant: str = "default",
               deadline_ms: Optional[float] = None,
               **named: np.ndarray) -> Response:
        """Admit one single-sample request; returns a ``Response`` future.

        Arrays go in ``mem`` or as keywords (like ``Executable.run``).
        Malformed arrays raise here, immediately — a typo is a caller
        bug, not an overload, and must not poison a micro-batch.
        Overload and shutdown come back as rejected futures.
        """
        arrays = dict(mem or {})
        arrays.update(named)
        program.check_arrays(arrays)
        now = time.perf_counter()
        dl_ms = deadline_ms
        if dl_ms is None:
            dl_ms = self.deadlines_ms.get(tenant, self.default_deadline_ms)
        req = Request(tenant=tenant, program=program, target=target,
                      mem=arrays, n_iters=(n_iters if n_iters is not None
                                           else program.n_iters),
                      t_submit=now,
                      deadline=(now + dl_ms / 1e3 if dl_ms is not None
                                else None))
        tr = obs.tracer()
        if tr.enabled:
            req.trace = RequestTrace(tr.new_trace_id(), now)
        with self._lock:
            if self._closed:
                return self._finish_rejected(req, "shutdown",
                                             "service is shut down")
            if self._pending >= self.max_queue:
                return self._finish_rejected(
                    req, "queue-full",
                    f"{self._pending} requests in flight "
                    f"(max_queue={self.max_queue})")
            self._pending += 1
            # enqueue under the lock: shutdown() sets _closed under this
            # same lock before it sends the dispatcher its stop sentinel,
            # so an admitted request always precedes the sentinel in the
            # FIFO and can never be stranded unresolved by a racing stop
            self._admission.put(req)
        return req.response

    def submit_stream(self, program: Program, target: Target,
                      mems: Sequence[Dict[str, np.ndarray]], *,
                      n_iters: Optional[int] = None,
                      tenant: str = "default",
                      chunk: Optional[int] = None, span: int = 4,
                      deadline_ms: Optional[float] = None
                      ) -> StreamResponse:
        """Admit one chunked request to be *pipelined* through a single
        warm trace; returns a ``StreamResponse`` whose ``chunks()``
        yields results as they drain from the engine.

        ``mems`` is a sequence of named-array dicts (one per sample).
        ``chunk`` bounds samples per pipelined chunk (default, and cap:
        ``max_batch`` — chunks ride the service's warm bucket traces, so
        streaming adds zero new traces).  ``span`` bounds consecutive
        chunks executed per dispatch (default 4): the stream is cut into
        spans that interleave with other tenants' micro-batches in the
        admission FIFO, so one long stream never monopolizes the
        coalescer.  Admission is all-or-nothing: if the whole stream
        does not fit under ``max_queue``, every member is rejected
        ``queue-full`` (a half-admitted stream helps nobody).

        In replicated-router mode chunks are routed as ordinary
        micro-batches (each replica pipelines within its own sweeps), so
        ``StreamResponse.info`` reports ``spans == 0`` there.
        """
        mems = [dict(m) for m in mems]
        for m in mems:
            program.check_arrays(m)
        if span < 1:
            raise ValueError(f"span must be >= 1, got {span}")
        step = self.max_batch if chunk is None else int(chunk)
        step = max(1, min(step, self.max_batch))
        now = time.perf_counter()
        dl_ms = deadline_ms
        if dl_ms is None:
            dl_ms = self.deadlines_ms.get(tenant, self.default_deadline_ms)
        deadline = now + dl_ms / 1e3 if dl_ms is not None else None
        n = n_iters if n_iters is not None else program.n_iters
        reqs = [Request(tenant=tenant, program=program, target=target,
                        mem=m, n_iters=n, t_submit=now, deadline=deadline)
                for m in mems]
        tr = obs.tracer()
        if tr.enabled and reqs:
            # one trace per stream; every member stamps into it so the
            # exported timeline shows the chunk pipeline end to end
            tid = tr.new_trace_id()
            for req in reqs:
                req.trace = RequestTrace(tid, now)
        sr = StreamResponse([r.response for r in reqs], step)
        if not reqs:
            return sr
        with self._lock:
            if self._closed:
                reject = ("shutdown", "service is shut down")
            elif self._pending + len(reqs) > self.max_queue:
                reject = ("queue-full",
                          f"stream of {len(reqs)} does not fit "
                          f"({self._pending} in flight, "
                          f"max_queue={self.max_queue})")
            else:
                reject = None
                self._pending += len(reqs)
                # spans enqueue under the lock for the same
                # shutdown-race reason as submit(); consecutive spans
                # are separate FIFO items, so concurrent submitters
                # interleave between them
                per_span = step * span
                for i in range(0, len(reqs), per_span):
                    self._admission.put(
                        _StreamSpan(reqs[i:i + per_span], step, sr))
        if reject is not None:
            for req in reqs:
                self._finish_rejected(req, *reject)
        return sr

    def _finish_rejected(self, req: Request, reason: str,
                         detail: str) -> Response:
        self._metrics.record_reject(req.tenant, reason)
        if req.trace is not None:
            t = req.trace
            obs.tracer().record(
                "request", t.t_submit, time.perf_counter(), cat="service",
                trace=t.trace_id,
                args={"tenant": req.tenant, "outcome": "rejected",
                      "reason": reason})
        req.response._resolve(exc=ServiceRejected(reason, detail))
        return req.response

    def _finish_trace(self, req: Request, now: float,
                      streamed: bool = False) -> Dict[str, object]:
        """Emit one completed request's span tree from its stamps (see
        ``RequestTrace``) and return the ``fut.info["trace"]`` breakdown.
        Called on the worker thread just before resolving, so
        ``resolve_ms`` covers metrics recording + tree emission and
        ``queue+coalesce+exec`` equals the reported latency exactly.
        The tree is handed to ``record_tree`` as raw tuples — ``Span``
        construction is deferred to the (cold) read side, keeping the
        per-request tracing cost a few microseconds."""
        t = req.trace
        tr = obs.tracer()
        pulled = t.t_pulled if t.t_pulled is not None else t.t_submit
        exec0 = t.t_exec0 if t.t_exec0 is not None else pulled
        exec1 = t.t_exec1 if t.t_exec1 is not None else now
        tid = t.trace_id
        items = (
            ("request", t.t_submit, now, "service",
             {"tenant": req.tenant, "program": req.program.name,
              "streamed": streamed}),
            ("queue", t.t_submit, pulled, "service", None),
            ("coalesce", pulled, exec0, "service", None),
            ("exec", exec0, exec1, "engine", t.exec_args),
            ("resolve", exec1, now, "service", None),
        )
        if t.t_emit is not None:
            # dispatch (batch FIFO / router wait) is the tail slice of
            # the coalesce window — shown as its own child span
            items += (("dispatch", t.t_emit, exec0, "service", None),)
        tr.record_tree(tid, items)
        return {
            "trace_id": tid,
            "queue_ms": round((pulled - t.t_submit) * 1e3, 3),
            "coalesce_ms": round((exec0 - pulled) * 1e3, 3),
            "exec_ms": round((exec1 - exec0) * 1e3, 3),
            "resolve_ms": round((now - exec1) * 1e3, 3),
        }

    # -- dispatcher -----------------------------------------------------------
    def _stamp_pulled(self, item: object) -> None:
        """Dispatcher-side trace stamp: the moment an item left the
        admission FIFO (start of its coalescer wait)."""
        if isinstance(item, _StreamSpan):
            reqs = item.requests
        elif isinstance(item, Request):
            reqs = (item,)
        else:
            return
        if reqs[0].trace is None:
            return
        now = time.perf_counter()
        for req in reqs:
            if req.trace is not None:
                req.trace.t_pulled = now

    def _emit(self, batch: List[Request], *, early: bool = False) -> None:
        """Hand one flush-ready micro-batch to the execution side: the
        shared FIFO in plain mode, the Router in replicated mode."""
        faults.dispatch_delay()      # no-op unless a fault plan is active
        if batch[0].trace is not None:
            now = time.perf_counter()
            for req in batch:
                if req.trace is not None:
                    req.trace.t_emit = now
        if self._router is None:
            self._batches.put(batch)
        else:
            self._router.route(batch[0].key, batch, early=early)

    def _emit_span(self, span: _StreamSpan) -> None:
        """Hand one stream span to the execution side.  Plain mode keeps
        the span whole — a worker pipelines its chunks through the
        engine's double-buffered path.  Router mode splits it into
        chunk-sized micro-batches routed like any other flush (each
        replica's sweeps pipeline internally; cross-chunk double
        buffering does not survive placement on different devices)."""
        if self._router is None:
            self._batches.put(span)
            return
        for i in range(0, len(span.requests), span.chunk):
            batch = span.requests[i:i + span.chunk]
            self._router.route(batch[0].key, batch)

    def _steal_for_idle(self, now: float) -> None:
        """Replicated mode: while there is strictly more idle capacity
        than routed-but-unclaimed work, flush the oldest sufficiently-
        aged partial bucket early — an idle replica beats a fuller
        batch (work stealing between coalescer buckets)."""
        while self._router.idle_slots() > self._router.queued():
            batch = self._coalescer.steal_oldest(now, self._steal_age_s)
            if batch is None:
                return
            self._emit(batch, early=True)

    def _dispatch_loop(self) -> None:
        while True:
            now = time.perf_counter()
            for batch in self._coalescer.pop_expired(now):
                self._emit(batch)
            if self._router is not None:
                self._steal_for_idle(time.perf_counter())
            wait = self._coalescer.next_deadline(time.perf_counter())
            timeout = _IDLE_TICK_S if wait is None else max(wait, 1e-4)
            if self._router is not None and wait is not None:
                # wake early enough to notice an idle replica while a
                # partial bucket is still young (steal granularity)
                timeout = max(min(timeout, max(self._steal_age_s / 2,
                                               1e-3)), 1e-4)
            item = self._admission.get(timeout=timeout)
            if item is _STOP:
                break
            self._stamp_pulled(item)
            if isinstance(item, _StreamSpan):
                self._emit_span(item)
            elif item is not None:
                full = self._coalescer.offer(item)
                if full is not None:
                    self._emit(full)
        # drain: late racers in admission, then every partial bucket
        for item in self._admission.drain():
            if item is _STOP:
                continue
            self._stamp_pulled(item)
            if isinstance(item, _StreamSpan):
                self._emit_span(item)
            else:
                full = self._coalescer.offer(item)
                if full is not None:
                    self._emit(full)
        for batch in self._coalescer.flush_all():
            self._emit(batch)
        if self._router is None:
            for _ in range(self.n_workers):
                self._batches.put(_STOP)
        else:
            self._router.stop()     # pulls drain the queues, then None

    # -- workers --------------------------------------------------------------
    def _worker_loop(self, index: int = 0) -> None:
        if self._router is None:
            while True:
                batch = self._batches.get()
                if batch is _STOP:
                    break
                if isinstance(batch, _StreamSpan):
                    self._run_stream_span(batch)
                else:
                    self._run_batch(batch)
            return
        slot = self._router.slots[index]
        while True:
            item = self._router.pull(index)
            if item is None:
                break
            _key, batch, _stolen = item
            t0 = time.perf_counter()
            n_live = self._run_batch(batch, slot=slot)
            self._router.done(index, n_live, time.perf_counter() - t0)

    def _executable(self, req: Request) -> Executable:
        """The shared warm Executable for a batch key, compiled through
        the mapping cache.  Workers racing on a cold key may each call
        ``compile``, but the cache's per-key compile lock collapses the
        expensive work to one mapping + one lowering (losers get a cache
        hit), so only the cheap Executable wrapper is ever duplicated.

        The first worker to install a tenant class's Executable also
        warms its execution engine (``Executable.warmup``): the cuda and
        torch paths launch the batch-bucket ladder once, so the class's
        variable-sized micro-batches never meet a cold shape on the
        serving path.  A warm-up failure is swallowed here (warming is an
        optimization); the class's first sweep then meets the same fault
        under the circuit breaker, which counts it and marks the futures
        it degrades.
        """
        key = req.key
        with self._lock:
            exe = self._exes.get(key)
        if exe is None:
            exe = ual_compile(req.program, req.target, cache=self._cache)
            with self._lock:
                installed = self._exes.setdefault(key, exe)
            if installed is exe and exe.success:
                try:
                    exe.warmup(self.warmup_buckets)
                except Exception:
                    pass     # warming is an optimization, never a failure
            exe = installed
        return exe

    def _prepare(self, batch: List[Request]
                 ) -> Tuple[List[Request], Optional[Executable]]:
        """Shared front half of batch and span execution: settle the
        pending count, reject aged-out members, resolve the shared warm
        Executable.  Returns ``(live, exe)``; ``exe`` is None when every
        member has already been resolved (expired / verifier-error /
        compile-failed / compile crash) and there is nothing to run."""
        with self._lock:
            self._pending -= len(batch)
        now = time.perf_counter()
        live = []
        for req in batch:
            if req.expired(now):
                self._finish_rejected(req, "deadline-exceeded",
                                      f"waited "
                                      f"{(now - req.t_submit) * 1e3:.1f}ms")
            else:
                live.append(req)
        if not live:
            return [], None
        try:
            exe = self._executable(live[0])
        except VerifyError as exc:
            # a config that fails static verification is a tenant
            # problem, not a worker crash: reject with the report's
            # one-line summary, keep the worker alive
            for req in live:
                self._finish_rejected(req, "verifier-error",
                                      exc.report.summary())
            return [], None
        except Exception as exc:     # resolve, don't kill the worker
            self._metrics.record_error([req.tenant for req in live])
            for req in live:
                req.response._resolve(exc=exc)
            return [], None
        if not exe.success:
            for req in live:
                self._finish_rejected(
                    req, "compile-failed",
                    f"{req.program.name} does not map onto "
                    f"{req.target.fabric.name}")
            return [], None
        return live, exe

    def _sweep(self, exe: Executable, live: List[Request], backend: str,
               slot=None) -> Tuple[List[Dict[str, np.ndarray]],
                                   Dict[str, object]]:
        """One engine sweep on an explicit backend — the unit the
        circuit breaker retries.  Device placement only rides along on
        backends that support it (a degraded sim sweep must not receive
        the cuda slot device).  The fault-injection hook sits inside
        the caller's ``try`` so an injected failure takes the exact
        path a real engine failure would."""
        kw: Dict[str, object] = {}
        if slot is not None and slot.device is not None:
            if getattr(get_backend(backend), "supports_device", False):
                kw["device"] = slot.device        # per-replica placement
        faults.check_exec(backend)
        return exe.run_batch_with_info(
            [req.mem for req in live], n_iters=live[0].n_iters,
            backend=backend, **kw)

    def _run_batch(self, batch: List[Request], slot=None) -> int:
        """Execute one micro-batch; returns how many requests actually
        rode the sweep (0 when every member was rejected first) so the
        router's per-replica sample counters stay honest.

        Degradable backends (``CircuitBreaker.fallbacks``) run under the
        breaker: an open class sweeps on its fallback outright, a failed
        primary sweep is retried in place on the fallback (the batch
        still resolves with bit-exact outputs — both backends consume
        the same lowered artifact), and only a fallback failure reaches
        the callers as an error."""
        live, exe = self._prepare(batch)
        if exe is None:
            return 0
        t_exec0 = time.perf_counter()
        primary = live[0].target.backend
        brk = self._breaker
        fb: Optional[str] = None
        probe = False
        if brk is not None:
            fb, probe = brk.plan(live[0].key, primary, t_exec0)
        degraded_to: Optional[str] = fb
        try:
            if fb is not None:
                outs, info = self._sweep(exe, live, fb, slot)
            else:
                try:
                    outs, info = self._sweep(exe, live, primary, slot)
                    if brk is not None:
                        brk.record_success(live[0].key, probe=probe)
                except Exception:
                    fallback = (brk.fallback_for(primary)
                                if brk is not None else None)
                    if fallback is None:
                        raise
                    if brk.record_failure(live[0].key, time.perf_counter(),
                                          probe=probe):
                        self._metrics.record_breaker_trip()
                    outs, info = self._sweep(exe, live, fallback, slot)
                    brk.record_degraded(live[0].key)
                    degraded_to = fallback
        except Exception as exc:     # resolve, don't kill the worker
            self._metrics.record_error([req.tenant for req in live])
            for req in live:
                req.response._resolve(exc=exc)
            return len(live)
        if degraded_to is not None:
            self._metrics.record_degraded(len(live))
            info["degraded_to"] = degraded_to
        done = time.perf_counter()
        self._metrics.record_batch(len(live), float(info.get("wall_s", 0.0)))
        sps = info.get("throughput_sps")
        traced = live[0].trace is not None
        if traced:
            exec_args = {k: info[k] for k in
                         ("buckets", "padded", "traced", "wall_s")
                         if k in info}
            exec_args["batch"] = len(live)
            for req in live:
                if req.trace is not None:
                    req.trace.t_exec0 = t_exec0
                    req.trace.t_exec1 = done
                    req.trace.exec_args = exec_args
        for req, out in zip(live, outs):
            latency = done - req.t_submit
            self._metrics.record_completed(req.tenant, latency)
            extra: Dict[str, object] = {}
            if degraded_to is not None:
                extra["degraded_to"] = degraded_to
            if req.trace is not None:
                extra["trace"] = self._finish_trace(req,
                                                    time.perf_counter())
            req.response._resolve(out, latency_ms=round(latency * 1e3, 3),
                                  batch=len(live), throughput_sps=sps,
                                  **extra)
        return len(live)

    def _resolve_chunk(self, members: List[Request],
                       outs: List[Dict[str, np.ndarray]],
                       cinfo: Dict[str, object], done: float,
                       t_exec0: float) -> None:
        """Resolve one drained stream chunk's futures."""
        for req, out in zip(members, outs):
            latency = done - req.t_submit
            self._metrics.record_completed(req.tenant, latency)
            extra: Dict[str, object] = {}
            if req.trace is not None:
                req.trace.t_exec0 = t_exec0
                req.trace.t_exec1 = done
                req.trace.exec_args = {
                    "chunk": cinfo.get("chunk"),
                    "batch": len(outs), "stream": True}
                extra["trace"] = self._finish_trace(
                    req, time.perf_counter(), streamed=True)
            req.response._resolve(out, latency_ms=round(latency * 1e3, 3),
                                  batch=len(outs), stream=True,
                                  chunk=cinfo.get("chunk"), **extra)

    def _run_stream_span(self, span: _StreamSpan) -> int:
        """Pipeline one stream span through the engine's double-buffered
        path, resolving each chunk's futures AS IT DRAINS — a consumer
        holding the ``StreamResponse`` sees chunk *i*'s results while
        chunk *i+1* is still computing.

        The span's LAST chunk resolves only after the span is recorded
        (``record_stream_span``) and merged into its ``StreamResponse``:
        a caller that reads ``stats()`` or ``info`` as soon as its
        futures resolve sees the span counted."""
        live, exe = self._prepare(span.requests)
        if exe is None:
            return 0
        idx = 0                      # members drained
        resolved = 0                 # members resolved
        n_chunks = 0
        last = None                  # the final chunk, held for the span
        t_exec0 = time.perf_counter()
        gen = exe._execute_stream([req.mem for req in live],
                                  live[0].n_iters, None, chunk=span.chunk)
        try:
            while True:
                try:
                    outs, cinfo = next(gen)
                except StopIteration as stop:
                    summary = dict(stop.value or {})
                    break
                done = time.perf_counter()
                members = live[idx:idx + len(outs)]
                idx += len(outs)
                n_chunks += 1
                if idx < len(live):
                    self._resolve_chunk(members, outs, cinfo, done, t_exec0)
                    resolved = idx
                else:
                    last = (members, outs, cinfo, done)
        except Exception as exc:     # resolve the unresolved tail
            self._metrics.record_error(
                [req.tenant for req in live[resolved:]])
            for req in live[resolved:]:
                req.response._resolve(exc=exc)
            return resolved
        self._metrics.record_stream_span(n_chunks, len(live),
                                         float(summary.get("wall_s", 0.0)),
                                         summary.get("overlap_frac"))
        span.stream._merge_span(summary)
        if last is not None:
            self._resolve_chunk(*last, t_exec0)
        return len(live)

    # -- observability --------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        """The serving numbers: p50/p99 latency (ms), achieved batch size
        (mean/max), samples/s, queue depth, rejects by reason, per-tenant
        totals, warm executable count, the mapping cache aggregate, and
        the execution engine aggregate (trace count / hit ratio —
        the launch-once-per-shape health of the cuda path)."""
        with self._lock:
            depth = self._pending
            n_exes = len(self._exes)
        snap = self._metrics.snapshot(queue_depth=depth)
        snap["executables"] = n_exes
        cache = self._cache if self._cache is not None else default_cache()
        snap["cache"] = cache.stats()
        snap["engine"] = default_engine().stats()
        if self._breaker is not None:
            snap["breaker"] = self._breaker.stats()
        if self._router is not None:
            snap["router"] = self._router.stats()
        return snap
