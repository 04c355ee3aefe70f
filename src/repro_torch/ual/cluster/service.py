"""``ClusterService`` — the multi-process serving front-end.

One parent process routes single-sample requests to N **worker
processes**, each running a full in-process ``Service`` (queue ->
coalesce -> batched sweep, optionally replicated over devices).  The
pieces:

  * **front-end routing** (``submit``) — least-loaded worker by
    in-flight count; among ties, a worker that has already registered
    the request's compatibility class wins (its Executable and engine
    traces are warm).  Same policy as the in-process ``Router``, one
    level up.
  * **lazy class registration** — the first request of a class on a
    worker ships the ``Program`` (with its unpicklable ``make_mem``
    generator stripped — the digest ignores it) and ``Target`` once;
    later requests send only arrays.
  * **shared artifact cache** — every worker opens the same on-disk
    ``MappingCache`` directory.  With the cache's cross-process per-key
    locks, a cold tenant pays ONE mapping + lowering cluster-wide; the
    other workers block briefly and load the artifact.
  * **collector thread** (parent) — drains the workers' outbox and
    resolves the parent-side ``Response`` futures, so ``submit`` callers
    use the exact same future API as the in-process service.
  * **watchdog thread** (parent) — the self-healing loop.  A dead
    worker's in-flight requests are **transparently re-dispatched** to
    live workers (safe: pure compute keyed on content digests, so a
    duplicate execution is idempotent) — bounded by ``max_retries`` and
    never past the request's deadline, with each hop visible as a
    ``retry`` obs span and counted in ``fut.info["retries"]``.  The
    worker itself is **respawned** under the ``RestartPolicy``
    (exponential backoff, bounded restart budget) and rejoins the
    routing set warm: its compatibility classes are re-registered and
    the artifacts re-load from the shared disk cache, no re-mapping.
    Only when the retry budget is exhausted (or no worker is live) does
    a caller see a ``worker-died`` verdict — every submitted future
    resolves or carries a verdict, none is ever lost or stuck.
    ``stats()["supervision"]`` reports deaths/restarts/backoff/uptime
    per worker.
  * **merged stats** (``stats()``) — one cluster view: aggregate
    completed / samples-per-second / rejects, conservative p50/p99
    (worst worker), front-end routing decisions, plus each worker's full
    ``Service.stats()`` snapshot (including its replica router, when
    replicated) under ``per_worker``.

On CUDA:

  * workers are **spawned**, never forked: a process forked after CUDA
    has started cannot use it, and spawn keeps each worker's torch and
    CUDA runtime independent of the parent's.  Every ``repro_torch`` and
    ``torch`` import in a worker happens after ``cfg["env"]`` lands in
    ``os.environ``;
  * **worker i sees one card**: ``CUDA_VISIBLE_DEVICES`` is card
    ``i % n_cards`` of the parent's visible cards, unless ``worker_env``
    sets it.  The parent counts the cards with
    ``torch.cuda.device_count()``, which does not initialise CUDA, and
    routes numpy arrays only: a ``ClusterService`` parent never
    initialises CUDA.  Each worker holds its own CUDA context, engines,
    pinned buffers and streams, and loads the ``cgra_exec`` library that
    the first process to build it published (the build is locked per
    library);
  * **no tensor crosses a queue**: requests and results on the inbox and
    outbox are numpy arrays and plain Python (a CUDA tensor pickled onto
    a ``multiprocessing`` queue becomes an IPC handle that dies with a
    killed worker);
  * fault plans ride the port's own variable, ``REPRO_TORCH_UAL_FAULTS``
    (``FaultPlan.to_env()``);
  * a class on a CUDA backend (``cuda``, ``cuda_sharded``) in a worker that
    sees no card answers its requests with an error: it never runs on
    another backend.

``worker_info()`` reports each worker's process: its pid, card, start-up
seconds, ``nvcc`` runs, ``cgra_exec`` launches, pinned staging bytes and
device memory, refreshed by every ``stats()`` round.
"""
from __future__ import annotations

import dataclasses
import itertools
import multiprocessing as mp
import os
import queue as queue_mod
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.ual.cluster.supervision import RestartPolicy, WorkerState

#: how often the watchdog polls worker liveness
_WATCH_TICK_S = 0.2


def merge_latency(snaps: Dict[int, Dict[str, object]]) -> Dict[str, object]:
    """Merge per-worker latency into cluster percentiles.

    Each snapshot may carry a raw ``latency_window_ms`` sample list
    (shipped by workers; POPPED here so it does not bloat the
    ``per_worker`` view).  Cluster ``p50_ms``/``p99_ms`` are computed
    over the concatenated samples — real percentiles of the merged
    distribution — while ``worst_worker_p99_ms`` keeps the old
    conservative max-of-workers number for soak-gate continuity.
    Workers that shipped no window (older snapshot shape) fall back to
    their pre-computed percentiles via the max path only.
    """
    samples: List[float] = []
    for s in snaps.values():
        samples.extend(s.pop("latency_window_ms", None) or [])
    p50s = [s["p50_ms"] for s in snaps.values()
            if s.get("p50_ms") is not None]
    p99s = [s["p99_ms"] for s in snaps.values()
            if s.get("p99_ms") is not None]
    p50 = obs.percentile(samples, 50)
    p99 = obs.percentile(samples, 99)
    return {
        "p50_ms": (round(p50, 3) if p50 is not None
                   else (max(p50s) if p50s else None)),
        "p99_ms": (round(p99, 3) if p99 is not None
                   else (max(p99s) if p99s else None)),
        "worst_worker_p99_ms": max(p99s) if p99s else None,
        "latency_samples_merged": len(samples),
    }


#: backends whose classes need a card in the worker
_CARD_BACKENDS = ("cuda", "cuda_sharded")


def _process_info() -> Dict[str, object]:
    """This worker process: what it built, launched and holds (device
    memory only where CUDA is already initialised: asking initialises
    nothing)."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.cgra_exec import ops
    from repro_torch.ual.engine import default_engine

    engines = default_engine().stats()["per_engine"].values()
    cuda = torch.cuda.is_initialized()
    return {
        "pid": os.getpid(),
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "nvcc_builds": build.compiles,
        "cgra_exec_launches": ops.launches(),
        "engines": sorted({e["engine"] for e in engines}),
        "pinned_bytes": sum(e["pinned_bytes"] for e in engines),
        "device_max_reserved_bytes": (torch.cuda.max_memory_reserved()
                                      if cuda else None),
        "device_max_allocated_bytes": (torch.cuda.max_memory_allocated()
                                       if cuda else None),
    }


def _worker_main(widx: int, inbox, outbox, cfg: Dict[str, object]) -> None:
    """One worker process: env -> Service -> message loop.

    Module-level (spawn target must be importable), and ALL repro_torch
    and torch imports happen here, after ``cfg["env"]`` lands in
    ``os.environ`` — so the worker's ``CUDA_VISIBLE_DEVICES``, fault plan
    and CPU device count are set before torch ever loads in this process.
    """
    os.environ.update(cfg.get("env") or {})
    from repro_torch import obs
    from repro_torch.ual import faults
    from repro_torch.ual.cache import MappingCache
    from repro_torch.ual.engine import require_cuda
    from repro_torch.ual.service import Service, ServiceRejected

    # fault plans ride the env (REPRO_TORCH_UAL_FAULTS) exactly like
    # tracing; binding the worker index arms worker-targeted kill specs
    faults.set_worker_index(widx)

    cache = (MappingCache(disk_dir=cfg["cache_dir"])
             if cfg.get("cache_dir") else None)
    svc = Service(max_batch=cfg["max_batch"],
                  max_wait_ms=cfg["max_wait_ms"],
                  max_queue=cfg["max_queue"],
                  workers=cfg["threads"],
                  replicas=cfg.get("replicas", 1),
                  warmup_buckets=cfg.get("warmup_buckets"),
                  cache=cache)
    classes: Dict[tuple, tuple] = {}

    def _forward(req_id: int):
        """Resolution callback: ship the local future's outcome home."""
        def cb(resp):
            exc = resp.exception(timeout=0)
            if exc is None:
                outbox.put(("done", req_id, widx, resp.result(0),
                            dict(resp.info)))
            elif isinstance(exc, ServiceRejected):
                outbox.put(("rej", req_id, widx, exc.reason, str(exc)))
            else:
                outbox.put(("err", req_id, widx,
                            f"{type(exc).__name__}: {exc}"))
        return cb

    outbox.put(("ready", widx))
    try:
        while True:
            msg = inbox.get()
            kind = msg[0]
            if kind == "stop":
                break
            if kind == "reg":
                _, class_id, program, target = msg
                no_card = None
                if target.backend in _CARD_BACKENDS:
                    try:
                        require_cuda()
                    except RuntimeError as e:
                        no_card = f"{type(e).__name__}: {e}"
                classes[class_id] = (program, target, no_card)
            elif kind == "req":
                (_, req_id, class_id, mem, n_iters, tenant,
                 deadline_ms) = msg
                # armed kill_worker specs fire here, BEFORE submit: the
                # triggering request dies in flight with the process,
                # exactly the crash shape the parent's retry path heals
                faults.on_request()
                program, target, no_card = classes[class_id]
                if no_card is not None:
                    # a card class never falls back to another backend
                    outbox.put(("err", req_id, widx, no_card))
                    continue
                resp = svc.submit(program, target, mem, n_iters=n_iters,
                                  tenant=tenant, deadline_ms=deadline_ms)
                resp.add_done_callback(_forward(req_id))
            elif kind == "stats":
                snap = svc.stats()
                # ship the raw latency window so the parent can merge
                # SAMPLES into real cluster percentiles (not max-of-p99)
                snap["latency_window_ms"] = \
                    svc._metrics.latency_window_ms()
                # spans ship BEFORE the stats reply: the shared outbox is
                # FIFO per worker, so once the parent's stats() collects
                # every reply, every span batch has been ingested too
                tr = obs.tracer()
                spans = tr.drain()
                if spans:
                    outbox.put(("spans", widx, spans, tr.epoch))
                outbox.put(("stats", widx, snap, _process_info()))
    finally:
        svc.shutdown(timeout=60.0)
        tr = obs.tracer()
        spans = tr.drain()
        if spans:
            try:
                outbox.put(("spans", widx, spans, tr.epoch))
            except (OSError, ValueError):
                pass
        outbox.put(("stopped", widx))


@dataclasses.dataclass
class _Flight:
    """Parent-side record of one in-flight request.  Retains the full
    submission payload (arrays, class, trip count, deadline) so the
    watchdog can re-dispatch it to a live worker if the one it rode
    dies — the transparent-retry path."""

    resp: object                      # parent-side Response future
    widx: int                         # worker currently carrying it
    tenant: str
    class_id: Tuple[str, str, str, int]
    arrays: Dict[str, np.ndarray]
    n_iters: int
    deadline: Optional[float]         # absolute parent perf_counter
    retries: int = 0


class ClusterService:
    """Sharded serving cluster: N worker processes, one front-end.

        cs = ual.ClusterService(workers=4, max_batch=32, max_wait_ms=2)
        fut = cs.submit(program, target, A=a, B=b, tenant="gemm-app")
        out = fut.result(timeout=60)      # same future API as Service
        print(cs.stats()["samples_per_s"], cs.stats()["workers"])
        cs.shutdown()

    ``worker_threads`` / ``replicas`` / ``warmup_buckets`` configure
    each worker's inner ``Service``; ``worker_env`` is merged into each
    worker's environment before torch loads there (a card of its own via
    ``CUDA_VISIBLE_DEVICES``, set per worker unless given here; the CPU
    device count via ``launch.mesh.forced_device_env``; fault plans via
    ``FaultPlan.to_env()``).  ``cache_dir`` is the shared on-disk
    artifact cache (defaults to the user-level cache directory); pass
    an empty string to disable disk sharing.

    ``restart_policy`` governs how dead workers are respawned
    (``RestartPolicy(max_restarts=0)`` restores evict-only);
    ``max_retries`` bounds how many times one in-flight request may be
    re-dispatched after worker deaths before its caller sees a
    ``worker-died`` verdict.
    """

    def __init__(self, workers: int = 2, *, max_batch: int = 32,
                 max_wait_ms: float = 2.0, max_queue: int = 1024,
                 worker_threads: int = 1, replicas: int = 1,
                 warmup_buckets: Optional[Sequence[int]] = None,
                 cache_dir: Optional[str] = None,
                 worker_env: Optional[Dict[str, str]] = None,
                 trace: bool = False,
                 restart_policy: Optional[RestartPolicy] = None,
                 max_retries: int = 2,
                 start: bool = True,
                 start_timeout_s: float = 180.0) -> None:
        if workers < 1:
            raise ValueError(f"need at least 1 worker, got {workers}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.n_workers = workers
        self.max_queue = max_queue
        self.start_timeout_s = start_timeout_s
        if cache_dir is None:
            from repro_torch.ual.cache import default_cache_dir
            cache_dir = str(default_cache_dir())
        env = dict(worker_env or {})
        # trace=True (or a tracing parent) turns tracing on INSIDE the
        # spawned workers via the env; their span batches ride the
        # result pipe home and land in the parent tracer with one track
        # per worker (see export_chrome)
        if trace or obs.tracer().enabled:
            env.setdefault(obs.TRACE_ENV, "1")
        self._cfg = {
            "max_batch": max_batch, "max_wait_ms": max_wait_ms,
            "max_queue": max_queue, "threads": worker_threads,
            "replicas": replicas,
            "warmup_buckets": (tuple(warmup_buckets)
                               if warmup_buckets is not None else None),
            "cache_dir": cache_dir or None,
            "env": env,
        }

        self.restart_policy = (restart_policy if restart_policy is not None
                               else RestartPolicy())
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        self.max_retries = max_retries

        self._lock = threading.Lock()
        self._stats_cond = threading.Condition(self._lock)
        self._respawn_cond = threading.Condition(self._lock)
        self._closed = False
        self._started = False
        self._req_ids = itertools.count()
        self._inflight: Dict[int, _Flight] = {}
        self._load: List[int] = [0] * workers          # in-flight per worker
        self._registered: List[set] = [set() for _ in range(workers)]
        self._alive: List[bool] = [False] * workers
        self._sup: List[WorkerState] = [WorkerState() for _ in range(workers)]
        #: class_id -> (wire-ready Program, Target): what a respawned
        #: worker needs to re-register its classes (warm rejoin)
        self._class_info: Dict[Tuple[str, str, str, int],
                               Tuple[object, object]] = {}
        self.decisions: Dict[str, int] = {"affinity": 0, "least_loaded": 0,
                                          "retry": 0}
        self._stats_buf: Dict[int, Dict[str, object]] = {}
        self._stats_want: set = set()
        self._proc_info: Dict[int, Dict[str, object]] = {}
        self._cards = _card_ids()

        self._procs: List[mp.process.BaseProcess] = []
        self._inboxes: List[object] = []
        self._result_qs: List[object] = []
        self._threads: List[threading.Thread] = []
        self._ready = threading.Event()
        self._n_ready = 0
        self._n_stopped = 0
        self._watchdog_errors = 0
        self._watchdog_last_error = ""
        if start:
            self.start()

    # -- lifecycle ------------------------------------------------------------
    def _worker_cfg(self, widx: int) -> Dict[str, object]:
        """Worker ``widx``'s config: its own card, unless the caller's
        ``worker_env`` names the cards."""
        env = self._cfg["env"]
        if self._cards and "CUDA_VISIBLE_DEVICES" not in env:
            env = dict(env, CUDA_VISIBLE_DEVICES=self._cards[
                widx % len(self._cards)])
        return dict(self._cfg, env=env)

    def start(self) -> "ClusterService":
        with self._lock:
            if self._started or self._closed:
                return self
            self._started = True
        ctx = mp.get_context("spawn")
        for i in range(self.n_workers):
            # One result queue PER worker: a worker hard-killed mid-write
            # can tear the message stream, and on a shared pipe that
            # desyncs every other worker's completions too.  Isolated
            # pipes contain the damage to the dead worker, and once the
            # parent drops its write end (on "ready") a hard death reads
            # as a clean EOF instead of a stuck partial message.
            inbox, outq = ctx.Queue(), ctx.Queue()
            p = ctx.Process(target=_worker_main,
                            args=(i, inbox, outq, self._worker_cfg(i)),
                            name=f"ual-cluster-worker-{i}", daemon=True)
            p.start()
            self._sup[i].started_at = time.perf_counter()
            self._inboxes.append(inbox)
            self._result_qs.append(outq)
            self._procs.append(p)
        for i, outq in enumerate(self._result_qs):
            t = threading.Thread(target=self._collector_loop,
                                 args=(i, outq),
                                 name=f"ual-cluster-collect-{i}", daemon=True)
            t.start()
            self._threads.append(t)
        t = threading.Thread(target=self._watchdog_loop,
                             name="ual-cluster-watch", daemon=True)
        t.start()
        self._threads.append(t)
        if not self._ready.wait(self.start_timeout_s):
            self.shutdown(timeout=10.0)
            raise RuntimeError(
                f"cluster start timed out: {self._n_ready}/{self.n_workers} "
                f"workers ready within {self.start_timeout_s}s")
        return self

    def shutdown(self, timeout: Optional[float] = 120.0) -> None:
        """Stop admitting, let every worker flush, join, reject leftovers.

        Safe against an in-progress respawn: ``_closed`` is set first
        (no NEW respawn can start), then any spawn already underway is
        waited out — the watchdog either installs the replacement here
        (so the stop/join sweep below covers it) or, seeing ``_closed``,
        reaps it as an orphan itself.  Either way no worker process
        leaks and the watchdog stays joinable."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            started = self._started
        if not started:
            return
        with self._respawn_cond:
            deadline0 = time.perf_counter() + 15.0
            while any(st.respawning for st in self._sup):
                rem = deadline0 - time.perf_counter()
                if rem <= 0 or not self._respawn_cond.wait(rem):
                    break
        for i, inbox in enumerate(self._inboxes):
            try:
                inbox.put(("stop",))
            except (OSError, ValueError):
                pass
        deadline = (time.perf_counter() + timeout
                    if timeout is not None else None)
        for p in self._procs:
            rem = (max(0.0, deadline - time.perf_counter())
                   if deadline is not None else None)
            p.join(rem)
            if p.is_alive():
                p.terminate()
        # every worker is gone: what is still queued for one is read by
        # no one, so this process's exit must not wait on its feeder
        for inbox in self._inboxes:
            inbox.cancel_join_thread()
        # collectors/watchdog see _closed + dead procs and exit; give
        # the collectors a moment to drain late completions before
        # rejecting (snapshot under the lock: _respawn appends threads)
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(5.0)
        with self._lock:
            leftovers = list(self._inflight.values())
            self._inflight.clear()
        from repro_torch.ual.service import ServiceRejected
        for fl in leftovers:
            fl.resp._resolve(exc=ServiceRejected(
                "shutdown", "cluster stopped before the response arrived"),
                retries=fl.retries)

    def __enter__(self) -> "ClusterService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- admission + routing --------------------------------------------------
    def submit(self, program, target,
               mem: Optional[Dict[str, np.ndarray]] = None, *,
               n_iters: Optional[int] = None, tenant: str = "default",
               deadline_ms: Optional[float] = None,
               **named: np.ndarray):
        """Admit one request; returns a ``Response`` future (same API as
        ``Service.submit``).  Routing: least-loaded worker, class-warm
        affinity tiebreak."""
        from repro_torch.ual.service import ServiceRejected
        from repro_torch.ual.service.queue import Response

        arrays = dict(mem or {})
        arrays.update(named)
        # numpy on the wire: a tensor would cross the queue as a handle
        arrays = {k: np.asarray(v) for k, v in arrays.items()}
        program.check_arrays(arrays)
        n = n_iters if n_iters is not None else program.n_iters
        class_id = (program.digest, target.digest, target.backend, n)
        resp = Response()
        now = time.perf_counter()
        deadline = (now + deadline_ms / 1e3 if deadline_ms is not None
                    else None)

        def _reject(reason: str, detail: str):
            resp._resolve(exc=ServiceRejected(reason, detail))
            return resp

        with self._lock:
            if self._closed:
                return _reject("shutdown", "cluster service is shut down")
            live = [i for i in range(self.n_workers) if self._alive[i]]
            if not live:
                return _reject("worker-died", "no live workers")
            if len(self._inflight) >= self.max_queue:
                return _reject("queue-full",
                               f"{len(self._inflight)} requests in flight "
                               f"(max_queue={self.max_queue})")
            min_load = min(self._load[i] for i in live)
            cands = [i for i in live if self._load[i] == min_load]
            warm = [i for i in cands if class_id in self._registered[i]]
            if warm:
                widx = warm[0]
                self.decisions["affinity"] += 1
            else:
                widx = cands[0]
                self.decisions["least_loaded"] += 1
            req_id = next(self._req_ids)
            self._inflight[req_id] = _Flight(
                resp=resp, widx=widx, tenant=tenant, class_id=class_id,
                arrays=arrays, n_iters=n, deadline=deadline)
            self._load[widx] += 1
            need_reg = class_id not in self._registered[widx]
            if need_reg:
                self._registered[widx].add(class_id)
            if class_id not in self._class_info:
                # make_mem is a convenience closure (often a lambda):
                # strip it for the wire — digest ignores it, workers
                # never call it.  Kept for the lifetime of the cluster
                # so respawned workers re-register their classes warm.
                self._class_info[class_id] = (
                    dataclasses.replace(program, make_mem=None), target)
            wire = self._class_info[class_id]
            # put under the lock (a put only queues for the feeder
            # thread): a class's "reg" reaches the worker before any
            # "req" of that class that another thread routes there next
            inbox = self._inboxes[widx]
            if need_reg:
                inbox.put(("reg", class_id, wire[0], wire[1]))
            inbox.put(("req", req_id, class_id, arrays, n, tenant,
                       deadline_ms))
        return resp

    # -- parent-side threads --------------------------------------------------
    def _settle(self, req_id: int) -> Optional[_Flight]:
        """Remove a finished request from the routing table.  Returns
        None for unknown ids — including a late duplicate completion of
        a request that was already retried and resolved elsewhere (the
        first resolution wins; re-execution is idempotent)."""
        with self._lock:
            fl = self._inflight.pop(req_id, None)
            if fl is not None:
                self._load[fl.widx] -= 1
            return fl

    def _collector_loop(self, widx: int, outq) -> None:
        """Drain ONE worker's result queue (one thread per worker).

        The queue has a single writer (its worker), so a torn message —
        the worker hard-killed mid-``put`` — can only mean that worker
        is dead: the loop exits and leaves the death to the watchdog.
        It never touches the other workers' streams.  A respawned
        worker gets a fresh queue and a fresh collector thread."""
        from repro_torch.ual.service import ServiceRejected
        while True:
            try:
                msg = outq.get(timeout=0.1)
            except queue_mod.Empty:
                with self._lock:
                    closed = self._closed
                if closed:
                    p = (self._procs[widx]
                         if widx < len(self._procs) else None)
                    if p is None or not p.is_alive():
                        return
                continue
            except (EOFError, OSError, ValueError):
                return          # pipe EOF / queue closed: worker is gone
            except Exception:
                return          # torn message from a mid-write death
            kind = msg[0]
            if kind == "ready":
                with self._lock:
                    self._alive[msg[1]] = True
                    self._sup[msg[1]].record_ready(time.perf_counter())
                    self._n_ready += 1
                    ready = self._n_ready >= self.n_workers
                if ready:
                    self._ready.set()
                # Drop the parent's copy of the write end: from here the
                # worker is the pipe's only writer, so a hard death EOFs
                # the stream instead of leaving this thread blocked on a
                # partial message.  (Deferred to "ready" so the fd has
                # been materialised in the child before we close ours.)
                try:
                    outq._writer.close()
                except (AttributeError, OSError):
                    pass
            elif kind == "done":
                _, req_id, widx, out, info = msg
                fl = self._settle(req_id)
                if fl is not None:
                    info["worker"] = widx
                    info["retries"] = fl.retries
                    fl.resp._resolve(out, **info)
            elif kind == "rej":
                _, req_id, widx, reason, detail = msg
                fl = self._settle(req_id)
                if fl is not None:
                    fl.resp._resolve(
                        exc=ServiceRejected(reason, detail),
                        retries=fl.retries)
            elif kind == "err":
                _, req_id, widx, text = msg
                fl = self._settle(req_id)
                if fl is not None:
                    fl.resp._resolve(exc=RuntimeError(
                        f"worker {widx}: {text}"), retries=fl.retries)
            elif kind == "spans":
                _, widx, spans, epoch = msg
                obs.tracer().ingest(spans, epoch=epoch,
                                    track_prefix=f"worker{widx}")
            elif kind == "stats":
                with self._stats_cond:
                    self._stats_buf[msg[1]] = msg[2]
                    self._proc_info[msg[1]] = msg[3]
                    self._stats_want.discard(msg[1])
                    self._stats_cond.notify_all()
            elif kind == "stopped":
                with self._lock:
                    # a worker that stops while the cluster runs (its
                    # loop raised) is left live here, so the watchdog sees
                    # its process exit as a death: its in-flight requests
                    # retry and it respawns
                    if self._closed:
                        self._alive[msg[1]] = False
                    self._n_stopped += 1
                return          # "stopped" is the worker's last message

    def _watchdog_loop(self) -> None:
        """The self-healing loop: detect deaths, re-dispatch orphaned
        in-flight requests to live workers, respawn dead workers under
        the restart policy.  No future is ever lost — an orphan either
        rides a retry hop or resolves with a verdict."""
        while True:
            with self._lock:
                if self._closed:
                    return
            time.sleep(_WATCH_TICK_S)
            try:
                self._watch_tick()
            except Exception as e:  # noqa: BLE001
                # The supervision thread must outlive any single bad
                # tick: if it died, orphaned futures would never resolve
                # and dead workers would never respawn.  Count the error
                # (surfaced in stats()["supervision"]) and keep going.
                with self._lock:
                    self._watchdog_errors += 1
                    self._watchdog_last_error = f"{type(e).__name__}: {e}"

    def _watch_tick(self) -> None:
        now = time.perf_counter()
        dead: List[int] = []
        orphans: List[Tuple[int, _Flight]] = []
        with self._lock:
            for i, p in enumerate(self._procs):
                if self._alive[i] and not p.is_alive():
                    self._alive[i] = False
                    self._sup[i].record_death(now, self.restart_policy)
                    # nobody reads the dead worker's inbox again: its
                    # feeder thread may be blocked on the full pipe for
                    # good, so this process's exit must not join it
                    self._inboxes[i].cancel_join_thread()
                    dead.append(i)
            if dead:
                doomed = set(dead)
                orphans = [(rid, fl) for rid, fl
                           in self._inflight.items()
                           if fl.widx in doomed]
                for rid, fl in orphans:
                    del self._inflight[rid]
                    self._load[fl.widx] -= 1
        if dead:
            with self._stats_cond:
                if self._stats_want & set(dead):
                    self._stats_want -= set(dead)
                    self._stats_cond.notify_all()
            for rid, fl in orphans:
                self._retry_or_reject(rid, fl, now)
        self._maybe_respawn(time.perf_counter())

    def _retry_or_reject(self, rid: int, fl: _Flight, now: float) -> None:
        """One orphaned request: re-dispatch to a live worker (same
        routing policy as ``submit``) unless the retry budget or the
        deadline says otherwise."""
        from repro_torch.ual.service import ServiceRejected
        dead_widx = fl.widx
        if fl.deadline is not None and now > fl.deadline:
            fl.resp._resolve(exc=ServiceRejected(
                "deadline-exceeded",
                f"worker {dead_widx} died in flight and the deadline "
                f"passed (after {fl.retries} retries)"),
                retries=fl.retries)
            return
        if fl.retries >= self.max_retries:
            fl.resp._resolve(exc=ServiceRejected(
                "worker-died",
                f"worker {dead_widx} exited with the request in flight; "
                f"retry budget ({self.max_retries}) exhausted"),
                retries=fl.retries)
            return
        rem_ms = ((fl.deadline - now) * 1e3 if fl.deadline is not None
                  else None)
        with self._lock:
            live = ([] if self._closed else
                    [i for i in range(self.n_workers) if self._alive[i]])
            if live:
                min_load = min(self._load[i] for i in live)
                cands = [i for i in live if self._load[i] == min_load]
                warm = [i for i in cands
                        if fl.class_id in self._registered[i]]
                widx = warm[0] if warm else cands[0]
                fl.retries += 1
                fl.widx = widx
                self._inflight[rid] = fl
                self._load[widx] += 1
                self.decisions["retry"] += 1
                need_reg = fl.class_id not in self._registered[widx]
                if need_reg:
                    self._registered[widx].add(fl.class_id)
                wire = self._class_info[fl.class_id]
                inbox = self._inboxes[widx]
                try:
                    # under the lock, as in submit: "reg" before "req"
                    if need_reg:
                        inbox.put(("reg", fl.class_id, wire[0], wire[1]))
                    inbox.put(("req", rid, fl.class_id, fl.arrays,
                               fl.n_iters, fl.tenant, rem_ms))
                except (OSError, ValueError):
                    # target worker's queue is gone (it died too); the
                    # next watchdog tick orphans this flight again
                    pass
        if not live:
            fl.resp._resolve(exc=ServiceRejected(
                "worker-died",
                f"worker {dead_widx} exited with the request in flight; "
                f"no live worker to retry on"), retries=fl.retries)
            return
        tr = obs.tracer()
        if tr.enabled:
            tr.record("retry", now, time.perf_counter(), cat="cluster",
                      args={"req": rid, "from": dead_widx, "to": widx,
                            "attempt": fl.retries, "tenant": fl.tenant})

    def _maybe_respawn(self, now: float) -> None:
        """Respawn every dead worker whose backoff has elapsed."""
        due: List[int] = []
        with self._lock:
            if self._closed:
                return
            for i, st in enumerate(self._sup):
                if (not self._alive[i] and not st.respawning
                        and not st.exhausted
                        and st.next_respawn_at is not None
                        and now >= st.next_respawn_at):
                    st.respawning = True
                    due.append(i)
        for i in due:
            self._respawn(i)

    def _respawn(self, widx: int) -> None:
        """Spawn the replacement for one dead worker and install it.

        Raced by ``shutdown()``: if ``_closed`` flipped while the
        process was spawning, the replacement is reaped here instead of
        installed — never leaked.  On install, the worker's previous
        compatibility classes are re-registered so it rejoins the
        routing set warm (artifacts re-load from the shared disk cache;
        no re-mapping, no cold routing misses)."""
        st = self._sup[widx]
        ctx = mp.get_context("spawn")
        inbox, outq = ctx.Queue(), ctx.Queue()
        p = ctx.Process(target=_worker_main,
                        args=(widx, inbox, outq, self._worker_cfg(widx)),
                        name=f"ual-cluster-worker-{widx}", daemon=True)
        p.start()
        with self._lock:
            aborted = self._closed
            if not aborted:
                old = self._procs[widx]
                self._procs[widx] = p
                self._inboxes[widx] = inbox
                self._result_qs[widx] = outq
                st.record_respawned(time.perf_counter())
                # re-register its classes before anything can route a
                # request to it (it turns live on "ready", under the lock)
                for cid in self._registered[widx]:
                    prog, targ = self._class_info[cid]
                    inbox.put(("reg", cid, prog, targ))
            st.respawning = False
            self._respawn_cond.notify_all()
        if aborted:
            try:
                inbox.put(("stop",))
            except (OSError, ValueError):
                pass
            p.join(5.0)
            if p.is_alive():
                p.terminate()
                p.join(5.0)
            return
        # The predecessor's collector thread winds down on its own (EOF
        # on the dead worker's private pipe); the replacement gets a
        # fresh queue + thread so a torn stream can never be inherited.
        t = threading.Thread(target=self._collector_loop,
                             args=(widx, outq),
                             name=f"ual-cluster-collect-{widx}r",
                             daemon=True)
        t.start()
        with self._lock:
            self._threads.append(t)
        old.join(0.1)                   # reap the dead predecessor

    # -- observability --------------------------------------------------------
    def queue_depth(self) -> int:
        """Requests admitted but not yet resolved, cluster-wide — the
        number the ``max_queue`` bound rejects against.  Cheap (one lock,
        no worker round-trip), so load generators can sample it hot."""
        with self._lock:
            return len(self._inflight)

    def stats(self, timeout: float = 30.0) -> Dict[str, object]:
        """One merged cluster view + each worker's full snapshot.

        Aggregates are sums (completed / rejects / samples-per-second /
        queue depth); latency percentiles are REAL cluster percentiles —
        workers ship their raw latency windows and the parent merges the
        samples (``merge_latency``) — with ``worst_worker_p99_ms``
        keeping the old conservative worst-replica number.  ``routing``
        is the front-end's decision counters; per-worker replica routers
        (when ``replicas > 1``) appear inside each ``per_worker``
        snapshot and their steal counts are summed into
        ``router_steals``.
        """
        with self._lock:
            live = [i for i in range(self.n_workers) if self._alive[i]]
        with self._stats_cond:
            self._stats_buf = {}
            self._stats_want = set(live)
        for i in live:
            try:
                self._inboxes[i].put(("stats",))
            except (OSError, ValueError):
                with self._stats_cond:
                    self._stats_want.discard(i)
        deadline = time.perf_counter() + timeout
        with self._stats_cond:
            while self._stats_want:
                rem = deadline - time.perf_counter()
                if rem <= 0 or not self._stats_cond.wait(rem):
                    break
            snaps = dict(self._stats_buf)
        with self._lock:
            now = time.perf_counter()
            merged: Dict[str, object] = {
                "cluster": True,
                "workers": len(live),
                "inflight": len(self._inflight),
                "routing": {"decisions": dict(self.decisions),
                            "load": list(self._load)},
                "supervision": {
                    "policy": self.restart_policy.snapshot(),
                    "max_retries": self.max_retries,
                    "restarts_total": sum(st.restarts for st in self._sup),
                    "deaths_total": sum(st.deaths for st in self._sup),
                    "retries_total": self.decisions.get("retry", 0),
                    "watchdog_errors": self._watchdog_errors,
                    "watchdog_last_error": self._watchdog_last_error,
                    "workers": {i: st.snapshot(now, self._alive[i])
                                for i, st in enumerate(self._sup)},
                },
            }
        rejects: Dict[str, int] = {}
        steals = 0
        for s in snaps.values():
            for reason, n in s.get("rejects", {}).items():
                rejects[reason] = rejects.get(reason, 0) + n
            steals += s.get("router", {}).get("steals", 0)
        latency = merge_latency(snaps)   # pops the shipped sample windows
        merged.update({
            "completed": sum(s.get("completed", 0) for s in snaps.values()),
            "rejected": sum(s.get("rejected", 0) for s in snaps.values()),
            "rejects": rejects,
            "errors": sum(s.get("errors", 0) for s in snaps.values()),
            "queue_depth": sum(s.get("queue_depth", 0)
                               for s in snaps.values()),
            "samples_per_s": round(sum(s.get("samples_per_s", 0.0)
                                       for s in snaps.values()), 1),
            "exec_samples_per_s": round(
                sum(s.get("exec_samples_per_s", 0.0)
                    for s in snaps.values()), 1),
            **latency,
            "router_steals": steals,
            "per_worker": {i: snaps[i] for i in sorted(snaps)},
        })
        return merged

    def worker_info(self) -> Dict[int, Dict[str, object]]:
        """Each worker process as its last ``stats()`` reply found it (pid,
        ``CUDA_VISIBLE_DEVICES``, ``nvcc_builds``, ``cgra_exec_launches``,
        engine names, ``pinned_bytes``, device memory peaks), with the
        parent's ``startup_s`` (spawn to ready) of its current process."""
        with self._lock:
            out = {}
            for i, info in sorted(self._proc_info.items()):
                st = self._sup[i]
                up = (st.ready_at - st.started_at
                      if st.ready_at is not None and st.started_at is not None
                      and st.ready_at >= st.started_at else None)
                out[i] = dict(info, startup_s=up)
            return out

    def export_chrome(self, path, timeout: float = 30.0):
        """Write the cluster-wide timeline as Chrome-trace JSON: one
        track group per worker process (``worker0/...``) plus the
        parent's own spans.  Triggers a stats round first so every
        worker ships its buffered span batch before the export."""
        self.stats(timeout=timeout)
        return obs.tracer().export_chrome(path)


def _card_ids() -> List[str]:
    """The parent's visible cards as ``CUDA_VISIBLE_DEVICES`` entries (none
    on a host without CUDA).  ``torch.cuda.device_count()`` counts them
    without initialising CUDA."""
    import torch

    n = torch.cuda.device_count()
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = ([v.strip() for v in visible.split(",") if v.strip()]
           if visible is not None else [str(k) for k in range(n)])
    return ids[:n]


__all__ = ("ClusterService", "merge_latency")
