"""Deterministic fault injection for the serving stack.

The self-healing layer (worker supervision, transparent retry, the
circuit breaker) is only trustworthy if its failure paths are *exercised
deterministically* — waiting for real crashes proves nothing.  This
module is the substrate: a seedable ``FaultPlan`` describing exactly
which faults fire and when, activated either in-process (``install``)
or via the environment (``REPRO_TORCH_UAL_FAULTS``) so spawned worker
processes honor the plan too.  The variable is this package's own, not
the JAX package's ``REPRO_UAL_FAULTS``: a plan meant for one package's
workers never arms the other's.  The plan's JSON is the JAX package's,
field for field, so a plan serialised by one loads in the other.

Fault vocabulary (``FaultSpec.kind``):

  * ``kill_worker``  — hard-exit (``os._exit``) the matching cluster
    worker process after ``after`` requests have been received there,
    exactly as a real crash would look to the parent's watchdog
    (no cleanup, no goodbye message, in-flight requests stranded).
  * ``exec_fault``   — raise ``InjectedFault`` inside the service
    worker's engine-sweep ``try`` block, ``count`` times after ``after``
    matching sweeps, optionally filtered to one ``backend`` — the lever
    that trips the circuit breaker on demand.
  * ``delay_dispatch`` — sleep ``delay_ms`` in the dispatcher before a
    micro-batch is emitted, ``count`` times (straggler emulation).
  * ``corrupt_cache`` — overwrite bytes of an on-disk artifact-cache
    entry of this package's cache under ``path`` when fired (torn-write
    emulation; see also ``corrupt_cache_entry`` for direct use from
    tests).

Counters are per-spec and advance in the worker's own serialized event
order, so a plan is deterministic per process regardless of thread
timing: "kill worker 0 after 6 requests" always kills on the 7th
request *received by worker 0*.  ``seed`` keys any future randomized
knobs; the built-in faults are fully counter-driven.

    plan = FaultPlan([FaultSpec("exec_fault", backend="cuda", count=3)])
    install(plan)                       # or: env.update(plan.to_env())

The hook entry points (``on_request`` / ``check_exec`` /
``dispatch_delay``) are no-ops costing one global read when no plan is
active, so the serving hot path pays nothing in production.
"""
from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Dict, List, Optional

#: environment variable carrying a JSON-serialized plan into spawned
#: worker processes (set via ``FaultPlan.to_env()`` -> ``worker_env``)
FAULTS_ENV = "REPRO_TORCH_UAL_FAULTS"

#: exit code used by ``kill_worker`` — distinct from Python's own crash
#: codes so a chaos run's logs show which deaths were injected
KILL_EXIT_CODE = 43

_KINDS = ("kill_worker", "exec_fault", "delay_dispatch", "corrupt_cache")


class InjectedFault(RuntimeError):
    """An ``exec_fault`` spec fired: the sweep 'failed' on purpose."""


@dataclass(frozen=True)
class FaultSpec:
    """One deterministic fault: what fires, where, and when.

    ``after`` is how many matching events pass through unharmed before
    the spec arms; ``count`` bounds how many times it fires once armed
    (``kill_worker`` effectively fires once — the process is gone).
    """

    kind: str
    worker: Optional[int] = None     # kill_worker: target worker (None=any)
    after: int = 0
    count: int = 1
    backend: Optional[str] = None    # exec_fault: only this backend
    delay_ms: float = 0.0            # delay_dispatch: sleep length
    path: Optional[str] = None       # corrupt_cache: cache dir to poison

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {_KINDS}")
        if self.after < 0 or self.count < 1:
            raise ValueError(f"need after >= 0 and count >= 1, got "
                             f"after={self.after} count={self.count}")


@dataclass(frozen=True)
class FaultPlan:
    """A seedable, serializable list of ``FaultSpec``s.

    ``to_env()`` returns the environment fragment that activates this
    plan in a spawned process (merge into ``ClusterService``'s
    ``worker_env``); ``from_env()`` is the receiving side, consulted
    lazily by the hook entry points.
    """

    specs: List[FaultSpec]
    seed: int = 0

    def to_json(self) -> str:
        return json.dumps({"seed": self.seed,
                           "specs": [asdict(s) for s in self.specs]})

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        raw = json.loads(text)
        return cls(specs=[FaultSpec(**s) for s in raw.get("specs", [])],
                   seed=int(raw.get("seed", 0)))

    def to_env(self) -> Dict[str, str]:
        return {FAULTS_ENV: self.to_json()}

    @classmethod
    def from_env(cls, environ: Optional[Dict[str, str]] = None
                 ) -> Optional["FaultPlan"]:
        text = (environ if environ is not None else os.environ).get(
            FAULTS_ENV)
        if not text:
            return None
        return cls.from_json(text)


class FaultInjector:
    """Runtime state of an active plan: per-spec seen/fired counters.

    One injector per process; counters advance in the order the hooks
    are called, which the serving stack keeps serialized per worker
    (requests arrive on one message loop, sweeps on one batch at a
    time), so firings are reproducible.
    """

    def __init__(self, plan: FaultPlan,
                 worker_index: Optional[int] = None) -> None:
        self.plan = plan
        self.worker_index = worker_index
        self._lock = threading.Lock()
        self._seen = [0] * len(plan.specs)
        self._fired = [0] * len(plan.specs)
        self.log: List[Dict[str, object]] = []

    def _arm(self, idx: int, spec: FaultSpec) -> bool:
        """Count one matching event against ``spec``; True if it fires."""
        with self._lock:
            self._seen[idx] += 1
            if (self._seen[idx] > spec.after
                    and self._fired[idx] < spec.count):
                self._fired[idx] += 1
                self.log.append({"kind": spec.kind, "event": self._seen[idx],
                                 "firing": self._fired[idx]})
                return True
        return False

    # -- hook bodies ---------------------------------------------------------
    def on_request(self) -> None:
        """Cluster-worker hook, once per received request."""
        for idx, spec in enumerate(self.plan.specs):
            if spec.kind == "kill_worker":
                if (spec.worker is not None
                        and spec.worker != self.worker_index):
                    continue
                if self._arm(idx, spec):
                    # a real crash: no cleanup, no flush, no goodbye
                    os._exit(KILL_EXIT_CODE)
            elif spec.kind == "corrupt_cache":
                if self._arm(idx, spec) and spec.path:
                    corrupt_cache_entry(spec.path)

    def check_exec(self, backend: str) -> None:
        """Service-worker hook, inside the engine-sweep ``try`` block."""
        for idx, spec in enumerate(self.plan.specs):
            if spec.kind != "exec_fault":
                continue
            if spec.backend is not None and spec.backend != backend:
                continue
            if self._arm(idx, spec):
                raise InjectedFault(
                    f"injected exec fault on backend {backend!r} "
                    f"(firing {self._fired[idx]}/{spec.count})")

    def dispatch_delay(self) -> float:
        """Dispatcher hook: seconds to stall before emitting a batch."""
        total = 0.0
        for idx, spec in enumerate(self.plan.specs):
            if spec.kind != "delay_dispatch":
                continue
            if self._arm(idx, spec):
                total += spec.delay_ms / 1e3
        return total


# -- process-wide active injector -------------------------------------------
_state_lock = threading.Lock()
_injector: Optional[FaultInjector] = None
_env_checked = False


def install(plan: FaultPlan,
            worker_index: Optional[int] = None) -> FaultInjector:
    """Activate ``plan`` in this process (tests / in-process services)."""
    global _injector, _env_checked
    with _state_lock:
        _injector = FaultInjector(plan, worker_index)
        _env_checked = True
        return _injector


def clear() -> None:
    """Deactivate fault injection in this process."""
    global _injector, _env_checked
    with _state_lock:
        _injector = None
        _env_checked = True


def active() -> Optional[FaultInjector]:
    """The process's active injector, loading ``REPRO_TORCH_UAL_FAULTS`` from
    the environment on first call (spawned workers inherit the plan this
    way); None when no plan is active."""
    global _injector, _env_checked
    if _env_checked:
        return _injector
    with _state_lock:
        if not _env_checked:
            plan = FaultPlan.from_env()
            if plan is not None:
                _injector = FaultInjector(plan)
            _env_checked = True
    return _injector


def set_worker_index(widx: int) -> None:
    """Bind the env-loaded injector to a cluster worker index so
    ``kill_worker`` specs with ``worker=`` match (called by the cluster
    worker main before its message loop)."""
    inj = active()
    if inj is not None:
        inj.worker_index = widx


# -- module-level hook entry points (no-ops when inactive) -------------------
def on_request() -> None:
    inj = active()
    if inj is not None:
        inj.on_request()


def check_exec(backend: str) -> None:
    inj = active()
    if inj is not None:
        inj.check_exec(backend)


def dispatch_delay() -> None:
    inj = active()
    if inj is not None:
        d = inj.dispatch_delay()
        if d > 0:
            time.sleep(d)


# -- cache corruption (torn-write emulation) ---------------------------------
def corrupt_cache_entry(disk_dir, *, which: str = "mapping",
                        index: int = 0,
                        mode: str = "truncate") -> Optional[Path]:
    """Deterministically corrupt one on-disk entry of this package's
    artifact cache (``repro_torch.ual.cache``: ``torch_``-prefixed files
    that start with its magic; the JAX package's entries are never
    touched).

    Picks the ``index``-th (sorted) entry of the given layer
    (``"mapping"`` or ``"lowered"``) under ``disk_dir`` and either
    truncates it mid-payload (``mode="truncate"`` — a torn write from a
    killed process) or flips bytes in place (``mode="flip"`` — silent
    media corruption).  Returns the path it poisoned, or None when the
    layer has no entries.  The cache's checksummed read path must treat
    the result as a miss and quarantine the file.
    """
    from repro_torch.ual.cache import _MAGIC, _PREFIX
    d = Path(disk_dir)
    if not d.is_dir():
        return None
    names = sorted(p for p in d.glob(f"{_PREFIX}*.pkl")
                   if p.read_bytes()[:len(_MAGIC)] == _MAGIC)
    if which == "lowered":
        names = [p for p in names if p.name.endswith("_low.pkl")]
    else:
        names = [p for p in names if not p.name.endswith("_low.pkl")]
    if index >= len(names):
        return None
    path = names[index]
    blob = path.read_bytes()
    if mode == "truncate":
        cut = max(1, len(blob) // 2)
        path.write_bytes(blob[:cut])
    else:
        mid = len(blob) // 2
        mangled = bytes((b ^ 0xFF) for b in blob[mid:mid + 8])
        path.write_bytes(blob[:mid] + mangled + blob[mid + 8:])
    return path


__all__ = ("FAULTS_ENV", "KILL_EXIT_CODE", "FaultInjector", "FaultPlan",
           "FaultSpec", "InjectedFault", "active", "check_exec", "clear",
           "corrupt_cache_entry", "dispatch_delay", "install",
           "on_request", "set_worker_index")
