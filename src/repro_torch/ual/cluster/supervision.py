"""Worker supervision policy: respawn budgets, backoff, uptime.

The cluster watchdog used to only *evict* dead workers — every crash
permanently shrank the pool.  This module is the parent-side policy
state behind the healing watchdog: a ``RestartPolicy`` (how many
respawns a worker slot gets, how long to back off between them) and a
``WorkerState`` per slot (deaths, restarts, due times, recovery
timing).  Bounded restarts, failures as recorded events; stateless
pure-compute workers have no checkpoint to restore, so a respawned worker
rejoins warm off the shared artifact cache.  The same policy as the JAX
package's ``repro.ual.cluster.supervision``, field for field.

All mutation happens under the owning ``ClusterService``'s lock; this
module holds no locks of its own.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class RestartPolicy:
    """How a cluster heals dead workers.

    Each worker slot gets ``max_restarts`` respawns over the cluster's
    lifetime; the i-th respawn waits ``backoff_base_s * factor**i``
    (capped at ``backoff_max_s``) after the death is detected, so a
    crash-looping worker consumes its budget slowly instead of spinning.
    ``max_restarts=0`` restores the old evict-only behavior.
    """

    max_restarts: int = 3
    backoff_base_s: float = 0.25
    backoff_factor: float = 2.0
    backoff_max_s: float = 10.0

    def backoff_s(self, restarts: int) -> float:
        """Delay before the (restarts+1)-th respawn of a worker."""
        return min(self.backoff_base_s * (self.backoff_factor ** restarts),
                   self.backoff_max_s)

    def snapshot(self) -> Dict[str, object]:
        return {"max_restarts": self.max_restarts,
                "backoff_base_s": self.backoff_base_s,
                "backoff_factor": self.backoff_factor,
                "backoff_max_s": self.backoff_max_s}


@dataclass
class WorkerState:
    """Supervision record for one worker slot (guarded by the cluster
    lock).  The watchdog drives the lifecycle:

        record_death -> (backoff elapses) -> respawning=True ->
        process spawned -> record_respawned -> worker 'ready' ->
        record_ready

    ``respawning`` marks a spawn in progress so ``shutdown()`` can wait
    for it and reap the new process instead of leaking it (the
    shutdown/respawn race).
    """

    started_at: Optional[float] = None    # last (re)spawn, perf_counter
    ready_at: Optional[float] = None      # last 'ready' handshake
    died_at: Optional[float] = None       # last detected death
    deaths: int = 0
    restarts: int = 0
    last_backoff_s: float = 0.0
    next_respawn_at: Optional[float] = None
    respawning: bool = False
    exhausted: bool = False               # restart budget spent
    last_recovery_s: Optional[float] = None

    def record_death(self, now: float,
                     policy: RestartPolicy) -> Optional[float]:
        """One detected death; schedules the respawn and returns its
        backoff, or None (and marks the slot exhausted) when the budget
        is spent."""
        self.deaths += 1
        self.died_at = now
        if self.restarts >= policy.max_restarts:
            self.exhausted = True
            self.next_respawn_at = None
            return None
        self.last_backoff_s = policy.backoff_s(self.restarts)
        self.next_respawn_at = now + self.last_backoff_s
        return self.last_backoff_s

    def record_respawned(self, now: float) -> None:
        """The replacement process has been spawned and installed."""
        self.restarts += 1
        self.started_at = now
        self.next_respawn_at = None
        self.respawning = False

    def record_ready(self, now: float) -> None:
        """The worker's 'ready' handshake arrived (initial or respawn).
        Recovery time is death-detection -> ready, the number the chaos
        bench bounds."""
        self.ready_at = now
        if self.died_at is not None:
            self.last_recovery_s = now - self.died_at

    def snapshot(self, now: Optional[float] = None,
                 alive: bool = False) -> Dict[str, object]:
        if now is None:
            now = time.perf_counter()
        return {
            "alive": alive,
            "deaths": self.deaths,
            "restarts": self.restarts,
            "uptime_s": (round(now - self.ready_at, 3)
                         if alive and self.ready_at is not None else None),
            "last_backoff_s": round(self.last_backoff_s, 3),
            "respawn_due_in_s": (round(max(0.0, self.next_respawn_at - now),
                                       3)
                                 if self.next_respawn_at is not None
                                 else None),
            "respawning": self.respawning,
            "exhausted": self.exhausted,
            "last_recovery_s": (round(self.last_recovery_s, 3)
                                if self.last_recovery_s is not None
                                else None),
        }


__all__ = ("RestartPolicy", "WorkerState")
