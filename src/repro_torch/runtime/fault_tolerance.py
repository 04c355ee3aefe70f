"""Fault tolerance: heartbeat failure detection, checkpoint/restart,
elastic re-meshing, and straggler mitigation (the JAX package's
``runtime/fault_tolerance.py``, over the port's checkpoints; the restart
semantics are the same).

At 1000+ nodes the failure model is: some host stops making progress
(hardware fault, preemption) or persistently lags (straggler).  The
supervisor wraps the training loop:

  * every step each worker "heartbeats" (here: a callback hook; on a real
    fleet, a distributed KV store / GCS object);
  * a missed-deadline heartbeat marks the worker failed -> the job restores
    the latest checkpoint and continues, optionally on a *smaller* data
    axis (elastic re-mesh: the checkpoint re-shards on load because arrays
    are stored mesh-agnostically and the data pipeline is a pure function
    of (seed, step, index));
  * stragglers (per-step time > straggler_factor x EMA) are counted and,
    past a threshold, treated as failures (re-dispatch policy).

The failure injection hook makes all of this unit-testable on CPU.

This module covers the *training* loop.  The serving-side sibling —
worker respawn under ``RestartPolicy``, transparent request retry, the
per-class circuit breaker, and the ``repro_torch.ual.faults`` deterministic
injection harness — lives in ``repro_torch.ual.cluster.supervision`` /
``repro_torch.ual.service.breaker``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.checkpoint.checkpoint import latest_step, restore, save


class WorkerFailure(RuntimeError):
    def __init__(self, worker: int, reason: str):
        super().__init__(f"worker {worker}: {reason}")
        self.worker = worker
        self.reason = reason


@dataclass
class FaultConfig:
    ckpt_dir: str = "/tmp/ckpt"
    ckpt_every: int = 50
    heartbeat_timeout_s: float = 300.0
    straggler_factor: float = 2.5
    straggler_strikes: int = 3
    max_restarts: int = 5


@dataclass
class StragglerMonitor:
    factor: float = 2.5
    strikes_to_fail: int = 3
    ema: float = 0.0
    alpha: float = 0.1
    strikes: Dict[int, int] = field(default_factory=dict)

    def observe(self, worker: int, step_time: float) -> Optional[str]:
        """Returns 'straggler' | 'fail' | None."""
        if self.ema == 0.0:
            self.ema = step_time
            return None
        verdict = None
        if step_time > self.factor * self.ema:
            self.strikes[worker] = self.strikes.get(worker, 0) + 1
            verdict = ("fail" if self.strikes[worker] >= self.strikes_to_fail
                       else "straggler")
        else:
            self.strikes[worker] = 0
        self.ema = (1 - self.alpha) * self.ema + self.alpha * step_time
        return verdict


class Supervisor:
    """Checkpoint/restart training supervisor (single-controller view)."""

    def __init__(self, cfg: FaultConfig, *, make_state: Callable[[], dict],
                 step_fn: Callable[[dict, int], dict],
                 on_remesh: Optional[Callable[[int], None]] = None):
        self.cfg = cfg
        self.make_state = make_state
        self.step_fn = step_fn
        self.on_remesh = on_remesh
        self.monitor = StragglerMonitor(cfg.straggler_factor,
                                        cfg.straggler_strikes)
        self.restarts = 0
        self.events: List[dict] = []

    def run(self, n_steps: int,
            failure_hook: Optional[Callable[[int], Optional[Exception]]] = None
            ) -> dict:
        state = self._restore_or_init()
        step = int(state.pop("__step__", 0))
        while step < n_steps:
            try:
                if failure_hook is not None:
                    err = failure_hook(step)
                    if err is not None:
                        raise err
                t0 = time.time()
                state = self.step_fn(state, step)
                verdict = self.monitor.observe(0, time.time() - t0)
                if verdict == "fail":
                    raise WorkerFailure(0, "persistent straggler")
                step += 1
                if step % self.cfg.ckpt_every == 0 or step == n_steps:
                    save(self.cfg.ckpt_dir, step, state,
                         extra={"step": step})
            except (WorkerFailure, RuntimeError) as e:
                self.restarts += 1
                self.events.append({"step": step, "error": str(e),
                                    "restart": self.restarts})
                if self.restarts > self.cfg.max_restarts:
                    raise
                if isinstance(e, WorkerFailure) and self.on_remesh:
                    self.on_remesh(e.worker)
                state = self._restore_or_init()
                step = int(state.pop("__step__", 0))
        return state

    def _restore_or_init(self) -> dict:
        last = latest_step(self.cfg.ckpt_dir)
        if last is None:
            s = self.make_state()
            s["__step__"] = 0
            return s
        template = self.make_state()
        state, manifest = restore(self.cfg.ckpt_dir, template, step=last)
        state["__step__"] = manifest["extra"].get("step", last)
        return state
