"""ReplicaPool + Router: who runs the next micro-batch, and where.

A ``ReplicaSlot`` is one execution replica — a worker thread, optionally
pinned to one torch device (``slot.device``), executing micro-batches
against the per-class warm Executables the ``Service`` shares across
slots (the *engines* under them are per-device: ``engine_for(device=)``
keys the trace cache on placement, so replicas never contend on one
device's queue).

The ``Router`` makes two decisions:

  * **route** (dispatcher side) — a flush-ready micro-batch goes to the
    least-loaded slot (queued + in-flight); among equally-loaded slots,
    one that has already executed this compatibility class wins
    (*affinity*: its engine is warm for the class), counted separately
    in ``decisions`` so tests can see both policies fire.
  * **pull** (worker side) — a slot takes its own queue first; when
    empty it **steals the oldest batch from the most-loaded sibling**
    (work conservation: an idle replica never watches a busy one's
    backlog grow).  Steals are counted per slot and globally.

The router is also the idle signal for the *coalescer-side* stealing in
``Service``: when ``idle_slots() > 0`` the dispatcher may flush a
partial bucket early (``Coalescer.steal_oldest``) instead of letting
idle capacity wait out ``max_wait_ms`` — that count lives in
``early_flushes``.

``stats()`` is the per-replica view the cluster front-end merges:
batches / samples / busy seconds / steals per slot, plus the decision
counters.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional, Sequence


class ReplicaSlot:
    """One replica's routing state (guarded by the Router's lock)."""

    def __init__(self, index: int, device=None) -> None:
        self.index = index
        self.device = device              # torch device, or None (default)
        self.queue: deque = deque()       # routed (key, batch) pairs
        self.in_flight = 0                # batches being executed now
        self.batches = 0                  # completed batches
        self.samples = 0                  # completed samples
        self.busy_s = 0.0                 # wall seconds inside sweeps
        self.steals = 0                   # batches this slot stole
        self.warm: set = set()            # class keys this slot has run

    def load(self) -> int:
        """Routing load: queued + executing batches."""
        return len(self.queue) + self.in_flight

    def stats(self) -> Dict[str, object]:
        busy = self.busy_s
        return {
            "device": (str(self.device) if self.device is not None
                       else None),
            "batches": self.batches,
            "samples": self.samples,
            "busy_s": round(busy, 4),
            "samples_per_s": (round(self.samples / busy, 1) if busy > 0
                              else 0.0),
            "steals": self.steals,
            "queued": len(self.queue),
            "in_flight": self.in_flight,
            "warm_classes": len(self.warm),
        }


class Router:
    """Least-loaded dispatch + idle work stealing over N replica slots."""

    def __init__(self, slots: int, devices: Optional[Sequence] = None
                 ) -> None:
        if slots < 1:
            raise ValueError(f"need at least 1 replica slot, got {slots}")
        devs = list(devices) if devices else [None] * slots
        if devices and len(devs) < slots:
            raise ValueError(f"{slots} slots but only {len(devs)} devices")
        self.slots = [ReplicaSlot(i, devs[i] if devices else None)
                      for i in range(slots)]
        self._cond = threading.Condition()
        self._stopped = False
        self.decisions: Dict[str, int] = {"affinity": 0, "least_loaded": 0}
        self.steals = 0
        self.early_flushes = 0

    # -- dispatcher side ------------------------------------------------------
    def route(self, key, batch, *, early: bool = False) -> int:
        """Assign a flush-ready micro-batch to a slot; returns its index.

        Least-loaded wins; among ties, a slot already warm for ``key``
        (affinity).  ``early=True`` marks a coalescer-side early flush
        (idle capacity stole a partial bucket from the clock)."""
        with self._cond:
            min_load = min(s.load() for s in self.slots)
            cands = [s for s in self.slots if s.load() == min_load]
            warm = [s for s in cands if key in s.warm]
            if warm:
                slot = warm[0]
                self.decisions["affinity"] += 1
            else:
                slot = cands[0]
                self.decisions["least_loaded"] += 1
            if early:
                self.early_flushes += 1
            slot.queue.append((key, batch))
            self._cond.notify_all()
            return slot.index

    def idle_slots(self) -> int:
        """Slots with nothing queued and nothing executing — the
        dispatcher's signal that a partial bucket may flush early."""
        with self._cond:
            return sum(1 for s in self.slots if s.load() == 0)

    def queued(self) -> int:
        with self._cond:
            return sum(len(s.queue) for s in self.slots)

    # -- worker side ----------------------------------------------------------
    def pull(self, index: int, timeout: Optional[float] = None):
        """Next ``(key, batch, stolen)`` for slot ``index``; None on
        timeout, or on stop once every queue has drained.

        Own queue first; otherwise steal the OLDEST batch from the
        most-loaded sibling — FIFO across the pool, so stealing reduces
        tail latency instead of reordering it."""
        deadline = (time.perf_counter() + timeout
                    if timeout is not None else None)
        slot = self.slots[index]
        with self._cond:
            while True:
                if slot.queue:
                    key, batch = slot.queue.popleft()
                    slot.in_flight += 1
                    slot.warm.add(key)
                    return key, batch, False
                victim = max(
                    (s for s in self.slots if s.queue),
                    key=lambda s: len(s.queue), default=None)
                if victim is not None:
                    key, batch = victim.queue.popleft()
                    slot.in_flight += 1
                    slot.warm.add(key)
                    slot.steals += 1
                    self.steals += 1
                    return key, batch, True
                if self._stopped:
                    return None
                if deadline is None:
                    self._cond.wait()
                else:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        return None
                    self._cond.wait(remaining)

    def done(self, index: int, n_samples: int, busy_s: float) -> None:
        """A slot finished a batch; updates load + throughput counters."""
        with self._cond:
            slot = self.slots[index]
            slot.in_flight -= 1
            slot.batches += 1
            slot.samples += n_samples
            slot.busy_s += busy_s
            self._cond.notify_all()

    # -- lifecycle ------------------------------------------------------------
    def stop(self) -> None:
        """No more routes are coming: pulls drain remaining queues, then
        return None (workers exit)."""
        with self._cond:
            self._stopped = True
            self._cond.notify_all()

    # -- observability --------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        with self._cond:
            return {
                "replicas": len(self.slots),
                "decisions": dict(self.decisions),
                "steals": self.steals,
                "early_flushes": self.early_flushes,
                "slots": [s.stats() for s in self.slots],
            }


__all__ = ("ReplicaSlot", "Router")
