"""Per-class circuit breaker: degrade a failing backend, probe, restore.

The ``cgra_exec`` engine is the fast path, but it is also the deep
end of the stack — a kernel that fails to build or launch, a poisoned
device, or an injected fault (``repro_torch.ual.faults``) can make its
sweeps fail while the rest of the service is perfectly healthy.  Because
every degradable backend pair here executes the *same lowered artifact*
bit-exactly (``sim`` consumes the dense linked tables exactly like
``cuda`` and ``torch``), falling back trades throughput for availability
without changing a single output word.  A fallback is never silent:
every degraded sweep is counted (``degraded_batches_total``) and marked
on its callers' futures (``info["degraded_to"]``).

States, per compatibility class (``Request.key``):

  * ``closed``    — primary backend; consecutive-failure counter runs.
  * ``open``      — ``threshold`` consecutive primary failures tripped
    the class; every sweep runs on the fallback until ``cooldown_s``
    has passed.
  * ``half-open`` — cooldown elapsed: exactly ONE probe sweep tries the
    primary again (concurrent sweeps stay on the fallback).  Success
    closes the class (restore); failure re-opens it for another
    cooldown.

The owning ``Service`` drives the protocol: ``plan()`` before a sweep
(which backend, is this the probe), ``record_failure`` /
``record_success`` after, ``record_degraded`` when a failed sweep was
re-run in place on the fallback.  ``stats()`` is the
``Service.stats()["breaker"]`` payload.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

#: default degradation map: primary backend -> bit-exact fallback
#: (both consume the shared lowered artifact, so survivors stay exact);
#: ``torch``, the kernel's plain version on the CPU, degrades like ``cuda``,
#: and the sharded pair like their single-device twins
DEGRADABLE: Dict[str, str] = {"cuda": "sim", "torch": "sim",
                              "cuda_sharded": "sim", "torch_sharded": "sim"}


class _ClassState:
    __slots__ = ("state", "consecutive", "trips", "restores",
                 "degraded_batches", "open_until", "probing")

    def __init__(self) -> None:
        self.state = "closed"
        self.consecutive = 0
        self.trips = 0
        self.restores = 0
        self.degraded_batches = 0
        self.open_until = 0.0
        self.probing = False


class CircuitBreaker:
    """Consecutive-failure breaker over the service's batch classes."""

    def __init__(self, threshold: int = 3, cooldown_s: float = 5.0,
                 fallbacks: Optional[Dict[str, str]] = None) -> None:
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.fallbacks = dict(DEGRADABLE if fallbacks is None else fallbacks)
        self._lock = threading.Lock()
        self._classes: Dict[tuple, _ClassState] = {}
        self.trips_total = 0
        self.degraded_total = 0

    def fallback_for(self, backend: str) -> Optional[str]:
        """The degradation target for ``backend`` (None: not degradable)."""
        return self.fallbacks.get(backend)

    def plan(self, key: tuple, backend: str,
             now: float) -> Tuple[Optional[str], bool]:
        """Pre-sweep decision for one batch of class ``key``.

        Returns ``(fallback_or_None, is_probe)``: None means run the
        primary backend (possibly as the half-open probe); a backend
        name means the class is degraded and the sweep must run there.
        """
        if backend not in self.fallbacks:
            return None, False
        with self._lock:
            st = self._classes.get(key)
            if st is None or st.state == "closed":
                return None, False
            if st.state == "open" and now >= st.open_until and not st.probing:
                st.state = "half-open"
                st.probing = True
                return None, True
            st.degraded_batches += 1
            self.degraded_total += 1
            return self.fallbacks[backend], False

    def record_success(self, key: tuple, probe: bool = False) -> bool:
        """A primary-backend sweep succeeded; True when a probe success
        just restored the class to ``closed``."""
        with self._lock:
            st = self._classes.get(key)
            if st is None:
                return False
            st.consecutive = 0
            if probe:
                st.state = "closed"
                st.probing = False
                st.restores += 1
                return True
            return False

    def record_failure(self, key: tuple, now: float,
                       probe: bool = False) -> bool:
        """A primary-backend sweep failed; True when this failure tripped
        (or re-opened) the class."""
        with self._lock:
            st = self._classes.setdefault(key, _ClassState())
            st.consecutive += 1
            if probe:
                # failed probe: straight back to open, fresh cooldown
                st.state = "open"
                st.open_until = now + self.cooldown_s
                st.probing = False
                return True
            if st.state == "closed" and st.consecutive >= self.threshold:
                st.state = "open"
                st.open_until = now + self.cooldown_s
                st.trips += 1
                self.trips_total += 1
                return True
            return False

    def record_degraded(self, key: tuple) -> None:
        """A failed primary sweep was re-run in place on the fallback."""
        with self._lock:
            st = self._classes.setdefault(key, _ClassState())
            st.degraded_batches += 1
            self.degraded_total += 1

    def state_of(self, key: tuple) -> str:
        with self._lock:
            st = self._classes.get(key)
            return st.state if st is not None else "closed"

    def stats(self) -> Dict[str, object]:
        """The ``Service.stats()["breaker"]`` payload: per-class state
        keyed by a short human-readable class tag, plus totals."""
        with self._lock:
            classes = {}
            for key, st in self._classes.items():
                tag = f"{key[2]}:{key[0][:8]}:{key[1][:8]}:n{key[3]}"
                classes[tag] = {
                    "state": st.state,
                    "consecutive_failures": st.consecutive,
                    "trips": st.trips,
                    "restores": st.restores,
                    "degraded_batches": st.degraded_batches,
                }
            return {
                "threshold": self.threshold,
                "cooldown_s": self.cooldown_s,
                "fallbacks": dict(self.fallbacks),
                "trips_total": self.trips_total,
                "degraded_batches_total": self.degraded_total,
                "classes": classes,
            }


__all__ = ("DEGRADABLE", "CircuitBreaker")
