"""The coalescer: single-sample requests -> flush-ready micro-batches.

Requests are bucketed by ``Request.key`` (program digest, target digest,
backend, trip count — the class that shares one lowered artifact).  A
bucket flushes on whichever comes first:

  * **size** — it reaches ``max_batch`` (returned directly from
    ``offer``, so a hot tenant never waits on the clock),
  * **age** — its *oldest* request has waited ``max_wait_s``
    (``pop_expired``), bounding the latency a lone request pays for the
    chance of company, or
  * **deadline** — a member's deadline arrives: the bucket flushes so
    the scheduler can issue the ``deadline-exceeded`` verdict (and run
    the still-live members) *at* the deadline, not at the next age
    flush — rejection latency stays bounded by the deadline itself.

``next_deadline`` tells the dispatcher how long it may sleep before some
bucket comes due — the queue->coalesce->sweep loop polls nothing.

The coalescer is owned by the single dispatcher thread; it is not
thread-safe and needs no lock.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.ual.service.queue import Request

Key = Tuple[str, str, str, int]


class Coalescer:
    def __init__(self, max_batch: int, max_wait_s: float) -> None:
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self._groups: Dict[Key, List[Request]] = {}

    def _due(self, group: List[Request]) -> float:
        """Absolute time this bucket must flush: its age limit, pulled
        earlier by the tightest member deadline."""
        due = group[0].t_submit + self.max_wait_s
        for req in group:
            if req.deadline is not None and req.deadline < due:
                due = req.deadline
        return due

    def offer(self, req: Request) -> Optional[List[Request]]:
        """Add a request to its bucket; return the bucket when it just
        filled to ``max_batch`` (the caller dispatches it), else None."""
        group = self._groups.setdefault(req.key, [])
        group.append(req)
        if len(group) >= self.max_batch:
            del self._groups[req.key]
            return group
        return None

    def pop_expired(self, now: float) -> List[List[Request]]:
        """Buckets that have come due (aged out, or a member deadline)."""
        out = []
        for key in list(self._groups):
            group = self._groups[key]
            if now >= self._due(group):
                out.append(group)
                del self._groups[key]
        return out

    def steal_oldest(self, now: float,
                     min_age_s: float = 0.0) -> Optional[List[Request]]:
        """Pop the earliest-due partial bucket whose oldest member has
        aged at least ``min_age_s`` — the dispatcher calls this when a
        replica is IDLE (``Router.idle_slots``): a waiting bucket trades
        its remaining chance of company for immediate execution on
        capacity that would otherwise do nothing.  ``min_age_s`` damps
        thrash: a brand-new bucket under a briefly-idle pool still gets
        a moment to coalesce.  Returns None when nothing qualifies."""
        best_key = None
        best_due = None
        for key, group in self._groups.items():
            if now - group[0].t_submit < min_age_s:
                continue
            due = self._due(group)
            if best_due is None or due < best_due:
                best_key, best_due = key, due
        if best_key is None:
            return None
        return self._groups.pop(best_key)

    def flush_all(self) -> List[List[Request]]:
        """Everything pending, regardless of size or age (shutdown)."""
        out = list(self._groups.values())
        self._groups.clear()
        return out

    def next_deadline(self, now: float) -> Optional[float]:
        """Seconds until the earliest bucket comes due (may be <= 0 when
        one already is), or None when nothing is pending."""
        if not self._groups:
            return None
        return min(self._due(g) for g in self._groups.values()) - now

    def pending(self) -> int:
        return sum(len(g) for g in self._groups.values())
