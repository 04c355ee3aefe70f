"""Persistent execution engine: upload once, launch many.

The ``cuda`` and ``torch`` backends execute a lowered artifact through this
engine.  It keeps the reference engine's contract (``repro.ual.engine``):

  * ``CompiledKernelCache`` — the engine registry, keyed on
    ``(lowered fingerprint, lanes, device)``,
  * each ``KernelEngine`` uploads the linked tables to its device ONCE
    (``ops.upload_tables``) and keeps them there — the CM-resident-on-chip
    analogue — and every call launches the ``cgra_exec`` kernel
    (``kernels/cgra_exec``) over them: the hand-written CUDA kernel on a
    CUDA device, its plain PyTorch version on the CPU,
  * ``n_iters`` is a kernel argument, so one launch configuration per
    ``(M, bucket)`` serves every trip count,
  * batch sizes are padded up a small **bucket ladder** (default ``1, 8``,
    then every 4x up to ``lanes``, and ``lanes``: ``1, 8, 32, 128`` at the
    reference's 128 lanes, ``1, 8, 32, 128, 512, 2048, 4096`` at the
    ``cuda`` backend's 4096): variable-sized batches hit warm shapes, a
    batch pads to at most 4x its size, and batches beyond the largest
    bucket run as largest-bucket chunks — the number of distinct shapes
    stays O(#buckets) however traffic is shaped.

The first launch of each ``(M, bucket)`` shape counts as a "trace", so
``stats()["traces"]`` means what it means on the reference engine: the
number of distinct shapes this engine has specialised, at most one per
bucket.  Every engine also counts calls, per-bucket hits and padding waste;
``CompiledKernelCache.stats()`` aggregates them (``Executable.warmup()``
reports them in ``last_info``).

Not ported yet: the double-buffered ``run_stream`` and the multi-device
sharded engine.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.lowering import LinkedConfig, lowered_fingerprint
from repro_torch.kernels.cgra_exec import ops


def bucket_ladder(lanes: int = 128,
                  buckets: Optional[Sequence[int]] = None) -> Tuple[int, ...]:
    """The batch-size ladder: ascending, deduplicated, capped at ``lanes``
    (the largest launch — bigger batches run as largest-bucket chunks).
    The default is 1, 8, then every 4x below ``lanes``, and ``lanes``, so a
    batch pads to at most 4x its size; up to 128 lanes it is the
    reference's ``(1, 8, 32, lanes)``."""
    if buckets is None:
        buckets = [1, 8]
        while buckets[-1] * 4 < lanes:
            buckets.append(buckets[-1] * 4)
        buckets.append(lanes)
    ladder = sorted({int(b) for b in buckets if 1 <= int(b) <= lanes})
    if not ladder:
        raise ValueError(f"bucket ladder {buckets!r} has no entry in "
                         f"[1, lanes={lanes}]")
    return tuple(ladder)


def require_cuda() -> None:
    """Raise unless this process sees a CUDA device — the ``cuda`` path
    never falls back to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the 'cuda' backend runs the hand-written cgra_exec kernel on a "
            "CUDA device, and this process sees none; pass backend='torch' "
            "(or device='cpu') to run the plain PyTorch version on the CPU")


class KernelEngine:
    """One persistent engine: a lowered artifact on one device.

    Owns the device-resident tables and the per-``(M, bucket)`` warm-shape
    set; ``device`` is a CUDA device (the kernel) or the CPU (the plain
    version).
    """

    def __init__(self, linked: LinkedConfig, *, lanes: int = 128,
                 buckets: Optional[Sequence[int]] = None,
                 device="cuda") -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda":
            require_cuda()
        self.linked = linked
        self.lanes = lanes
        self.buckets = bucket_ladder(lanes, buckets)
        self.fingerprint = lowered_fingerprint(linked)
        self.name = f"cgra_exec-{self.device.type}"
        # the CM image goes to the device once per engine
        self.tables = ops.upload_tables(linked, self.device)
        # _trace_lock serializes first launches of a shape (so concurrent
        # callers count exactly one trace per bucket); _stats_lock guards
        # the counters and the warm-shape set
        self.traces = 0
        self.calls = 0
        self.samples = 0
        self.padded_samples = 0
        self.bucket_calls: Dict[int, int] = {}
        self._warm: set = set()              # (M, bucket) already launched
        self._trace_lock = threading.Lock()
        self._stats_lock = threading.Lock()

    def bucket_for(self, b: int) -> int:
        """Smallest ladder bucket >= b (callers chunk at the largest)."""
        for bk in self.buckets:
            if bk >= b:
                return bk
        return self.buckets[-1]

    def _launch(self, block: np.ndarray, n_iters: int) -> np.ndarray:
        """One padded (bucket, M) block through the kernel and back."""
        memT = torch.from_numpy(block).to(self.device).t().contiguous()
        out = ops.cgra_exec(self.tables, memT, n_iters)
        return out.t().contiguous().cpu().numpy()

    def _call_block(self, block: np.ndarray, n_iters: int
                    ) -> Tuple[np.ndarray, bool]:
        """Returns ``(out, was_cold)``: cold means THIS call was the first
        launch of the ``(M, bucket)`` shape, counted as one trace."""
        key = (block.shape[1], block.shape[0])
        with self._stats_lock:
            warm = key in self._warm
        if warm:
            return self._launch(block, n_iters), False
        with self._trace_lock:
            with self._stats_lock:
                cold = key not in self._warm
                if cold:
                    self.traces += 1
            out = self._launch(block, n_iters)
            with self._stats_lock:
                self._warm.add(key)
        return out, cold

    def run(self, flats: np.ndarray, n_iters: int
            ) -> Tuple[np.ndarray, Dict[str, object]]:
        """Execute a (B, M) batch of scratchpad images for ``n_iters``.

        Pads each chunk up the bucket ladder (B > largest bucket runs as
        largest-bucket chunks) and slices the padding back off; returns
        ``(out (B, M), per-call info)``.
        """
        flats = np.ascontiguousarray(flats, np.int32)
        if flats.ndim != 2:
            raise ValueError(f"expected (B, M) images, got {flats.shape}")
        B, M = flats.shape
        used: List[int] = []
        cold_blocks = 0
        top = self.buckets[-1]
        if B <= top and self.bucket_for(B) == B:
            # pad-free fast path: the batch IS a bucket
            out, was_cold = self._call_block(flats, n_iters)
            cold_blocks = int(was_cold)
            used.append(B)
        else:
            out = np.empty((B, M), np.int32)
            i = 0
            while i < B:
                chunk = min(B - i, top)
                rows = self.bucket_for(chunk)
                block = flats[i:i + chunk]
                if rows != chunk:
                    block = np.concatenate(
                        [block, np.zeros((rows - chunk, M), np.int32)])
                block_out, was_cold = self._call_block(block, n_iters)
                out[i:i + chunk] = block_out[:chunk]
                cold_blocks += was_cold
                used.append(rows)
                i += chunk
        with self._stats_lock:
            for rows in used:
                self.bucket_calls[rows] = self.bucket_calls.get(rows, 0) + 1
            self.padded_samples += sum(used) - B
            self.calls += 1
            self.samples += B
            traces_total = self.traces
        info = {
            "engine": self.name,
            "buckets": used,
            "padded": sum(used) - B,
            "traced": cold_blocks,
            "traces_total": traces_total,
        }
        return out, info

    def warmup(self, M: int,
               buckets: Optional[Sequence[int]] = None) -> Dict[str, object]:
        """Launch the ladder (or a subset) once for scratchpad width ``M``
        with a zero batch; ``n_iters`` is an argument, so one warm shape per
        bucket covers every trip count.  Sizes off the ladder snap UP to
        the bucket that will execute them, so re-warming is a no-op.
        Returns this engine's stats."""
        want = sorted({self.bucket_for(b) for b in
                       bucket_ladder(self.lanes, buckets or self.buckets)})
        for rows in want:
            with self._stats_lock:
                warm = (M, rows) in self._warm
            if not warm:
                self.run(np.zeros((rows, M), np.int32), 1)
        return self.stats()

    def stats(self) -> Dict[str, object]:
        with self._stats_lock:
            traces = self.traces
            bucket_calls = dict(sorted(self.bucket_calls.items()))
            snap = {
                "calls": self.calls,
                "samples": self.samples,
                "padded_samples": self.padded_samples,
                "warm_shapes": sorted(self._warm),
            }
        calls = sum(bucket_calls.values())
        hits = max(0, calls - traces)
        return {
            "traces": traces,
            "bucket_calls": bucket_calls,
            "hit_ratio": round(hits / calls, 4) if calls else None,
            "buckets": self.buckets,
            "device": str(self.device),
            **snap,
        }


class CompiledKernelCache:
    """The engine registry: one ``KernelEngine`` per
    ``(lowered fingerprint, lanes, device)``, created on first use and kept
    for the life of the process — shared by the backends and
    ``Executable.warmup``."""

    def __init__(self, buckets: Optional[Sequence[int]] = None) -> None:
        self.default_buckets = buckets
        self._engines: Dict[Tuple[str, int, str], KernelEngine] = {}
        self._lock = threading.Lock()

    def engine_for(self, linked: LinkedConfig, *, lanes: int = 128,
                   buckets: Optional[Sequence[int]] = None,
                   device="cuda") -> KernelEngine:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            require_cuda()
            dev = torch.device("cuda", torch.cuda.current_device())
        key = (lowered_fingerprint(linked), lanes, str(dev))
        with self._lock:
            eng = self._engines.get(key)
            if eng is None:
                eng = KernelEngine(linked, lanes=lanes,
                                   buckets=buckets or self.default_buckets,
                                   device=dev)
                self._engines[key] = eng
            return eng

    def run(self, linked: LinkedConfig, flats: np.ndarray, n_iters: int, *,
            lanes: int = 128, device="cuda"
            ) -> Tuple[np.ndarray, Dict[str, object]]:
        return self.engine_for(linked, lanes=lanes,
                               device=device).run(flats, n_iters)

    def warmup(self, linked: LinkedConfig, M: int, *,
               buckets: Optional[Sequence[int]] = None, lanes: int = 128,
               device="cuda") -> Dict[str, object]:
        return self.engine_for(linked, lanes=lanes,
                               device=device).warmup(M, buckets)

    def stats(self) -> Dict[str, object]:
        """Aggregate over every engine: total traces / calls / samples,
        hit ratio, plus the per-engine breakdown."""
        with self._lock:
            engines = dict(self._engines)
        per = {f"{fp[:12]}/lanes={lanes}/{dev}": e.stats()
               for (fp, lanes, dev), e in engines.items()}
        traces = sum(e["traces"] for e in per.values())
        bucket_calls = sum(sum(e["bucket_calls"].values())
                           for e in per.values())
        hits = max(0, bucket_calls - traces)
        return {
            "engines": len(per),
            "traces": traces,
            "calls": sum(e["calls"] for e in per.values()),
            "samples": sum(e["samples"] for e in per.values()),
            "padded_samples": sum(e["padded_samples"] for e in per.values()),
            "hit_ratio": round(hits / bucket_calls, 4) if bucket_calls
            else None,
            "per_engine": per,
        }

    def __len__(self) -> int:
        with self._lock:
            return len(self._engines)


_default: Optional[CompiledKernelCache] = None
_default_lock = threading.Lock()


def default_engine() -> CompiledKernelCache:
    """The process-wide engine cache the backends use by default.  Its
    aggregate stats are registered as the ``engine`` source in the metrics
    registry (read through this accessor, so swapping the default engine
    needs no re-registration)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = CompiledKernelCache()
            obs.registry().register_source(
                "engine", lambda: default_engine().stats(), replace=True)
        return _default


def set_default_engine(cache: Optional[CompiledKernelCache]
                       ) -> CompiledKernelCache:
    """Swap the process-wide engine cache (e.g. a fresh one in tests);
    returns the previous one so callers can restore it."""
    global _default
    prev = default_engine()
    with _default_lock:
        _default = cache
    return prev
