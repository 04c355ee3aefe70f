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

On a CUDA device every block goes up and comes back through pinned host
buffers, reused per ``(M, bucket)``, with the upload, the kernel and the
download on three streams of their own (``KernelEngine``).  ``run_stream``
pipelines bucket-sized chunks through them with **double buffering**:
while chunk *i* downloads, chunk *i+1* uploads and computes and the host
stages the next — the same bucket-ladder shapes (zero new traces on a warm
engine).  Chunks are yielded as they drain; the generator's return value
reports ``overlap_frac`` (the fraction of the wall the host spent working
instead of blocked on the device), ``stream_chunks`` and throughput.  On
the CPU the same generator runs each chunk in turn.

The first launch of each ``(M, bucket)`` shape counts as a "trace", so
``stats()["traces"]`` means what it means on the reference engine: the
number of distinct shapes this engine has specialised, at most one per
bucket.  Every engine also counts calls, per-bucket hits, padding waste
and streaming activity (``streams``/``stream_chunks``);
``CompiledKernelCache.stats()`` aggregates them (the execution service
surfaces this in ``Service.stats()["engine"]``, and ``Executable.warmup()``
reports it in ``last_info``).

``ShardedKernelEngine`` is the multi-device engine behind the
``cuda_sharded`` and ``torch_sharded`` backends: one ``KernelEngine`` per
device of a host mesh (``launch.mesh.make_host_mesh``), each with the
tables, pinned buffers and streams of its own.  A block of ``chunk`` samples
runs at ``n_devices x bucket_for(ceil(chunk / n_devices))`` rows, the
reference's block plan: each device takes its row range, padded with zero
rows to the per-device bucket, and the results are gathered in order.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple, Union)

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


#: bytes of one staged piece on a CUDA device: the host fills a block's
#: pinned buffer a piece at a time, each piece's upload enqueued as soon as
#: it is filled, and the download comes back in pieces too (128 rows at an
#: 8192-word scratchpad).
STAGE_BYTES = 4 << 20


class _Slot:
    """One pinned host staging buffer of an ``(M, bucket)`` shape: the
    block's rows go up from it and its results come back into it."""

    __slots__ = ("host", "view")

    def __init__(self, rows: int, M: int) -> None:
        self.host = torch.empty((rows, M), dtype=torch.int32,
                                pin_memory=True)
        self.view = self.host.numpy()


class _InFlight:
    """One dispatched block: ``b`` live rows padded to ``rows``.  On a CUDA
    device its results sit in ``d_out`` once ``done`` fires until their
    download is enqueued (``d_out`` then goes to None), and land in
    ``slot`` as ``events`` (one a piece) fire.  On the CPU ``out`` already
    holds the results."""

    __slots__ = ("b", "rows", "cold", "slot", "d_out", "done", "events",
                 "out", "t_up", "t_disp")

    def __init__(self, b: int, rows: int, slot: Optional[_Slot] = None,
                 d_out=None, done=None, out: Optional[np.ndarray] = None
                 ) -> None:
        self.b = b
        self.rows = rows
        self.cold = False
        self.slot = slot
        self.d_out = d_out
        self.done = done
        self.events: List = []
        self.out = out
        self.t_up = self.t_disp = 0.0       # host clock around dispatch


def _pieces(rows: int, M: int) -> List[Tuple[int, int]]:
    step = max(1, STAGE_BYTES // (4 * M))
    return [(r, min(r + step, rows)) for r in range(0, rows, step)]


class Flattened:
    """B named-array dicts standing for their (B, M) scratchpad images:
    the engine flattens them (``program.flatten_batch(..., out=)``) a
    piece at a time straight into its staging buffer, so no (B, M) array
    of their own is made.  Slices like an array."""

    def __init__(self, program, mems: Sequence[Dict[str, np.ndarray]]
                 ) -> None:
        self.program = program
        self.mems = list(mems)
        self.shape = (len(self.mems), program.layout.total_words)

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, rows: slice) -> "Flattened":
        return Flattened(self.program, self.mems[rows])

    def write(self, out: np.ndarray, r0: int, r1: int) -> None:
        """Flatten samples ``r0:r1`` into ``out`` ((r1 - r0, M) int32)."""
        self.program.flatten_batch(self.mems[r0:r1], out=out)


def _write(block, out: np.ndarray, r0: int, r1: int) -> None:
    """Rows ``r0:r1`` of a block (an array or ``Flattened``) into ``out``."""
    if isinstance(block, Flattened):
        block.write(out, r0, r1)
    else:
        out[...] = block[r0:r1]


class KernelEngine:
    """One persistent engine: a lowered artifact on one device.

    Owns the device-resident tables and the per-``(M, bucket)`` warm-shape
    set; ``device`` is a CUDA device (the kernel) or the CPU (the plain
    version).

    On a CUDA device every block is staged through a **pinned** host
    buffer, allocated once per ``(M, bucket)`` and reused (a pool: a
    buffer goes back to it only after its results are copied out, so no
    buffer is refilled while a copy may still read or write it, and no
    caller's result aliases one).  The upload, the kernel and the download
    go on three CUDA streams of their own, ordered by events, without
    blocking the host; the host fills the buffer in pieces of
    ``STAGE_BYTES``, so a piece's upload runs while the host fills the
    next.  In a pipeline of blocks a block's download waits for the next
    block: the host fills that one's buffer whole, enqueues its upload as
    one copy and the download right behind it, so the card's two copy
    directions run at once; the last block downloads as soon as the
    source ends.
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
        self.tables = self._put_tables(linked)
        # _trace_lock serializes first launches of a shape (so concurrent
        # callers count exactly one trace per bucket); _stats_lock guards
        # the counters, the warm-shape set and the staging pool
        self.traces = 0
        self.calls = 0
        self.samples = 0
        self.padded_samples = 0
        self.streams = 0             # run_stream invocations completed
        self.stream_chunks = 0       # chunks drained across all streams
        self.pinned_bytes = 0        # pinned staging allocated (a pool: its peak)
        self.bucket_calls: Dict[int, int] = {}
        self._warm: set = set()              # (M, bucket) already launched
        self._free: Dict[Tuple[int, int], List[_Slot]] = {}
        self._cuda_streams: Optional[Tuple[object, object, object]] = None
        self._trace_lock = threading.Lock()
        self._stats_lock = threading.Lock()

    def _put_tables(self, linked: LinkedConfig):
        return ops.upload_tables(linked, self.device)

    def _info_extra(self) -> Dict[str, object]:
        """Engine-flavour extras merged into per-call info and stats."""
        return {}

    def bucket_for(self, b: int) -> int:
        """Smallest ladder bucket >= b (callers chunk at the largest)."""
        for bk in self.buckets:
            if bk >= b:
                return bk
        return self.buckets[-1]

    # -- the block plan (overridden by the sharded engine) --------------------
    def _capacity(self) -> int:
        """Rows one block can carry; ``run`` chunks bigger batches."""
        return self.buckets[-1]

    def _block_rows(self, chunk: int) -> int:
        """Padded row count the block for ``chunk`` samples runs at."""
        return self.bucket_for(chunk)

    # -- staging (CUDA) --------------------------------------------------------
    def _acquire(self, M: int, rows: int) -> _Slot:
        """A free pinned buffer of the shape; a new one only when every
        buffer of the shape is in use (one per concurrent block)."""
        with self._stats_lock:
            free = self._free.get((M, rows))
            if free:
                return free.pop()
            self.pinned_bytes += 4 * rows * M
        return _Slot(rows, M)

    def _release(self, slot: _Slot) -> None:
        with self._stats_lock:
            self._free.setdefault(tuple(slot.host.shape[::-1]),
                                  []).append(slot)

    def _stream_set(self):
        """(upload, compute, download) streams of this engine's device,
        created on first use."""
        with self._stats_lock:
            if self._cuda_streams is None:
                self._cuda_streams = tuple(
                    torch.cuda.Stream(device=self.device) for _ in range(3))
            return self._cuda_streams

    def _download(self, fl: _InFlight) -> None:
        """Enqueue a CUDA block's download, a piece at a time, each piece
        followed by its event (once; a no-op after that and on the CPU)."""
        if fl.d_out is None:
            return
        down = self._stream_set()[2]
        with torch.cuda.device(self.device), torch.cuda.stream(down):
            down.wait_event(fl.done)
            fl.d_out.record_stream(down)
            for r0, r1 in _pieces(fl.b, fl.d_out.shape[1]):
                fl.slot.host[r0:r1].copy_(fl.d_out[r0:r1], non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(down)
                fl.events.append(ev)
        fl.d_out = None

    def _enqueue(self, block, rows: int, n_iters: int,
                 before: Optional[_InFlight] = None) -> _InFlight:
        """Start one (b, M) block (an array or ``Flattened``), padded to
        ``rows``, through the kernel; returns without waiting for the
        device (CUDA) or with the result (CPU, where the plain version
        runs right here).  On CUDA the block's download is left to
        ``_download``.  With ``before`` (a block whose download is still
        to go) the buffer is filled whole and uploaded in one copy, with
        ``before``'s download enqueued right behind it, so the two overlap
        however slowly the host fills; else each piece goes up as soon as
        it is filled."""
        b, M = block.shape
        if self.device.type == "cpu":
            padded = np.zeros((rows, M), np.int32)
            _write(block, padded[:b], 0, b)
            out = ops.cgra_exec(self.tables,
                                torch.from_numpy(padded).t().contiguous(),
                                n_iters)
            return _InFlight(b, rows, out=out.t().contiguous().numpy()[:b])
        slot = self._acquire(M, rows)
        up, compute, _ = self._stream_set()
        whole = before is not None and before.d_out is not None
        with torch.cuda.device(self.device):
            with torch.cuda.stream(up):
                d_in = torch.empty((rows, M), dtype=torch.int32,
                                   device=self.device)
                for r0, r1 in _pieces(rows, M):
                    lo, hi = min(r0, b), min(r1, b)
                    if hi > lo:
                        _write(block, slot.view[lo:hi], lo, hi)
                    slot.view[max(r0, b):r1] = 0     # bucket padding
                    if not whole:
                        d_in[r0:r1].copy_(slot.host[r0:r1], non_blocking=True)
                if whole:
                    d_in.copy_(slot.host, non_blocking=True)
            if whole:
                self._download(before)
            compute.wait_stream(up)
            with torch.cuda.stream(compute):
                d_in.record_stream(compute)
                out = ops.cgra_exec(self.tables, d_in.t().contiguous(),
                                    n_iters)
                d_out = out.t().contiguous()
                done = torch.cuda.Event()
                done.record(compute)
        return _InFlight(b, rows, slot=slot, d_out=d_out, done=done)

    def _drain(self, fl: _InFlight, into: Optional[np.ndarray] = None,
               consume: Optional[Callable[[np.ndarray], object]] = None
               ) -> Tuple[object, float]:
        """Wait for one block and take its ``b`` result rows out of the
        staging buffer: ``consume(rows)`` (which must copy what it keeps:
        the buffer is reused) when given, else a copy (into ``into`` when
        given).  Returns ``(result, host seconds blocked on the
        device)``."""
        if fl.slot is None:
            if consume is not None:
                return consume(fl.out), 0.0
            if into is not None:
                into[...] = fl.out
                return into, 0.0
            return fl.out, 0.0
        self._download(fl)
        view = fl.slot.view
        out = None
        if consume is None:
            out = into if into is not None else np.empty(
                (fl.b, view.shape[1]), np.int32)
        waited = 0.0
        for (r0, r1), ev in zip(_pieces(fl.b, view.shape[1]), fl.events):
            t0 = time.perf_counter()
            ev.synchronize()
            waited += time.perf_counter() - t0
            if out is not None:
                out[r0:r1] = view[r0:r1]
        if consume is not None:
            out = consume(view[:fl.b])
        self._release(fl.slot)
        return out, waited

    def _submit(self, block, n_iters: int,
                before: Optional[_InFlight] = None,
                rows: Optional[int] = None) -> _InFlight:
        """Dispatch one block of at most ``_capacity()`` rows, padded to
        ``rows`` (default ``_block_rows``), finishing ``before``'s download
        beside its upload.  The first launch of an ``(M, bucket)`` shape
        runs to its end under the trace lock and counts as this engine's
        one trace of the shape."""
        rows = rows or self._block_rows(block.shape[0])
        key = (block.shape[1], rows)
        with self._stats_lock:
            warm = key in self._warm
        if warm:
            return self._enqueue(block, rows, n_iters, before)
        with self._trace_lock:
            with self._stats_lock:
                cold = key not in self._warm
                if cold:
                    self.traces += 1
            fl = self._enqueue(block, rows, n_iters, before)
            self._download(fl)
            for ev in fl.events:
                ev.synchronize()
            fl.cold = cold
            with self._stats_lock:
                self._warm.add(key)
        return fl

    def _pipeline(self, blocks: Iterable, n_iters: int,
                  depth: int) -> Iterator[_InFlight]:
        """Dispatch ``blocks`` in order; yield each one, oldest first, once
        ``depth`` newer ones are in flight behind it (or the source has
        ended).  Each block's download goes out beside the next block's
        upload (``_enqueue``), the last one's when the source ends.  The consumer drains
        each before asking for the next."""
        inflight: deque = deque()
        last: Optional[_InFlight] = None
        for blk in blocks:
            t_up = time.perf_counter()
            fl = self._submit(blk, n_iters, before=last)
            fl.t_up, fl.t_disp = t_up, time.perf_counter()
            inflight.append(fl)
            last = fl
            while len(inflight) > depth:
                yield inflight.popleft()
        if last is not None:
            self._download(last)
        while inflight:
            yield inflight.popleft()

    def _count(self, used: List[int], samples: int, stream_chunks: int = -1
               ) -> int:
        """Book one call (or one stream, when ``stream_chunks`` >= 0);
        returns the engine's trace total."""
        with self._stats_lock:
            for rows in used:
                self.bucket_calls[rows] = self.bucket_calls.get(rows, 0) + 1
            self.padded_samples += sum(used) - samples
            self.calls += 1
            self.samples += samples
            if stream_chunks >= 0:
                self.streams += 1
                self.stream_chunks += stream_chunks
            return self.traces

    def run(self, flats, n_iters: int, *,
            consume: Optional[Callable[[np.ndarray], object]] = None
            ) -> Tuple[object, Dict[str, object]]:
        """Execute a (B, M) batch of scratchpad images (an array, or
        ``Flattened`` samples) for ``n_iters``.

        Pads each chunk up the bucket ladder (B > largest bucket runs as
        largest-bucket chunks, two in flight behind the one draining) and
        slices the padding back off; returns ``(out (B, M), per-call
        info)`` — or, with ``consume``, ``([consume(rows) per chunk],
        info)``, where ``rows`` is a chunk's results still in the staging
        buffer (``consume`` copies what it keeps, as
        ``Program.unflatten_batch`` does; no (B, M) result is made).
        """
        if not isinstance(flats, Flattened):
            flats = np.ascontiguousarray(flats, np.int32)
            if flats.ndim != 2:
                raise ValueError(f"expected (B, M) images, got "
                                 f"{flats.shape}")
        B, M = flats.shape
        top = self._capacity()
        out = [] if consume is not None else np.empty((B, M), np.int32)
        used: List[int] = []
        cold_blocks = 0
        i = 0
        for fl in self._pipeline((flats[j:j + top] for j in range(0, B, top)),
                                 n_iters, depth=2):
            if consume is not None:
                out.append(self._drain(fl, consume=consume)[0])
            else:
                self._drain(fl, into=out[i:i + fl.b])
            i += fl.b
            used.append(fl.rows)
            cold_blocks += fl.cold
        traces_total = self._count(used, B)
        return out, {
            "engine": self.name,
            "buckets": used,
            "padded": sum(used) - B,
            "traced": cold_blocks,
            "traces_total": traces_total,
            **self._info_extra(),
        }

    # -- streaming ------------------------------------------------------------
    def run_stream(self, source: Union[np.ndarray, Iterable],
                   n_iters: int, *, chunk: Optional[int] = None,
                   depth: int = 2,
                   consume: Optional[Callable[[np.ndarray], object]] = None
                   ) -> Iterator[Tuple[object, Dict[str, object]]]:
        """Streaming execution: pipeline bucket-sized chunks with double
        buffering, yielding ``(out_chunk (b, M), chunk_info)`` as each
        chunk drains (``(consume(rows), chunk_info)`` with ``consume``,
        as in ``run``).

        ``source`` is a (B, M) batch or an iterable of (b, M) row blocks,
        arrays or ``Flattened`` (blocks larger than ``chunk`` are
        re-chunked; ``chunk`` defaults to, and is capped at, the top
        bucket).  On a CUDA device up to
        ``depth`` chunks are in flight behind the one draining: while
        chunk *i* downloads, chunk *i+1* uploads and computes and the host
        stages chunk *i+2* (and, through an iterable source, flattens the
        next).  Chunks ride the same bucket-ladder shapes as ``run``: a
        warm engine streams with ZERO new traces.  On the CPU the same
        generator runs each chunk to its end in turn.

        The generator's return value (``StopIteration.value``) is the
        stream summary: ``stream_chunks``, ``samples``, ``buckets``,
        ``padded``, ``traced``, ``traces_total``, ``wall_s``, ``wait_s``
        (host time blocked on the device), ``overlap_frac`` = 1 -
        wait/wall — the fraction of the wall the host spent staging other
        chunks while the device worked — and ``throughput_sps``.  On the
        CPU every chunk runs inside its dispatch, so nothing overlaps:
        ``wait_s`` is the wall and ``overlap_frac`` 0.0, as for an empty
        stream.
        """
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        top = self._capacity()
        step = top if chunk is None else max(1, min(int(chunk), top))

        def blocks() -> Iterator:
            blks = [source] if isinstance(source, np.ndarray) else source
            for blk in blks:
                if not isinstance(blk, Flattened):
                    blk = np.ascontiguousarray(blk, np.int32)
                for i in range(0, len(blk), step):
                    yield blk[i:i + step]

        t_start = time.perf_counter()
        wait_s = 0.0
        used: List[int] = []
        cold_blocks = 0
        n_samples = 0
        tr = obs.tracer()
        tron = tr.enabled
        # one trace groups every chunk span of this stream in the export
        stream_trace = tr.new_trace_id() if tron else None
        for n_chunks, fl in enumerate(self._pipeline(blocks(), n_iters,
                                                     depth)):
            t0 = time.perf_counter()
            out, waited = self._drain(fl, consume=consume)
            wait_s += waited
            cold_blocks += fl.cold
            used.append(fl.rows)
            n_samples += fl.b
            info = {"chunk": n_chunks, "bucket": fl.rows, "samples": fl.b,
                    "traced": int(fl.cold)}
            if tron:
                # device-busy window approximated from dispatch end to
                # ready; drain = the copy out of the staging buffer
                t_ready = t0 + waited
                for name, a, z in (("stream:upload", fl.t_up, fl.t_disp),
                                   ("stream:compute", fl.t_disp, t_ready),
                                   ("stream:drain", t_ready,
                                    time.perf_counter())):
                    tr.record(name, a, z, cat="engine", trace=stream_trace,
                              args=info)
            yield out, info
        wall = time.perf_counter() - t_start
        if self.device.type == "cpu":
            wait_s = wall
        traces_total = self._count(used, n_samples, len(used))
        return {
            "engine": self.name,
            "stream_chunks": len(used),
            "samples": n_samples,
            "buckets": used,
            "padded": sum(used) - n_samples,
            "traced": cold_blocks,
            "traces_total": traces_total,
            "wall_s": wall,
            "wait_s": wait_s,
            "overlap_frac": (round(max(0.0, 1.0 - wait_s / wall), 4)
                             if wall > 0 and used else 0.0),
            "throughput_sps": n_samples / wall if wall > 0 else 0.0,
            **self._info_extra(),
        }

    def warmup(self, M: int,
               buckets: Optional[Sequence[int]] = None) -> Dict[str, object]:
        """Launch the ladder (or a subset) once for scratchpad width ``M``
        with a zero batch; ``n_iters`` is an argument, so one warm shape per
        bucket covers every trip count.  Sizes off the ladder snap UP to
        the bucket that will execute them, so re-warming is a no-op.
        Returns this engine's stats."""
        want = sorted({self._block_rows(min(b, self._capacity())) for b in
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
                "streams": self.streams,
                "stream_chunks": self.stream_chunks,
                "pinned_bytes": self.pinned_bytes,
                "warm_shapes": sorted(self._warm),
            }
        calls = sum(bucket_calls.values())
        hits = max(0, calls - traces)
        return {
            "traces": traces,
            "bucket_calls": bucket_calls,
            "hit_ratio": round(hits / calls, 4) if calls else None,
            "buckets": self.buckets,
            "engine": self.name,
            "device": str(self.device),
            **snap,
            **self._info_extra(),
        }


class _ShardedFlight:
    """One dispatched block of the sharded engine: ``b`` live rows padded
    to ``rows`` (``n_devices`` x the per-device bucket), one ``_InFlight``
    a device, each holding its own row range."""

    __slots__ = ("b", "rows", "M", "cold", "parts", "t_up", "t_disp")

    def __init__(self, b: int, rows: int, M: int, cold: bool,
                 parts: List[_InFlight]) -> None:
        self.b, self.rows, self.M, self.cold = b, rows, M, cold
        self.parts = parts
        self.t_up = self.t_disp = 0.0


class ShardedKernelEngine(KernelEngine):
    """The multi-device engine: one block plan over every device of a
    1-D host mesh (default ``launch.mesh.make_host_mesh()``: every card).

    Each device has an engine of its own (``shards``): the packed tables
    uploaded once to it, its own pinned buffers and its own three streams.
    A block of ``chunk`` samples runs at ``n_devices x
    bucket_for(ceil(chunk / n_devices))`` rows: device ``d`` takes samples
    ``d*q .. (d+1)*q`` (``q = ceil(chunk / n_devices)``) padded with zero
    rows to the per-device bucket, launched on its own streams, and the
    results are gathered in device order with the padding sliced off.  The
    warm-shape set and the trace count stay at most one per bucket, as in
    the single-device engine, and the outputs are bit-equal to it.

    The mesh is a list of ``torch.device``s of one type: CUDA cards, or
    repeated CPU devices (``make_host_mesh("cpu", n)``) for the plain
    version.
    """

    def __init__(self, linked: LinkedConfig, *, lanes: int = 128,
                 buckets: Optional[Sequence[int]] = None,
                 mesh: Optional[Sequence] = None) -> None:
        if mesh is None:
            from repro_torch.launch.mesh import make_host_mesh
            mesh = make_host_mesh()
        devices = [torch.device(d) for d in mesh]
        if not devices or len({d.type for d in devices}) != 1:
            raise ValueError(f"ShardedKernelEngine needs a non-empty 1-D "
                             f"mesh of one device type, got {mesh!r}")
        self.mesh = devices
        self.n_devices = len(devices)
        self.shards = [KernelEngine(linked, lanes=lanes, buckets=buckets,
                                    device=d) for d in devices]
        super().__init__(linked, lanes=lanes, buckets=buckets,
                         device=devices[0])
        self.name += "-sharded"

    def _put_tables(self, linked: LinkedConfig):
        """The CM image once per device: each shard's own upload."""
        return tuple(shard.tables for shard in self.shards)

    def _info_extra(self) -> Dict[str, object]:
        return {"n_devices": self.n_devices}

    # -- the sharded block plan -----------------------------------------------
    def _capacity(self) -> int:
        return self.n_devices * self.buckets[-1]

    def _block_rows(self, chunk: int) -> int:
        per_device = -(-chunk // self.n_devices)      # ceil
        return self.n_devices * self.bucket_for(per_device)

    def _submit(self, block, n_iters: int,
                before: Optional[_ShardedFlight] = None,
                rows: Optional[int] = None) -> _ShardedFlight:
        """Split one block into per-device row ranges and dispatch each on
        its device (finishing ``before``'s part on the same device beside
        its upload)."""
        b, M = block.shape
        q = -(-b // self.n_devices)
        per = (rows or self._block_rows(b)) // self.n_devices
        prev = before.parts if before is not None else [None] * len(
            self.shards)
        parts = [shard._submit(block[min(d * q, b):min((d + 1) * q, b)],
                               n_iters, before=p, rows=per)
                 for d, (shard, p) in enumerate(zip(self.shards, prev))]
        key = (M, self.n_devices * per)
        with self._stats_lock:
            cold = key not in self._warm
            if cold:
                self.traces += 1
                self._warm.add(key)
        return _ShardedFlight(b, self.n_devices * per, M, cold, parts)

    def _download(self, fl: _ShardedFlight) -> None:
        for shard, part in zip(self.shards, fl.parts):
            shard._download(part)

    def _drain(self, fl: _ShardedFlight, into: Optional[np.ndarray] = None,
               consume: Optional[Callable[[np.ndarray], object]] = None
               ) -> Tuple[object, float]:
        """Gather the devices' rows in order (into ``into`` when given),
        then ``consume`` them when given.  One device hands its staging
        buffer's rows straight to ``consume``."""
        if len(fl.parts) == 1:
            return self.shards[0]._drain(fl.parts[0], into=into,
                                         consume=consume)
        out = into if into is not None else np.empty((fl.b, fl.M), np.int32)
        waited, r = 0.0, 0
        for shard, part in zip(self.shards, fl.parts):
            _, w = shard._drain(part, into=out[r:r + part.b])
            waited += w
            r += part.b
        if consume is not None:
            return consume(out), waited
        return out, waited

    def stats(self) -> Dict[str, object]:
        snap = super().stats()
        snap["device"] = ",".join(str(d) for d in self.mesh)
        snap["pinned_bytes"] = sum(s.pinned_bytes for s in self.shards)
        return snap


class CompiledKernelCache:
    """The engine registry: one ``KernelEngine`` per
    ``(lowered fingerprint, lanes, placement)``, created on first use and
    kept for the life of the process — shared by the backends and
    ``Executable.warmup``.  The placement is one device (``engine_for``) or
    a mesh (``sharded_engine_for``: ``sharded:`` and its devices)."""

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

    def sharded_engine_for(self, linked: LinkedConfig, *, lanes: int = 128,
                           buckets: Optional[Sequence[int]] = None,
                           mesh: Optional[Sequence] = None
                           ) -> ShardedKernelEngine:
        """The multi-device engine for ``linked`` over ``mesh`` (default:
        every card, ``launch.mesh.make_host_mesh()``), cached like
        ``engine_for``."""
        if mesh is None:
            from repro_torch.launch.mesh import make_host_mesh
            mesh = make_host_mesh()
        mesh = [torch.device(d) for d in mesh]
        key = (lowered_fingerprint(linked), lanes,
               "sharded:" + ",".join(str(d) for d in mesh))
        with self._lock:
            eng = self._engines.get(key)
            if eng is None:
                eng = ShardedKernelEngine(
                    linked, lanes=lanes,
                    buckets=buckets or self.default_buckets, mesh=mesh)
                self._engines[key] = eng
            return eng

    def run(self, linked: LinkedConfig, flats: np.ndarray, n_iters: int, *,
            lanes: int = 128, device="cuda"
            ) -> Tuple[np.ndarray, Dict[str, object]]:
        return self.engine_for(linked, lanes=lanes,
                               device=device).run(flats, n_iters)

    def sharded_run(self, linked: LinkedConfig, flats: np.ndarray,
                    n_iters: int, *, lanes: int = 128,
                    mesh: Optional[Sequence] = None
                    ) -> Tuple[np.ndarray, Dict[str, object]]:
        return self.sharded_engine_for(linked, lanes=lanes,
                                       mesh=mesh).run(flats, n_iters)

    def run_stream(self, linked: LinkedConfig, source, n_iters: int, *,
                   chunk: Optional[int] = None, depth: int = 2,
                   lanes: int = 128, device="cuda"
                   ) -> Iterator[Tuple[np.ndarray, Dict[str, object]]]:
        """Streaming execution through the cached engine for ``linked``
        (see ``KernelEngine.run_stream``); yields drained chunks, returns
        the stream summary via ``StopIteration.value``."""
        return self.engine_for(linked, lanes=lanes, device=device
                               ).run_stream(source, n_iters, chunk=chunk,
                                            depth=depth)

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
            "streams": sum(e["streams"] for e in per.values()),
            "stream_chunks": sum(e["stream_chunks"] for e in per.values()),
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
