"""Pluggable execution backends for the unified abstraction layer.

A backend turns ``(Program, MapResult, named arrays)`` into named output
arrays.  Six ship with the package:

  * ``interp``  — the DFG interpreter oracle (no mapping required; the
    reference semantics every other backend must match bit-exactly),
  * ``sim``     — the vectorized, natively-batched simulator executing
    the lowered configuration tables (``core.simulator.simulate_batch``),
  * ``cuda``    — the hand-written CUDA ``cgra_exec`` kernel executing the
    same tables on the card through the persistent engine
    (``repro_torch.ual.engine``): tables uploaded once per engine,
    batch-bucket padding, ``n_iters`` a kernel argument.  It raises on a
    machine with no CUDA device; it never falls back,
  * ``torch``   — the kernel's plain PyTorch version through the same
    engine on the CPU, for callers that name it,
  * ``cuda_sharded`` — every sweep split over ALL the cards of this
    process (``launch.mesh.make_host_mesh()``) through one
    ``ShardedKernelEngine``: a device per row range, per-device bucket
    padding; it raises with no card,
  * ``torch_sharded`` — its CPU twin, over ``make_host_mesh("cpu")``: as
    many repeated CPU devices as ``launch.mesh.forced_host_devices`` set
    (default 1).

``sim``, ``cuda`` and ``torch`` consume the shared **lowered artifact**
(``core.lowering.LinkedConfig``) produced once by the compile pipeline's
lowering pass: backends that set ``consumes_lowered = True`` receive it
via the ``lowered`` keyword — the tables are program-independent (pure
function of the machine configuration), so custom device backends can
execute them directly instead of re-deriving routing from the raw config.

Third parties extend the layer with ``register_backend("mine", MyBackend())``
— see ROADMAP.md for a worked example.  Backends are resolved by name at
``compile()`` time; unknown names raise with the list of registered ones.
"""
from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core.dfg import interpret
from repro_torch.core.mapper import MapResult
from repro_torch.ual.program import Program

Mem = Dict[str, np.ndarray]
Info = Dict[str, object]


class Backend:
    """Base class: subclass and override ``execute`` (and optionally
    ``execute_batch`` when the device can batch natively)."""

    #: whether ``compile()`` must produce a machine configuration first
    requires_config: bool = True
    #: backends that execute the lowered dense tables set this to True and
    #: accept a ``lowered=`` keyword (a ``core.lowering.LinkedConfig``) in
    #: ``execute``/``execute_batch``; backends that interpret the raw
    #: config (or need no config at all) leave it False and keep the plain
    #: four-argument signature
    consumes_lowered: bool = False
    #: backends that can pin one call to one device accept a
    #: ``device=`` keyword in ``execute``/``execute_batch`` — the
    #: serving cluster's replica router uses this to run per-device
    #: replicas; leave False to never receive the keyword
    supports_device: bool = False
    #: natively-batched backends that can skip re-flattening when the
    #: caller already holds the (B, total_words) image accept a
    #: ``flats=`` keyword in ``execute_batch`` — ``Executable.validate``
    #: uses this to flatten its test vectors ONCE per multi-backend sweep
    accepts_flats: bool = False

    def execute(self, program: Program, result: Optional[MapResult],
                mem: Mem, n_iters: int, **kw) -> Tuple[Mem, Info]:
        raise NotImplementedError

    def execute_batch(self, program: Program, result: Optional[MapResult],
                      mems: List[Mem], n_iters: int, **kw
                      ) -> Tuple[List[Mem], Info]:
        outs = []
        info: Info = {}
        for m in mems:
            out, info = self.execute(program, result, m, n_iters, **kw)
            outs.append(out)
        return outs, info

    def execute_stream(self, program: Program, result: Optional[MapResult],
                       mems: Iterable[Mem], n_iters: int, *,
                       chunk: Optional[int] = None, **kw
                       ) -> Iterator[Tuple[List[Mem], Info]]:
        """Streaming execution: yield ``(out_dicts, chunk_info)`` per
        chunk of ``chunk`` samples as results drain; the generator's
        return value is the stream summary (must carry ``overlap_frac``
        and ``stream_chunks``).

        This default chunks the input through ``execute_batch`` — chunked
        delivery, but NO transfer/compute overlap (``overlap_frac`` 0.0).
        Backends with an asynchronous device path (``cuda``) override it
        with a genuinely pipelined implementation.
        """
        step = max(1, int(chunk) if chunk else 32)
        n_chunks = 0
        n_samples = 0
        group: List[Mem] = []
        for m in mems:
            group.append(m)
            if len(group) >= step:
                outs, info = self.execute_batch(program, result, group,
                                                n_iters, **kw)
                yield outs, {"chunk": n_chunks, "samples": len(outs),
                             **info}
                n_chunks += 1
                n_samples += len(outs)
                group = []
        if group:
            outs, info = self.execute_batch(program, result, group,
                                            n_iters, **kw)
            yield outs, {"chunk": n_chunks, "samples": len(outs), **info}
            n_chunks += 1
            n_samples += len(outs)
        return {"stream_chunks": n_chunks, "samples": n_samples,
                "overlap_frac": 0.0, "streamed": "chunked-sync"}


class InterpBackend(Backend):
    """DFG-interpreter oracle: executes the *pre-layout* DFG directly."""

    requires_config = False

    def execute(self, program, result, mem, n_iters):
        program.check_arrays(mem)
        return interpret(program.dfg, mem, n_iters), {}


def _ensure_lowered(result, lowered):
    """The shared artifact, or (for callers bypassing the pipeline) the
    per-process fingerprint memo — no path lowers one config twice."""
    if lowered is not None:
        return lowered
    from repro_torch.kernels.cgra_exec.ops import _memoized_link
    return _memoized_link(result.config)


class SimBackend(Backend):
    """Vectorized, natively-batched simulation of the lowered tables.

    Consumes the shared lowered artifact; a single ``execute_batch`` call
    steps the whole batch through the fabric simultaneously (leading
    batch axis in the engine state).  The scalar reference engine remains
    available as ``core.simulator.simulate_reference``.
    """

    consumes_lowered = True
    accepts_flats = True

    def execute(self, program, result, mem, n_iters, lowered=None):
        from repro_torch.core.simulator import simulate_batch
        flat = program.flatten(mem)
        out, stats = simulate_batch(_ensure_lowered(result, lowered),
                                    flat[None], n_iters)
        return program.unflatten(out[0]), {"sim_stats": stats,
                                           "engine": "vectorized"}

    def execute_batch(self, program, result, mems, n_iters, lowered=None,
                      flats=None):
        from repro_torch.core.simulator import simulate_batch
        if flats is None:
            flats = program.flatten_batch(mems)
        outs, stats = simulate_batch(_ensure_lowered(result, lowered),
                                     flats, n_iters)
        return (program.unflatten_batch(outs),
                {"sim_stats": stats, "engine": "vectorized", "batched": True})


class EngineBackend(Backend):
    """The ``cgra_exec`` kernel through the persistent engine
    (``repro_torch.ual.engine``) on one device type: ``"cuda"`` launches
    the hand-written CUDA kernel and raises where there is no CUDA device;
    ``"cpu"`` runs the plain PyTorch version.  The linked tables stay on
    the device per engine, ``n_iters`` is a kernel argument, and batch
    sizes pad up the bucket ladder (``engine.bucket_ladder(lanes)``).
    ``lanes`` is the engine's largest bucket, one launch of the kernel:
    batches above it run as ``lanes``-row chunks.

    A per-call ``device=`` keyword (``supports_device``) pins the sweep to
    one device of the backend's type — the replica router's placement
    path; the engine cache keys engines on the device.

    With ``sharded=True`` (``cuda_sharded``, ``torch_sharded``) every sweep
    runs through one ``ShardedKernelEngine`` over the host mesh of the
    backend's device type, read at each call
    (``launch.mesh.make_host_mesh``): a sharded sweep spans every device,
    so pinning it to one is a contradiction and ``supports_device`` is
    False."""

    consumes_lowered = True
    accepts_flats = True
    supports_device = True

    def __init__(self, device: str, lanes: int = 128, sharded: bool = False):
        self.device = device
        self.lanes = lanes
        self.sharded = sharded
        self.supports_device = not sharded

    @property
    def engine(self):
        """The process-wide engine cache (``ual.set_default_engine``)."""
        from repro_torch.ual.engine import default_engine
        return default_engine()

    def _engine_for(self, linked, device=None):
        if self.sharded:
            from repro_torch.launch.mesh import make_host_mesh
            return self.engine.sharded_engine_for(
                linked, lanes=self.lanes, mesh=make_host_mesh(self.device))
        return self.engine.engine_for(linked, lanes=self.lanes,
                                      device=device or self.device)

    def execute(self, program, result, mem, n_iters, lowered=None,
                device=None):
        outs, info = self.execute_batch(program, result, [mem], n_iters,
                                        lowered=lowered, device=device)
        return outs[0], info

    def execute_batch(self, program, result, mems, n_iters, lowered=None,
                      device=None, flats=None):
        """The samples are flattened straight into the engine's staging
        buffer (unless the caller holds their images already, ``flats``)
        and the outputs unflattened straight out of it."""
        from repro_torch.ual.engine import Flattened
        source = Flattened(program, mems) if flats is None else flats
        linked = _ensure_lowered(result, lowered)
        parts, info = self._engine_for(linked, device).run(
            source, n_iters, consume=program.unflatten_batch)
        info["batched"] = True
        return [out for part in parts for out in part], info

    def execute_stream(self, program, result, mems, n_iters, *,
                       chunk=None, lowered=None, device=None):
        """Pipelined streaming: chunks flow through the engine's
        double-buffered ``run_stream`` — while chunk *i* downloads, chunk
        *i+1* uploads and computes and the host flattens the next
        straight into its staging buffer; drained chunks are unflattened
        straight out of theirs.  ``chunk``
        defaults to, and is capped at, the engine's top bucket (4096 on
        ``cuda``; times the devices, sharded), so a stream adds no shape
        ``execute_batch`` would not launch; the summary carries the
        engine's measured ``overlap_frac``."""
        from repro_torch.ual.engine import Flattened
        eng = self._engine_for(_ensure_lowered(result, lowered), device)
        top = eng._capacity()
        step = max(1, min(int(chunk), top)) if chunk else top

        def blocks():
            group = []
            for m in mems:
                group.append(m)
                if len(group) >= step:
                    yield Flattened(program, group)
                    group = []
            if group:
                yield Flattened(program, group)

        gen = eng.run_stream(blocks(), n_iters, chunk=step,
                             consume=program.unflatten_batch)
        while True:
            try:
                outs, cinfo = next(gen)
            except StopIteration as stop:
                summary = dict(stop.value or {})
                summary["batched"] = True
                return summary
            yield outs, cinfo

    def warmup(self, program, result, lowered=None, buckets=None,
               device=None):
        """Launch the bucket ladder once for this program's scratchpad
        width (``n_iters`` is an argument, so one warm shape per bucket
        covers every trip count).  Returns the engine's stats."""
        linked = _ensure_lowered(result, lowered)
        return self._engine_for(linked, device).warmup(
            program.layout.total_words, buckets)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_BACKENDS: Dict[str, Backend] = {}


def register_backend(name: str, backend: Backend,
                     overwrite: bool = False) -> None:
    """Register an execution backend under ``name``.

    Registering an existing name raises unless ``overwrite=True`` — silent
    replacement is how two plugins stomp each other.
    """
    if name in _BACKENDS and not overwrite:
        raise ValueError(f"backend {name!r} already registered; "
                         f"pass overwrite=True to replace it")
    if not isinstance(backend, Backend):
        raise TypeError(f"backend must be a ual.backends.Backend, "
                        f"got {type(backend).__name__}")
    _BACKENDS[name] = backend


def get_backend(name: str) -> Backend:
    if name not in _BACKENDS:
        raise KeyError(f"unknown backend {name!r}; "
                       f"registered: {sorted(_BACKENDS)}")
    return _BACKENDS[name]


def list_backends() -> List[str]:
    return sorted(_BACKENDS)


#: the ``cuda`` backend's largest bucket: a ``run_batch`` of 4096 test
#: vectors is one launch of the kernel
CUDA_LANES = 4096

register_backend("interp", InterpBackend())
register_backend("sim", SimBackend())
register_backend("cuda", EngineBackend("cuda", lanes=CUDA_LANES))
register_backend("torch", EngineBackend("cpu"))
register_backend("cuda_sharded", EngineBackend("cuda", lanes=CUDA_LANES,
                                               sharded=True))
register_backend("torch_sharded", EngineBackend("cpu", sharded=True))
