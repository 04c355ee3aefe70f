"""``Executable`` — a compiled (Program, Target) pair, dict-in/dict-out.

``compile()`` produces one of these.  It owns the mapping artifacts
(``MapResult`` with the machine configuration), the **lowered artifact**
(the dense linked tables every execution engine consumes — produced once
by the pipeline's lowering pass) and compile-time metadata (cache hit?
how many mapper restarts did *this* compile pay?), and runs on any
registered backend with automatic flatten/unflatten of the named arrays:

    exe = compile(program, target)
    out = exe.run(a=a, b=b)                  # dict in, dict out
    outs = exe.run_batch([{...}, {...}])     # natively batched (sim/cuda)
    exe.last_info["throughput_sps"]          # samples/s of that call
    report = exe.validate(seed=0)            # vs the DFG-interpreter oracle

    for chunk in exe.run_stream(mems):       # streaming: chunks drain as
        consume(chunk)                       # later chunks still compute
    exe.last_info["overlap_frac"]            # transfer/compute overlap

Streaming (``run_stream`` / ``run_batch(stream=True)``) pipelines the
batch through the backend in bucket-sized chunks — on the cuda backend
chunk *i* downloads while *i+1* uploads and computes and the host stages
the next (double buffering through pinned host buffers on three CUDA
streams); the torch backend runs the same chunks in turn, and sim and
interp fall back to chunked synchronous delivery.  The stream summary
(``stream_chunks``, ``overlap_frac``, ``throughput_sps``) lands in
``last_info`` at exhaustion and is also the generator's return value
(``StopIteration.value``) for concurrent sharers.

Execution info (engine stats, throughput) is *returned per call*
internally; ``last_info`` is only a convenience copy of the most recent
call's info, so one Executable can be shared across threads or worker
processes (batched serving, ``explore(workers=N)``) without the info of
concurrent calls racing each other — never read ``last_info`` to observe
a *specific* call's info in concurrent code.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.analysis.verifier import CheckReport
from repro_torch.core.lowering import LinkedConfig
from repro_torch.core.mapper import MapResult
from repro_torch.ual.backends import Backend, get_backend
from repro_torch.ual.program import Program
from repro_torch.ual.target import Target


@dataclass
class PassRecord:
    """One pipeline pass's report: what ran, how long, what it found."""

    name: str
    wall_s: float = 0.0
    stats: Dict[str, object] = field(default_factory=dict)

    def __str__(self) -> str:
        kv = ", ".join(f"{k}={v}" for k, v in self.stats.items())
        return f"{self.name}: {self.wall_s * 1e3:.2f}ms ({kv})"


@dataclass
class CompileInfo:
    cache_hit: bool = False
    mapper_restarts: int = 0      # restarts paid by THIS compile (0 on hit)
    wall_s: float = 0.0
    key: Optional[Tuple[str, str]] = None
    passes: List[PassRecord] = field(default_factory=list)

    @property
    def pass_times(self) -> Dict[str, float]:
        """Per-pass wall seconds keyed by pass name (pipeline order)."""
        return {p.name: p.wall_s for p in self.passes}


@dataclass
class Executable:
    program: Program
    target: Target
    map_result: Optional[MapResult]          # None for mapping-free backends
    compile_info: CompileInfo = field(default_factory=CompileInfo)
    spatial_subgraphs: int = 0               # spatial fabrics: #subgraphs
    lowered: Optional[LinkedConfig] = None   # shared lowered artifact
    #: the compile-time verifier's findings (``repro_torch.analysis.verifier``)
    #: — present whenever a machine configuration was verified.  Errors
    #: abort ``compile()`` (``VerifyError``), so a constructed Executable
    #: carries at most warnings/infos here; None for mapping-free
    #: backends, spatial fabrics and custom pipelines without the pass
    check_report: Optional[CheckReport] = None
    #: convenience copy of the most recent run/run_batch info — NOT a
    #: synchronization point; concurrent callers each get their own info
    #: internally and this attribute only reflects whichever call wrote last
    last_info: Dict[str, object] = field(default_factory=dict)

    # -- introspection --------------------------------------------------------
    @property
    def II(self) -> Optional[int]:
        """Achieved initiation interval; None for mapping-free executables
        (interp backend), where no II exists to compare."""
        return self.map_result.II if self.map_result else None

    @property
    def success(self) -> bool:
        return self.map_result.success if self.map_result else True

    def __str__(self) -> str:
        ii = self.II if self.success else "unmapped"
        hit = "cache" if self.compile_info.cache_hit else "cold"
        return (f"Executable({self.program.name} on {self.target.name}: "
                f"II={ii}, {hit}, {self.compile_info.wall_s:.2f}s)")

    # -- execution ------------------------------------------------------------
    def _resolve(self, backend: Optional[str]) -> Backend:
        name = backend or self.target.backend
        be = get_backend(name)
        if be.requires_config:
            if self.map_result is not None and not self.map_result.success:
                raise RuntimeError(
                    f"{self.program.name}: mapping onto "
                    f"{self.target.fabric.name} failed "
                    f"(ii_max={self.target.ii_max}, "
                    f"{self.map_result.restarts} restarts); raise ii_max / "
                    f"max_restarts or use a larger fabric")
            if self.map_result is None or self.map_result.config is None:
                raise RuntimeError(
                    f"{self.program.name}: backend {name!r} needs a machine "
                    f"configuration, but this executable has none (compiled "
                    f"for a mapping-free backend or a spatial fabric); "
                    f"recompile with a temporal fabric target")
        return be

    def _backend_kwargs(self, be: Backend) -> Dict[str, object]:
        """Extra keywords for backends that consume the lowered artifact.

        Executables compiled before the lowering pass existed (or through
        a custom pipeline without it) lower lazily here, once, and keep
        the artifact for subsequent calls.
        """
        if not getattr(be, "consumes_lowered", False):
            return {}
        if (self.lowered is None and self.map_result is not None
                and self.map_result.config is not None):
            from repro_torch.core.lowering import link_config
            self.lowered = link_config(self.map_result.config)
        return {"lowered": self.lowered}

    def _execute(self, mem: Dict[str, np.ndarray], n_iters: int,
                 backend: Optional[str]
                 ) -> Tuple[Dict[str, np.ndarray], Dict[str, object]]:
        """One sample through a backend; returns (outputs, per-call info)."""
        be = self._resolve(backend)
        out, info = be.execute(self.program, self.map_result, mem, n_iters,
                               **self._backend_kwargs(be))
        return out, dict(info)

    def _execute_batch(self, mems: Sequence[Dict[str, np.ndarray]],
                       n_iters: int, backend: Optional[str],
                       **backend_opts: object
                       ) -> Tuple[List[Dict[str, np.ndarray]],
                                  Dict[str, object]]:
        """A batch through a backend; returns (outputs, per-call info with
        wall time and throughput in samples/s).  ``backend_opts`` are
        forwarded verbatim (e.g. ``device=`` on backends advertising
        ``supports_device`` — the replica router's placement path)."""
        be = self._resolve(backend)
        mems = list(mems)
        t0 = time.perf_counter()
        outs, info = be.execute_batch(self.program, self.map_result, mems,
                                      n_iters, **self._backend_kwargs(be),
                                      **backend_opts)
        wall = time.perf_counter() - t0
        info = dict(info)
        info["wall_s"] = wall
        info["batch"] = len(mems)
        info["throughput_sps"] = len(mems) / wall if wall > 0 else float("inf")
        return outs, info

    def _execute_stream(self, mems, n_iters: int, backend: Optional[str],
                        chunk: Optional[int] = None, **backend_opts: object):
        """A batch through a backend's streaming path; yields
        ``(out_dicts, chunk_info)`` per drained chunk and *returns* the
        stream summary (wall time, samples, ``overlap_frac``,
        ``throughput_sps``) as the generator's value."""
        be = self._resolve(backend)
        t0 = time.perf_counter()
        gen = be.execute_stream(self.program, self.map_result, mems, n_iters,
                                chunk=chunk, **self._backend_kwargs(be),
                                **backend_opts)
        n_samples = 0
        n_chunks = 0
        while True:
            try:
                outs, cinfo = next(gen)
            except StopIteration as stop:
                summary = dict(stop.value or {})
                break
            n_samples += len(outs)
            n_chunks += 1
            yield outs, cinfo
        wall = time.perf_counter() - t0
        summary.setdefault("stream_chunks", n_chunks)
        summary["stream"] = True
        summary["wall_s"] = wall
        summary["batch"] = n_samples
        summary["throughput_sps"] = (n_samples / wall if wall > 0
                                     else float("inf"))
        return summary

    def warmup(self, buckets: Optional[Sequence[int]] = None, *,
               backend: Optional[str] = None) -> Dict[str, object]:
        """Pre-launch the execution engine's batch-bucket ladder (cuda /
        torch: one warm shape per bucket; ``n_iters`` is a kernel
        argument, so those shapes cover every trip count).  Returns the
        engine's stats (trace count, per-bucket calls, hit ratio) and
        records them in ``last_info["engine_stats"]``.  A no-op ``{}`` on
        backends with nothing to warm (sim/interp execute eagerly).
        """
        be = self._resolve(backend)
        if not hasattr(be, "warmup"):
            return {}
        kw = self._backend_kwargs(be)
        stats = be.warmup(self.program, self.map_result, buckets=buckets,
                          **kw)
        self.last_info = {"engine_stats": stats, "warmed": True}
        return stats

    def run(self, arrays: Optional[Dict[str, np.ndarray]] = None,
            n_iters: Optional[int] = None, *,
            backend: Optional[str] = None,
            **named: np.ndarray) -> Dict[str, np.ndarray]:
        """Execute with named input arrays; returns all named arrays after
        the run (outputs updated, inputs passed through).

        Arrays go in the ``arrays`` dict or as keyword arguments; use the
        dict form when an array name collides with a parameter name here
        (``arrays``/``n_iters``/``backend``).
        """
        mem = dict(arrays or {})
        mem.update(named)
        n = n_iters if n_iters is not None else self.program.n_iters
        out, info = self._execute(mem, n, backend)
        self.last_info = info
        return out

    def run_batch(self, mems: Sequence[Dict[str, np.ndarray]],
                  n_iters: Optional[int] = None, *,
                  backend: Optional[str] = None,
                  stream: bool = False,
                  chunk: Optional[int] = None
                  ) -> List[Dict[str, np.ndarray]]:
        """Execute a batch of named-array dicts; natively batched on the
        ``sim``, ``cuda`` and ``torch`` backends (one engine sweep for the
        whole batch).  The call's wall time, batch size and throughput
        (``throughput_sps``, samples/s) are recorded in ``last_info``.

        ``stream=True`` runs the batch through the backend's streaming
        path instead (double buffering on cuda); the results
        come back as one flat list but ``last_info`` carries the stream
        summary (``stream_chunks``, ``overlap_frac``).  Use
        ``run_stream`` to consume chunks as they drain.
        """
        outs, info = self.run_batch_with_info(mems, n_iters, backend=backend,
                                              stream=stream, chunk=chunk)
        self.last_info = info
        return outs

    def run_batch_with_info(self, mems: Sequence[Dict[str, np.ndarray]],
                            n_iters: Optional[int] = None, *,
                            backend: Optional[str] = None,
                            stream: bool = False,
                            chunk: Optional[int] = None,
                            **backend_opts: object
                            ) -> Tuple[List[Dict[str, np.ndarray]],
                                       Dict[str, object]]:
        """``run_batch`` for concurrent sharers of one Executable: returns
        ``(outputs, info)`` per call — wall time, batch size and
        ``throughput_sps`` — WITHOUT publishing through ``last_info``, so
        parallel callers (the execution service's workers, ``explore``
        pools) never read another call's numbers.  Extra keywords are
        forwarded to the backend (``device=`` for per-replica placement
        on backends advertising ``supports_device``).  ``stream=True``
        collects the backend's streaming path into one flat list and
        returns the stream summary as the info."""
        n = n_iters if n_iters is not None else self.program.n_iters
        if not stream:
            return self._execute_batch(mems, n, backend, **backend_opts)
        outs: List[Dict[str, np.ndarray]] = []
        gen = self._execute_stream(mems, n, backend, chunk=chunk,
                                   **backend_opts)
        while True:
            try:
                chunk_outs, _ = next(gen)
            except StopIteration as stop:
                return outs, dict(stop.value or {})
            outs.extend(chunk_outs)

    def run_stream(self, mems: Sequence[Dict[str, np.ndarray]],
                   n_iters: Optional[int] = None, *,
                   backend: Optional[str] = None,
                   chunk: Optional[int] = None):
        """Streaming execution: a generator yielding lists of output
        dicts chunk-by-chunk as results drain from the device, while
        later chunks are still uploading/computing (double buffering on
        the cuda backend — same bucket-ladder shapes as ``run_batch``,
        zero new traces on a warm engine).

        ``chunk`` bounds samples per chunk (default: the engine's top
        warm bucket).  At exhaustion ``last_info`` holds the stream
        summary — ``stream_chunks``, ``overlap_frac`` (fraction of wall
        time the host was NOT blocked waiting on the device),
        ``throughput_sps`` — and the same dict is the generator's return
        value for callers that drive ``next()`` manually."""
        n = n_iters if n_iters is not None else self.program.n_iters
        gen = self._execute_stream(mems, n, backend, chunk=chunk)
        while True:
            try:
                outs, _ = next(gen)
            except StopIteration as stop:
                info = dict(stop.value or {})
                self.last_info = info
                return info
            yield outs

    # -- validation -----------------------------------------------------------
    def validate(self, seed: int = 0, n_iters: Optional[int] = None,
                 make_mem=None, backends: Optional[Sequence[str]] = None,
                 n_vectors: int = 1):
        """Random test vectors -> oracle vs backend(s), bit-exact.

        Generates ``n_vectors`` input sets (the Program's ``make_mem`` or
        uniform random), runs the DFG-interpreter oracle on each, then
        every requested backend as ONE natively-batched sweep over the
        shared lowered artifact — not ``n_vectors`` scalar runs — and
        counts word mismatches over the declared output arrays.
        """
        from repro_torch.core.dfg import interpret
        from repro_torch.core.validate import ValidationReport

        if not self.success:
            return ValidationReport(self.program.name, self.target.fabric.name,
                                    self.map_result, False,
                                    n_iters or self.program.n_iters)
        n = n_iters if n_iters is not None else self.program.n_iters
        rng = np.random.default_rng(seed)
        gen = make_mem if make_mem is not None else self.program.random_inputs
        mems_in = [dict(gen(rng)) for _ in range(n_vectors)]
        expects = [interpret(self.program.dfg, m, n) for m in mems_in]

        names = backends if backends is not None else (self.target.backend,)
        if "interp" in names:
            raise ValueError(
                "validate(): 'interp' IS the validation oracle — comparing "
                "it against itself always passes; validate a device backend "
                "instead, e.g. backends=('sim',) or ('sim', 'cuda')")
        mism = 0
        sim_stats = None
        per_backend: Dict[str, bool] = {}
        # the (B, total_words) image is backend-independent: flatten the
        # test vectors ONCE and hand the image to every natively-batched
        # backend that advertises ``accepts_flats`` — a multi-backend
        # sweep over the same vectors pays one flatten, not len(names)
        flats = None
        for bname in names:
            opts: Dict[str, object] = {}
            if getattr(get_backend(bname), "accepts_flats", False):
                if flats is None:
                    flats = self.program.flatten_batch(mems_in)
                opts["flats"] = flats
            gots, info = self._execute_batch(mems_in, n, bname, **opts)
            bad = sum(int((expect[a] != got[a]).sum())
                      for expect, got in zip(expects, gots)
                      for a in self.program.outputs)
            per_backend[bname] = bad == 0
            mism += bad
            if "sim_stats" in info:
                sim_stats = info["sim_stats"]
        return ValidationReport(self.program.name, self.target.fabric.name,
                                self.map_result, mism == 0, n, sim_stats,
                                mism, backend_results=per_backend,
                                n_vectors=n_vectors)
