"""Unified abstraction layer (UAL) of the port: ``repro.ual``'s public API
on PyTorch and CUDA::

    from repro_torch import ual

    program = ual.Program.from_kernel("gemm")              # what to run
    target = ual.Target.from_name("hycube", rows=4, cols=4)  # where: cuda
    exe = ual.compile(program, target)                     # cached pipeline
    out = exe.run(A=a, B=b)                                # dict in/out
    report = exe.validate(backends=("cuda", "sim"))        # vs the oracle

Vocabulary, as in the reference:

  * ``Program``  — DFG + scratchpad layout + named I/O spec, content-hashed
    (the same digest as ``repro.ual.Program`` for the same kernel),
  * ``Target``   — fabric + mapper strategy + backend name; the default
    backend is ``cuda``,
  * ``compile``  — the staged pass pipeline (layout -> MII bounds ->
    mapping strategy -> lowering -> verify -> binding), memoized across
    processes by ``(program.digest, target.digest)`` in this package's own
    cache directory,
  * ``verify``/``CheckReport`` — the compile-time config verifier,
  * ``Executable`` — ``run``/``run_batch``/``validate`` on any backend,
  * ``CompiledKernelCache``/``default_engine`` — the persistent engine
    behind the ``cuda`` and ``torch`` backends: tables uploaded to the
    device once, ``n_iters`` a kernel argument, batch sizes padded up a
    bucket ladder, blocks staged through pinned host buffers, and
    ``run_stream`` double-buffered over three CUDA streams,
  * ``Service``  — the dynamic-batching execution service
    (``repro_torch.ual.service``): single-sample requests are queued,
    coalesced into micro-batches per ``(program.digest, target.digest)``
    class and executed as one ``run_batch`` sweep on shared warm
    Executables; ``submit`` returns a ``Response`` future, overload and
    expired deadlines come back as ``ServiceRejected`` verdicts, a
    per-class ``CircuitBreaker`` degrades a failing ``cuda`` (or
    ``torch``) class to the bit-exact ``sim`` backend and counts it;
    ``submit_stream`` is the bulk path (``StreamResponse``);
    ``Service(replicas=N)`` routes micro-batches over replica slots
    (``Router``),
  * ``FaultPlan``/``FaultSpec`` — deterministic fault injection
    (``repro_torch.ual.faults``; ``InjectedFault`` is what an
    ``exec_fault`` raises),
  * ``ClusterService`` — N spawned worker processes behind one front-end
    (``repro_torch.ual.cluster``), one card each, sharing the on-disk
    artifact cache; a dead worker's in-flight requests retry on live
    workers and the worker respawns warm under a ``RestartPolicy``,
  * ``ShardedKernelEngine`` — one block plan split over every device of
    the host mesh (``repro_torch.launch.mesh``), behind the sharded
    backends,
  * ``compile_many``/``explore`` — grid compilation over a forked process
    pool with cache-aware dedup, and the Pareto DSE front-end on top of it
    (``DesignPoint``, ``ExploreReport``; GOPS/W from ``core.energy``),
  * ``python -m repro_torch.ual.check`` — the verifier CLI.

Backends: ``interp`` (the DFG oracle), ``sim`` (the vectorized numpy
simulator), ``cuda`` (the hand-written kernel on the card; raises with no
CUDA device), ``torch`` (the kernel's plain PyTorch version on the CPU),
``cuda_sharded`` (the kernel on every card of the process, one block plan)
and ``torch_sharded`` (its CPU twin over ``launch.mesh.forced_host_devices``
CPU devices).
"""
from repro_torch.analysis.verifier import (CheckReport, Diagnostic,
                                           VerifyError, verify)
from repro_torch.core.lowering import LinkedConfig, link_config
from repro_torch.core.mapper import (MapperStrategy, list_strategies,
                                     register_strategy)
from repro_torch.ual.backends import (Backend, get_backend, list_backends,
                                      register_backend)
from repro_torch.ual.cache import (CACHE_VERSION, CacheStats, MappingCache,
                                   default_cache, default_cache_dir,
                                   set_default_cache)
from repro_torch.ual.cluster import ClusterService, RestartPolicy, Router
from repro_torch.ual.compiler import compile
from repro_torch.ual.faults import FaultPlan, FaultSpec, InjectedFault
from repro_torch.ual.engine import (CompiledKernelCache, KernelEngine,
                                    ShardedKernelEngine, bucket_ladder,
                                    default_engine, set_default_engine)
from repro_torch.ual.executable import CompileInfo, Executable, PassRecord
from repro_torch.ual.explore import (DesignPoint, ExploreReport,
                                     compile_many, explore)
from repro_torch.ual.pipeline import (CompileContext, CompilePass, Pipeline,
                                      VerifyPass, default_pipeline)
from repro_torch.ual.program import Program
from repro_torch.ual.service import (Response, Service, ServiceRejected,
                                     StreamResponse)
from repro_torch.ual.service.breaker import CircuitBreaker
from repro_torch.ual.target import (FABRICS, Target, list_fabrics,
                                    register_fabric)

__all__ = [
    "Backend", "CACHE_VERSION", "CacheStats", "CheckReport",
    "CircuitBreaker", "ClusterService", "CompileContext", "CompileInfo",
    "CompiledKernelCache", "CompilePass", "DesignPoint", "Diagnostic",
    "Executable", "ExploreReport", "FABRICS", "FaultPlan", "FaultSpec",
    "InjectedFault", "KernelEngine", "LinkedConfig", "MapperStrategy",
    "MappingCache", "PassRecord", "Pipeline", "Program", "Response",
    "RestartPolicy", "Router", "Service", "ServiceRejected",
    "ShardedKernelEngine", "StreamResponse", "Target",
    "VerifyError", "VerifyPass",
    "bucket_ladder", "compile", "compile_many", "default_cache",
    "default_cache_dir", "default_engine", "default_pipeline", "explore",
    "get_backend", "link_config", "list_backends", "list_fabrics",
    "list_strategies", "register_backend", "register_fabric",
    "register_strategy", "set_default_cache", "set_default_engine",
    "verify",
]
