"""``repro_torch.ual.service`` — the dynamic-batching CGRA execution service.

``Executable.run_batch`` is far cheaper per sample than scalar runs —
but only for callers who hand-assemble a batch.  Real serving
traffic arrives one sample at a time, from many tenants, against many
kernels.  This package decouples request arrival from fabric execution
(the STRELA move, with Morpher's framing that the *platform* owns the
orchestration):

    queue -> coalesce -> batched sweep

  * ``queue``     — admission: ``Request``/``Response`` futures, the
    thread-safe FIFO, ``ServiceRejected`` for overload verdicts,
  * ``coalescer`` — compatibility buckets keyed on
    ``(program.digest, target.digest, backend, n_iters)``; flush on
    ``max_batch`` or ``max_wait_ms``, whichever first,
  * ``scheduler`` — ``Service`` itself: dispatcher + workers executing
    each micro-batch as ONE ``run_batch`` sweep on shared warm
    Executables (compiled through the mapping cache — a cold tenant pays
    one mapping + one lowering, service-wide),
  * ``metrics``   — the ``stats()`` surface: p50/p99 latency, achieved
    batch size, samples/s, queue depth, rejects by reason.

Bulk chunked traffic goes through ``Service.submit_stream`` — one
tenant's request pipelined through a single warm trace in bounded spans
(``StreamResponse``: per-sample futures, ``chunks()`` streaming
consumption, aggregated overlap info).

The public names re-exported at ``repro_torch.ual`` are ``Service``,
``Response``, ``StreamResponse`` and ``ServiceRejected``.
"""
from repro_torch.ual.service.coalescer import Coalescer
from repro_torch.ual.service.metrics import ServiceMetrics
from repro_torch.ual.service.queue import (AdmissionQueue, Request, Response,
                                     ServiceRejected, StreamResponse)
from repro_torch.ual.service.scheduler import Service

__all__ = ["AdmissionQueue", "Coalescer", "Request", "Response", "Service",
           "ServiceMetrics", "ServiceRejected", "StreamResponse"]
