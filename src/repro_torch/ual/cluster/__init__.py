"""``repro_torch.ual.cluster`` — sharded serving: replicas, routing, processes.

Three layers, smallest first:

  * ``replica`` — ``ReplicaSlot`` + ``Router``: least-loaded dispatch
    with class-affinity tiebreak and idle work stealing across an
    in-process pool of worker threads (used by ``Service(replicas=N)``),
    each slot optionally pinned to one torch device.
  * ``ShardedKernelEngine`` (in ``repro_torch.ual.engine``) — one block
    plan split over every device of a host mesh (the ``cuda_sharded`` and
    ``torch_sharded`` backends).
  * ``service`` — ``ClusterService``: N spawned worker processes behind
    one front-end, one card each, sharing the on-disk artifact cache,
    healed under a ``RestartPolicy`` (``supervision``) and merging their
    ``stats()`` into a single cluster view.
"""
from repro_torch.ual.cluster.replica import ReplicaSlot, Router
from repro_torch.ual.cluster.service import ClusterService
from repro_torch.ual.cluster.supervision import RestartPolicy, WorkerState

__all__ = ("ClusterService", "ReplicaSlot", "RestartPolicy", "Router",
           "WorkerState")
