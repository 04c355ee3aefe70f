"""``repro_torch.ual.cluster`` — replicated serving: replicas and routing.

  * ``replica`` — ``ReplicaSlot`` + ``Router``: least-loaded dispatch
    with class-affinity tiebreak and idle work stealing across an
    in-process pool of worker threads (used by ``Service(replicas=N)``),
    each slot optionally pinned to one torch device.

The JAX package's ``ClusterService`` (worker processes behind one
front-end), its supervision and its sharded engine are not ported yet.
"""
from repro_torch.ual.cluster.replica import ReplicaSlot, Router

__all__ = ("ReplicaSlot", "Router")
