"""Host mesh of the port: a 1-D list of ``torch.device``s.

The JAX package's ``repro.launch.mesh`` builds a 1-D ``data`` mesh of every
jax device on the host, and forces a CPU host to expose N virtual devices
through ``--xla_force_host_platform_device_count`` in ``XLA_FLAGS``.
``XLA_FLAGS`` means nothing to the port.  Here:

  * ``make_host_mesh()`` is every CUDA card of this process,
    ``[cuda:0, ..., cuda:n-1]`` (``CUDA_VISIBLE_DEVICES`` decides which
    cards that is), and raises where there is none;
  * ``make_host_mesh("cpu", n)`` is ``n`` repeated CPU devices — the mesh
    the sharded engine's CPU twin (the ``torch_sharded`` backend) splits
    its blocks over, so multi-device code paths run on a plain CPU host;
  * ``forced_host_devices(n)`` / ``forced_device_env(n)`` set how many CPU
    devices that CPU mesh has when no ``n`` is given, in this process or in
    a child, through one variable of the port's own,
    ``REPRO_TORCH_HOST_DEVICES``.  It is read whenever a CPU mesh is made,
    so, unlike the XLA flag, it may be set at any time.

Nothing here creates a CUDA context at import or when a CPU mesh is made;
``make_host_mesh()`` counts the cards with ``torch.cuda.device_count()``,
which does not initialise CUDA either.

``make_mesh(shape, axes)`` is the sharded steps' mesh: a named ``Mesh`` of
axis names and sizes, the counterpart of ``jax.make_mesh`` (and of
``jax.sharding.AbstractMesh`` where no device is needed).  The spec tables
(``sharding/specs.py``) read only its names and sizes; its
``device_mesh()`` is a ``torch.distributed`` ``DeviceMesh`` over the default
process group, one rank a device, which the sharded steps distribute over.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

#: how many CPU devices ``make_host_mesh("cpu")`` gives (default 1)
HOST_DEVICES_ENV = "REPRO_TORCH_HOST_DEVICES"


def _check(n: int) -> int:
    if n < 1:
        raise ValueError(f"forced device count must be >= 1, got {n}")
    return n


def forced_host_devices(n: int) -> int:
    """Make the CPU mesh of THIS process ``n`` devices (patches
    ``REPRO_TORCH_HOST_DEVICES``).  Returns ``n``::

        from repro_torch.launch.mesh import forced_host_devices, make_host_mesh
        forced_host_devices(4)
        assert len(make_host_mesh("cpu")) == 4
    """
    os.environ[HOST_DEVICES_ENV] = str(_check(n))
    return n


def forced_device_env(n: int,
                      base: Optional[Mapping[str, str]] = None) -> dict:
    """Environment dict for a *subprocess* whose CPU mesh has ``n``
    devices: a copy of ``base`` (default ``os.environ``) with
    ``REPRO_TORCH_HOST_DEVICES`` set to ``n``."""
    env = dict(base if base is not None else os.environ)
    env[HOST_DEVICES_ENV] = str(_check(n))
    return env


def make_host_mesh(device_type: str = "cuda",
                   n: Optional[int] = None) -> List:
    """The devices a sharded engine splits its blocks over, in order.

    ``"cuda"``: every card this process sees; raises with no card.
    ``"cpu"``: ``n`` CPU devices (default ``REPRO_TORCH_HOST_DEVICES``,
    else 1)."""
    import torch

    if device_type == "cpu":
        if n is None:
            n = int(os.environ.get(HOST_DEVICES_ENV, "1"))
        return [torch.device("cpu")] * _check(n)
    if device_type != "cuda":
        raise ValueError(f"unknown device type {device_type!r}; "
                         f"a host mesh is 'cuda' or 'cpu'")
    cards = torch.cuda.device_count()
    if cards < 1:
        raise RuntimeError("make_host_mesh('cuda'): this process sees no "
                           "CUDA device; use make_host_mesh('cpu', n) for "
                           "the CPU mesh")
    return [torch.device("cuda", i) for i in range(cards)]


@dataclass(frozen=True)
class Mesh:
    """A named device mesh: ``axis_names`` and their ``axis_sizes``, ranks
    laid out row-major over them (the last axis fastest), as
    ``jax.make_mesh`` lays out devices.  ``shape`` maps each name to its
    size, as a jax mesh's does."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    _meshes: Dict[str, Any] = field(default_factory=dict, compare=False,
                                    repr=False)

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} and shape "
                             f"{self.axis_sizes} differ in length")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
        for n in self.axis_sizes:
            _check(n)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def device_mesh(self, device_type: Optional[str] = None):
        """The ``DeviceMesh`` of this mesh over the default process group,
        whose world size must equal ``size`` (rank r is device r of the
        row-major layout).  ``device_type`` defaults to ``"cuda"`` where the
        process sees a card, else ``"cpu"``; one ``DeviceMesh`` is built
        per type and kept."""
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        if device_type is None:
            device_type = "cuda" if torch.cuda.is_available() else "cpu"
        if device_type not in self._meshes:
            if not dist.is_initialized():
                raise RuntimeError(
                    f"a {self.size}-device mesh needs a process group of "
                    f"{self.size} ranks (torch.distributed."
                    f"init_process_group); none is initialized")
            world = dist.get_world_size()
            if world != self.size:
                raise RuntimeError(
                    f"mesh {self.shape} has {self.size} devices, the "
                    f"process group {world} ranks")
            ranks = torch.arange(self.size).reshape(self.axis_sizes)
            self._meshes[device_type] = DeviceMesh(
                device_type, ranks, mesh_dim_names=self.axis_names)
        return self._meshes[device_type]


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """The named mesh of ``shape`` over ``axes`` (``jax.make_mesh``'s
    counterpart); building it needs no process group."""
    return Mesh(tuple(str(a) for a in axes), tuple(int(n) for n in shape))


__all__ = ("HOST_DEVICES_ENV", "Mesh", "forced_device_env",
           "forced_host_devices", "make_host_mesh", "make_mesh")
