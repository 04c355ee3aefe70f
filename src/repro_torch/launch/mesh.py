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
"""
from __future__ import annotations

import os
from typing import List, Mapping, Optional

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


__all__ = ("HOST_DEVICES_ENV", "forced_device_env", "forced_host_devices",
           "make_host_mesh")
