"""``Target`` — where (and how) a Program runs.

A Target names a fabric (the elaborated ADL topology), a mapper strategy
with its quality knobs, and an execution backend.  Fabrics come from a
registry keyed by the ADL builder names (``hycube``/``n2n``/``pace``/
``spatial``/``tpu_pod``); backends come from the pluggable registry in
``ual.backends``.

``Target.digest`` hashes only what the *mapper* consumes — the fabric
topology and the mapping knobs — deliberately excluding the backend, so a
Program compiled once is served from the cache for every backend that
executes the same machine configuration (interp / sim / torch / cuda
parity costs one mapping, not four).

The default backend is ``cuda``: a Target runs on the card unless the
caller names another backend (``torch`` for the plain PyTorch version on
the CPU, ``sim`` or ``interp``).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field, fields, replace
from functools import cached_property
from typing import Callable, Dict, Optional

from repro_torch.core.adl import FABRIC_BUILDERS, Fabric

FABRICS: Dict[str, Callable[..., Fabric]] = dict(FABRIC_BUILDERS)


def register_fabric(name: str, builder: Callable[..., Fabric],
                    overwrite: bool = False) -> None:
    """Register a fabric builder under ``name``.

    Registering an existing name raises unless ``overwrite=True`` — silent
    replacement is how two plugins stomp each other.  ``builder`` is any
    callable returning a ``Fabric`` (``Target.from_name`` forwards its
    non-knob keyword arguments to it); the ADL builders
    ``hycube``/``n2n``/``pace``/``spatial``/``tpu_pod`` ship built-in.
    """
    if name in FABRICS and not overwrite:
        raise ValueError(f"fabric {name!r} already registered; "
                         f"pass overwrite=True to replace it")
    if not callable(builder):
        raise TypeError(f"builder must be callable, "
                        f"got {type(builder).__name__}")
    FABRICS[name] = builder


def list_fabrics() -> list:
    """Sorted names of all registered fabric builders."""
    return sorted(FABRICS)


@dataclass(frozen=True)
class Target:
    fabric: Fabric
    backend: str = "cuda"
    # -- mapper knobs (all hashed into .digest) -------------------------------
    strategy: str = "adaptive"
    ii_max: int = 48
    seed: int = 0
    max_restarts: int = 8
    time_budget_s: Optional[float] = 90.0
    label_fn: Optional[Callable] = field(default=None, compare=False)

    @property
    def name(self) -> str:
        return f"{self.fabric.name}/{self.backend}"

    @cached_property
    def digest(self) -> str:
        """Stable SHA-256 over the mapping-relevant configuration.

        Excludes ``backend`` (the bitstream is backend-independent) and
        ``label_fn`` (unhashable; callers supplying one should bypass or
        scope their own cache).
        """
        blob = "|".join([
            self.fabric.to_json(), self.strategy, str(self.ii_max),
            str(self.seed), str(self.max_restarts),
            str(self.time_budget_s),
        ])
        return hashlib.sha256(blob.encode()).hexdigest()

    def with_backend(self, backend: str) -> "Target":
        return replace(self, backend=backend)

    @staticmethod
    def from_name(fabric: str, *, backend: str = "cuda",
                  **kwargs) -> "Target":
        """Build a Target from a registered fabric name, e.g.::

            Target.from_name("hycube", rows=4, cols=4, max_hops=4,
                             backend="cuda", seed=3)

        Keyword names matching Target fields (``seed``, ``max_restarts``,
        ``ii_max``, ``strategy``, ``time_budget_s``, ``label_fn``) set the
        mapper knobs; everything else goes to the fabric builder.  Knob
        defaults therefore live in exactly one place — the dataclass.
        """
        if fabric not in FABRICS:
            raise KeyError(f"unknown fabric {fabric!r}; "
                           f"registered: {sorted(FABRICS)}")
        knob_names = {f.name for f in fields(Target)} - {"fabric", "backend"}
        knobs = {k: v for k, v in kwargs.items() if k in knob_names}
        fabric_kwargs = {k: v for k, v in kwargs.items()
                         if k not in knob_names}
        return Target(FABRICS[fabric](**fabric_kwargs), backend=backend,
                      **knobs)
