"""Carry mapping state into the port as plain data.

Mappings are what this system has in place of weights, and the mapper is
time-budgeted: two packages (or two machines) may legitimately map one
``(program, target)`` pair differently.  To execute exactly the mapping
some other toolchain produced — the JAX reference, in the parity tests —
its state crosses as plain data: numpy arrays, numbers and the fabric's
JSON (``Fabric.to_json``).  Nothing here imports another package.

  * ``config_state`` / ``machine_config`` — a ``MachineConfig``,
  * ``map_state`` / ``map_result`` — the ``MapResult`` fields the pipeline
    and ``Executable`` read, with its configuration,
  * ``linked_state`` / ``linked_config`` — the lowered ``LinkedConfig``.

The ``*_state`` readers take any object with the same attribute names, so
they read the reference's objects as well as the port's.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.core.adl import Fabric
from repro_torch.core.lowering import LinkedConfig
from repro_torch.core.machine import MachineConfig
from repro_torch.core.mapper import MapResult

CONFIG_ARRAYS = ("opcode", "const", "use_const", "t0", "node_id", "op_src",
                 "xbar", "regw")
MAP_FIELDS = ("success", "II", "mii", "placements", "schedule_len",
              "restarts", "wall_s", "strategy")
LINKED_ARRAYS = ("scalar", "ops", "regw")
LINKED_FIELDS = ("II", "n_pes", "n_regs", "mem_pes", "n_mem_ports",
                 "unresolved_inputs")


def config_state(cfg) -> Dict[str, object]:
    """Plain data of a machine configuration: fabric JSON, II, arrays."""
    state: Dict[str, object] = {"fabric": cfg.fabric.to_json(),
                                "II": int(cfg.II)}
    for name in CONFIG_ARRAYS:
        state[name] = np.array(getattr(cfg, name), np.int32)
    return state


def machine_config(state: Dict[str, object]) -> MachineConfig:
    """The port's ``MachineConfig`` from ``config_state`` data."""
    arrays = {name: np.array(state[name], np.int32) for name in CONFIG_ARRAYS}
    return MachineConfig(fabric=Fabric.from_json(state["fabric"]),
                         II=int(state["II"]), **arrays)


def map_state(result) -> Dict[str, object]:
    """Plain data of a mapping result (its configuration included)."""
    state = {name: getattr(result, name) for name in MAP_FIELDS}
    state["placements"] = {int(n): (int(pe), int(t)) for n, (pe, t)
                           in result.placements.items()}
    state["config"] = (None if result.config is None
                       else config_state(result.config))
    return state


def map_result(state: Dict[str, object]) -> MapResult:
    """The port's ``MapResult`` from ``map_state`` data."""
    cfg: Optional[MachineConfig] = (None if state["config"] is None
                                    else machine_config(state["config"]))
    fields = {name: state[name] for name in MAP_FIELDS}
    fields["placements"] = dict(fields["placements"])
    return MapResult(config=cfg, **fields)


def linked_state(linked) -> Dict[str, object]:
    """Plain data of a lowered artifact."""
    state: Dict[str, object] = {name: getattr(linked, name)
                                for name in LINKED_FIELDS}
    state["mem_pes"] = tuple(int(p) for p in linked.mem_pes)
    for name in LINKED_ARRAYS:
        state[name] = np.array(getattr(linked, name), np.int32)
    return state


def linked_config(state: Dict[str, object]) -> LinkedConfig:
    """The port's ``LinkedConfig`` from ``linked_state`` data."""
    fields = {name: state[name] for name in LINKED_FIELDS}
    fields["mem_pes"] = tuple(int(p) for p in fields["mem_pes"])
    arrays = {name: np.array(state[name], np.int32) for name in LINKED_ARRAYS}
    return LinkedConfig(**fields, **arrays)
