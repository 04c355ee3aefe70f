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
  * ``linked_state`` / ``linked_config`` — the lowered ``LinkedConfig``,
  * ``lm_params_from_state`` — a language model's parameters, from the
    reference's stacked numpy arrays, so both packages compute on the same
    weights.

The ``*_state`` readers take any object with the same attribute names, so
they read the reference's objects as well as the port's.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.adl import Fabric
from repro_torch.core.lowering import LinkedConfig
from repro_torch.core.machine import MachineConfig
from repro_torch.core.mapper import MapResult
from repro_torch.models.common import ModelConfig, check_family

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


#: numpy dtype names of the reference's parameters -> the port's dtypes
#: (bf16 arrives as ml_dtypes' ``bfloat16``, which torch cannot read)
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name not in TORCH_DTYPES:
        raise ValueError(f"no torch dtype for parameter dtype {a.dtype}")
    # a writable f32 copy, which holds every bf16 value exactly
    t = torch.from_numpy(np.array(a, np.float32))
    return t.to(device=device, dtype=TORCH_DTYPES[a.dtype.name])


def lm_params_from_state(state: Dict[str, object], cfg: ModelConfig,
                         device) -> Dict[str, object]:
    """The port's parameters from a reference parameter tree as numpy
    arrays (per-layer weights stacked on a leading ``(L, ...)`` axis, as the
    reference's ``init_params`` makes them), on ``device``, each in its own
    dtype.  dense: ``attn``, ``mlp``, ``norm1``, ``norm2`` stacked ``(L,
    ...)``.  moe: ``attn``, ``moe`` (``router``, ``we_*``, ``ws_*`` and
    ``dense`` where the config has them), ``norm1``, ``norm2`` stacked
    ``(L, ...)``.  rwkv6: ``rwkv`` stacked ``(L, ...)``.  zamba2: ``mamba``
    stacked ``(L, ...)``, and ``shared_attn``,
    ``shared_mlp``, ``shared_norm1``, ``shared_norm2`` stacked ``(1, ...)``,
    which become ``params["shared"]``.  hubert and paligemma: the dense
    layers, and the front end's unstacked ``frontend_proj`` and
    ``mask_embed`` (audio) or ``img_proj`` (image)."""
    check_family(cfg)
    L = cfg.n_layers

    def layer(tree, i):
        """Entry ``i`` of every stacked array of ``tree``."""
        if isinstance(tree, dict):
            return {n: layer(w, i) for n, w in tree.items()}
        return _tensor(tree[i], device)

    if cfg.family == "rwkv6":
        stacked = state["rwkv"]["norm1"]
    elif cfg.family == "zamba2":
        stacked = state["mamba"]["w_in"]
    else:
        stacked = state["norm1"]
    if np.shape(stacked)[0] != L:
        raise ValueError(f"the state stacks {np.shape(stacked)[0]} layers, "
                         f"the config has {L}")
    params: Dict[str, object] = {
        name: _tensor(state[name], device)
        for name in ("embed", "final_norm", "lm_head", "frontend_proj",
                     "mask_embed", "img_proj") if name in state}
    if cfg.family == "rwkv6":
        params["layers"] = [layer(state["rwkv"], i) for i in range(L)]
        return params
    if cfg.family == "zamba2":
        params["layers"] = [layer(state["mamba"], i) for i in range(L)]
        params["shared"] = {n: layer(state[f"shared_{n}"], 0)
                            for n in ("attn", "mlp", "norm1", "norm2")}
        return params
    ffn = "moe" if cfg.family == "moe" else "mlp"
    params["layers"] = [{n: layer(state[n], i)
                         for n in ("attn", ffn, "norm1", "norm2")}
                        for i in range(L)]
    return params
