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
    weights; ``lm_state_from_params`` is its inverse, for the parameters
    and any tree that mirrors them (gradients, optimizer moments), and
    ``lm_leaves`` / ``map_lm_tree`` name every tensor of such a tree by its
    place in the reference's tree (checkpoints and the optimizer use them).

The ``*_state`` readers take any object with the same attribute names, so
they read the reference's objects as well as the port's.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

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


#: a tensor's place in the reference's tree: its key path, and its index on
#: the stacked ``(L, ...)`` axis (None for a leaf the reference does not
#: stack)
Place = Tuple[Tuple[str, ...], Optional[int]]


def _layers_prefix(tree: Dict[str, Any]) -> Tuple[str, ...]:
    """Where the reference keeps ``tree["layers"]``: under ``mamba``
    (zamba2, which has a ``shared`` block), under ``rwkv`` (an RWKV-6 block
    has ``mix``), else at the top level (dense, moe, hubert, paligemma)."""
    if "shared" in tree:
        return ("mamba",)
    layers = tree["layers"]
    if layers and "mix" in layers[0]:
        return ("rwkv",)
    return ()


def map_lm_tree(tree, fn: Callable[[Tuple[str, ...], Optional[int], Any],
                                   Any], path: Tuple[str, ...] = ()):
    """A copy of ``tree`` (nested dicts, lists, tuples) with every leaf
    replaced by ``fn(path, layer, leaf)``, where ``(path, layer)`` is the
    leaf's place in the reference's layout.  Dict keys and list indices
    extend the path (as ``str``), except in a dict that holds a list under
    ``"layers"`` (the port's model parameters, or a tree that mirrors
    them): there entry i of ``layers`` is layer i of the stacked leaves the
    reference keeps at the top, under ``mamba`` or under ``rwkv``
    (``_layers_prefix``), and zamba2's ``shared`` block is layer 0 of the
    reference's ``shared_attn``, ``shared_mlp``, ``shared_norm1`` and
    ``shared_norm2``."""
    def walk(node, path, layer):
        if isinstance(node, dict):
            if isinstance(node.get("layers"), list) and layer is None:
                return lm_node(node, path)
            return {k: walk(v, path + (str(k),), layer)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (str(i),), layer)
                              for i, v in enumerate(node))
        return fn(path, layer, node)

    def lm_node(node, path):
        out = {}
        prefix = path + _layers_prefix(node)
        for k, v in node.items():
            if k == "layers":
                out[k] = [walk(lp, prefix, i) for i, lp in enumerate(v)]
            elif k == "shared" and "layers" in node:
                out[k] = {n: walk(sub, path + (f"shared_{n}",), 0)
                          for n, sub in v.items()}
            else:
                out[k] = walk(v, path + (str(k),), None)
        return out

    return walk(tree, tuple(path), None)


def lm_leaves(tree) -> List[Tuple[Tuple[str, ...], Optional[int], Any]]:
    """Every leaf of ``tree`` with its place in the reference's layout,
    ``(path, layer, leaf)``, in the tree's order (``map_lm_tree``)."""
    out: List[Tuple[Tuple[str, ...], Optional[int], Any]] = []
    map_lm_tree(tree, lambda p, i, leaf: out.append((p, i, leaf)))
    return out


def lm_groups(tree) -> Dict[Tuple[str, ...], List[Tuple[Optional[int],
                                                        Any]]]:
    """The leaves of ``tree`` by the reference leaf they form: key path ->
    [(layer, leaf)] in layer order, one entry with layer None for a leaf
    the reference does not stack (``map_lm_tree``)."""
    out: Dict[Tuple[str, ...], list] = {}
    for path, layer, leaf in lm_leaves(tree):
        out.setdefault(path, []).append((layer, leaf))
    for entries in out.values():
        if entries[0][0] is not None:
            entries.sort(key=lambda e: e[0])
    return out


def at_path(tree, path: Tuple[str, ...]):
    """The node of nested dicts ``tree`` at key path ``path``."""
    for k in path:
        tree = tree[k]
    return tree


def nest(flat: Dict[Tuple[str, ...], Any]) -> Dict[str, Any]:
    """Nested dicts from ``{key path: value}``."""
    out: Dict[str, Any] = {}
    for path, value in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value
    return out


def _numpy(t) -> np.ndarray:
    """A tensor as numpy, bf16 (which numpy has not) as its exact f32."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def lm_state_from_params(params, cfg: Optional[ModelConfig] = None
                         ) -> Dict[str, object]:
    """The reference's layout of the port's parameters, or of any tree that
    mirrors them (gradients, AdamW moments): nested dicts of numpy arrays,
    each per-layer weight stacked on a leading ``(L, ...)`` axis, zamba2's
    shared block on a ``(1, ...)`` one (``map_lm_tree``).  bf16 tensors
    come out as their exact f32 values (numpy has no bf16; cast them to the
    reference's dtype there).  The inverse of ``lm_params_from_state``;
    ``cfg``, when given, checks the number of layers."""
    flat = {}
    for path, entries in lm_groups(params).items():
        if entries[0][0] is None:
            flat[path] = _numpy(entries[0][1])
        else:
            flat[path] = np.stack([_numpy(t) for _, t in entries])
    if cfg is not None and isinstance(params, dict) and "layers" in params \
            and len(params["layers"]) != cfg.n_layers:
        raise ValueError(f"the parameters hold {len(params['layers'])} "
                         f"layers, the config has {cfg.n_layers}")
    return nest(flat)
