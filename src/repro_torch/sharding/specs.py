"""Sharding rules: logical axes -> partition specs over the (pod, data,
model) mesh (the JAX package's ``sharding/specs.py``, in PyTorch).

Parallelism layout (MaxText-style, generalizes to any axis sizes):

  * DP   — batch over ('pod', 'data') (pods compose with the data axis)
  * FSDP — parameter d_model/reduction dims over 'data' (ZeRO-3: optimizer
           state inherits the param specs, so it is fully sharded too)
  * TP   — heads / ffn / vocab / experts over 'model' (Megatron pairs:
           column-parallel then row-parallel, one all-reduce per block)
  * EP   — MoE expert dim over 'model'
  * SP   — long-context cells shard sequence over ('pod', 'data') when the
           batch axis is too small (e.g. long_500k with batch 1), and the
           decode KV cache over 'model' when kv_heads < model-axis size

A spec (``P``) keeps the reference's per-dimension form: one entry per
tensor dimension, each ``None``, a mesh axis name or a tuple of names.  The
tables are pure functions of the config and the mesh's axis names and sizes
(``launch.mesh.Mesh``), and they describe the reference's parameter tree,
each per-layer weight stacked on a leading ``(L, ...)`` axis.
``spec_at`` reads them onto the port's per-layer tree (dropping the
layer axis), and ``placements`` turns a spec into ``DTensor`` placements
over the mesh's ``DeviceMesh``: a dimension sharded over a tuple of axes
takes ``Shard(d)`` on each of those mesh dimensions (the tuple in mesh
order), and a mesh dimension that no entry names is ``Replicate()``.

Nothing here hard-codes axis sizes; scaling to 1000+ nodes only grows the
'pod'/'data' axes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from repro_torch.interop import at_path, map_lm_tree
from repro_torch.launch.mesh import Mesh
from repro_torch.models.common import ModelConfig


def _canonical(entry):
    """An entry as ``PartitionSpec`` keeps it: a tuple of one name is the
    name, an empty tuple None, a list a tuple."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return None if not entry else entry[0] if len(entry) == 1 else entry
    return entry


class P(tuple):
    """A partition spec: one entry per leading tensor dimension, each None
    (replicated), a mesh axis name or a tuple of names; dimensions past
    the last entry are replicated (``jax.sharding.PartitionSpec``'s
    counterpart, canonical as it is)."""

    def __new__(cls, *entries):
        return super().__new__(cls, map(_canonical, entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def is_spec(x) -> bool:
    return isinstance(x, P)


def tree_map(fn: Callable, tree, *rest, is_leaf=is_spec):
    """``fn`` over the leaves of ``tree`` (nested dicts, lists, tuples; a
    spec is a leaf), with the matching nodes of ``rest``."""
    if not is_leaf(tree):
        if isinstance(tree, dict):
            return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                       is_leaf=is_leaf)
                              for i, v in enumerate(tree))
    return fn(tree, *rest)


def mesh_axis(mesh: Mesh, name: str) -> Optional[str]:
    return name if name in mesh.axis_names else None


def dp_axes(mesh: Mesh, strategy: str = "tp2d"):
    """Composite DP axis.

    tp2d: ('pod', 'data') — the model axis is reserved for TP/EP.
    fsdp: ('data', 'model') — batch over the whole pod; the pod axis stays
    pure (possibly redundant) DP so a fixed global batch still fits the
    2-pod mesh.
    """
    if strategy == "fsdp":
        axes = tuple(a for a in ("data", "model") if a in mesh.axis_names)
    else:
        axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return axes if axes else None


def fsdp_weight_axes(mesh: Mesh):
    """Combined weight-shard axes for the pure-FSDP (ZeRO-3) strategy."""
    axes = tuple(a for a in ("data", "model") if a in mesh.axis_names)
    return axes if axes else None


def _axes_size(mesh: Mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh.shape[axes]
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def dp_size(mesh: Mesh, strategy: str = "tp2d") -> int:
    """Devices along the composite DP axis."""
    return _axes_size(mesh, dp_axes(mesh, strategy))


def batch_sharded(mesh: Mesh, strategy: str, global_batch: int) -> bool:
    """Whether a batch of ``global_batch`` shards over the DP axis (else the
    sequence does)."""
    n = dp_size(mesh, strategy)
    return global_batch % n == 0 and global_batch >= n


def param_specs(cfg: ModelConfig, mesh: Mesh) -> Dict[str, Any]:
    """Spec tree of the reference's ``init_params(cfg)`` structure."""
    if cfg.shard_strategy == "fsdp":
        fsdp = fsdp_weight_axes(mesh)      # weights over (data x model)
        tp = None                          # no tensor parallelism
    else:
        fsdp = mesh_axis(mesh, "data")
        tp = mesh_axis(mesh, "model")

    # whole-head mode: keep KV projections off the TP axis when kv heads
    # don't divide it (their activations replicate; weights follow)
    kv_tp = tp
    if (tp is not None and cfg.attn_head_shard == "heads"
            and cfg.kv_heads % mesh.shape[tp] != 0):
        kv_tp = None

    def attn_specs():
        s = {
            "wq": P(None, fsdp, tp),
            "wk": P(None, fsdp, kv_tp),
            "wv": P(None, fsdp, kv_tp),
            "wo": P(None, tp, fsdp),
        }
        if cfg.qk_norm:
            s["q_norm"] = P(None, None)
            s["k_norm"] = P(None, None)
        return s

    def mlp_specs():
        s = {"w_up": P(None, fsdp, tp), "w_down": P(None, tp, fsdp)}
        if cfg.mlp_act == "silu":
            s["w_gate"] = P(None, fsdp, tp)
        return s

    specs: Dict[str, Any] = {
        "embed": P(tp, fsdp),
        "final_norm": P(None),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(fsdp, tp)
    if cfg.family in ("dense", "hubert", "paligemma"):
        specs.update(attn=attn_specs(), mlp=mlp_specs(),
                     norm1=P(None, None), norm2=P(None, None))
    elif cfg.family == "moe":
        moe = {
            "router": P(None, fsdp, None),
            "we_gate": P(None, tp, fsdp, None),
            "we_up": P(None, tp, fsdp, None),
            "we_down": P(None, tp, None, fsdp),
        }
        if cfg.n_shared_experts:
            moe.update(ws_gate=P(None, fsdp, tp), ws_up=P(None, fsdp, tp),
                       ws_down=P(None, tp, fsdp))
        if cfg.dense_residual:
            moe["dense"] = mlp_specs()
        specs.update(attn=attn_specs(), moe=moe,
                     norm1=P(None, None), norm2=P(None, None))
    elif cfg.family == "rwkv6":
        specs["rwkv"] = {
            "mix": P(None, None, None),
            "wr": P(None, fsdp, tp), "wk": P(None, fsdp, tp),
            "wv": P(None, fsdp, tp), "wg": P(None, fsdp, tp),
            "ww": P(None, fsdp, tp),
            "w_bias": P(None, tp), "u": P(None, tp),
            "wo": P(None, tp, fsdp), "ln_x": P(None, tp),
            "ffn_k": P(None, fsdp, tp), "ffn_v": P(None, tp, fsdp),
            "ffn_r": P(None, fsdp, tp),
            "norm1": P(None, None), "norm2": P(None, None),
        }
    elif cfg.family == "zamba2":
        specs["mamba"] = {
            "w_in": P(None, fsdp, tp),
            "conv_w": P(None, None, tp),
            "A_log": P(None, None), "D": P(None, None),
            "dt_bias": P(None, None),
            "w_out": P(None, tp, fsdp),
            "norm": P(None, None), "gate_norm": P(None, tp),
        }
        specs["shared_attn"] = attn_specs()
        specs["shared_mlp"] = mlp_specs()
        specs["shared_norm1"] = P(None, None)
        specs["shared_norm2"] = P(None, None)
    if cfg.frontend == "audio":
        specs["frontend_proj"] = P(fsdp, tp)
        specs["mask_embed"] = P(None)
    if cfg.frontend == "image":
        specs["img_proj"] = P(fsdp, tp)
    return specs


def batch_specs(cfg: ModelConfig, mesh: Mesh, global_batch: int,
                kind: str) -> Dict[str, Any]:
    """Input-batch specs; batch over DP if divisible else seq."""
    dp = dp_axes(mesh, cfg.shard_strategy)
    ok = bool(dp) and batch_sharded(mesh, cfg.shard_strategy, global_batch)
    bspec = dp if ok else None
    sspec = None if ok else dp            # sequence-parallel fallback
    if cfg.family == "hubert":
        return {"features": P(bspec, sspec, None),
                "mask": P(bspec, sspec), "targets": P(bspec, sspec)}
    out = {"tokens": P(bspec, sspec)}
    if cfg.family == "paligemma":
        out["img_embeds"] = P(bspec, None, None)
    return out


def cache_specs(cfg: ModelConfig, mesh: Mesh, batch: int) -> Dict[str, Any]:
    """Decode-cache specs (see the module docstring for the policy)."""
    dp = dp_axes(mesh, cfg.shard_strategy)
    tp = (mesh_axis(mesh, "model") if cfg.shard_strategy != "fsdp" else None)
    tp_size = mesh.shape[tp] if tp else 1
    batch_ok = bool(dp) and batch % dp_size(mesh, cfg.shard_strategy) == 0
    b = dp if batch_ok else None
    # KV heads over model when divisible, else shard cache sequence (SP)
    heads_ok = bool(tp) and cfg.kv_heads % tp_size == 0
    kvh = tp if heads_ok else None
    kvs = None if heads_ok else (tp if batch_ok else dp)
    if not batch_ok and not heads_ok:
        kvs = dp          # batch=1 & few kv heads: SP over the big DP axis
    if cfg.family in ("dense", "moe", "paligemma"):
        return {"k": P(None, b, kvs, kvh, None),
                "v": P(None, b, kvs, kvh, None), "len": P()}
    if cfg.family == "rwkv6":
        return {"wkv": P(None, b, tp, None, None),
                "tmix": P(None, b, None), "cmix": P(None, b, None),
                "len": P()}
    if cfg.family == "zamba2":
        return {"conv": P(None, b, None, tp),
                "ssm": P(None, b, tp, None, None),
                "k": P(None, b, kvs, kvh, None),
                "v": P(None, b, kvs, kvh, None), "len": P()}
    raise ValueError(cfg.family)


def activation_spec(mesh: Mesh, global_batch: int) -> P:
    dp = dp_axes(mesh)
    if dp and batch_sharded(mesh, "tp2d", global_batch):
        return P(dp, None, None)
    return P(None, dp, None)


def sanitize_specs(tree_specs, tree_shapes, mesh: Mesh):
    """Shape-aware spec cleanup: pad each spec to the leaf's full rank and
    drop mesh axes from any dimension they don't divide evenly.  Keeps the
    sharding rules declarative while staying correct for odd sizes such as
    hubert's 504-entry codebook embedding.  ``tree_shapes`` mirrors
    ``tree_specs`` with anything that has a ``shape`` (``input_specs``'s
    meta tensors)."""
    def fix(spec, leaf):
        return fitted(spec, leaf.shape, mesh) if is_spec(spec) else spec
    return tree_map(fix, tree_specs, tree_shapes)


def fitted(spec: P, shape, mesh: Mesh) -> P:
    """``spec`` padded to ``shape``'s rank, each dim's axes dropped where
    they do not divide it (``sanitize_specs`` on one leaf)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    return P(*(ax if dim % _axes_size(mesh, ax) == 0 else None
               for dim, ax in zip(shape, entries)))


# ---------------------------------------------------------------------------
# Specs -> DTensor placements
# ---------------------------------------------------------------------------

def placements(spec: P, mesh: Mesh) -> tuple:
    """``spec`` as ``DTensor`` placements over ``mesh``'s dimensions: a
    tensor dimension whose entry names mesh axis a is ``Shard(d)`` on a's
    mesh dimension (a tuple entry on each of its axes, which must come in
    mesh order), every other mesh dimension ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh.axis_names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        dims = [mesh.axis_names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"{spec}: axes {axes} of dimension {d} are not "
                             f"in mesh order {mesh.axis_names}")
        for m in dims:
            if not isinstance(out[m], Replicate):
                raise ValueError(f"{spec}: mesh axis "
                                 f"{mesh.axis_names[m]} shards two dims")
            out[m] = Shard(d)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``'s counterpart):
    ``placements`` over the mesh's ``DeviceMesh``."""
    mesh: Mesh
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def place(self, t):
        """``t`` laid out by this sharding: a ``DTensor`` redistributed
        where its placements differ, a plain tensor (the same full tensor
        on every rank) split locally, with no communication (a ``meta``
        tensor onto the CPU mesh)."""
        from torch.distributed.tensor import DTensor, distribute_tensor
        if isinstance(t, DTensor):
            if tuple(t.placements) == self.placements:
                return t
            return t.redistribute(t.device_mesh, self.placements)
        kind = t.device.type
        return distribute_tensor(t, self.mesh.device_mesh(
            "cpu" if kind == "meta" else kind), self.placements,
            src_data_rank=None)


def to_shardings(tree_specs, mesh: Mesh):
    return tree_map(lambda s: NamedSharding(mesh, s), tree_specs)


def spec_at(tree_specs, path, layer):
    """The spec (or sharding) at ``path`` of ``tree_specs``, less the
    stacked layer axis for a per-layer tensor (``layer`` not None)."""
    s = at_path(tree_specs, path)
    if layer is None:
        return s
    if isinstance(s, NamedSharding):
        return NamedSharding(s.mesh, P(*s.spec[1:]))
    return P(*s[1:])


def distribute(tree, shardings):
    """``tree`` with every tensor laid out by ``shardings`` (a tree of
    ``NamedSharding`` in the reference's layout, read onto ``tree`` by
    ``spec_at``; ``NamedSharding.place``).  Other leaves (a cache's
    ``len``) pass as they are."""
    import torch
    return map_lm_tree(tree, lambda path, layer, leaf: spec_at(
        shardings, path, layer).place(leaf)
        if isinstance(leaf, torch.Tensor) else leaf)


def full(tree):
    """``tree`` with every ``DTensor`` gathered to its full tensor (a
    collective: every rank calls it in the same order)."""
    from torch.distributed.tensor import DTensor
    return map_lm_tree(tree, lambda _p, _i, leaf: leaf.full_tensor()
                       if isinstance(leaf, DTensor) else leaf)


__all__ = ("NamedSharding", "P", "activation_spec", "batch_sharded",
           "batch_specs", "cache_specs", "distribute", "dp_axes", "dp_size",
           "fitted", "fsdp_weight_axes", "full", "is_spec", "mesh_axis",
           "param_specs", "placements", "sanitize_specs", "spec_at",
           "to_shardings", "tree_map")
