"""``meta``-tensor stand-ins for every model input (no allocation): the
JAX package's ``launch/input_specs.py``, whose ``ShapeDtypeStruct``s they
replace.

Used by the dry-run: parameters, optimizer state, batches and decode
caches for every (arch x shape) cell, with the reference's shapes and
dtypes.  Parameters and optimizer state come in the reference's layout,
each per-layer weight stacked on a leading ``(L, ...)`` axis (the layout
the spec tables of ``sharding/specs.py`` describe); ``models.common.
init_params`` and ``lm.init_cache`` run on the ``meta`` device to make
them.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.interop import lm_groups, nest
from repro_torch.models.common import ModelConfig, init_params
from repro_torch.train.optimizer import OptConfig

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype, device=META)


def stacked(tree) -> Dict[str, Any]:
    """The reference's layout of the port's ``meta`` tree ``tree``: each
    per-layer leaf as one ``(L, ...)`` meta tensor (``interop.lm_groups``)."""
    return nest({path: (e[0][1] if e[0][0] is None
                        else _sds((len(e), *e[0][1].shape), e[0][1].dtype))
                 for path, e in lm_groups(tree).items()})


def port_params(cfg: ModelConfig) -> Dict[str, Any]:
    """The port's parameter tree of ``cfg`` on the ``meta`` device."""
    return init_params(None, cfg, META)


def param_structs(cfg: ModelConfig) -> Dict[str, Any]:
    """Mirror the reference's ``init_params()`` shapes without allocating."""
    return stacked(port_params(cfg))


def batch_structs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "hubert":
        return {
            "features": _sds((B, S, cfg.d_model), torch.float32),
            "mask": _sds((B, S), torch.bool),
            "targets": _sds((B, S), torch.int32),
        }
    out = {"tokens": _sds((B, S), torch.int32)}
    if cfg.family == "paligemma":
        out["img_embeds"] = _sds((B, cfg.n_prefix_tokens, cfg.d_model),
                                 torch.float32)
    return out


def cache_structs(cfg: ModelConfig, batch: int, max_len: int):
    """The decode cache of ``lm.init_cache`` on ``meta``, its ``len`` an
    int32 scalar as in the reference (the port's step keeps ``len`` a
    Python int)."""
    from repro_torch.models.lm import init_cache
    cache = init_cache(cfg, batch, max_len, device=META)
    cache["len"] = _sds((), torch.int32)
    return cache


def opt_structs(cfg: ModelConfig, opt: OptConfig, compress: bool = False):
    from repro_torch.train.train_step import make_train_state
    return make_train_state(cfg, opt, port_params(cfg), compress)


def token_structs(batch: int):
    return _sds((batch, 1), torch.int32)


__all__ = ("batch_structs", "cache_structs", "opt_structs", "param_structs",
           "port_params", "stacked", "token_structs")
