"""The port's spec tables against the JAX package's, entry by entry.

``sharding/specs.py``, ``sharding/ctx.make_rules`` and
``train/optimizer.opt_state_specs`` are pure functions of the config and
the mesh's axis names and sizes, so both packages' tables are computed
with no device: the reference's on ``jax.sharding.AbstractMesh``, the
port's on ``launch.mesh.make_mesh``.  Every architecture at its published
widths, on the production meshes (16, 16) ``data,model`` and (2, 16, 16)
``pod,data,model`` and the 1-D ``data`` host mesh, under both
``shard_strategy``s, at global batches 1, 32, 128 and 256.  Then the
spec-to-placement converter on tuple axes, the counterpart of
``tests/test_distribution.py::test_param_specs_cover_tree``, and
``constrain``'s contract.
"""
import dataclasses
import functools

import jax
import pytest
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.launch.input_specs import param_structs as ref_param_structs
from repro.sharding import ctx as ref_ctx
from repro.sharding import specs as ref_specs
from repro.train.optimizer import OptConfig as RefOptConfig
from repro.train.optimizer import opt_state_specs as ref_opt_state_specs
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.launch.input_specs import param_structs, port_params
from repro_torch.launch.mesh import make_mesh
from repro_torch.sharding import ctx, specs
from repro_torch.sharding.specs import P
from repro_torch.train.optimizer import OptConfig, opt_state_specs

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "host": ((1,), ("data",))}
STRATEGIES = ("tp2d", "fsdp")
BATCHES = (1, 32, 128, 256)
ARCH_NAMES = sorted(ARCHS)
CASES = [(a, m, s) for a in ARCH_NAMES for m in MESHES for s in STRATEGIES]


def _meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), make_mesh(shape, axes)


def _cfgs(arch, strategy, **kw):
    return (dataclasses.replace(ref_get_config(arch), shard_strategy=strategy,
                                **kw),
            dataclasses.replace(get_config(arch), shard_strategy=strategy,
                                **kw))


def _entries(spec):
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                 for e in spec)


def _ref_flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                  for k in path): _entries(s) for path, s in leaves}


def _flat(tree, path=()):
    if isinstance(tree, P):
        return {path: _entries(tree)}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, path + (str(k),)))
    return out


def _same(port_tree, ref_tree):
    assert _flat(port_tree) == _ref_flat(ref_tree)


@functools.lru_cache(maxsize=None)
def _structs(arch):
    """(the reference's abstract parameters, the port's meta ones)."""
    return ref_param_structs(ref_get_config(arch)), param_structs(
        get_config(arch))


@pytest.mark.parametrize("arch,mesh,strategy", CASES)
def test_param_specs(arch, mesh, strategy):
    rmesh, pmesh = _meshes(mesh)
    for head_shard in ("auto", "heads"):
        rcfg, pcfg = _cfgs(arch, strategy, attn_head_shard=head_shard)
        _same(specs.param_specs(pcfg, pmesh),
              ref_specs.param_specs(rcfg, rmesh))


@pytest.mark.parametrize("arch,mesh,strategy", CASES)
def test_batch_specs(arch, mesh, strategy):
    rmesh, pmesh = _meshes(mesh)
    rcfg, pcfg = _cfgs(arch, strategy)
    for batch in BATCHES:
        for kind in ("train", "prefill"):
            _same(specs.batch_specs(pcfg, pmesh, batch, kind),
                  ref_specs.batch_specs(rcfg, rmesh, batch, kind))


@pytest.mark.parametrize("arch,mesh,strategy", CASES)
def test_cache_specs(arch, mesh, strategy):
    rmesh, pmesh = _meshes(mesh)
    rcfg, pcfg = _cfgs(arch, strategy)
    for batch in BATCHES:
        if rcfg.family == "hubert":
            with pytest.raises(ValueError):
                ref_specs.cache_specs(rcfg, rmesh, batch)
            with pytest.raises(ValueError):
                specs.cache_specs(pcfg, pmesh, batch)
            continue
        _same(specs.cache_specs(pcfg, pmesh, batch),
              ref_specs.cache_specs(rcfg, rmesh, batch))


@pytest.mark.parametrize("mesh", MESHES)
def test_activation_spec(mesh):
    rmesh, pmesh = _meshes(mesh)
    for batch in BATCHES:
        assert _entries(specs.activation_spec(pmesh, batch)) == _entries(
            ref_specs.activation_spec(rmesh, batch))


@pytest.mark.parametrize("arch,mesh,strategy", CASES)
def test_sanitize_specs(arch, mesh, strategy):
    """On ``input_specs``' shapes (hubert's 504-row codebook among them);
    the port's meta shapes are the reference's abstract ones."""
    rmesh, pmesh = _meshes(mesh)
    rcfg, pcfg = _cfgs(arch, strategy)
    rstructs, pstructs = _structs(arch)
    _same(specs.sanitize_specs(specs.param_specs(pcfg, pmesh), pstructs,
                               pmesh),
          ref_specs.sanitize_specs(ref_specs.param_specs(rcfg, rmesh),
                                   rstructs, rmesh))


@pytest.mark.parametrize("arch,mesh,factored",
                         [(a, m, f) for a in ARCH_NAMES for m in MESHES
                          for f in (False, True)])
def test_opt_state_specs(arch, mesh, factored):
    rmesh, pmesh = _meshes(mesh)
    rcfg, pcfg = _cfgs(arch, "tp2d")
    rstructs, pstructs = _structs(arch)
    rspecs = ref_specs.sanitize_specs(ref_specs.param_specs(rcfg, rmesh),
                                      rstructs, rmesh)
    pspecs = specs.sanitize_specs(specs.param_specs(pcfg, pmesh), pstructs,
                                  pmesh)
    _same(opt_state_specs(pspecs, OptConfig(factored=factored), pstructs),
          ref_opt_state_specs(rspecs, RefOptConfig(factored=factored),
                              rstructs))
    if not factored:       # the shapes are needed only to factor
        _same(opt_state_specs(pspecs, OptConfig()),
              ref_opt_state_specs(rspecs, RefOptConfig()))


@pytest.mark.parametrize("mesh,strategy,batch_sharded,kv_tp_ok",
                         [(m, s, b, k) for m in MESHES for s in STRATEGIES
                          for b in (True, False) for k in (True, False)])
def test_make_rules(mesh, strategy, batch_sharded, kv_tp_ok):
    rmesh, pmesh = _meshes(mesh)
    want = ref_ctx.make_rules(rmesh, batch_sharded=batch_sharded,
                              strategy=strategy, kv_tp_ok=kv_tp_ok)
    got = ctx.make_rules(pmesh, batch_sharded=batch_sharded,
                         strategy=strategy, kv_tp_ok=kv_tp_ok)
    assert sorted(got) == sorted(want)
    for kind in want:
        assert _entries(got[kind].spec) == _entries(want[kind].spec), kind


@pytest.mark.parametrize("spec,want", [
    (P(("pod", "data"), None, "model"), ("S0", "S0", "S2")),
    (P(None, ("data", "model")), ("R", "S1", "S1")),
    (P("model", "data"), ("R", "S1", "S0")),
    (P(None, None), ("R", "R", "R")),
    (P(), ("R", "R", "R")),
])
def test_spec_to_placements_on_tuple_axes(spec, want):
    """A dim sharded over a tuple of axes takes Shard(d) on each of its
    mesh dims; a mesh dim no entry names is Replicate()."""
    mesh = make_mesh((2, 16, 16), ("pod", "data", "model"))
    got = tuple("R" if p.is_replicate() else f"S{p.dim}"
                for p in specs.placements(spec, mesh))
    assert got == want


def test_spec_to_placements_refuses_out_of_order_axes():
    mesh = make_mesh((2, 16, 16), ("pod", "data", "model"))
    with pytest.raises(ValueError, match="mesh order"):
        specs.placements(P(("model", "data")), mesh)
    with pytest.raises(ValueError, match="shards two dims"):
        specs.placements(P("data", "data"), mesh)


@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-moe-16b",
                                  "rwkv6-1.6b", "zamba2-2.7b",
                                  "hubert-xlarge", "paligemma-3b",
                                  "arctic-480b"])
def test_param_specs_cover_tree(arch):
    """Every parameter of the port's tree (per layer) has a spec of at
    most its rank, read from the reference-layout table (``spec_at``),
    and every stacked leaf of the reference's tree has one too."""
    from repro_torch.interop import lm_leaves
    assert smoke_config(arch).name == ref_smoke_config(arch).name
    mesh = make_mesh((1,), ("data",))
    cfg = smoke_config(arch)
    table = specs.param_specs(cfg, mesh)
    for path, layer, leaf in lm_leaves(port_params(cfg)):
        spec = specs.spec_at(table, path, layer)
        assert isinstance(spec, P), (arch, path)
        assert len(spec) <= leaf.ndim, (arch, path, layer)
    flat = _flat(table)
    for path, e in _flat(specs.tree_map(
            lambda s, t: P(*range(t.ndim)), table,
            param_structs(cfg))).items():
        assert path in flat and len(flat[path]) <= len(e), (arch, path)


def test_constrain_passes_plain_tensors_and_raises_on_a_rule_it_cannot_apply():
    """No rules, or a plain tensor: ``constrain`` returns its input.  On a
    DTensor under rules it lays it out by the rule, and raises on a rank
    mismatch or an unknown kind; a kernel wrapper refuses a DTensor (a
    fake group of one rank, destroyed on the way out)."""
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch.dryrun import fake_group

    x = torch.zeros(4, 8, 16)
    assert ctx.constrain(x, "hidden") is x
    mesh = make_mesh((1, 1), ("data", "model"))
    rules = ctx.make_rules(mesh)
    with ctx.activation_sharding(rules):
        assert ctx.constrain(x, "hidden") is x
    with fake_group(1):
        t = specs.NamedSharding(mesh, P(None, "data")).place(x)
        with ctx.activation_sharding(rules):
            got = ctx.constrain(t, "hidden")
            assert tuple(got.placements) == specs.placements(
                P(("data",), None, None), mesh)
            with pytest.raises(ValueError, match="rank"):
                ctx.constrain(t, "tokens2d")
            with pytest.raises(KeyError, match="no activation rule"):
                ctx.constrain(t, "no-such-kind")
        q = specs.NamedSharding(mesh, P()).place(torch.zeros(1, 4, 2, 8))
        with pytest.raises(TypeError, match="DTensor"):
            flash_attention(q, q, q)


def test_constrain_says_every_axis_it_leaves_off():
    """A rule's axes that do not divide a dimension (XLA pads it) stay off
    it, and each drop is said: a ``ShardingDropWarning`` and one entry,
    counted, in every ``record_drops`` list; an axis that divides is kept
    in silence (a fake group of four ranks, destroyed on the way out)."""
    import warnings

    import torch
    from repro_torch.launch.dryrun import fake_group

    mesh = make_mesh((2, 2), ("data", "model"))
    rules = ctx.make_rules(mesh, batch_sharded=False)
    with fake_group(4):
        odd = specs.NamedSharding(mesh, P()).place(torch.zeros(1, 3, 8))
        even = specs.NamedSharding(mesh, P()).place(torch.zeros(1, 4, 8))
        with ctx.record_drops() as drops, \
                ctx.activation_sharding(rules), \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(2):
                got = ctx.constrain(odd, "hidden")
                assert all(pl.is_replicate() for pl in got.placements)
            kept = ctx.constrain(even, "hidden")
            assert tuple(kept.placements) == specs.placements(
                P(None, ("data",), None), mesh)
    assert [w.category for w in caught] == [ctx.ShardingDropWarning] * 2
    assert drops == [{"rule": "hidden", "spec": "P(None, 'data', None)",
                      "shape": [1, 3, 8], "applied": "P(None, None, None)",
                      "count": 2}]
    assert ctx.fit("hidden", P(None, "data"), (1, 4, 8), mesh) == P(
        None, "data", None)
