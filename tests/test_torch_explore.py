"""The port's DSE front end against the reference's, on the same grids.

``compile_many`` and ``explore`` run through both packages with caches of
their own in tmp dirs:

  * ``compile_many`` dedups by digest (two unique keys map twice, duplicates
    and a backend twin are warm hits), keeps input order, attributes the
    pool's mapping cost to the first pair of each key, and memoizes a failed
    mapping in-process only — the same II, hit pattern and store counts as
    the reference;
  * ``explore``'s report: equal II and GOPS/W per point, the same
    ``n_mapped`` and cache-hit count, a warm re-sweep that maps nothing, and
    the same Pareto set when the port's Pareto filter is given the
    reference's objective values (the mapping wall times differ between
    any two runs, so each report's own frontier is checked for dominance
    separately);
  * ``DesignPoint`` and ``ExploreReport`` carry the reference's fields;
  * the pool forks, and this test process has imported torch: each unique
    key still maps exactly once.
"""
import dataclasses
import sys

import numpy as np
import pytest

from repro import ual as rual
from repro.core.adl import hycube as ref_hycube
from repro_torch import ual as tual
from repro_torch.core.adl import hycube
from repro_torch.ual.explore import pareto_front, space_targets

PASS_NAMES = ["layout", "mii", "mapping", "lowering", "verify", "binding"]
SPACE = {"fabric": [("hycube", dict(rows=4, cols=4)),
                    ("n2n", dict(rows=4, cols=4))],
         "strategy": ["adaptive", "sa"]}


def _caches(tmp_path):
    return (rual.MappingCache(disk_dir=tmp_path / "ref"),
            tual.MappingCache(disk_dir=tmp_path / "port"))


def test_design_point_and_report_fields_match():
    for port_cls, ref_cls in ((tual.DesignPoint, rual.DesignPoint),
                              (tual.ExploreReport, rual.ExploreReport)):
        assert ([f.name for f in dataclasses.fields(port_cls)]
                == [f.name for f in dataclasses.fields(ref_cls)])


def test_compile_many_dedups_and_orders_like_the_reference(tmp_path):
    rcache, pcache = _caches(tmp_path)
    runs = {}
    for side, ual, cache, twin in (("ref", rual, rcache, "pallas"),
                                   ("port", tual, pcache, "cuda")):
        program = ual.Program.from_kernel("gemm", bank_words=64)
        t_hyc = ual.Target.from_name("hycube", rows=4, cols=4,
                                     backend="sim")
        t_n2n = ual.Target.from_name("n2n", rows=4, cols=4, backend="sim")
        pairs = [(program, t_hyc), (program, t_n2n),
                 (program, t_hyc.with_backend(twin)),   # same digest as [0]
                 (program, t_hyc)]                      # exact duplicate
        runs[side] = (program, ual.compile_many(pairs, workers=2,
                                                cache=cache), cache)
    (rprog, rexes, rcache), (pprog, pexes, pcache) = runs["ref"], runs["port"]
    assert pprog.digest == rprog.digest
    assert [e.success for e in pexes] == [True] * 4
    assert [e.II for e in pexes] == [e.II for e in rexes]
    assert pcache.stats.stores == rcache.stats.stores == 2
    assert ([e.compile_info.cache_hit for e in pexes]
            == [e.compile_info.cache_hit for e in rexes]
            == [False, False, True, True])
    assert pexes[0].compile_info.mapper_restarts >= 1
    stats = {p.name: p.stats for p in pexes[0].compile_info.passes}
    assert stats["mapping"]["cache"] == "pool"
    assert [p.name for p in pexes[0].compile_info.passes] == PASS_NAMES
    # the pool's mapping runs bit-equal to the reference's and the oracle
    mem = rprog.random_inputs(np.random.default_rng(0))
    got = pexes[0].run(mem, backend="torch")
    want = rexes[0].run(mem)
    seq = tual.compile(pprog, pexes[0].target, use_cache=False).run(
        mem, backend="sim")
    for name in rprog.outputs:
        np.testing.assert_array_equal(got[name], want[name])
        np.testing.assert_array_equal(got[name], seq[name])


def test_compile_many_failure_memo_matches(tmp_path):
    """An unmappable point maps once in the pool, is memoized in-process
    only, and its duplicate is a warm failure — in both packages."""
    rcache, pcache = _caches(tmp_path)
    seen = {}
    for side, ual, cache, fab in (("ref", rual, rcache, ref_hycube),
                                  ("port", tual, pcache, hycube)):
        program = ual.Program.from_kernel("gemm", bank_words=64)
        good = ual.Target.from_name("hycube", rows=4, cols=4, backend="sim")
        bad = ual.Target(fab(2, 2), backend="sim", ii_max=1, max_restarts=1)
        exes = ual.compile_many([(program, good), (program, bad),
                                 (program, bad)], workers=2, cache=cache)
        pkls = list((tmp_path / side).glob("*.pkl"))
        seen[side] = ([e.success for e in exes],
                      [e.compile_info.cache_hit for e in exes],
                      len([p for p in pkls if not p.name.endswith("_low.pkl")]),
                      cache.contains((program.digest, bad.digest)))
        cache.clear_memory()
        assert not cache.contains((program.digest, bad.digest))
    assert seen["port"] == seen["ref"] == ([True, False, False],
                                           [False, False, True], 1, True)


def test_compile_many_mixed_grid_serial_paths(tmp_path):
    """Spatial fabrics and mapping-free backends compile serially in the
    parent, in input order; only the temporal mapping is stored."""
    _, cache = _caches(tmp_path)
    program = tual.Program.from_kernel("gemm", bank_words=64)
    pairs = [(program, tual.Target.from_name("spatial", backend="interp")),
             (program, tual.Target(hycube(4, 4), backend="interp")),
             (program, tual.Target.from_name("hycube", rows=4, cols=4,
                                             backend="sim"))]
    exes = tual.compile_many(pairs, workers=2, cache=cache)
    assert exes[0].spatial_subgraphs >= 1
    assert exes[1].map_result is None
    assert exes[2].map_result.config is not None
    assert cache.stats.stores == 1


def test_explore_report_matches_the_reference(tmp_path):
    assert "torch" in sys.modules          # the pool forks after torch
    rcache, pcache = _caches(tmp_path)
    rprog = rual.Program.from_kernel("gemm", bank_words=64)
    pprog = tual.Program.from_kernel("gemm", bank_words=64)
    want = rual.explore(rprog, SPACE, workers=2, cache=rcache)
    got = tual.explore(pprog, SPACE, workers=2, cache=pcache)
    assert got.program == want.program
    assert len(got.points) == len(want.points) == 4
    for p, q in zip(got.points, want.points):
        assert (p.fabric, p.strategy, p.knobs, p.success) == \
            (q.fabric, q.strategy, q.knobs, q.success)
        assert p.II == q.II and p.mii == q.mii and p.II >= 1
        assert p.gops_w == q.gops_w and p.gops_w > 0
        assert set(p.pass_times) == set(PASS_NAMES)
    # each unique key mapped exactly once, after torch was imported
    assert got.n_mapped == want.n_mapped == 4 == pcache.stats.stores
    assert got.n_warm == want.n_warm == 0
    # the Pareto filter, fed the reference's objective values, picks the
    # reference's frontier
    same = [dataclasses.replace(p, II=q.II, mapper_wall_s=q.mapper_wall_s,
                                gops_w=q.gops_w)
            for p, q in zip(got.points, want.points)]
    picked = pareto_front(same)
    assert ([i for i, p in enumerate(same) if p in picked]
            == [i for i, q in enumerate(want.points) if q in want.pareto])
    # and the port's own frontier is non-dominated in its own report
    assert got.pareto and set(got.pareto) <= set(got.points)
    for p in got.pareto:
        for q in got.points:
            assert not (q.II <= p.II and q.mapper_wall_s <= p.mapper_wall_s
                        and q.gops_w >= p.gops_w
                        and (q.II, q.mapper_wall_s, q.gops_w)
                        != (p.II, p.mapper_wall_s, p.gops_w))
    rendered = got.render()
    assert "hycube_4x4" in rendered and "Pareto" in rendered
    assert sorted(got.to_json()) == sorted(want.to_json())
    assert (sorted(got.to_json()["points"][0])
            == sorted(want.to_json()["points"][0]))

    again = tual.explore(pprog, SPACE, workers=2, cache=pcache)
    rgain = rual.explore(rprog, SPACE, workers=2, cache=rcache)
    assert again.n_mapped == rgain.n_mapped == 0
    assert again.n_warm == rgain.n_warm == len(again.points)
    assert [p.II for p in again.points] == [p.II for p in got.points]


def test_explore_rejects_bad_space_like_the_reference():
    program = tual.Program.from_kernel("gemm", bank_words=64)
    for space, exc, match in (
            ({"strategy": ["adaptive"]}, ValueError, "'fabric' axis"),
            ({"fabric": ["hycube"], "rows": [4]}, ValueError,
             "unknown space axes"),
            ({"fabric": ["fpga"]}, KeyError, "unknown fabric 'fpga'"),
            ({"fabric": ["hycube"], "strategy": []}, ValueError,
             "design space is empty")):
        with pytest.raises(exc, match=match):
            tual.explore(program, space)
        with pytest.raises(exc, match=match):
            rual.explore(rual.Program.from_kernel("gemm"), space)


def test_space_targets_match():
    from repro.ual.explore import space_targets as ref_space_targets
    space = {"fabric": ["hycube", ("n2n", dict(rows=4, cols=4))],
             "strategy": "sa", "backend": "interp", "seed": [0, 1]}
    got = space_targets(space)
    want = ref_space_targets(space)
    assert [(t.strategy, t.backend, t.digest, k) for t, k in got] == \
        [(t.strategy, t.backend, t.digest, k) for t, k in want]
