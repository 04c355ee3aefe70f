"""The port's fault plans and circuit breaker against the reference's.

  * a ``FaultPlan`` serialised by either package loads in the other, and
    each package arms only from its own environment variable,
  * the injector fires on the same events as the reference's for the same
    plan and event sequence,
  * ``CircuitBreaker`` walked through the same events at the same clock
    values reaches the same states and stats in both packages (the
    reference's ``pallas`` standing where the port's ``cuda`` stands),
  * the live service on the ``torch`` backend degrades three injected
    sweep failures to the bit-exact ``sim`` backend, trips once, fails the
    first half-open probe and restores on the second, like the
    reference's on ``pallas``; ``sim`` itself has no fallback and
    surfaces the error,
  * ``delay_dispatch`` stalls a micro-batch's emission,
  * a corrupted entry of the port's cache reads as a miss, is
    quarantined and recompiled; the reference's entries in a shared
    directory are never touched.

The ``cuda``-marked case needs a card and skips without one.
"""
import time

import numpy as np
import pytest
import torch

from repro import ual as rual
from repro.core.dfg import interpret
from repro.ual import faults as rfaults
from repro.ual.service.breaker import CircuitBreaker as RefBreaker
from repro_torch import ual as tual
from repro_torch.ual import faults
from repro_torch.ual.service.breaker import CircuitBreaker

TIMEOUT = 120


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    """Every test starts and ends with fault injection inactive in both
    packages."""
    faults.clear()
    rfaults.clear()
    yield
    faults.clear()
    rfaults.clear()


@pytest.fixture(scope="module", autouse=True)
def port_cache(tmp_path_factory):
    cache = tual.MappingCache(disk_dir=tmp_path_factory.mktemp("port_cache"))
    prev = tual.set_default_cache(cache)
    yield cache
    tual.set_default_cache(prev)


def _program():
    return tual.Program.from_kernel("gemm", bank_words=64)


def _target(backend):
    return tual.Target.from_name("hycube", rows=4, cols=4, backend=backend)


def _oracle(program, mem):
    return interpret(rual.Program.from_kernel("gemm", bank_words=64).dfg,
                     mem, program.n_iters)


PLAN_SPECS = [("kill_worker", {"worker": 1, "after": 6}),
              ("exec_fault", {"backend": "cuda", "after": 2, "count": 3}),
              ("delay_dispatch", {"delay_ms": 25.0}),
              ("corrupt_cache", {"path": "/nonexistent", "after": 1})]


# ---------------------------------------------------------------------------
# plans across the two packages
# ---------------------------------------------------------------------------

def test_fault_plan_json_loads_across_packages():
    plan = tual.FaultPlan([tual.FaultSpec(k, **kw) for k, kw in PLAN_SPECS],
                          seed=7)
    rplan = rual.FaultPlan([rual.FaultSpec(k, **kw) for k, kw in PLAN_SPECS],
                           seed=7)
    assert plan.to_json() == rplan.to_json()
    assert tual.FaultPlan.from_json(rplan.to_json()) == plan
    assert rual.FaultPlan.from_json(plan.to_json()) == rplan
    assert tual.FaultPlan.from_json(plan.to_json()) == plan


def test_each_package_arms_from_its_own_variable(monkeypatch):
    plan = tual.FaultPlan([tual.FaultSpec("exec_fault", backend="cuda")])
    env = plan.to_env()
    assert set(env) == {"REPRO_TORCH_UAL_FAULTS"} == {faults.FAULTS_ENV}
    assert tual.FaultPlan.from_env(env) == plan
    assert tual.FaultPlan.from_env({}) is None
    # the reference's variable never arms the port, nor the port's it
    assert tual.FaultPlan.from_env({rfaults.FAULTS_ENV: plan.to_json()}) \
        is None
    assert rual.FaultPlan.from_env(env) is None
    # the lazy in-process activation path (what a spawned worker does)
    monkeypatch.setenv(rfaults.FAULTS_ENV, plan.to_json())
    faults._env_checked = False
    assert faults.active() is None
    monkeypatch.setenv(faults.FAULTS_ENV, plan.to_json())
    faults._env_checked = False
    inj = faults.active()
    assert inj is not None and inj.plan == plan


@pytest.mark.parametrize("kind,kw", [("meteor_strike", {}),
                                     ("exec_fault", {"after": -1}),
                                     ("exec_fault", {"count": 0})])
def test_fault_spec_validation_matches(kind, kw):
    for mod in (tual, rual):
        with pytest.raises(ValueError):
            mod.FaultSpec(kind, **kw)


def _fire_sequence(mod, faults_mod, backend):
    """Drive one plan through a fixed event sequence; returns what fired
    at each event and the injector's log."""
    plan = mod.FaultPlan([
        mod.FaultSpec("exec_fault", backend=backend, after=2, count=2),
        mod.FaultSpec("exec_fault", after=4, count=1),
        mod.FaultSpec("delay_dispatch", delay_ms=40.0, after=1, count=2),
    ])
    inj = faults_mod.FaultInjector(plan)
    seen = []
    for be in ["sim", backend, backend, "sim", backend, backend, backend,
               "sim", backend]:
        try:
            inj.check_exec(be)
            seen.append("pass")
        except mod.InjectedFault as exc:
            seen.append(str(exc).replace(backend, "<primary>"))
    seen += [inj.dispatch_delay() for _ in range(4)]
    return seen, inj.log


def test_injector_fires_like_the_reference():
    got = _fire_sequence(tual, faults, "cuda")
    assert got == _fire_sequence(rual, rfaults, "pallas")
    seen, log = got
    # the backend spec fires on its 3rd and 4th matching events; the
    # unfiltered one counts events the first did not fail, firing on its 5th
    assert [s == "pass" for s in seen[:9]] == \
        [True] * 4 + [False] * 3 + [True] * 2
    assert seen[9:] == [0.0, pytest.approx(0.04), pytest.approx(0.04), 0.0]
    assert [e["kind"] for e in log] == ["exec_fault"] * 3 + \
        ["delay_dispatch"] * 2


# ---------------------------------------------------------------------------
# the breaker, one script in both packages
# ---------------------------------------------------------------------------

def _breaker_script(cls, primary):
    brk = cls(threshold=2, cooldown_s=10.0)
    key = ("p", "t", primary, 8)
    other = ("q", "t", primary, 8)
    steps = [
        ("plan", key, 0.0), ("fail", key, 0.0), ("plan", key, 0.5),
        ("fail", key, 1.0), ("plan", key, 2.0), ("degraded", key),
        ("plan", other, 2.0), ("succ", other), ("plan", key, 12.0),
        ("plan", key, 12.0), ("fail_probe", key, 12.5), ("plan", key, 20.0),
        ("plan", key, 23.0), ("succ_probe", key), ("plan", key, 23.5),
        ("fail", other, 30.0), ("fail", other, 30.0), ("plan", other, 39.9),
        ("plan", other, 40.0), ("succ_probe", other),
    ]
    seen = [brk.fallback_for(primary), brk.fallback_for("interp")]
    for op, k, *now in steps:
        if op == "plan":
            seen.append(brk.plan(k, primary, now=now[0]))
        elif op == "fail":
            seen.append(brk.record_failure(k, now=now[0]))
        elif op == "fail_probe":
            seen.append(brk.record_failure(k, now=now[0], probe=True))
        elif op == "succ":
            seen.append(brk.record_success(k))
        elif op == "succ_probe":
            seen.append(brk.record_success(k, probe=True))
        else:
            brk.record_degraded(k)
        seen.append(brk.state_of(k))
    stats = brk.stats()
    stats.pop("fallbacks")
    stats["classes"] = {tag.replace(primary, "<primary>"): c
                        for tag, c in stats["classes"].items()}
    return seen, stats


def test_breaker_walks_like_the_reference():
    got = _breaker_script(CircuitBreaker, "cuda")
    assert got == _breaker_script(RefBreaker, "pallas")
    seen, stats = got
    assert seen[:2] == ["sim", None]
    assert stats["trips_total"] == 2
    assert {c["restores"] for c in stats["classes"].values()} == {1}
    assert {c["state"] for c in stats["classes"].values()} == {"closed"}
    with pytest.raises(ValueError):
        CircuitBreaker(threshold=0)
    assert CircuitBreaker().fallbacks == {"cuda": "sim", "torch": "sim",
                                          "cuda_sharded": "sim",
                                          "torch_sharded": "sim"}


# ---------------------------------------------------------------------------
# the breaker in the live service
# ---------------------------------------------------------------------------

def _serve_one_at_a_time(mems, backend, cooldown, plan_backend):
    program, target = _program(), _target(backend)
    faults.install(tual.FaultPlan(
        [tual.FaultSpec("exec_fault", backend=plan_backend, count=3)]))
    infos = []
    with tual.Service(max_batch=4, max_wait_ms=5, breaker_threshold=2,
                      breaker_cooldown_s=cooldown) as svc:
        for i, mem in enumerate(mems):
            if i in (3, 4):
                time.sleep(cooldown + 0.1)      # let the class half-open
            resp = svc.submit(program, target, mem)
            out = resp.result(timeout=TIMEOUT)
            expect = _oracle(program, mem)
            for name in program.outputs:
                np.testing.assert_array_equal(out[name], expect[name])
            infos.append(dict(resp.info))
        stats = svc.stats()
    return infos, stats


def test_service_degrades_trips_and_restores_bit_exact():
    """Three injected torch sweep failures: the first two degrade in place
    (trip at threshold 2), the third fails the half-open probe; the next
    probe restores.  Every caller gets bit-exact outputs."""
    rng = np.random.default_rng(11)
    mems = [_program().random_inputs(rng) for _ in range(5)]
    infos, stats = _serve_one_at_a_time(mems, "torch", 0.4, "torch")
    assert [i.get("degraded_to") for i in infos] == \
        ["sim", "sim", "sim", "sim", None]
    brk = stats["breaker"]
    assert brk["trips_total"] == 1
    assert brk["degraded_batches_total"] == 4
    (cls,) = brk["classes"].values()
    assert cls["state"] == "closed" and cls["restores"] == 1
    assert stats["completed"] == 5 and stats["errors"] == 0


def test_service_without_fallback_surfaces_the_error():
    program, target = _program(), _target("sim")
    mem = program.random_inputs(np.random.default_rng(12))
    faults.install(tual.FaultPlan(
        [tual.FaultSpec("exec_fault", backend="sim", count=1)]))
    with tual.Service(max_batch=4, max_wait_ms=5, breaker_threshold=2) as svc:
        resp = svc.submit(program, target, mem)
        with pytest.raises(tual.InjectedFault):
            resp.result(timeout=TIMEOUT)
        out = svc.submit(program, target, mem).result(timeout=TIMEOUT)
        stats = svc.stats()
    expect = _oracle(program, mem)
    for name in program.outputs:
        np.testing.assert_array_equal(out[name], expect[name])
    assert stats["errors"] == 1
    assert stats["breaker"]["degraded_batches_total"] == 0


def test_delay_dispatch_stalls_emission():
    program, target = _program(), _target("torch")
    mem = program.random_inputs(np.random.default_rng(13))
    with tual.Service(max_batch=4, max_wait_ms=5) as svc:
        svc.submit(program, target, mem).result(timeout=TIMEOUT)
        faults.install(tual.FaultPlan(
            [tual.FaultSpec("delay_dispatch", delay_ms=200.0, count=1)]))
        t0 = time.perf_counter()
        svc.submit(program, target, mem).result(timeout=TIMEOUT)
        stalled = time.perf_counter() - t0
    assert stalled >= 0.2, f"dispatch delay not applied ({stalled:.3f}s)"


# ---------------------------------------------------------------------------
# corrupted cache entries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["truncate", "flip"])
def test_corrupt_cache_entry_quarantined_and_recompiled(tmp_path, mode):
    program, target = _program(), _target("torch")
    tual.compile(program, target, cache=tual.MappingCache(disk_dir=tmp_path))
    # a reference entry in the same directory is never the one poisoned
    rual.compile(rual.Program.from_kernel("gemm", bank_words=64),
                 rual.Target.from_name("hycube", rows=4, cols=4),
                 cache=rual.MappingCache(disk_dir=tmp_path))
    ref_entries = {p: p.read_bytes() for p in tmp_path.glob("*.pkl")
                   if not p.name.startswith("torch_")}
    assert ref_entries
    path = faults.corrupt_cache_entry(tmp_path, which="mapping", mode=mode)
    assert path is not None and path.name.startswith("torch_")
    assert {p: p.read_bytes() for p in ref_entries} == ref_entries
    cache = tual.MappingCache(disk_dir=tmp_path)
    exe = tual.compile(program, target, cache=cache)
    rec = {p.name: p.stats for p in exe.compile_info.passes}
    assert rec["mapping"].get("cache") == "miss"
    assert cache.stats.quarantined == 1
    assert cache.stats()["quarantined"] == 1
    assert [p.name for p in tmp_path.glob("*.pkl.corrupt")] == \
        [path.name + ".corrupt"]
    mem = program.random_inputs(np.random.default_rng(14))
    out = exe.run(**mem)
    expect = _oracle(program, mem)
    for name in program.outputs:
        np.testing.assert_array_equal(out[name], expect[name])


def test_corrupt_lowered_entry_is_also_quarantined(tmp_path):
    program, target = _program(), _target("torch")
    tual.compile(program, target, cache=tual.MappingCache(disk_dir=tmp_path))
    assert faults.corrupt_cache_entry(tmp_path, which="lowered",
                                      mode="flip") is not None
    cache = tual.MappingCache(disk_dir=tmp_path)
    exe = tual.compile(program, target, cache=cache)
    rec = {p.name: p.stats for p in exe.compile_info.passes}
    assert rec["mapping"].get("cache") == "hit"
    assert cache.stats.quarantined == 1
    assert list(tmp_path.glob("*_low.pkl.corrupt"))


def test_corrupt_cache_entry_finds_nothing_in_an_empty_layer(tmp_path):
    assert faults.corrupt_cache_entry(tmp_path / "missing") is None
    assert faults.corrupt_cache_entry(tmp_path, which="lowered") is None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_breaker_on_cuda_degrades_and_restores_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cgra_exec kernel has no CPU mode")
    from repro_torch.kernels.cgra_exec import ops
    rng = np.random.default_rng(15)
    mems = [_program().random_inputs(rng) for _ in range(5)]
    before = ops.launches()
    infos, stats = _serve_one_at_a_time(mems, "cuda", 0.8, "cuda")
    assert [i.get("degraded_to") for i in infos] == \
        ["sim", "sim", "sim", "sim", None]
    assert stats["breaker"]["trips_total"] == 1
    assert ops.launches() > before
