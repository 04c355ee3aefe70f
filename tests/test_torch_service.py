"""The port's execution service against the reference's, on the same inputs.

The same seeded requests go through the reference's ``Service`` on its
``sim`` backend and the port's ``Service`` on its ``torch`` backend (the
``cgra_exec`` kernel's plain version on the CPU); outputs are compared bit
for bit with each other and with the DFG-interpreter oracle:

  * single and coalesced requests; per-class coalescing (program digest x
    target digest x backend x n_iters), with the two services reporting
    the same achieved batch sizes,
  * the ``stats()`` key sets, ``["engine"]``, ``["stream"]``,
    ``["breaker"]`` and the per-tenant rows included,
  * a cold tenant pays one mapping and one lowering under concurrent
    submits,
  * the ``queue-full``, ``deadline-exceeded`` and ``shutdown`` verdicts,
    letter for letter,
  * the coalescer and the replica router as pure units, driven through the
    same steps in both packages, and the replicated service's parity and
    early flush.

Every service here is built with ``start=False``, fed, then started, so the
coalescer sees the whole batch at once and the tests do not depend on
thread timing; every ``result()`` has a timeout.  The ``cuda``-marked case
needs a card and skips without one.
"""
import time

import numpy as np
import pytest
import torch

from repro import ual as rual
from repro.core.dfg import interpret
from repro.ual.cluster.replica import Router as RefRouter
from repro.ual.service.coalescer import Coalescer as RefCoalescer
from repro.ual.service.queue import Request as RefRequest
from repro_torch import ual as tual
from repro_torch.ual.cluster.replica import Router
from repro_torch.ual.service.coalescer import Coalescer
from repro_torch.ual.service.queue import Request

TIMEOUT = 120
#: (service module, backend) per package: the reference on sim, the port
#: on its CPU engine
SIDES = {"ref": (rual, "sim"), "port": (tual, "torch")}


@pytest.fixture(scope="module", autouse=True)
def port_cache(tmp_path_factory):
    """The port's mapping cache in a tmp dir, as the process default."""
    cache = tual.MappingCache(disk_dir=tmp_path_factory.mktemp("port_cache"))
    prev = tual.set_default_cache(cache)
    yield cache
    tual.set_default_cache(prev)


def _program(side, kname="gemm"):
    return SIDES[side][0].Program.from_kernel(kname, bank_words=64)


def _target(side, backend=None):
    mod, default = SIDES[side]
    return mod.Target.from_name("hycube", rows=4, cols=4,
                                backend=backend or default)


def _mems(kname, n, seed):
    rng = np.random.default_rng(seed)
    program = _program("ref", kname)
    return [program.random_inputs(rng) for _ in range(n)]


def _serve(side, requests, backend=None, **svc_kw):
    """Submit ``(kname, mem, submit kwargs)`` requests to a service built
    with ``start=False``, then start it; returns (futures, outputs,
    stats).  With a long ``max_wait_ms`` only size flushes cut batches,
    whatever the threads' timing."""
    svc = SIDES[side][0].Service(start=False, **svc_kw)
    target = _target(side, backend)
    try:
        futs = [svc.submit(_program(side, kname), target, mem, **kw)
                for kname, mem, kw in requests]
        svc.start()
        outs = [f.result(timeout=TIMEOUT) for f in futs]
        stats = svc.stats()
    finally:
        svc.shutdown()
    return futs, outs, stats


def _assert_same(got, want, names):
    for g, w in zip(got, want):
        for name in names:
            np.testing.assert_array_equal(g[name], w[name])


def _oracle(kname, mem, n_iters=None):
    program = _program("ref", kname)
    return interpret(program.dfg, mem,
                     program.n_iters if n_iters is None else n_iters)


# ---------------------------------------------------------------------------
# outputs and coalescing
# ---------------------------------------------------------------------------

def test_single_request_matches_reference_and_oracle():
    mem = _mems("gemm", 1, 0)[0]
    runs = {side: _serve(side, [("gemm", mem, {})], max_batch=8,
                         max_wait_ms=2) for side in SIDES}
    outputs = _program("ref").outputs
    _assert_same(runs["port"][1], runs["ref"][1], outputs)
    _assert_same(runs["port"][1], [_oracle("gemm", mem)], outputs)
    (resp,) = runs["port"][0]
    assert resp.done() and not resp.rejected
    assert resp.info["batch"] == 1 and resp.info["latency_ms"] > 0
    assert sorted(resp.info) == sorted(runs["ref"][0][0].info)


def test_many_requests_coalesce_and_stay_bitexact():
    mems = _mems("gemm", 24, 1)
    runs = {side: _serve(side, [("gemm", m, {}) for m in mems],
                         max_batch=8, max_wait_ms=60_000) for side in SIDES}
    outputs = _program("ref").outputs
    _assert_same(runs["port"][1], runs["ref"][1], outputs)
    _assert_same(runs["port"][1], [_oracle("gemm", m) for m in mems],
                 outputs)
    port, ref = runs["port"][2], runs["ref"][2]
    assert port["completed"] == ref["completed"] == 24
    assert port["mean_batch"] == ref["mean_batch"] == 8.0
    assert port["batches"] == ref["batches"] == 3
    assert port["samples_per_s"] > 0
    assert port["p50_ms"] is not None and port["p99_ms"] is not None


def test_stats_key_sets_match_the_reference():
    mem = _mems("gemm", 1, 2)[0]
    ref = _serve("ref", [("gemm", mem, {"tenant": "t"})])[2]
    port = _serve("port", [("gemm", mem, {"tenant": "t"})])[2]
    assert sorted(port) == sorted(ref)
    for part in ("engine", "stream", "breaker", "cache"):
        assert sorted(port[part]) == sorted(ref[part]), part
    assert sorted(port["tenants"]["t"]) == sorted(ref["tenants"]["t"])
    assert port["breaker"]["fallbacks"] == {
        "cuda": "sim", "torch": "sim", "cuda_sharded": "sim",
        "torch_sharded": "sim"}
    assert port["breaker"]["degraded_batches_total"] == 0
    assert port["engine"]["calls"] >= 1


def test_mixed_tenants_batch_within_their_class_only():
    """gemm and fft share the service but never one sweep; the two
    packages cut the same micro-batches."""
    mems = {k: _mems(k, 8, 3 + i) for i, k in enumerate(("gemm", "fft"))}
    requests = [(k, mems[k][i], {"tenant": f"{k}-app"})
                for i in range(8) for k in ("gemm", "fft")]
    runs = {side: _serve(side, requests, max_batch=4, max_wait_ms=60_000)
            for side in SIDES}
    for (kname, mem, _), got, want, resp in zip(
            requests, runs["port"][1], runs["ref"][1], runs["port"][0]):
        outputs = _program("ref", kname).outputs
        _assert_same([got], [want], outputs)
        _assert_same([got], [_oracle(kname, mem)], outputs)
        assert resp.info["batch"] == 4
    for side in SIDES:
        stats = runs[side][2]
        assert stats["tenants"]["gemm-app"]["completed"] == 8
        assert stats["tenants"]["fft-app"]["completed"] == 8
        assert stats["executables"] == 2    # one warm Executable per class
    assert [r.info["batch"] for r in runs["port"][0]] == \
        [r.info["batch"] for r in runs["ref"][0]]


def test_different_n_iters_never_share_a_sweep():
    m1, m2 = _mems("gemm", 2, 4)
    requests = [("gemm", m1, {}), ("gemm", m2, {"n_iters": 4})]
    runs = {side: _serve(side, requests, max_batch=8, max_wait_ms=20)
            for side in SIDES}
    outputs = _program("ref").outputs
    _assert_same(runs["port"][1], runs["ref"][1], outputs)
    _assert_same(runs["port"][1][1:], [_oracle("gemm", m2, 4)], outputs)
    assert [r.info["batch"] for r in runs["port"][0]] == [1, 1]


def test_cold_tenant_compiles_once_under_concurrent_submits(tmp_path):
    """A cold tenant's first requests on three worker threads: one mapper
    run and one lowering, counted by the port's cache."""
    cache = tual.MappingCache(disk_dir=tmp_path / "cold")
    mems = _mems("gemm", 12, 5)
    _futs, outs, _stats = _serve("port", [("gemm", m, {}) for m in mems],
                                 max_batch=1, max_wait_ms=1, workers=3,
                                 cache=cache)
    assert cache.stats.stores == 1
    assert cache.stats.lowered_stores == 1
    _assert_same(outs, [_oracle("gemm", m) for m in mems],
                 _program("ref").outputs)


# ---------------------------------------------------------------------------
# backpressure, deadlines, shutdown: the same verdicts in both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side", ["ref", "port"])
def test_overload_rejects_with_queue_full(side):
    mem = _mems("gemm", 1, 6)[0]
    svc = SIDES[side][0].Service(max_batch=8, max_queue=4, start=False)
    accepted = [svc.submit(_program(side), _target(side), mem)
                for _ in range(4)]
    overflow = [svc.submit(_program(side), _target(side), mem)
                for _ in range(3)]
    for resp in overflow:
        assert resp.done() and resp.rejected
        assert resp.reason == "queue-full"
        with pytest.raises(SIDES[side][0].ServiceRejected):
            resp.result()
    assert svc.stats()["queue_depth"] == 4
    svc.shutdown()
    assert [r.reason for r in accepted] == ["shutdown"] * 4
    stats = svc.stats()
    assert stats["rejects"] == {"queue-full": 3, "shutdown": 4}
    assert stats["queue_depth"] == 0


def test_port_rejects_like_the_reference():
    """Queue-full, deadline and shutdown verdicts, side by side."""
    mem = _mems("gemm", 1, 7)[0]
    verdicts = {}
    for side in SIDES:
        mod = SIDES[side][0]
        prog, tgt = _program(side), _target(side)
        svc = mod.Service(max_batch=8, max_wait_ms=1, max_queue=2,
                          start=False, deadlines_ms={"impatient": 1.0})
        late = svc.submit(prog, tgt, mem, tenant="impatient")
        kept = svc.submit(prog, tgt, mem)
        full = svc.submit(prog, tgt, mem)
        time.sleep(0.05)                    # let the deadline lapse
        svc.start()
        with pytest.raises(mod.ServiceRejected):
            late.result(timeout=TIMEOUT)
        kept.result(timeout=TIMEOUT)
        svc.shutdown()
        after = svc.submit(prog, tgt, mem)
        verdicts[side] = ([r.reason for r in (late, kept, full, after)],
                          svc.stats()["rejects"],
                          svc.stats()["tenants"]["impatient"])
    assert verdicts["port"] == verdicts["ref"]
    assert verdicts["port"][0] == ["deadline-exceeded", None, "queue-full",
                                   "shutdown"]


def test_malformed_arrays_raise_at_submit():
    with tual.Service(max_batch=4, max_wait_ms=1) as svc:
        with pytest.raises(KeyError, match="unknown array"):
            svc.submit(_program("port"), _target("port"),
                       not_an_array=np.zeros(4, np.int32))


def test_shutdown_flushes_partial_batches():
    mems = _mems("gemm", 3, 8)
    svc = tual.Service(max_batch=64, max_wait_ms=60_000)
    resps = [svc.submit(_program("port"), _target("port"), m) for m in mems]
    svc.shutdown()
    outs = [r.result(timeout=TIMEOUT) for r in resps]
    _assert_same(outs, [_oracle("gemm", m) for m in mems],
                 _program("ref").outputs)


def test_deadline_bounds_rejection_latency_not_max_wait():
    mem = _mems("gemm", 1, 9)[0]
    with tual.Service(max_batch=64, max_wait_ms=60_000) as svc:
        t0 = time.perf_counter()
        resp = svc.submit(_program("port"), _target("port"), mem,
                          deadline_ms=50)
        with pytest.raises(tual.ServiceRejected):
            resp.result(timeout=10)
        waited = time.perf_counter() - t0
    assert resp.reason == "deadline-exceeded"
    assert waited < 5


# ---------------------------------------------------------------------------
# coalescer and router units, the same steps in both packages
# ---------------------------------------------------------------------------

class _FakeReq:
    def __init__(self, key, t, deadline=None):
        self.key, self.t_submit, self.deadline = key, t, deadline


def _coalescer_script(cls):
    """One script over size, age, deadline and key separation; returns
    every observable it produced."""
    seen = []
    co = cls(max_batch=2, max_wait_s=1.0)
    seen.append(co.offer(_FakeReq("k1", 0.0)) is None)
    seen.append(len(co.offer(_FakeReq("k1", 0.1))))       # size flush
    co.offer(_FakeReq("k2", 10.0))
    seen += [co.pop_expired(10.5), co.next_deadline(10.5)]
    seen += [len(b) for b in co.pop_expired(11.0)]         # age flush
    seen.append(co.next_deadline(11.0))
    co = cls(max_batch=8, max_wait_s=1000.0)
    co.offer(_FakeReq("k", 0.0, deadline=2.0))
    seen += [co.next_deadline(0.0), co.pop_expired(1.9),
             [len(b) for b in co.pop_expired(2.0)]]        # member deadline
    co = cls(max_batch=3, max_wait_s=1.0)
    for key in ("a", "b", "a"):
        co.offer(_FakeReq(key, 0.0))
    seen += [co.pending(), sorted(len(b) for b in co.flush_all())]
    return seen


def test_coalescer_matches_the_reference():
    got = _coalescer_script(Coalescer)
    assert got == _coalescer_script(RefCoalescer)
    assert got[1] == 2 and got[3] == pytest.approx(0.5)
    assert got[-2:] == [3, [1, 2]]


@pytest.mark.parametrize("side", ["ref", "port"])
def test_coalescer_steal_oldest_honors_min_age(side):
    mod, req_cls, co_cls = ((rual, RefRequest, RefCoalescer) if side == "ref"
                            else (tual, Request, Coalescer))
    c = co_cls(max_batch=8, max_wait_s=1.0)
    r1 = req_cls(tenant="a", program=_program(side), target=_target(side),
                 mem={}, n_iters=4, t_submit=100.0)
    r2 = req_cls(tenant="b", program=_program(side), target=_target(side),
                 mem={}, n_iters=8, t_submit=100.5)
    c.offer(r1)
    c.offer(r2)
    assert c.steal_oldest(100.05, min_age_s=0.1) is None
    assert c.steal_oldest(100.2, min_age_s=0.1) == [r1]
    assert c.pending() == 1
    assert c.steal_oldest(100.55, min_age_s=0.1) is None
    assert c.steal_oldest(100.7, min_age_s=0.1) == [r2]


def _router_script(cls):
    seen = []
    r = cls(3)
    r.slots[0].in_flight = 2
    r.slots[1].in_flight = 1
    seen += [r.route("k", ["b0"]), r.route("k", ["b1"]) != 0,
             r.stats()["decisions"]]
    r = cls(3)
    r.slots[2].warm.add("classA")
    seen += [r.route("classA", ["b"]), r.stats()["decisions"],
             r.route("classB", ["b"]) != 2]
    r = cls(2)
    r.route("k", ["old"])
    r.route("k", ["new"])
    r.slots[0].queue.extend(r.slots[1].queue)
    r.slots[1].queue.clear()
    seen.append(r.pull(1, timeout=0.1))
    r.done(1, 1, 0.01)
    seen += [r.slots[1].steals, r.slots[1].samples, r.stats()["steals"]]
    r = cls(1)
    r.route("k", ["pending"])
    r.stop()
    seen.append(r.pull(0, timeout=1.0))
    r.done(0, 1, 0.0)
    seen.append(r.pull(0, timeout=1.0))
    seen.append(r.stats())
    for bad in ((0,), (3, [None, None])):
        with pytest.raises(ValueError):
            cls(*bad)
    return seen


def test_router_matches_the_reference():
    got = _router_script(Router)
    assert got == _router_script(RefRouter)
    assert got[0] == 2 and got[3] == 2
    assert got[6] == ("k", ["old"], True)            # stolen, FIFO
    assert got[-3] == ("k", ["pending"], False) and got[-2] is None


# ---------------------------------------------------------------------------
# the replicated service
# ---------------------------------------------------------------------------

def test_replicated_service_parity_and_router_stats():
    mems = _mems("gemm", 24, 10)
    requests = [("gemm", m, {}) for m in mems]
    runs = {side: _serve(side, requests, max_batch=8, max_wait_ms=30,
                         replicas=2) for side in SIDES}
    outputs = _program("ref").outputs
    _assert_same(runs["port"][1], runs["ref"][1], outputs)
    _assert_same(runs["port"][1], [_oracle("gemm", m) for m in mems],
                 outputs)
    router, ref_router = runs["port"][2]["router"], runs["ref"][2]["router"]
    assert sorted(router) == sorted(ref_router)
    assert router["replicas"] == 2 and len(router["slots"]) == 2
    assert sum(s["samples"] for s in router["slots"]) == 24
    assert sum(router["decisions"].values()) == \
        sum(s["batches"] for s in router["slots"])
    for slot, ref_slot in zip(router["slots"], ref_router["slots"]):
        assert sorted(slot) == sorted(ref_slot)


def test_replicated_service_pins_slots_to_devices():
    """``devices=`` pins each replica slot; the torch backend accepts the
    slot's device, so both slots run on the CPU engine."""
    mems = _mems("gemm", 6, 11)
    _futs, outs, stats = _serve(
        "port", [("gemm", m, {}) for m in mems], max_batch=2,
        max_wait_ms=30, devices=[torch.device("cpu")] * 2)
    _assert_same(outs, [_oracle("gemm", m) for m in mems],
                 _program("ref").outputs)
    assert [s["device"] for s in stats["router"]["slots"]] == ["cpu"] * 2
    assert tual.get_backend("torch").supports_device


def test_replicated_service_early_flush_when_replicas_idle():
    mem = _mems("gemm", 1, 12)[0]
    with tual.Service(max_batch=64, max_wait_ms=2000, replicas=2) as svc:
        t0 = time.perf_counter()
        svc.submit(_program("port"), _target("port"), mem).result(
            timeout=TIMEOUT)
        waited = time.perf_counter() - t0
        stats = svc.stats()
    assert waited < 1.5, "early flush should beat the 2s age limit"
    assert stats["router"]["early_flushes"] >= 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_service_on_cuda_matches_sim():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cgra_exec kernel has no CPU mode")
    from repro_torch.kernels.cgra_exec import ops
    mems = _mems("gemm", 40, 13)
    before = ops.launches()
    _futs, outs, stats = _serve("port", [("gemm", m, {}) for m in mems],
                                backend="cuda", max_batch=16, max_wait_ms=2)
    program = _program("port")
    exe = tual.compile(program, _target("port", "sim"))
    _assert_same(outs, exe.run_batch(mems), program.outputs)
    assert stats["breaker"]["degraded_batches_total"] == 0
    assert stats["errors"] == 0 and stats["completed"] == 40
    assert ops.launches() > before
