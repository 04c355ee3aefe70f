"""The port's cluster layer against the reference's: sharding and processes.

Counterparts of ``tests/test_cluster.py:189-525`` (its first part, the
router and the replicated service, is ``tests/test_torch_service.py``):

  * the sharded engine (``torch_sharded``, the CPU twin of ``cuda_sharded``)
    over 3 CPU devices is bit-exact to the reference's interp oracle, its
    ``sim`` backend and the port's single-device ``torch`` engine on ragged
    batches, with the reference's block plan (``n_devices x
    bucket_for(ceil(chunk / n_devices))`` rows) and at most one trace a
    bucket; the same in a fresh process whose CPU mesh is set to 2 devices
    through ``forced_device_env``.  The reference's own sharded path fails
    on this jax, so it is held to these instead;
  * a cold class compiled by three processes against one disk cache maps
    once; ``_write_atomic`` and ``process_lock_key`` of the port's cache;
  * ``ClusterService`` on the port's ``torch`` backend: outputs bit-equal
    to the reference's ``Service`` on ``sim`` and to the oracle, the merged
    ``stats()`` with the reference's key sets, rejects after shutdown, a
    worker killed mid-batch with transparent retry, retry exhaustion giving
    a ``worker-died`` verdict, a respawned worker rejoining warm (no
    mapping stored, artifacts off the shared disk), shutdown during a
    respawn leaking nothing, one card per worker, a ``cuda`` class on a
    worker without a card answered with an error (never run on ``sim``),
    and a parent that never initialises CUDA.

Every blocking call has its own timeout; no assertion rests on thread
timing (the reference's ``mean_batch > 1`` is not copied).  Workers are
spawned and import torch, so each cluster takes a few seconds to start.
"""
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import ual as rual
from repro.core.dfg import interpret
from repro_torch import ual as tual
from repro_torch.launch import mesh
from repro_torch.ual.cluster.service import ClusterService

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 120


@pytest.fixture(scope="module", autouse=True)
def port_cache(tmp_path_factory):
    """The port's mapping cache in a tmp dir, as the process default."""
    cache = tual.MappingCache(disk_dir=tmp_path_factory.mktemp("port_cache"))
    prev = tual.set_default_cache(cache)
    yield cache
    tual.set_default_cache(prev)


def _program(mod=tual):
    return mod.Program.from_kernel("gemm", bank_words=64)


def _target(backend="torch", mod=tual):
    return mod.Target.from_name("hycube", rows=4, cols=4, backend=backend)


def _mems(n, seed):
    rng = np.random.default_rng(seed)
    program = _program(rual)
    return [program.random_inputs(rng) for _ in range(n)]


def _oracle(mem):
    program = _program(rual)
    return interpret(program.dfg, mem, program.n_iters)


def _assert_same(got, want):
    for g, w in zip(got, want, strict=True):
        for name in _program(rual).outputs:
            np.testing.assert_array_equal(g[name], w[name])


def _cluster(tmp_path, **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("max_wait_ms", 2)
    return ClusterService(cache_dir=str(tmp_path / "shared"),
                          start_timeout_s=TIMEOUT, **kw)


# ---------------------------------------------------------------------------
# the host mesh and the sharded engine
# ---------------------------------------------------------------------------

def test_host_mesh_forms(monkeypatch):
    # setenv first: the undo then restores the variable's absence, after
    # forced_host_devices below sets it
    monkeypatch.setenv(mesh.HOST_DEVICES_ENV, "1")
    monkeypatch.delenv(mesh.HOST_DEVICES_ENV)
    assert mesh.make_host_mesh("cpu") == [torch.device("cpu")]
    assert mesh.make_host_mesh("cpu", 3) == [torch.device("cpu")] * 3
    assert mesh.forced_host_devices(4) == 4
    assert len(mesh.make_host_mesh("cpu")) == 4
    env = mesh.forced_device_env(2, base={"A": "1"})
    assert env == {"A": "1", mesh.HOST_DEVICES_ENV: "2"}
    with pytest.raises(ValueError):
        mesh.forced_host_devices(0)
    with pytest.raises(ValueError):
        mesh.make_host_mesh("tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.make_host_mesh()
    assert not torch.cuda.is_initialized()


@pytest.mark.parametrize("B", [0, 1, 7, 129])
def test_sharded_parity_over_three_cpu_devices(monkeypatch, B):
    """torch_sharded over 3 CPU devices == interp == reference sim ==
    the port's single-device torch engine, on ragged batches."""
    monkeypatch.setenv(mesh.HOST_DEVICES_ENV, "3")
    mems = _mems(B, 3 + B)
    exe = tual.compile(_program(), _target())
    got = exe.run_batch(mems, backend="torch_sharded")
    info = dict(exe.last_info)
    ref_exe = rual.compile(_program(rual), _target("sim", rual))
    _assert_same(got, ref_exe.run_batch(mems))
    _assert_same(got, exe.run_batch(mems, backend="torch"))
    _assert_same(got, [_oracle(m) for m in mems])
    assert info["engine"] == "cgra_exec-cpu-sharded"
    assert info["n_devices"] == 3
    eng = tual.default_engine().sharded_engine_for(
        exe.lowered, lanes=128, mesh=mesh.make_host_mesh("cpu", 3))
    if B:
        assert info["buckets"] == [3 * eng.bucket_for(-(-B // 3))]
        assert info["padded"] == info["buckets"][0] - B
    else:
        assert info["buckets"] == []
    stats = eng.stats()
    assert stats["traces"] <= len(stats["buckets"])
    assert stats["n_devices"] == 3
    assert stats["device"] == "cpu,cpu,cpu"


def test_sharded_stream_and_chunks_past_capacity(monkeypatch):
    """A batch past the mesh's capacity (3 x 128) runs as several blocks;
    run_stream through the sharded engine stays bit-exact."""
    monkeypatch.setenv(mesh.HOST_DEVICES_ENV, "3")
    mems = _mems(400, 11)
    exe = tual.compile(_program(), _target())
    got = exe.run_batch(mems, backend="torch_sharded")
    assert exe.last_info["buckets"] == [384, 24]
    streamed = [o for chunk in exe.run_stream(mems, chunk=100,
                                              backend="torch_sharded")
                for o in chunk]
    assert exe.last_info["n_devices"] == 3
    want = exe.run_batch(mems, backend="sim")
    _assert_same(got, want)
    _assert_same(streamed, want)
    assert tual.get_backend("torch_sharded").supports_device is False
    assert tual.get_backend("cuda_sharded").supports_device is False


def test_sharded_parity_under_forced_two_devices():
    """A fresh process whose CPU mesh is 2 devices (forced_device_env)
    runs the sharded path bit-exact, the batch split over both."""
    code = (
        "import numpy as np\n"
        "from repro_torch import ual\n"
        "from repro_torch.core.dfg import interpret\n"
        "from repro_torch.launch.mesh import make_host_mesh\n"
        "assert len(make_host_mesh('cpu')) == 2\n"
        "program = ual.Program.from_kernel('gemm', bank_words=64)\n"
        "target = ual.Target.from_name('hycube', rows=4, cols=4,\n"
        "                              backend='torch')\n"
        "exe = ual.compile(program, target, cache=ual.MappingCache(\n"
        "    disk_dir=None))\n"
        "rng = np.random.default_rng(0)\n"
        "mems = [program.random_inputs(rng) for _ in range(5)]\n"
        "outs = exe.run_batch(mems, backend='torch_sharded')\n"
        "info = exe.last_info\n"
        "sims = exe.run_batch(mems, backend='sim')\n"
        "ok = all(np.array_equal(o[n], s[n]) and np.array_equal(\n"
        "    o[n], interpret(program.dfg, m, program.n_iters)[n])\n"
        "    for m, o, s in zip(mems, outs, sims) for n in program.outputs)\n"
        "print('DEVICES', info['n_devices'], 'BUCKETS', info['buckets'],\n"
        "      'PARITY', ok)\n"
    )
    env = mesh.forced_device_env(2)
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "DEVICES 2 BUCKETS [16] PARITY True" in out.stdout


# ---------------------------------------------------------------------------
# cross-process compile-once through the shared disk cache
# ---------------------------------------------------------------------------

def test_cold_compile_happens_once_across_processes(tmp_path):
    code = (
        "import sys\n"
        "from repro_torch import ual\n"
        "cache = ual.MappingCache(disk_dir=sys.argv[1])\n"
        "program = ual.Program.from_kernel('gemm')\n"
        "target = ual.Target.from_name('hycube', rows=4, cols=4)\n"
        "exe = ual.compile(program, target, cache=cache)\n"
        "rec = {p.name: p.stats for p in exe.compile_info.passes}\n"
        "print('MAPPING', rec['mapping'].get('cache'))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              env=env, cwd=str(ROOT))
             for _ in range(3)]
    outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    for p, (stdout, stderr) in zip(procs, outs):
        assert p.returncode == 0, stderr[-2000:]
    verdicts = [stdout.strip().split()[-1] for stdout, _ in outs]
    assert verdicts.count("miss") == 1, verdicts
    assert verdicts.count("hit") == 2, verdicts
    mapping_pkls = [f for f in tmp_path.glob("*.pkl")
                    if not f.name.endswith("_low.pkl")]
    assert len(mapping_pkls) == 1


def test_write_atomic_tolerates_concurrent_winner(tmp_path, monkeypatch):
    cache = tual.MappingCache(disk_dir=tmp_path)
    path = tmp_path / "entry.pkl"
    real_replace = os.replace

    def losing_replace(src, dst):
        real_replace(src, dst)      # "the other writer" wins first...
        raise OSError("simulated lost rename race")

    monkeypatch.setattr(os, "replace", losing_replace)
    cache._write_atomic(path, {"payload": 1})       # tolerated
    assert path.exists()
    assert not list(tmp_path.glob("*.tmp.*"))

    def failing_replace(src, dst):
        raise OSError("disk detached")

    gone = tmp_path / "never.pkl"
    monkeypatch.setattr(os, "replace", failing_replace)
    with pytest.raises(OSError):
        cache._write_atomic(gone, {"payload": 2})
    assert not gone.exists()
    assert not list(tmp_path.glob("*.tmp.*"))


def test_process_lock_key_is_reentrant_across_instances(tmp_path):
    a = tual.MappingCache(disk_dir=tmp_path)
    b = tual.MappingCache(disk_dir=tmp_path)
    key = ("p" * 24, "t" * 24)
    la, lb = a.process_lock_key(key), b.process_lock_key(key)
    assert la is not None and lb is not None
    assert Path(la._path) == Path(lb._path)
    with la:
        assert Path(la._path).exists()
    with lb:
        pass
    assert tual.MappingCache(disk_dir=None).process_lock_key(key) is None


# ---------------------------------------------------------------------------
# ClusterService end to end (spawned worker processes, torch backend)
# ---------------------------------------------------------------------------

def test_cluster_service_parity_and_merged_stats(tmp_path):
    mems = _mems(16, 4)
    with _cluster(tmp_path, workers=2, max_wait_ms=10) as cs:
        resps = [cs.submit(_program(), _target(), m) for m in mems]
        outs = [r.result(timeout=TIMEOUT) for r in resps]
        stats = cs.stats(timeout=TIMEOUT)
        procs = cs.worker_info()
    ref_svc = rual.Service(max_batch=8, max_wait_ms=10, start=False)
    try:
        futs = [ref_svc.submit(_program(rual), _target("sim", rual), m)
                for m in mems]
        ref_svc.start()
        want = [f.result(timeout=TIMEOUT) for f in futs]
        ref_snap = ref_svc.stats()
    finally:
        ref_svc.shutdown()
    _assert_same(outs, want)
    _assert_same(outs, [_oracle(m) for m in mems])
    assert all(r.info.get("worker") in (0, 1) for r in resps)
    assert all(r.info.get("retries") == 0 for r in resps)
    # the reference's merged schema, key for key
    ref_cs = rual.ClusterService(workers=2, start=False,
                                 cache_dir=str(tmp_path / "ref"))
    ref_stats = ref_cs.stats(timeout=1)
    assert sorted(stats) == sorted(ref_stats)
    for part in ("routing", "supervision"):
        assert sorted(stats[part]) == sorted(ref_stats[part]), part
    assert (sorted(stats["supervision"]["workers"][0])
            == sorted(ref_stats["supervision"]["workers"][0]))
    assert sorted(stats["per_worker"]) == [0, 1]
    for snap in stats["per_worker"].values():
        assert sorted(snap) == sorted(ref_snap)
    assert stats["cluster"] is True and stats["workers"] == 2
    assert stats["completed"] == 16 and stats["rejected"] == 0
    assert stats["errors"] == 0
    assert stats["samples_per_s"] > 0 and stats["p99_ms"] is not None
    assert stats["latency_samples_merged"] == 16
    decisions = stats["routing"]["decisions"]
    assert set(decisions) == {"affinity", "least_loaded", "retry"}
    assert decisions["retry"] == 0 and sum(decisions.values()) == 16
    # one mapping cluster-wide, each worker on the plain version
    assert sum(s["cache"]["mapping"]["stores"]
               for s in stats["per_worker"].values()) == 1
    assert sorted(procs) == [0, 1]
    for info in procs.values():
        assert info["engines"] in ([], ["cgra_exec-cpu"])
        assert info["nvcc_builds"] == 0 and info["startup_s"] > 0
        assert info["device_max_reserved_bytes"] is None


def test_cluster_service_rejects_after_shutdown(tmp_path):
    cs = _cluster(tmp_path, workers=1, max_batch=4, max_wait_ms=5)
    cs.shutdown(timeout=TIMEOUT)
    resp = cs.submit(_program(), _target(), _mems(1, 5)[0])
    assert resp.rejected and resp.reason == "shutdown"


def test_cluster_pins_one_card_per_worker(tmp_path):
    """Worker i sees card i % n of the parent's visible cards, unless the
    caller's worker_env names the cards (checked on the config, without
    starting processes)."""
    cs = _cluster(tmp_path, workers=3, start=False)
    cs._cards = ["0", "1"]
    assert [cs._worker_cfg(i)["env"]["CUDA_VISIBLE_DEVICES"]
            for i in range(3)] == ["0", "1", "0"]
    mine = _cluster(tmp_path, workers=2, start=False,
                    worker_env={"CUDA_VISIBLE_DEVICES": "5"})
    mine._cards = ["0", "1"]
    assert [mine._worker_cfg(i)["env"]["CUDA_VISIBLE_DEVICES"]
            for i in range(2)] == ["5", "5"]
    none = _cluster(tmp_path, workers=2, start=False)
    none._cards = []
    assert "CUDA_VISIBLE_DEVICES" not in none._worker_cfg(1)["env"]


def test_cuda_class_without_a_card_errors_never_runs_sim(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a worker here sees a card")
    mem = _mems(1, 12)[0]
    with _cluster(tmp_path, workers=1) as cs:
        resp = cs.submit(_program(), _target("cuda"), mem)
        with pytest.raises(RuntimeError, match="sees none"):
            resp.result(timeout=TIMEOUT)
        ok = cs.submit(_program(), _target(), mem).result(timeout=TIMEOUT)
        stats = cs.stats(timeout=TIMEOUT)
    _assert_same([ok], [_oracle(mem)])
    assert stats["per_worker"][0]["breaker"]["degraded_batches_total"] == 0


class _SlowRegInbox:
    """A worker's inbox whose "reg" messages take 0.3 s to be put: a
    thread preempted between routing a new class and sending it."""

    def __init__(self, inbox):
        self._inbox = inbox

    def put(self, msg):
        if msg[0] == "reg":
            time.sleep(0.3)
        self._inbox.put(msg)

    def __getattr__(self, name):
        return getattr(self._inbox, name)


def test_a_class_is_registered_before_its_requests_arrive(tmp_path):
    """A second client routing the same new class to the same worker
    while the first is still sending the registration must not get its
    request there first (the worker would not know the class)."""
    mems = _mems(2, 13)
    with _cluster(tmp_path, workers=1) as cs:
        cs._inboxes[0] = _SlowRegInbox(cs._inboxes[0])
        futs = [None, None]

        def first():
            futs[0] = cs.submit(_program(), _target(), mems[0])

        t = threading.Thread(target=first)
        t.start()
        time.sleep(0.1)                 # the first is inside its "reg"
        futs[1] = cs.submit(_program(), _target(), mems[1])
        t.join(TIMEOUT)
        assert not t.is_alive()
        outs = [f.result(timeout=TIMEOUT) for f in futs]
        sup = cs.stats(timeout=TIMEOUT)["supervision"]
    _assert_same(outs, [_oracle(m) for m in mems])
    assert sup["deaths_total"] == 0 and sup["retries_total"] == 0


def test_a_worker_whose_loop_fails_is_healed_like_a_dead_one(tmp_path):
    """A worker whose message loop raises exits through its clean-up path
    (its last message is "stopped"): the cluster still counts a death,
    respawns it and keeps serving."""
    mem = _mems(1, 14)[0]
    with _cluster(tmp_path, workers=1, restart_policy=tual.RestartPolicy(
            max_restarts=1, backoff_base_s=0.1)) as cs:
        cs.submit(_program(), _target(), mem).result(timeout=TIMEOUT)
        cs._inboxes[0].put(("req", -1, ("no", "such", "class", 1), {}, 1,
                            "t", None))
        snap = _wait_respawn(cs, 0)
        out = cs.submit(_program(), _target(), mem).result(timeout=TIMEOUT)
    assert snap["deaths"] == 1 and snap["restarts"] == 1
    _assert_same([out], [_oracle(mem)])


def _wait_respawn(cs, widx, timeout=TIMEOUT):
    deadline = time.time() + timeout
    snap = None
    while time.time() < deadline:
        snap = cs.stats(timeout=30)["supervision"]["workers"][widx]
        if snap["restarts"] >= 1 and snap["alive"]:
            return snap
        time.sleep(0.2)
    raise AssertionError(f"worker {widx} never respawned: {snap}")


def test_cluster_kill_midbatch_transparent_retry(tmp_path):
    """Worker 0 hard-exits with requests in flight: every future still
    resolves bit-exact (orphans retry on worker 1) and worker 0 respawns."""
    mems = _mems(24, 7)
    plan = tual.FaultPlan([tual.FaultSpec("kill_worker", worker=0, after=3)])
    with _cluster(tmp_path, workers=2, worker_env=plan.to_env(),
                  restart_policy=tual.RestartPolicy(
                      max_restarts=2, backoff_base_s=0.1)) as cs:
        resps = [cs.submit(_program(), _target(), m) for m in mems]
        outs = [r.result(timeout=TIMEOUT) for r in resps]
        _assert_same(outs, [_oracle(m) for m in mems])
        assert any(r.info.get("retries", 0) >= 1 for r in resps)
        assert all(r.info.get("retries", 0) <= cs.max_retries
                   for r in resps)
        snap = _wait_respawn(cs, 0)
        stats = cs.stats(timeout=30)
    assert snap["deaths"] == 1 and snap["restarts"] == 1
    assert snap["last_recovery_s"] is not None
    sup = stats["supervision"]
    assert sup["restarts_total"] == 1 and sup["deaths_total"] == 1
    assert sup["retries_total"] == stats["routing"]["decisions"]["retry"] >= 1
    assert sup["policy"]["max_restarts"] == 2
    assert sup["watchdog_errors"] == 0


def test_cluster_retry_exhaustion_yields_worker_died_verdict(tmp_path):
    mem = _mems(1, 8)[0]
    plan = tual.FaultPlan([tual.FaultSpec("kill_worker", worker=0)])
    with _cluster(tmp_path, workers=1, max_batch=4,
                  worker_env=plan.to_env(), max_retries=0,
                  restart_policy=tual.RestartPolicy(max_restarts=0)) as cs:
        resp = cs.submit(_program(), _target(), mem)   # its arrival kills
        with pytest.raises(tual.ServiceRejected) as err:
            resp.result(timeout=TIMEOUT)
        assert err.value.reason == "worker-died"
        assert resp.info.get("retries") == 0
        deadline = time.time() + TIMEOUT
        while cs.stats(timeout=10)["supervision"]["workers"][0]["alive"]:
            assert time.time() < deadline, "death never detected"
            time.sleep(0.1)
        late = cs.submit(_program(), _target(), mem)
        assert late.rejected and late.reason == "worker-died"
        sup = cs.stats(timeout=10)["supervision"]
    assert sup["workers"][0]["exhausted"] is True
    assert sup["restarts_total"] == 0


def test_cluster_respawned_worker_rejoins_warm(tmp_path):
    """The respawned worker re-registers its classes and loads the
    artifacts off the shared disk: zero mapping or lowering stores."""
    mems = _mems(8, 9)
    plan = tual.FaultPlan([tual.FaultSpec("kill_worker", worker=0, after=2)])
    with _cluster(tmp_path, workers=2, max_batch=4,
                  worker_env=plan.to_env(),
                  restart_policy=tual.RestartPolicy(
                      max_restarts=1, backoff_base_s=0.1)) as cs:
        for r in [cs.submit(_program(), _target(), m) for m in mems]:
            r.result(timeout=TIMEOUT)
        _wait_respawn(cs, 0)
        # sequential requests go to the warm, least-loaded worker 0; stay
        # under the re-armed kill threshold (after=2)
        resps, outs = [], []
        for mem in mems[:2]:
            resps.append(cs.submit(_program(), _target(), mem))
            outs.append(resps[-1].result(timeout=TIMEOUT))
        stats = cs.stats(timeout=30)
        procs = cs.worker_info()
    _assert_same(outs, [_oracle(m) for m in mems[:2]])
    assert [r.info["worker"] for r in resps] == [0, 0]
    w0 = stats["per_worker"].get(0)
    assert w0 is not None, "respawned worker must answer stats"
    assert w0["cache"]["mapping"]["stores"] == 0
    assert w0["cache"]["lowered"]["stores"] == 0
    assert w0["cache"]["mapping"]["disk_hits"] >= 1
    assert procs[0]["nvcc_builds"] == 0


def test_cluster_shutdown_during_respawn_leaks_nothing(tmp_path):
    mem = _mems(1, 10)[0]
    plan = tual.FaultPlan([tual.FaultSpec("kill_worker", worker=0)])
    cs = _cluster(tmp_path, workers=1, max_batch=4,
                  worker_env=plan.to_env(),
                  restart_policy=tual.RestartPolicy(max_restarts=3,
                                                    backoff_base_s=0.05))
    resp = cs.submit(_program(), _target(), mem)       # kills the only worker
    deadline = time.time() + TIMEOUT
    while cs.stats(timeout=10)["supervision"]["workers"][0]["deaths"] < 1:
        assert time.time() < deadline, "death never detected"
        time.sleep(0.05)
    cs.shutdown(timeout=TIMEOUT)                       # races the respawn
    assert all(not p.is_alive() for p in cs._procs), "leaked worker"
    assert all(not t.is_alive() for t in cs._threads), "wedged thread"
    with pytest.raises(tual.ServiceRejected):
        resp.result(timeout=5)


def test_cluster_parent_never_initialises_cuda():
    """A parent that routes through a ClusterService (and counts the cards
    for its workers) never creates a CUDA context of its own."""
    code = (
        "import sys, tempfile\n"
        "import numpy as np, torch\n"
        "from repro_torch import ual\n"
        "def main():\n"
        "    program = ual.Program.from_kernel('gemm', bank_words=64)\n"
        "    target = ual.Target.from_name('hycube', rows=4, cols=4,\n"
        "                                  backend='torch')\n"
        "    mem = program.random_inputs(np.random.default_rng(0))\n"
        "    with ual.ClusterService(workers=1, max_wait_ms=2,\n"
        "            cache_dir=tempfile.mkdtemp()) as cs:\n"
        "        out = cs.submit(program, target, mem).result(timeout=120)\n"
        "        cs.stats(timeout=60)\n"
        "    assert out, out\n"
        "    print('CUDA_INITIALISED', torch.cuda.is_initialized())\n"
        "if __name__ == '__main__':\n"
        "    main()\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "CUDA_INITIALISED False" in out.stdout


def test_parent_exits_after_a_worker_dies_with_a_backlog():
    """Worker 0 dies with a backlog on its inbox (more requests than its
    pipe holds): every future still resolves, and the parent process then
    exits instead of waiting forever on the dead inbox's feeder thread.
    (On ``sim``: what is tested is the parent, not the engine.)"""
    code = (
        "import tempfile\n"
        "import numpy as np\n"
        "from repro_torch import ual\n"
        "def main():\n"
        "    program = ual.Program.from_kernel('gemm', bank_words=64)\n"
        "    target = ual.Target.from_name('hycube', rows=4, cols=4,\n"
        "                                  backend='sim')\n"
        "    rng = np.random.default_rng(0)\n"
        "    mems = [program.random_inputs(rng) for _ in range(300)]\n"
        "    plan = ual.FaultPlan([ual.FaultSpec('kill_worker', worker=0,\n"
        "                                        after=2)])\n"
        "    cs = ual.ClusterService(workers=2, max_batch=64, max_wait_ms=2,\n"
        "        cache_dir=tempfile.mkdtemp(), worker_env=plan.to_env(),\n"
        "        restart_policy=ual.RestartPolicy(max_restarts=0),\n"
        "        max_retries=2)\n"
        "    futs = [cs.submit(program, target, m) for m in mems]\n"
        "    outs = [f.result(timeout=120) for f in futs]\n"
        "    sup = cs.stats(timeout=60)['supervision']\n"
        "    print('RESOLVED', len(outs), 'DEATHS', sup['deaths_total'])\n"
        "if __name__ == '__main__':\n"
        "    main()\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "RESOLVED 300 DEATHS 1" in out.stdout
