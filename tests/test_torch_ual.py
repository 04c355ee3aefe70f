"""The port's unified abstraction layer end to end, against the reference.

  * ``compile`` -> ``run_batch`` on the ``torch`` backend (the kernel's
    plain version on the CPU) equals the reference's ``pallas`` backend
    (Pallas in interpret mode) on the same mapping, for ragged batch sizes
    and several trip counts — the mapping is the reference's, carried
    across as plain data and seeded into the port's cache under the same
    ``(program.digest, target.digest)`` key,
  * the engine specialises at most one shape per bucket of its ladder,
    also on a ladder that reaches above 128 lanes (the ``cuda`` backend's
    reaches 4096), bit-exact against the ``sim`` backend across its
    bucket edges; each backend's lanes and ladder,
  * a warm compile is a cache hit with zero mapper restarts,
  * the two packages' caches never read each other's entries,
  * the ``cuda`` backend, the default, raises where there is no CUDA device
    and never falls back to the CPU.
"""
import numpy as np
import pytest
import torch

from repro import ual as rual
from repro.core.lowering import lowered_fingerprint as ref_lowered_fp
from repro.ual import cache as ref_cache_mod
from repro_torch import interop
from repro_torch import ual as tual
from repro_torch.core.lowering import lowered_fingerprint
from repro_torch.kernels.cgra_exec import ops
from repro_torch.core.simulator import simulate_batch
from repro_torch.ual import cache as port_cache_mod
from repro_torch.ual.engine import bucket_ladder


@pytest.fixture(autouse=True)
def port_cache(tmp_path):
    """The port's mapping cache in a tmp dir, as the process default."""
    cache = tual.MappingCache(disk_dir=tmp_path / "port_cache")
    prev = tual.set_default_cache(cache)
    yield cache
    tual.set_default_cache(prev)


@pytest.fixture
def engine():
    """A fresh engine cache as the port's process default."""
    fresh = tual.CompiledKernelCache()
    prev = tual.set_default_engine(fresh)
    yield fresh
    tual.set_default_engine(prev)


def _on_reference_mapping(kname, cache):
    """The reference's executable (``pallas`` backend) and the port's
    executable (``torch`` backend) of the same mapping."""
    rprog = rual.Program.from_kernel(kname)
    rexe = rual.compile(rprog, rual.Target.from_name(
        "hycube", rows=4, cols=4, backend="pallas"))
    tprog = tual.Program.from_kernel(kname)
    target = tual.Target.from_name("hycube", rows=4, cols=4, backend="torch")
    key = (tprog.digest, target.digest)
    assert key == (rprog.digest, rexe.target.digest)
    cache.put(key, interop.map_result(interop.map_state(rexe.map_result)))
    texe = tual.compile(tprog, target)
    assert texe.compile_info.cache_hit
    assert texe.compile_info.mapper_restarts == 0
    assert lowered_fingerprint(texe.lowered) == ref_lowered_fp(rexe.lowered)
    return rexe, texe


def _assert_same(outs, refs):
    assert len(outs) == len(refs)
    for got, want in zip(outs, refs):
        assert sorted(got) == sorted(want)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name])


@pytest.mark.parametrize("B", [1, 7, 9, 33, 129])
def test_run_batch_matches_reference_pallas(B, port_cache, engine):
    rexe, texe = _on_reference_mapping("gemm", port_cache)
    rng = np.random.default_rng(B)
    mems = [texe.program.random_inputs(rng) for _ in range(B)]
    want = rexe.run_batch(mems)
    _assert_same(texe.run_batch(mems), want)
    info = texe.last_info
    assert info["batched"] and info["batch"] == B
    assert sum(info["buckets"]) - info["padded"] == B
    _assert_same(texe.run_batch(mems, stream=True, chunk=8), want)


@pytest.mark.parametrize("n_iters", [1, 3, 9])
def test_trip_counts_match_reference_pallas(n_iters, port_cache, engine):
    rexe, texe = _on_reference_mapping("nw", port_cache)
    rng = np.random.default_rng(n_iters)
    mems = [texe.program.random_inputs(rng) for _ in range(9)]
    _assert_same(texe.run_batch(mems, n_iters),
                 rexe.run_batch(mems, n_iters))
    one = texe.run(mems[0], n_iters)
    _assert_same([one], [rexe.run(mems[0], n_iters)])


def test_engine_specialises_at_most_one_shape_per_bucket(port_cache, engine):
    program = tual.Program.from_kernel("gemm")
    exe = tual.compile(program, tual.Target.from_name(
        "hycube", rows=4, cols=4, backend="torch"))
    rng = np.random.default_rng(0)
    for B in (1, 2, 7, 8, 9, 31, 33, 129):
        exe.run_batch([program.random_inputs(rng) for _ in range(B)],
                      n_iters=1 + B % 5)
    stats = engine.engine_for(exe.lowered, device="cpu").stats()
    assert stats["buckets"] == (1, 8, 32, 128)
    assert stats["traces"] == len(stats["warm_shapes"]) <= 4
    warm = exe.warmup()
    assert warm["traces"] == 4 and exe.last_info["warmed"]
    exe.run_batch([program.random_inputs(rng) for _ in range(20)])
    assert exe.last_info["traced"] == 0
    assert engine.stats()["traces"] == 4
    assert engine.stats()["engines"] == 1


def test_ladder_above_128_lanes_is_bitexact_with_sim(port_cache):
    """A CPU engine whose ladder reaches above 128 (lanes = 256) pads and
    chunks batches across every bucket edge, bit-exact against the
    vectorized simulator, with at most one trace per bucket."""
    cache = tual.CompiledKernelCache()
    program = tual.Program.from_kernel("gemm")
    exe = tual.compile(program, tual.Target.from_name(
        "hycube", rows=4, cols=4, backend="torch"))
    rng = np.random.default_rng(11)
    used = []
    for B in (1, 127, 129, 255, 256, 257, 600):
        flats = program.flatten_batch([program.random_inputs(rng)
                                       for _ in range(B)])
        out, info = cache.run(exe.lowered, flats, program.n_iters,
                              lanes=256, device="cpu")
        want, _ = simulate_batch(exe.lowered, flats, program.n_iters)
        np.testing.assert_array_equal(out, want)
        assert sum(info["buckets"]) - info["padded"] == B
        used += info["buckets"]
    stats = cache.engine_for(exe.lowered, lanes=256, device="cpu").stats()
    assert stats["buckets"] == (1, 8, 32, 128, 256)
    assert used == [1, 128, 256, 256, 256, 256, 1, 256, 256, 128]
    assert stats["traces"] == len(stats["warm_shapes"]) == 3
    assert stats["bucket_calls"] == {1: 2, 128: 2, 256: 6}


def test_backend_lanes_and_ladders():
    """The ``cuda`` backend launches a run_batch of 4096 at once, on a
    ladder that pads a batch to at most 4x its size; the CPU engine keeps
    the reference's ladder.  Both read without a card."""
    cuda, cpu = tual.get_backend("cuda"), tual.get_backend("torch")
    assert (cuda.lanes, cuda.device) == (4096, "cuda")
    assert bucket_ladder(cuda.lanes) == (1, 8, 32, 128, 512, 2048, 4096)
    assert (cpu.lanes, cpu.device) == (128, "cpu")
    assert bucket_ladder(cpu.lanes) == (1, 8, 32, 128)
    ladder = bucket_ladder(cuda.lanes)
    assert all(min(x for x in ladder if x >= b) <= 4 * b
               for b in range(1, cuda.lanes + 1))
    assert bucket_ladder(256) == (1, 8, 32, 128, 256)
    assert bucket_ladder(16) == (1, 8, 16)
    assert bucket_ladder(4096, (1, 64, 9000)) == (1, 64)


def test_warm_compile_is_a_cache_hit(tmp_path):
    cache = tual.MappingCache(disk_dir=tmp_path / "c")
    program = tual.Program.from_kernel("nw")
    target = tual.Target.from_name("hycube", rows=4, cols=4)
    cold = tual.compile(program, target, cache=cache)
    assert cold.success and not cold.compile_info.cache_hit
    assert cold.compile_info.mapper_restarts >= 1
    warm = tual.compile(program, target.with_backend("torch"), cache=cache)
    assert warm.compile_info.cache_hit
    assert warm.compile_info.mapper_restarts == 0
    assert warm.II == cold.II
    cache.clear_memory()
    disk = tual.compile(program, target, cache=cache)
    assert disk.compile_info.cache_hit and cache.stats.disk_hits == 1
    assert disk.compile_info.mapper_restarts == 0
    assert lowered_fingerprint(disk.lowered) == \
        lowered_fingerprint(cold.lowered)


def test_caches_never_read_each_other(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_UAL_CACHE", raising=False)
    monkeypatch.delenv("REPRO_TORCH_UAL_CACHE", raising=False)
    assert tual.default_cache_dir() != rual.default_cache_dir()
    assert tual.default_cache_dir().parts[-2:] == ("repro_torch",
                                                   "ual_cache")
    monkeypatch.setenv("REPRO_UAL_CACHE", str(tmp_path / "ref_only"))
    assert tual.default_cache_dir() != tmp_path / "ref_only"
    monkeypatch.setenv("REPRO_TORCH_UAL_CACHE", str(tmp_path / "port_only"))
    assert tual.default_cache_dir() == tmp_path / "port_only"
    assert rual.default_cache_dir() == tmp_path / "ref_only"

    # one directory shared by both: each misses on the other's entries
    shared = tmp_path / "shared"
    ref_cache = rual.MappingCache(disk_dir=shared)
    rual.compile(rual.Program.from_kernel("gemm"),
                 rual.Target.from_name("hycube", rows=4, cols=4),
                 cache=ref_cache)
    ref_files = {p.name for p in shared.glob("*.pkl")}
    port_cache = tual.MappingCache(disk_dir=shared)
    exe = tual.compile(tual.Program.from_kernel("gemm"),
                       tual.Target.from_name("hycube", rows=4, cols=4),
                       cache=port_cache)
    assert not exe.compile_info.cache_hit
    port_files = {p.name for p in shared.glob("*.pkl")} - ref_files
    assert port_files and all(n.startswith("torch_") for n in port_files)
    assert not any(n.startswith("torch_") for n in ref_files)
    for name in ref_files:
        with pytest.raises(ValueError, match="header"):
            port_cache_mod._unpack_entry((shared / name).read_bytes())
    for name in port_files:
        with pytest.raises(ValueError, match="header"):
            ref_cache_mod._unpack_entry((shared / name).read_bytes())
    again = rual.MappingCache(disk_dir=shared)
    assert rual.compile(rual.Program.from_kernel("gemm"),
                        rual.Target.from_name("hycube", rows=4, cols=4),
                        cache=again).compile_info.cache_hit
    assert again.stats.quarantined == port_cache.stats.quarantined == 0
    assert port_cache.stats()["mapping"]["disk_entries"] == 1


def test_cuda_backend_without_a_card_raises(monkeypatch, port_cache, engine):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tual.list_backends() == ["cuda", "cuda_sharded", "interp", "sim",
                                    "torch", "torch_sharded"]
    program = tual.Program.from_kernel("gemm")
    target = tual.Target.from_name("hycube", rows=4, cols=4)
    assert target.backend == "cuda"
    exe = tual.compile(program, target)
    mems = [program.random_inputs(np.random.default_rng(0))]
    before = ops.launches()
    with pytest.raises(RuntimeError, match="sees none"):
        exe.run_batch(mems)
    with pytest.raises(RuntimeError, match="sees none"):
        exe.validate(backends=("sim", "cuda"))
    with pytest.raises(RuntimeError, match="sees no"):
        exe.run_batch(mems, backend="cuda_sharded")
    with pytest.raises(RuntimeError, match="sees none"):
        ops.cgra_exec_op(exe.map_result.config, program.flatten(mems[0])[None],
                         program.n_iters)
    assert ops.launches() == before
    assert len(engine) == 0                 # nothing fell back to the CPU
    assert exe.validate(backends=("sim", "torch")).passed
