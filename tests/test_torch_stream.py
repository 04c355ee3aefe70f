"""The port's streaming engine and ``submit_stream`` against the reference.

  * streamed chunks on the ``torch`` backend are bit-exact vs the port's
    ``run_batch``, the reference's ``sim`` backend and the DFG-interpreter
    oracle — ragged final chunk, chunk == 1 and a batch beyond the ladder
    included,
  * the engine's stream summary has the reference engine's key set, and
    the engine counts ``streams``/``stream_chunks``,
  * a warm engine streams with zero new traces; cold streaming traffic
    specialises at most one shape per ladder bucket,
  * ``Service.submit_stream``'s contract (5 spans, 70 samples, 80
    completed) holds straight after the futures resolve — repeated 20
    times, because the reference resolves a span's last chunk before it
    counts the span (a race the port must not copy),
  * admission verdicts: queue-full all-or-nothing, after shutdown, and
    the empty stream,
  * a batch that is a bucket size is not padded; ``validate`` flattens
    its vectors once per multi-backend sweep.

The ``cuda``-marked cases need a card and skip without one.
"""
import numpy as np
import pytest
import torch

from repro import ual as rual
from repro.core.dfg import interpret
from repro.ual.engine import CompiledKernelCache as RefKernelCache
from repro_torch import ual as tual
from repro_torch.ual import engine as engine_mod

N_ITERS = 6
TIMEOUT = 120


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    """(port program, port torch executable, reference program, reference
    sim executable) of gemm on HyCUBE 4x4 at a 64-word bank."""
    cache = tual.MappingCache(disk_dir=tmp_path_factory.mktemp("port_cache"))
    prev = tual.set_default_cache(cache)
    program = tual.Program.from_kernel("gemm", bank_words=64)
    exe = tual.compile(program, tual.Target.from_name(
        "hycube", rows=4, cols=4, backend="torch"))
    rprogram = rual.Program.from_kernel("gemm", bank_words=64)
    rexe = rual.compile(rprogram, rual.Target.from_name(
        "hycube", rows=4, cols=4, backend="sim"))
    assert exe.success and rexe.success
    assert program.digest == rprogram.digest
    yield program, exe, rprogram, rexe
    tual.set_default_cache(prev)


def _mems(program, B, seed=0):
    rng = np.random.default_rng(seed)
    return [program.random_inputs(rng) for _ in range(B)]


def _drain(gen):
    """Consume a streaming generator; returns (chunks, summary)."""
    chunks = []
    while True:
        try:
            chunks.append(next(gen))
        except StopIteration as stop:
            return chunks, dict(stop.value or {})


def _assert_same(got, want, names):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for name in names:
            np.testing.assert_array_equal(g[name], w[name])


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,chunk", [(37, 8), (32, 32), (9, 1), (70, 32),
                                     (300, None)])
def test_stream_bitexact_vs_run_batch_reference_and_oracle(compiled, B,
                                                           chunk):
    program, exe, rprogram, rexe = compiled
    mems = _mems(program, B, seed=B)
    chunks, summary = _drain(exe.run_stream(mems, n_iters=N_ITERS,
                                            chunk=chunk))
    flat = [d for c in chunks for d in c]
    _assert_same(flat, exe.run_batch(mems, n_iters=N_ITERS),
                 program.outputs)
    _assert_same(flat, rexe.run_batch(mems, n_iters=N_ITERS),
                 program.outputs)
    _assert_same(flat, [interpret(rprogram.dfg, m, N_ITERS) for m in mems],
                 program.outputs)
    step = chunk or 128                 # the CPU engine's top bucket
    assert [len(c) for c in chunks] == \
        [min(step, B - i) for i in range(0, B, step)]
    assert summary["stream_chunks"] == len(chunks)
    assert summary["samples"] == B


def test_run_batch_stream_flag_collects_and_reports(compiled):
    program, exe, _rprogram, rexe = compiled
    mems = _mems(program, 20, seed=3)
    outs = exe.run_batch(mems, n_iters=N_ITERS, stream=True, chunk=8)
    _assert_same(outs, rexe.run_batch(mems, n_iters=N_ITERS),
                 program.outputs)
    info = exe.last_info
    assert info["stream"] is True and info["batch"] == 20
    assert info["stream_chunks"] == 3
    assert info["buckets"] == [8, 8, 8] and info["padded"] == 4
    # the CPU engine runs each chunk to its end: nothing overlaps
    assert info["overlap_frac"] == 0.0
    assert info["throughput_sps"] > 0


def test_stream_chunked_sync_fallback_on_sim(compiled):
    program, exe, _rprogram, rexe = compiled
    mems = _mems(program, 5, seed=4)
    chunks, summary = _drain(exe.run_stream(mems, n_iters=N_ITERS,
                                            backend="sim", chunk=2))
    _assert_same([d for c in chunks for d in c],
                 rexe.run_batch(mems, n_iters=N_ITERS), program.outputs)
    assert summary["streamed"] == "chunked-sync"
    assert summary["stream_chunks"] == 3
    assert summary["overlap_frac"] == 0.0


# ---------------------------------------------------------------------------
# trace economy
# ---------------------------------------------------------------------------

def test_warm_engine_streams_with_zero_new_traces(compiled):
    program, exe, _rprogram, _rexe = compiled
    eng = tual.CompiledKernelCache().engine_for(exe.lowered, device="cpu")
    eng.warmup(program.layout.total_words)
    before = eng.traces
    flats = program.flatten_batch(_mems(program, 37, seed=9))
    chunks, summary = _drain(eng.run_stream(flats, N_ITERS, chunk=8))
    assert eng.traces == before == len(eng.buckets)
    assert summary["traced"] == 0
    assert sum(len(out) for out, _ in chunks) == 37
    np.testing.assert_array_equal(np.concatenate([o for o, _ in chunks]),
                                  eng.run(flats, N_ITERS)[0])


def test_cold_stream_traces_bounded_by_ladder(compiled, monkeypatch):
    """Cold streaming traffic specialises at most once per ladder bucket —
    counted on the kernel wrapper's first launch of each shape."""
    program, exe, _rprogram, _rexe = compiled
    shapes = []
    real = engine_mod.ops.cgra_exec
    monkeypatch.setattr(engine_mod.ops, "cgra_exec",
                        lambda tables, memT, n, *a: shapes.append(
                            tuple(memT.shape)) or real(tables, memT, n, *a))
    cache = tual.CompiledKernelCache(buckets=(1, 8))
    flats = program.flatten_batch(_mems(program, 8, seed=10))
    for B, chunk in ((7, 8), (8, 4), (3, 1), (8, 8)):
        chunks, _ = _drain(cache.run_stream(exe.lowered, flats[:B], N_ITERS,
                                            chunk=chunk, device="cpu"))
        assert sum(len(out) for out, _ in chunks) == B
    eng = cache.engine_for(exe.lowered, device="cpu")
    assert len(set(shapes)) == eng.traces <= 2
    assert eng.streams == 4


# ---------------------------------------------------------------------------
# metrics schema
# ---------------------------------------------------------------------------

def test_stream_summary_schema_matches_the_reference_engine(compiled):
    program, exe, rprogram, _rexe = compiled
    rexe = rual.compile(rprogram, rual.Target.from_name(
        "hycube", rows=4, cols=4, backend="pallas"))
    flats = program.flatten_batch(_mems(program, 17, seed=12))
    cache = tual.CompiledKernelCache()
    eng = cache.engine_for(exe.lowered, device="cpu")
    chunks, summary = _drain(eng.run_stream(flats, N_ITERS, chunk=8))
    rchunks, rsummary = _drain(RefKernelCache().engine_for(
        rexe.lowered).run_stream(flats, N_ITERS, chunk=8))
    assert sorted(summary) == sorted(rsummary)
    for (out, cinfo), (rout, rinfo) in zip(chunks, rchunks):
        np.testing.assert_array_equal(out, rout)
        assert sorted(cinfo) == sorted(rinfo)
        assert {k: cinfo[k] for k in ("chunk", "bucket", "samples")} == \
            {k: rinfo[k] for k in ("chunk", "bucket", "samples")}
    for key in ("stream_chunks", "samples", "buckets", "padded"):
        assert summary[key] == rsummary[key], key
    assert summary["stream_chunks"] == 3 and summary["samples"] == 17
    assert 0.0 <= summary["overlap_frac"] <= 1.0
    assert summary["throughput_sps"] > 0
    stats = eng.stats()
    assert stats["streams"] == 1 and stats["stream_chunks"] == 3
    agg = cache.stats()
    assert agg["streams"] == 1 and agg["stream_chunks"] == 3


# ---------------------------------------------------------------------------
# service: submit_stream
# ---------------------------------------------------------------------------

def test_submit_stream_span_contract_holds_as_futures_resolve(compiled):
    """One bulk tenant's stream beside a discrete tenant's singles: both
    bit-exact, the stream cut into 5 spans, and ``stats()`` counting every
    span the moment the last future resolves — 20 times over.  A callback
    on each span's last future reads the counts on the resolving thread
    itself, at the instant of resolution: span k must already be counted
    there, whatever the threads' timing."""
    program, _exe, _rprogram, rexe = compiled
    target = tual.Target.from_name("hycube", rows=4, cols=4, backend="torch")
    mems = _mems(program, 70, seed=20)
    ref = rexe.run_batch(mems, n_iters=N_ITERS)
    for rep in range(20):
        svc = tual.Service(max_batch=16, max_wait_ms=2.0, max_queue=512,
                           start=False)
        try:
            d_futs = [svc.submit(program, target, m, tenant="discrete",
                                 n_iters=N_ITERS) for m in mems[:10]]
            sr = svc.submit_stream(program, target, mems, tenant="bulk",
                                   n_iters=N_ITERS, chunk=8, span=2)
            seen = []
            for last in (15, 31, 47, 63, 69):       # each span's last member
                sr.responses[last].add_done_callback(
                    lambda _r: seen.append((svc.stats()["stream"]["spans"],
                                            sr.info["spans"])))
            svc.start()
            got = []
            for chunk_outs in sr.chunks(timeout=TIMEOUT):
                assert len(chunk_outs) <= 8
                got.extend(chunk_outs)
            d_outs = [f.result(timeout=TIMEOUT) for f in d_futs]
            stats = svc.stats()
            info = sr.info
        finally:
            svc.shutdown()
        _assert_same(got, ref, program.outputs)
        _assert_same(d_outs, ref[:10], program.outputs)
        # 70 samples at chunk=8, span=2 -> ceil(70/16) = 5 spans
        assert stats["stream"]["spans"] == 5, rep
        assert stats["stream"]["samples"] == 70, rep
        assert stats["stream"]["chunks"] == 9, rep
        assert stats["completed"] == 80, rep
        assert info["spans"] == 5 and info["samples"] == 70, rep
        assert seen == [(k, k) for k in range(1, 6)], rep
        assert 0.0 <= info["overlap_frac"] <= 1.0
        assert sr.responses[0].info.get("stream") is True


@pytest.mark.parametrize("side", ["ref", "port"])
def test_submit_stream_queue_full_is_all_or_nothing(compiled, side):
    program, _exe, rprogram, _rexe = compiled
    mod, prog, backend = ((rual, rprogram, "sim") if side == "ref"
                          else (tual, program, "torch"))
    target = mod.Target.from_name("hycube", rows=4, cols=4, backend=backend)
    mems = _mems(program, 24, seed=21)
    svc = mod.Service(max_batch=8, max_queue=16, start=False)
    try:
        sr = svc.submit_stream(prog, target, mems, n_iters=N_ITERS)
        assert sr.rejected and sr.reason == "queue-full"
        assert [r.reason for r in sr.responses] == ["queue-full"] * 24
        ok = svc.submit_stream(prog, target, mems[:4], n_iters=N_ITERS)
        assert not ok.done()
    finally:
        svc.shutdown()
    assert [r.reason for r in ok.responses] == ["shutdown"] * 4
    assert svc.stats()["rejects"] == {"queue-full": 24, "shutdown": 4}


def test_submit_stream_after_shutdown_rejected(compiled):
    program, _exe, _rprogram, _rexe = compiled
    target = tual.Target.from_name("hycube", rows=4, cols=4, backend="torch")
    svc = tual.Service(max_batch=8)
    svc.shutdown()
    sr = svc.submit_stream(program, target, _mems(program, 3, seed=22),
                           n_iters=N_ITERS)
    assert sr.rejected and sr.reason == "shutdown"
    assert svc.stats()["stream"]["spans"] == 0


def test_submit_stream_empty_is_a_noop(compiled):
    program, _exe, _rprogram, _rexe = compiled
    target = tual.Target.from_name("hycube", rows=4, cols=4, backend="torch")
    with tual.Service(max_batch=8) as svc:
        sr = svc.submit_stream(program, target, [], n_iters=N_ITERS)
        assert len(sr) == 0 and sr.done() and not sr.rejected
        assert sr.results() == []


# ---------------------------------------------------------------------------
# padding and validate
# ---------------------------------------------------------------------------

def test_exact_bucket_batch_skips_padding(compiled):
    program, exe, rprogram, _rexe = compiled
    eng = tual.CompiledKernelCache().engine_for(exe.lowered, device="cpu")
    mems = _mems(program, 8, seed=30)
    flats = program.flatten_batch(mems)
    out, info = eng.run(flats, N_ITERS)
    assert info["padded"] == 0 and eng.padded_samples == 0
    for b in (0, 7):
        want = interpret(rprogram.dfg, mems[b], N_ITERS)
        got = program.unflatten(out[b])
        for name in program.outputs:
            np.testing.assert_array_equal(got[name], want[name])
    out7, info7 = eng.run(flats[:7], N_ITERS)
    assert info7["padded"] == 1 and out7.shape[0] == 7
    np.testing.assert_array_equal(out7, out[:7])


def test_validate_flattens_once_per_multi_backend_sweep(compiled,
                                                        monkeypatch):
    program, exe, _rprogram, _rexe = compiled
    calls = []
    real = tual.Program.flatten_batch
    monkeypatch.setattr(tual.Program, "flatten_batch",
                        lambda self, ms: calls.append(len(ms))
                        or real(self, ms))
    report = exe.validate(seed=5, backends=("sim", "torch"), n_vectors=4)
    assert report.passed
    assert calls == [4]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cgra_exec kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture
def gemm_cuda():
    program = tual.Program.from_kernel("gemm")
    exe = tual.compile(program, tual.Target.from_name(
        "hycube", rows=4, cols=4, backend="cuda"),
        cache=tual.MappingCache(disk_dir=None))
    return program, exe


@pytest.mark.cuda
@pytest.mark.parametrize("B", [300, 4096])
def test_pinned_run_batch_matches_sim(card, gemm_cuda, B):
    """One launch, staged in pieces of 128 rows at M = 8192; at B = 300 the
    bucket of 512 pads part of one piece and all of another."""
    from repro_torch.kernels.cgra_exec import ops
    program, exe = gemm_cuda
    mems = _mems(program, B, seed=40)
    before = ops.launches()
    outs = exe.run_batch(mems)
    assert ops.launches() == before + 1
    _assert_same(outs, exe.run_batch(mems, backend="sim"), program.outputs)
    eng = tual.default_engine().engine_for(exe.lowered, lanes=4096,
                                           device=card)
    rows = eng.bucket_for(B)
    assert eng._free[(program.layout.total_words, rows)]   # kept for reuse


@pytest.mark.cuda
def test_run_stream_of_16384_on_cuda(card, gemm_cuda):
    from repro_torch.kernels.cgra_exec import ops
    program, exe = gemm_cuda
    mems = _mems(program, 16384, seed=41)
    exe.warmup()
    before = ops.launches()
    chunks = list(exe.run_stream(mems))
    info = exe.last_info
    assert ops.launches() == before + 4
    assert [len(c) for c in chunks] == [4096] * 4
    assert info["traced"] == 0 and info["stream_chunks"] == 4
    assert 0.0 <= info["overlap_frac"] <= 1.0
    _assert_same([d for c in chunks for d in c],
                 exe.run_batch(mems, backend="sim"), program.outputs)
