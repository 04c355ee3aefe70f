"""The hand-written ``cgra_exec`` kernel on a CUDA card: bit-exact against
its plain version at the engine's bucket edges, on mapped pairs (gemm on
HyCUBE 4x4, fft on PACE 8x8), the hand-built edge-case table and the
large-state table that runs the global-state form, in every form and
geometry; a ``run_batch`` of 4096 on the ``cuda`` backend is one launch.

These tests need a card and skip without one (the kernel has no CPU mode;
the CPU tests hold its plain version to the JAX package instead).  They
import nothing of JAX, so they also run where only the port is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import ual
from repro_torch.kernels.cgra_exec import ops
from repro_torch.kernels.cgra_exec.edge_cases import (edge_case_config,
                                                      edge_case_images,
                                                      large_state_config)
from repro_torch.kernels.cgra_exec.ref import cgra_exec_torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cgra_exec kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture
def gemm():
    program = ual.Program.from_kernel("gemm")
    exe = ual.compile(program, ual.Target.from_name("hycube", rows=4, cols=4),
                      cache=ual.MappingCache(disk_dir=None))
    return program, exe


@pytest.mark.parametrize("B", [1, 100, 300])
def test_kernel_matches_plain_version(card, gemm, B):
    program, exe = gemm
    rng = np.random.default_rng(B)
    cases = [(exe.lowered, program.flatten_batch(
        [program.random_inputs(rng) for _ in range(B)]), program.n_iters),
        (edge_case_config(), edge_case_images(rng, B, 1024), 6)]
    for linked, mems, n in cases:
        memT = torch.from_numpy(np.ascontiguousarray(mems.T)).to(card)
        before = ops.launches()
        got = ops.cgra_exec(ops.upload_tables(linked, card), memT, n)
        torch.cuda.synchronize()
        assert ops.launches() == before + 1
        assert torch.equal(got, cgra_exec_torch(linked, memT, n))
        assert torch.equal(memT.cpu(), torch.from_numpy(mems.T))


def _case(name, rng, B):
    """(linked, (B, M) images, n_iters) of one table the kernel runs."""
    if name == "edge_cases":
        return edge_case_config(), edge_case_images(rng, B, 1024), 6
    if name == "large_state":
        return large_state_config(), edge_case_images(rng, B, 1024), 6
    kname, fab = name.split("@")
    kw = {"rows": 4, "cols": 4} if fab == "hycube" else {}
    program = ual.Program.from_kernel(kname)
    exe = ual.compile(program, ual.Target.from_name(fab, **kw),
                      cache=ual.MappingCache(disk_dir=None))
    return exe.lowered, program.flatten_batch(
        [program.random_inputs(rng) for _ in range(B)]), program.n_iters


def _holds(card, tables, mems, n, plan=None):
    memT = torch.from_numpy(np.ascontiguousarray(mems.T)).to(card)
    before = ops.launches()
    got = ops.cgra_exec(tables, memT, n, plan)
    torch.cuda.synchronize()
    assert ops.launches() == before + 1
    assert torch.equal(got, cgra_exec_torch(tables.linked, memT, n))


@pytest.mark.parametrize("name", ["gemm@hycube", "fft@pace", "edge_cases",
                                  "large_state"])
def test_kernel_matches_plain_version_at_bucket_edges(card, name):
    linked, mems, n = _case(name, np.random.default_rng(3), 4096)
    tables = ops.upload_tables(linked, card)
    plan = ops.plan_launch(tables.layout)
    assert plan.state_shared == (name != "large_state")
    for B in (1, 31, 33, 128, 129, 4096):
        _holds(card, tables, mems[:B], n)


@pytest.mark.parametrize("name", ["gemm@hycube", "edge_cases"])
def test_every_form_and_geometry_matches_plain_version(card, name):
    """State and tables each in shared or global memory, one lane per
    thread or a group's cycle over several warps: one answer."""
    linked, mems, n = _case(name, np.random.default_rng(4), 300)
    tables = ops.upload_tables(linked, card)
    words = 4 * tables.layout.words.size
    for groups, warps in ((4, 1), (1, 1), (1, 3), (2, 4), (1, 8)):
        plan = ops.plan_launch(tables.layout, groups, warps)
        state = plan.smem_bytes - words
        for s_on, t_on in ((True, True), (True, False), (False, True),
                           (False, False)):
            _holds(card, tables, mems, n, dataclasses.replace(
                plan, state_shared=s_on, tables_shared=t_on,
                smem_bytes=state * s_on + words * t_on))


def test_run_batch_of_4096_is_one_launch(card, gemm):
    program, exe = gemm
    fresh = ual.CompiledKernelCache()
    prev = ual.set_default_engine(fresh)
    try:
        mems = [program.random_inputs(np.random.default_rng(5))
                for _ in range(4096)]
        before = ops.launches()
        outs = exe.run_batch(mems)
        assert ops.launches() == before + 1
        stats = fresh.stats()["per_engine"]
        assert [e["bucket_calls"] for e in stats.values()] == [{4096: 1}]
        sims = exe.run_batch(mems, backend="sim")
        for out, sim in zip(outs, sims):
            for name in program.outputs:
                np.testing.assert_array_equal(out[name], sim[name])
    finally:
        ual.set_default_engine(prev)


def test_cuda_backend_validates_and_launches(card, gemm):
    program, exe = gemm
    before = ops.launches()
    rep = exe.validate(backends=("cuda", "sim"), n_vectors=40)
    assert rep.passed and rep.backend_results == {"cuda": True, "sim": True}
    assert ops.launches() > before


def test_wrapper_rejects_tables_on_another_device(card, gemm):
    program, exe = gemm
    tables = ops.upload_tables(exe.lowered, "cpu")
    memT = torch.zeros((program.layout.total_words, 4), dtype=torch.int32,
                       device=card)
    with pytest.raises(ValueError, match="tables on cpu"):
        ops.cgra_exec(tables, memT, 1)
