"""The hand-written ``cgra_exec`` kernel on a CUDA card.

These tests need a card and skip without one (the kernel has no CPU mode;
the CPU tests hold its plain version to the JAX package instead).  They
import nothing of JAX, so they also run where only the port is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import ual
from repro_torch.kernels.cgra_exec import ops
from repro_torch.kernels.cgra_exec.edge_cases import (edge_case_config,
                                                      edge_case_images)
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
