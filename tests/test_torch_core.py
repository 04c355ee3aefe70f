"""Parity of the port's toolchain core with the JAX package's.

The port (``repro_torch``) keeps its own copies of the numpy toolchain:
fabrics, DFGs, the kernel library, the mapper, lowering, the simulators and
the verifier.  These tests hold each copy to the reference on the same
inputs, bit-exact (everything is int32, so the tolerance is 0):

  * ``Program.digest`` and ``Target.digest`` agree for every library kernel
    on HyCUBE 4x4, N2N 4x4 and PACE 8x8 — the same key into either cache,
  * a mapping made by the reference, carried across as plain data
    (``repro_torch.interop``), lowers to the same fingerprints and tables,
    simulates to the same images and verifies to the same findings,
  * the port's own mapper produces configurations that pass the port's
    interpreter oracle.
"""
import numpy as np
import pytest

from repro import ual as rual
from repro.core.kernel_lib import KERNELS as REF_KERNELS
from repro.core.lowering import config_fingerprint as ref_config_fp
from repro.core.lowering import lowered_fingerprint as ref_lowered_fp
from repro.core.simulator import simulate_batch as ref_simulate_batch
from repro.core.simulator import simulate_reference as ref_simulate_reference
from repro_torch import interop
from repro_torch import ual as tual
from repro_torch.analysis.verifier import verify
from repro_torch.core.kernel_lib import KERNELS
from repro_torch.core.lowering import (config_fingerprint, link_config,
                                       lowered_fingerprint)
from repro_torch.core.simulator import simulate_batch, simulate_reference

FABRICS = {"hycube": {"rows": 4, "cols": 4}, "n2n": {"rows": 4, "cols": 4},
           "pace": {}}
#: every kernel of the reference's library, jax_poly (traced with torch.fx
#: in the port, with jax in the reference) included
PORTED_KERNELS = sorted(REF_KERNELS)
#: pairs the reference maps for the carried-state tests (cheap to map)
CARRIED = [(k, f) for f in FABRICS for k in ("gemm", "nw")]


@pytest.fixture(autouse=True)
def port_cache(tmp_path):
    """The port's mapping cache in a tmp dir, as the process default."""
    cache = tual.MappingCache(disk_dir=tmp_path / "port_cache")
    prev = tual.set_default_cache(cache)
    yield cache
    tual.set_default_cache(prev)


def _ref_compiled(kname, fabric):
    """The reference's executable (mapped once per session by the
    conftest's shared cache) and its program."""
    target = rual.Target.from_name(fabric, **FABRICS[fabric])
    program = rual.Program.from_kernel(kname,
                                       n_banks=target.fabric.n_mem_ports)
    exe = rual.compile(program, target)
    assert exe.success, f"{kname} failed to map on {fabric}"
    return program, exe


def test_kernel_library_is_the_reference_minus_jax_poly():
    """Once the reference's minus jax_poly; now the reference's library,
    in its order."""
    assert list(KERNELS) == list(REF_KERNELS)


@pytest.mark.parametrize("fabric", sorted(FABRICS))
@pytest.mark.parametrize("kname", PORTED_KERNELS)
def test_program_and_target_digests_match(kname, fabric):
    rt = rual.Target.from_name(fabric, **FABRICS[fabric])
    tt = tual.Target.from_name(fabric, backend="torch", **FABRICS[fabric])
    assert tt.fabric.to_json() == rt.fabric.to_json()
    assert tt.digest == rt.digest
    n_banks = rt.fabric.n_mem_ports
    rp = rual.Program.from_kernel(kname, n_banks=n_banks)
    tp = tual.Program.from_kernel(kname, n_banks=n_banks)
    assert tp.digest == rp.digest
    assert tp.n_iters == rp.n_iters
    assert tp.layout.total_words == rp.layout.total_words
    rng_r, rng_t = np.random.default_rng(3), np.random.default_rng(3)
    np.testing.assert_array_equal(tp.flatten(tp.random_inputs(rng_t)),
                                  rp.flatten(rp.random_inputs(rng_r)))


@pytest.mark.parametrize("kname,fabric", CARRIED)
def test_carried_mapping_lowers_identically(kname, fabric):
    _, rexe = _ref_compiled(kname, fabric)
    result = interop.map_result(interop.map_state(rexe.map_result))
    cfg = result.config
    assert config_fingerprint(cfg) == ref_config_fp(rexe.map_result.config)
    linked = link_config(cfg)
    ref = rexe.lowered
    assert lowered_fingerprint(linked) == ref_lowered_fp(ref)
    for name in ("scalar", "ops", "regw"):
        np.testing.assert_array_equal(getattr(linked, name),
                                      getattr(ref, name))
    assert tuple(linked.mem_pes) == tuple(ref.mem_pes)
    assert (linked.II, linked.n_pes, linked.n_regs, linked.t0_max,
            linked.cm_bytes(), linked.unresolved_inputs) == (
        ref.II, ref.n_pes, ref.n_regs, ref.t0_max, ref.cm_bytes(),
        ref.unresolved_inputs)
    # the lowered artifact crosses as plain data just as well
    again = interop.linked_config(interop.linked_state(ref))
    assert lowered_fingerprint(again) == ref_lowered_fp(ref)
    assert result.II == rexe.map_result.II
    assert result.placements == rexe.map_result.placements


@pytest.mark.parametrize("kname,fabric", CARRIED)
def test_carried_mapping_verifies_identically(kname, fabric):
    rprog, rexe = _ref_compiled(kname, fabric)
    tprog = tual.Program.from_kernel(kname,
                                     n_banks=rexe.target.fabric.n_mem_ports)
    cfg = interop.machine_config(interop.config_state(rexe.map_result.config))
    report = verify(cfg, program=tprog, name=kname)
    ref = rexe.check_report
    assert report.ok == ref.ok
    assert sorted(d.render() for d in report.diagnostics) == \
        sorted(d.render() for d in ref.diagnostics)


@pytest.mark.parametrize("kname,fabric", CARRIED)
def test_simulators_match_reference(kname, fabric):
    rprog, rexe = _ref_compiled(kname, fabric)
    linked = interop.linked_config(interop.linked_state(rexe.lowered))
    rng = np.random.default_rng(11)
    flats = rprog.flatten_batch([rprog.random_inputs(rng) for _ in range(5)])
    n = rprog.n_iters
    got, stats = simulate_batch(linked, flats, n)
    want, ref_stats = ref_simulate_batch(rexe.lowered, flats, n)
    np.testing.assert_array_equal(got, want)
    assert vars(stats) == vars(ref_stats)
    cfg = interop.machine_config(interop.config_state(rexe.map_result.config))
    one, one_stats = simulate_reference(cfg, flats[0], n)
    ref_one, ref_one_stats = ref_simulate_reference(rexe.map_result.config,
                                                    flats[0], n)
    np.testing.assert_array_equal(one, ref_one)
    np.testing.assert_array_equal(one, want[0])
    assert vars(one_stats) == vars(ref_one_stats)


@pytest.mark.parametrize("kname", ["gemm", "nw"])
def test_port_mapper_passes_the_port_oracle(kname, port_cache):
    program = tual.Program.from_kernel(kname)
    exe = tual.compile(program, tual.Target.from_name(
        "hycube", rows=4, cols=4, backend="torch"))
    assert exe.success and exe.check_report.ok
    assert not exe.compile_info.cache_hit
    rep = exe.validate(seed=2, backends=("sim", "torch"), n_vectors=4)
    assert rep.passed, rep
    assert rep.backend_results == {"sim": True, "torch": True}
    state = interop.map_state(exe.map_result)
    again = interop.map_result(state)
    assert config_fingerprint(again.config) == \
        config_fingerprint(exe.map_result.config)
