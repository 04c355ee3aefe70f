"""The port's PACE energy model against the reference's, function by function.

``repro_torch.core.energy`` is pure Python; every function gets the same
arguments in both packages (a grid of supply voltages, utilisations, gating
and technology nodes) and must return the same floats.  ``kernel_energy``
prices the same mapped machine configurations — the reference's and the
port's own mapping of the same kernel, which agree — and the calibration
anchors of the paper (Figs. 10-11, Table IV) hold in the port as they do in
the reference.
"""
import itertools

import numpy as np
import pytest

from repro.core import energy as ref
from repro.core.adl import hycube as ref_hycube
from repro.core.adl import pace as ref_pace
from repro.core.dfg import apply_layout as ref_apply_layout
from repro.core.dfg import plan_layout as ref_plan_layout
from repro.core.kernel_lib import KERNELS as REF_KERNELS
from repro.core.mapper import map_dfg as ref_map_dfg
from repro_torch.core import energy as port
from repro_torch.core.adl import hycube as port_hycube
from repro_torch.core.adl import pace as port_pace
from repro_torch.core.dfg import apply_layout, plan_layout
from repro_torch.core.kernel_lib import KERNELS
from repro_torch.core.mapper import map_dfg

VDDS = (0.55, 0.6, 0.75, 0.9, 1.0)


def test_constants_match():
    for name in ("N_PES", "F_SLOPE_MHZ_PER_V", "V_T", "K_DYN_MW_PER_V2MHZ",
                 "P_STATIC_MW", "POWER_SPLIT", "AREA_SPLIT_CGRA",
                 "AREA_SPLIT_SOC", "SOC_AREA_MM2", "CGRA_AREA_MM2",
                 "DYNAMIC_GATING_SAVINGS", "OPS_PER_PE_CYCLE"):
        assert getattr(port, name) == getattr(ref, name), name
    # at the threshold voltage the clock stops: both models divide by zero
    for mod in (port, ref):
        assert mod.freq_mhz(mod.V_T) == 0.0
        with pytest.raises(ZeroDivisionError):
            mod.component_energy_pj(mod.V_T)


@pytest.mark.parametrize("vdd", VDDS)
def test_voltage_curves_match(vdd):
    assert port.freq_mhz(vdd) == ref.freq_mhz(vdd)
    assert port.component_energy_pj(vdd) == ref.component_energy_pj(vdd)
    for activity, gating in itertools.product((0.0, 0.3, 1.0),
                                              (False, True)):
        assert (port.cgra_power_mw(vdd, activity, gating)
                == ref.cgra_power_mw(vdd, activity, gating))
    for util, gating in itertools.product((0.05, 0.3, 0.77, 1.0),
                                          (False, True)):
        assert (port.efficiency_gops_w(vdd, util, gating)
                == ref.efficiency_gops_w(vdd, util, gating))


@pytest.mark.parametrize("n_ops,II,n_pes", [(21, 2, 16), (21, 5, 64),
                                            (64, 1, 16), (7, 0, 16),
                                            (7, 3, 0), (150, 4, 64)])
def test_point_efficiency_matches(n_ops, II, n_pes):
    for vdd, gating in itertools.product((0.6, 0.8), (False, True)):
        assert (port.point_efficiency_gops_w(n_ops, II, n_pes, vdd, gating)
                == ref.point_efficiency_gops_w(n_ops, II, n_pes, vdd,
                                               gating))


@pytest.mark.parametrize("node", (16, 22, 28, 40, 65))
def test_normalisation_matches(node):
    for x in (3.02, 20.1, 400.0):
        assert port.normalized_area(x, node) == ref.normalized_area(x, node)
        assert (port.normalized_efficiency(x, node)
                == ref.normalized_efficiency(x, node))


def test_table4_matches_and_pace_wins():
    rows = port.table4_comparison()
    assert rows == ref.table4_comparison()
    pace = rows["PACE"]
    for k, r in rows.items():
        if k != "PACE":
            assert 1.0 < pace["norm_eff"] / r["norm_eff"] < 5.0, k
    assert pace["norm_area"] == min(r["norm_area"] for r in rows.values())


@pytest.mark.parametrize("kname,fabric", [("gemm", "pace"),
                                          ("gemm", "hycube"),
                                          ("nw", "hycube")])
def test_kernel_energy_matches(kname, fabric):
    """The same mapped configuration priced by both packages, and the
    port's own mapping of the kernel priced the same; gating saves, and
    the configuration memory is the largest term (Fig. 11c)."""
    dfg, _, n_iters = KERNELS[kname]()
    laid = apply_layout(dfg, plan_layout(dfg))
    fab = port_pace() if fabric == "pace" else port_hycube(4, 4)
    res = map_dfg(laid, fab, seed=0)
    rdfg, _, _ = REF_KERNELS[kname]()
    rlaid = ref_apply_layout(rdfg, ref_plan_layout(rdfg))
    rfab = ref_pace() if fabric == "pace" else ref_hycube(4, 4)
    rres = ref_map_dfg(rlaid, rfab, seed=0)
    assert res.success and rres.success
    np.testing.assert_array_equal(res.config.opcode, rres.config.opcode)
    for gating in (True, False):
        want = ref.kernel_energy(rres.config, n_iters, dynamic_gating=gating)
        assert port.kernel_energy(rres.config, n_iters,
                                  dynamic_gating=gating) == want
        assert port.kernel_energy(res.config, n_iters,
                                  dynamic_gating=gating) == want
    on = port.kernel_energy(res.config, n_iters, dynamic_gating=True)
    off = port.kernel_energy(res.config, n_iters, dynamic_gating=False)
    assert on["total"] < off["total"]
    assert on["cm"] == max(v for k, v in on.items()
                           if k not in ("total", "per_op"))
