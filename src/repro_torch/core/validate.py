"""End-to-end validation: map -> simulate -> check (paper Table II rows
"Test data generation" and "Validation against test data").

The bespoke layout/map/flatten/simulate/compare loop that used to live
here is now ``Executable.validate()`` in the unified abstraction layer
(``repro_torch.ual``); ``validate_kernel`` remains as the stable entry point and
delegates — existing callers keep working and now share the UAL mapping
cache.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from repro_torch.core.adl import Fabric
from repro_torch.core.dfg import DFG
from repro_torch.core.mapper import MapResult
from repro_torch.core.simulator import SimStats


@dataclass
class ValidationReport:
    kernel: str
    fabric: str
    map_result: MapResult
    passed: bool
    n_iters: int
    sim_stats: Optional[SimStats] = None
    mismatches: int = 0
    backend_results: Optional[Dict[str, bool]] = field(default=None)
    #: how many random test vectors were swept (one natively-batched run
    #: per backend — see ``Executable.validate``)
    n_vectors: int = 1

    def __str__(self) -> str:
        status = "PASS" if self.passed else "FAIL"
        ii = self.map_result.II if self.map_result.success else "—"
        return (f"[{status}] {self.kernel} on {self.fabric}: II={ii} "
                f"(MII={self.map_result.mii}), "
                f"util={self.map_result.fu_util:.2f}, "
                f"restarts={self.map_result.restarts}")


def validate_kernel(dfg: DFG, make_mem: Callable, n_iters: int,
                    fabric: Fabric, seed: int = 0, ii_max: int = 48,
                    strategy: str = "adaptive") -> ValidationReport:
    """Map ``dfg`` onto ``fabric`` and check the simulated configuration
    bit-exactly against the DFG-interpreter oracle on random test vectors.
    """
    # function-level import: ual imports ValidationReport from this module
    from repro_torch import ual
    program = ual.Program.from_dfg(dfg, n_iters, make_mem=make_mem,
                                   n_banks=fabric.n_mem_ports)
    target = ual.Target(fabric, backend="sim", strategy=strategy,
                        ii_max=ii_max, seed=seed)
    exe = ual.compile(program, target)
    return exe.validate(seed=seed, n_iters=n_iters, make_mem=make_mem)
