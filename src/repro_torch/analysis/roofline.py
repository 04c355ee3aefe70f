"""Roofline analysis of dry-run cells on NVIDIA H100 SXM peaks (the JAX
package's ``analysis/roofline.py``, whose TPU v5e constants these replace).

Three terms per (arch x shape x mesh) cell:

    compute    = FLOPs      / (chips * PEAK_FLOPS_BF16)
    memory     = bytes      / (chips * HBM_BW)
    collective = coll_bytes / (chips * LINK_BW)

The FLOPs, bytes and collective wire bytes come from the traced step's
cost model (``analysis/hlo_cost``), per device.  MODEL_FLOPS = 6*N*D
(train) or 2*N*D (inference), N the active parameters (MoE: top-k and
shared experts only), gives the useful-compute ratio.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from repro_torch.analysis.hlo_cost import COLLECTIVES

# -- NVIDIA H100 SXM5 constants (NVIDIA H100 Tensor Core GPU datasheet) -----
#: dense bf16 tensor-core FLOP/s per card (the datasheet's 1,979 TFLOP/s
#: is with 2:4 sparsity)
PEAK_FLOPS_BF16 = 989e12
#: HBM3 bytes/s per card
HBM_BW = 3.35e12
#: NVLink 4 bytes/s per card in one direction (900 GB/s both ways)
LINK_BW = 450e9


def parse_collectives(cost: Dict[str, object]) -> Dict[str, Dict[str, float]]:
    """Operand bytes and count per collective kind, every kind present
    (the reference's ``parse_collectives`` over HLO text; here over the
    cost model's ``collectives``)."""
    colls = cost.get("collectives", {})
    return {k: {"count": colls.get(k, {}).get("count", 0),
                "bytes": colls.get(k, {}).get("operand_bytes", 0)}
            for k in COLLECTIVES}


@dataclass
class RooflineResult:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    model_flops: float
    per_device_hbm_peak: float = 0.0
    collectives: Dict[str, Dict[str, float]] = field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS_BF16)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / (self.chips * LINK_BW)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time_lb(self) -> float:
        """Lower-bound step time = max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful compute vs the machine at the step-time lower bound."""
        if self.step_time_lb == 0:
            return 0.0
        return (self.model_flops / self.step_time_lb) \
            / (self.chips * PEAK_FLOPS_BF16)

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips, "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "per_device_hbm_peak": self.per_device_hbm_peak,
            "collectives": self.collectives,
        }


def model_flops(cfg, shape_kind: str, seq: int, batch: int,
                decode: bool = False) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference forward)."""
    n_active = cfg.active_param_count()
    tokens = batch * (1 if decode else seq)
    mult = 6.0 if shape_kind == "train" else 2.0
    return mult * n_active * tokens


def analyze(arch: str, shape: str, mesh_name: str, chips: int,
            cost: Dict[str, object], mflops: float,
            mem_peak: float = 0.0) -> RooflineResult:
    """Roofline of a whole-mesh cost (``cost``'s FLOPs and bytes summed
    over the ``chips`` devices, collectives' operand bytes by kind)."""
    colls = parse_collectives(cost)
    return RooflineResult(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=float(cost.get("flops", 0.0)),
        hlo_bytes=float(cost.get("bytes accessed", 0.0)),
        collective_bytes=sum(v["bytes"] for v in colls.values()),
        model_flops=mflops, per_device_hbm_peak=mem_peak, collectives=colls)


def analyze_per_device(arch: str, shape: str, mesh_name: str, chips: int,
                       hlo_cost: Dict[str, object], mflops: float,
                       mem_peak: float = 0.0) -> RooflineResult:
    """Roofline from the per-device cost model (``hlo_cost.CostModel``):
    every quantity is already per chip, so the terms divide by one chip's
    peaks (``chips`` kept for the useful-compute ratio)."""
    return RooflineResult(
        arch=arch, shape=shape, mesh=mesh_name, chips=1,
        hlo_flops=float(hlo_cost["flops_per_device"]),
        hlo_bytes=float(hlo_cost["bytes_per_device"]),
        collective_bytes=float(hlo_cost["collective_wire_bytes_per_device"]),
        model_flops=mflops / chips,        # useful flops per chip
        per_device_hbm_peak=mem_peak,
        collectives=dict(hlo_cost["collectives"]),
    )


__all__ = ("HBM_BW", "LINK_BW", "PEAK_FLOPS_BF16", "RooflineResult",
           "analyze", "analyze_per_device", "model_flops",
           "parse_collectives")
