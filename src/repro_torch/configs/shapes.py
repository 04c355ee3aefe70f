"""Assigned input shapes (4 per architecture; 40 cells total).

``long_500k`` needs sub-quadratic attention: it runs only for the SSM /
hybrid families (rwkv6, zamba2); pure/windowed-attention archs retain
quadratic *global* layers and are skipped (DESIGN.md §Arch-applicability).
Encoder-only archs (hubert) have no decode step, so decode shapes skip.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

SUBQUADRATIC_FAMILIES = ("rwkv6", "zamba2")


def cell_skip_reason(family: str, shape: str) -> Optional[str]:
    """None if the (arch-family, shape) cell runs; else the skip reason."""
    if family == "hubert" and shape in ("decode_32k", "long_500k"):
        return "encoder-only: no decode step"
    if shape == "long_500k" and family not in SUBQUADRATIC_FAMILIES:
        return "long_500k requires sub-quadratic attention (SSM/hybrid only)"
    return None


def all_cells(arch_names, arch_families) -> list:
    """[(arch, shape, skip_reason)] over the full 40-cell grid."""
    cells = []
    for a in arch_names:
        fam = arch_families[a]
        for s in SHAPES:
            cells.append((a, s, cell_skip_reason(fam, s)))
    return cells
