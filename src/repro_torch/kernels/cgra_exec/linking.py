"""Compatibility shim: the "linker" is the shared lowering pass.

The dense-table construction is the single source of truth in
``repro_torch.core.lowering`` — the same lowered artifact drives the CUDA
``cgra_exec`` kernel, its plain PyTorch version, the vectorized batched
simulator and the ``ual`` compile pipeline's ``lowering`` pass.  This module
re-exports the public names under the kernel's package.
"""
from __future__ import annotations

from repro_torch.core.lowering import (K_CONST, K_NONE, K_O, K_R, K_RESULT,
                                       LinkedConfig, link_config)

__all__ = ["K_CONST", "K_NONE", "K_O", "K_R", "K_RESULT", "LinkedConfig",
           "link_config"]
