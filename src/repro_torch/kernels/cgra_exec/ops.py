"""Public wrapper: lowered tables + scratchpad block -> the CUDA kernel.

``cgra_exec(tables, memT, n_iters)`` launches the hand-written kernel
(``csrc/cgra_exec.cu``) when ``memT`` lies on a CUDA device and raises if it
cannot; only a CPU tensor goes to the plain PyTorch version
(``ref.cgra_exec_torch``).  ``upload_tables`` puts a ``LinkedConfig``'s
dense tables on a device once; the execution engine keeps them there.

Every launch adds one to the module's launch count (``launches()``), so a
run can show that it went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import lowering
from repro_torch.core.lowering import (LinkedConfig, config_fingerprint,
                                       link_config)
from repro_torch.core.machine import OPC, MachineConfig
from repro_torch.kernels import build as _build
from repro_torch.kernels.cgra_exec.ref import cgra_exec_torch

SOURCES = (Path(__file__).resolve().parent / "csrc" / "cgra_exec.cu",)

_launches = 0
_count_lock = threading.Lock()


def launches() -> int:
    """Kernel launches since the last ``reset_launches`` (CUDA only)."""
    with _count_lock:
        return _launches


def reset_launches() -> None:
    global _launches
    with _count_lock:
        _launches = 0


def defines() -> Dict[str, int]:
    """The ``-D`` flags the kernel is built with: opcode numbers from
    ``core.machine.OPC`` and the lowered source kinds, never hand-copied."""
    d = {f"OPC_{name}": code for name, code in OPC.items()}
    d.update({k: getattr(lowering, k) for k in
              ("K_NONE", "K_O", "K_R", "K_CONST", "K_RESULT")})
    return d


def build() -> Path:
    """Build the kernel library (no-op when it exists); returns its path."""
    return _build.build("cgra_exec", SOURCES, defines())


@functools.cache
def _launcher():
    """The library's C entry point, built and loaded once per process:
    hashing the sources on every launch would cost more host time than a
    launch at the engine's bucket of 128 lanes takes on the card."""
    fn = _build.load("cgra_exec", SOURCES, defines()).cgra_exec_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@dataclass(frozen=True)
class DeviceTables:
    """A lowered artifact's tables, resident on one device."""

    linked: LinkedConfig
    device: torch.device
    scalar: torch.Tensor      # (S, P, 4) int32
    ops: torch.Tensor         # (S, P, 3, 5) int32
    regw: torch.Tensor        # (S, P, R, 3) int32
    mem_pes: torch.Tensor     # (n_mem_pes,) int32


def upload_tables(linked: LinkedConfig, device) -> DeviceTables:
    """Copy the dense tables to ``device`` once (checked for shape)."""
    device = torch.device(device)
    S, P, R = linked.II, linked.n_pes, linked.n_regs
    want = {"scalar": (S, P, 4), "ops": (S, P, 3, 5), "regw": (S, P, R, 3)}
    for name, shape in want.items():
        got = np.shape(getattr(linked, name))
        if got != shape:
            raise ValueError(f"linked.{name} has shape {got}, expected "
                             f"{shape} for II={S}, P={P}, R={R}")
    if S < 1 or P < 1:
        raise ValueError(f"II={S} and n_pes={P} must be positive")
    mem_pes = np.asarray(linked.mem_pes, np.int32).reshape(-1)
    if ((mem_pes < 0) | (mem_pes >= P)).any():
        raise ValueError(f"mem_pes {tuple(mem_pes)} outside [0, {P})")

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32)).to(device)

    return DeviceTables(linked, device, put(linked.scalar), put(linked.ops),
                        put(linked.regw), put(mem_pes))


def _check(tables: DeviceTables, memT: torch.Tensor, n_iters: int
           ) -> Tuple[int, int]:
    if not isinstance(memT, torch.Tensor):
        raise TypeError(f"memT must be a torch.Tensor, got "
                        f"{type(memT).__name__}")
    if memT.dtype != torch.int32 or memT.dim() != 2:
        raise ValueError(f"memT must be a 2-D int32 (M, B) block, got "
                         f"{memT.dtype} {tuple(memT.shape)}")
    if not memT.is_contiguous():
        raise ValueError("memT must be contiguous (lane-minor (M, B))")
    if memT.device != tables.device:
        raise ValueError(f"memT is on {memT.device}, the tables on "
                         f"{tables.device}")
    M, B = memT.shape
    if M < 1 or B < 1:
        raise ValueError(f"empty scratchpad block {tuple(memT.shape)}")
    n = int(n_iters)
    linked = tables.linked
    if n < 0 or linked.t0_max + (n + 1) * linked.II + 2 >= 2 ** 31:
        raise ValueError(f"n_iters={n_iters} out of range")
    return M, B


def cgra_exec(tables: DeviceTables, memT: torch.Tensor,
              n_iters: int) -> torch.Tensor:
    """Execute ``tables`` for ``n_iters`` iterations over the lane-minor
    (M, B) int32 block ``memT``; returns a new (M, B) block.

    On a CUDA tensor this launches the kernel on the current stream, without
    synchronising, or raises; a CPU tensor runs the plain version."""
    global _launches
    M, B = _check(tables, memT, n_iters)
    if memT.device.type == "cpu":
        return cgra_exec_torch(tables.linked, memT, int(n_iters))
    if memT.device.type != "cuda":
        raise ValueError(f"cgra_exec runs on cuda or cpu, not {memT.device}")
    linked = tables.linked
    P, R = linked.n_pes, linked.n_regs
    out = torch.empty_like(memT)
    scratch = torch.empty((2 * P + 2 * P * R, B), dtype=torch.int32,
                          device=memT.device)
    fn = _launcher()
    with torch.cuda.device(memT.device):
        stream = torch.cuda.current_stream(memT.device).cuda_stream
        err = fn(tables.scalar.data_ptr(), tables.ops.data_ptr(),
                 tables.regw.data_ptr(), tables.mem_pes.data_ptr(),
                 memT.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                 int(tables.mem_pes.numel()), linked.II, P, R, M, B,
                 linked.t0_max, int(n_iters), stream)
    if err != 0:
        raise RuntimeError(f"cgra_exec launch failed: CUDA error {err}")
    with _count_lock:
        _launches += 1
    return out


#: fingerprint-keyed memo for callers that pass ``linked=None``: every
#: distinct configuration is lowered at most once per process
_LINKED_MEMO: Dict[str, LinkedConfig] = {}
_LINKED_LOCK = threading.Lock()


def _memoized_link(cfg: MachineConfig) -> LinkedConfig:
    fp = config_fingerprint(cfg)
    with _LINKED_LOCK:
        linked = _LINKED_MEMO.get(fp)
    if linked is None:
        linked = link_config(cfg)
        with _LINKED_LOCK:
            linked = _LINKED_MEMO.setdefault(fp, linked)
    return linked


def cgra_exec_op(cfg: MachineConfig, mem: np.ndarray, n_iters: int, *,
                 device="cuda", lanes: int = 128,
                 linked: Optional[LinkedConfig] = None) -> np.ndarray:
    """Execute a mapped configuration over (B, M) int32 scratchpad images
    through the persistent engine on ``device`` (the card unless the
    caller asks for ``"cpu"``); returns the final (B, M) images."""
    if linked is None:
        linked = _memoized_link(cfg)
    from repro_torch.ual.engine import default_engine
    out, _ = default_engine().run(linked, np.asarray(mem, np.int32), n_iters,
                                  lanes=lanes, device=device)
    return out
