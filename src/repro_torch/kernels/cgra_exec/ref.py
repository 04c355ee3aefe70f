"""Plain PyTorch version of the ``cgra_exec`` kernel.

``cgra_exec_torch`` computes what the CUDA kernel (``csrc/cgra_exec.cu``)
and the JAX package's Pallas kernel compute — cycle-accurate execution of a
lowered configuration over a batch of scratchpad images — as batch-wide
tensor ops on any device:

  * operand fetch and register writes are ``index_select`` row reads of the
    lane-minor ``(rows, B)`` state, where the TPU used one-hot sums;
  * loads and stores are per-lane ``gather``/``scatter_`` on the ``(M, B)``
    scratchpad; an out-of-range address loads 0 and drops the store;
  * arithmetic runs in int64 and is wrapped to int32 explicitly (PyTorch's
    int32 overflow is no contract); ``//`` on integer tensors floors.

The control (which PE fires this cycle) is a function of the tables and the
cycle alone; it is computed on the tensors' device too, so no value ever
syncs to the host.  The CPU tests and the ``torch`` backend run this; on a
card, only the kernel-vs-plain comparison does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.lowering import (K_CONST, K_NONE, K_O, K_R, K_RESULT,
                                       LinkedConfig)
from repro_torch.core.machine import OPC

_I32_BIAS = 1 << 31
_I32_MASK = (1 << 32) - 1


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor -> the int32 value with the same low 32 bits (int64)."""
    return ((x + _I32_BIAS) & _I32_MASK) - _I32_BIAS


def _alu(opc: int, v0, v1, v2, const):
    """One opcode's result over (N, B) int64 operands, already wrapped."""
    if opc == OPC["ADD"]:
        return wrap_i32(v0 + v1)
    if opc == OPC["SUB"]:
        return wrap_i32(v0 - v1)
    if opc == OPC["MUL"]:
        return wrap_i32(v0 * v1)          # |product| < 2**62: exact in int64
    if opc == OPC["SHL"]:
        return wrap_i32(v0 << (v1 & 31))
    if opc == OPC["SHR"]:
        return v0 >> (v1 & 31)            # arithmetic; in range already
    if opc == OPC["AND"]:
        return v0 & v1
    if opc == OPC["OR"]:
        return v0 | v1
    if opc == OPC["XOR"]:
        return v0 ^ v1
    if opc == OPC["MIN"]:
        return torch.minimum(v0, v1)
    if opc == OPC["MAX"]:
        return torch.maximum(v0, v1)
    if opc == OPC["ABS"]:
        return wrap_i32(v0.abs())         # ABS(INT_MIN) == INT_MIN
    if opc == OPC["CMPLT"]:
        return (v0 < v1).long()
    if opc == OPC["CMPGT"]:
        return (v0 > v1).long()
    if opc == OPC["CMPEQ"]:
        return (v0 == v1).long()
    if opc == OPC["CMPNE"]:
        return (v0 != v1).long()
    if opc == OPC["CMPLE"]:
        return (v0 <= v1).long()
    if opc == OPC["CMPGE"]:
        return (v0 >= v1).long()
    if opc == OPC["SELECT"]:
        return torch.where(v0 != 0, v1, v2)
    if opc == OPC["MOVC"]:
        return const.expand_as(v0)
    if opc == OPC["ROUTE"]:
        return v0
    return torch.zeros_like(v0)           # NOP, LOAD, STORE, unknown


def _rows(state: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``state[idx]`` over the rows of a (N, B) block; 0 where idx is
    outside [0, N), as the TPU's one-hot gather gives."""
    n = state.shape[0]
    ok = (idx >= 0) & (idx < n)
    got = state.index_select(0, idx.clamp(0, max(n - 1, 0)))
    return torch.where(ok[:, None], got, torch.zeros((), dtype=state.dtype,
                                                     device=state.device))


def cgra_exec_torch(linked: LinkedConfig, memT: torch.Tensor,
                    n_iters: int) -> torch.Tensor:
    """Execute ``linked`` for ``n_iters`` iterations over ``memT``, the
    lane-minor (M, B) int32 scratchpad block; returns the final (M, B)
    int32 block on ``memT``'s device.  ``memT`` is not modified."""
    dev = memT.device
    II, P, R = linked.II, linked.n_pes, linked.n_regs
    M, B = memT.shape
    scalar = torch.as_tensor(np.asarray(linked.scalar), device=dev).long()
    optab = torch.as_tensor(np.asarray(linked.ops), device=dev).long()
    rwtab = torch.as_tensor(np.asarray(linked.regw), device=dev).long()
    opcodes = [sorted({int(c) for c in np.asarray(linked.scalar)[s, :, 0]})
               for s in range(II)]
    pe_rows = torch.arange(P, device=dev)

    mem = memT.to(torch.int32).clone()
    O = torch.zeros((P, B), dtype=torch.int64, device=dev)
    Rf = torch.zeros((P * R, B), dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    total = linked.t0_max + (int(n_iters) + 1) * II + 2
    for t in range(total):
        s = t % II
        sc, op, rw = scalar[s], optab[s], rwtab[s]
        opc, const, use_c, t0 = sc[:, 0], sc[:, 1], sc[:, 2], sc[:, 3]
        it = torch.where(t0 >= 0, (t - t0) // II, zero)          # floor
        fired = (opc != OPC["NOP"]) & (t0 >= 0) & (t >= t0) & (it < n_iters)
        cvec = const[:, None].expand(P, B)

        # ---- operand fetch: previous-cycle latches / registers / const ---
        kinds, vs = [], []
        for k in range(3):
            kind, pe, reg = op[:, k, 0], op[:, k, 1], op[:, k, 2]
            dist, init = op[:, k, 3], op[:, k, 4]
            v = torch.where((kind == K_O)[:, None], _rows(O, pe), zero)
            v = torch.where((kind == K_R)[:, None],
                            _rows(Rf, wrap_i32(pe * R + reg)), v)
            v = torch.where((kind == K_CONST)[:, None], cvec, v)
            use_init = (dist > 0) & (it < dist)
            v = torch.where(use_init[:, None], init[:, None].expand(P, B), v)
            kinds.append(kind)
            vs.append(v)
        # the immediate is a *trailing* ALU operand when use_const is set
        n_ops = sum((kd != K_NONE).long() for kd in kinds)
        uc = use_c != 0
        for k in range(3):
            fill = (kinds[k] == K_NONE) & uc & (n_ops == k)
            vs[k] = torch.where(fill[:, None], cvec, vs[k])
        v0, v1, v2 = vs

        result = torch.zeros((P, B), dtype=torch.int64, device=dev)
        for code in opcodes[s]:
            result = torch.where((opc == code)[:, None],
                                 _alu(code, v0, v1, v2, const[:, None]),
                                 result)

        # ---- memory ops: sequential over the LSU PEs (port order) --------
        for mp in linked.mem_pes:
            is_ld = fired[mp] & (opc[mp] == OPC["LOAD"])
            is_st = fired[mp] & (opc[mp] == OPC["STORE"])
            has_idx = op[mp, 0, 0] != K_NONE
            l_addr = wrap_i32(torch.where(has_idx, v0[mp], zero) + const[mp])
            has2 = op[mp, 1, 0] != K_NONE
            s_addr = torch.where(has2, wrap_i32(v0[mp] + const[mp]),
                                 const[mp].expand(B))
            s_val = torch.where(has2, v1[mp], v0[mp])
            addr = torch.where(is_st, s_addr, l_addr)
            ok = (addr >= 0) & (addr < M)
            a = addr.clamp(0, M - 1)[None, :]
            cur = mem.gather(0, a)[0]
            lval = torch.where(ok, cur.long(), zero)
            mem.scatter_(0, a, torch.where(is_st & ok, s_val.to(torch.int32),
                                           cur)[None, :])
            row = torch.where(is_ld, lval, torch.where(is_st, s_val,
                                                       result[mp]))
            result = torch.where((pe_rows == mp)[:, None], row[None, :],
                                 result)

        # ---- end of cycle: register writes, then output latches ----------
        rwk = rw[:, :, 0].reshape(P * R)
        rwp = rw[:, :, 1].reshape(P * R)
        rwr = rw[:, :, 2].reshape(P * R)
        fired_src = _rows(fired.long()[:, None], rwp)[:, 0] != 0
        Rf_new = torch.where((rwk == K_O)[:, None], _rows(O, rwp), Rf)
        Rf_new = torch.where((rwk == K_R)[:, None],
                             _rows(Rf, wrap_i32(rwp * R + rwr)), Rf_new)
        Rf_new = torch.where(((rwk == K_RESULT) & fired_src)[:, None],
                             _rows(result, rwp), Rf_new)
        O = torch.where(fired[:, None], result, O)
        Rf = Rf_new
    return mem
