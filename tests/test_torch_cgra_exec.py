"""The port's ``cgra_exec``: its plain PyTorch version against the JAX
package's engines, bit-exact (int32 throughout, so the tolerance is 0).

  * the paper's seven benchmark kernels on HyCUBE 4x4, mapped by the
    reference and carried across as plain data: ``cgra_exec_torch`` equals
    the reference's ``simulate_batch`` and ``cgra_exec_ref``,
  * gemm and nw: equal to the Pallas kernel in interpret mode,
  * hand-built tables that drive single semantics into their corners (int32
    wraparound, shift amounts, ``ABS(INT_MIN)``, out-of-range and wrapping
    addresses, a load after a same-cycle store, loop-carried init values
    after a late ``t0``), each held against a numpy statement of the
    semantics and against ``make_cgra_call(..., interpret=True)``; plus the
    combined edge-case table that ``chip_smoke.py`` also runs on the card,
  * the packed tables the kernel reads (``ops.pack_tables``): expanded
    back (``ops.unpack_tables``), they read what the dense tables read on
    every entry the kernel reads, keep the memory PEs' port order, and run
    to the same images; the launch plan's choice of form by size,
  * the wrapper's argument checks and the kernel library's build rules
    (the kernel itself runs on a card only: ``test_torch_cuda.py``).

Where the numpy engines (``simulate_reference``/``simulate_batch``) and
the kernels part on out-of-range addresses, the kernels are the contract:
the edge-case tests hold the port against the Pallas kernel only.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ual as rual
from repro.core.lowering import LinkedConfig as RefLinkedConfig
from repro.core.simulator import simulate_batch as ref_simulate_batch
from repro.kernels.cgra_exec.kernel import make_cgra_call
from repro.kernels.cgra_exec.ops import cgra_exec_op as ref_cgra_exec_op
from repro.kernels.cgra_exec.ref import cgra_exec_ref
from repro_torch import interop
from repro_torch.core.lowering import (K_CONST, K_NONE, K_O, K_R, K_RESULT,
                                       LinkedConfig, link_config)
from repro_torch.core.machine import OPC
from repro_torch.kernels import build as _build
from repro_torch.kernels.cgra_exec import ops
from repro_torch.kernels.cgra_exec.edge_cases import (LARGE_MIN_WORDS,
                                                      edge_case_config,
                                                      edge_case_images,
                                                      large_state_config)
from repro_torch.kernels.cgra_exec.ref import cgra_exec_torch, wrap_i32

INT_MIN, INT_MAX = -(1 << 31), (1 << 31) - 1
PAPER_KERNELS = ("gemm", "fft", "adpcm", "aes", "disparity", "dct", "nw")


def _carried(kname):
    """The reference's HyCUBE 4x4 mapping of ``kname`` (mapped once per
    session by the conftest's cache), carried into the port's types."""
    target = rual.Target.from_name("hycube", rows=4, cols=4)
    program = rual.Program.from_kernel(kname,
                                       n_banks=target.fabric.n_mem_ports)
    exe = rual.compile(program, target)
    assert exe.success, f"{kname} failed to map"
    cfg = interop.machine_config(interop.config_state(exe.map_result.config))
    return program, exe, cfg, link_config(cfg)


def _torch(linked, mems, n_iters):
    """(B, M) images through the plain version, back as (B, M)."""
    memT = torch.from_numpy(np.ascontiguousarray(mems.T))
    out = cgra_exec_torch(linked, memT, n_iters)
    assert out.dtype == torch.int32 and out.shape == memT.shape
    return out.t().numpy()


def _wrapper(linked, mems, n_iters):
    """The same through the public wrapper on a CPU tensor."""
    memT = torch.from_numpy(np.ascontiguousarray(mems.T))
    return ops.cgra_exec(ops.upload_tables(linked, "cpu"), memT,
                         n_iters).t().numpy()


def _pallas(linked, mems, n_iters):
    """The JAX package's Pallas kernel in interpret mode on the same tables
    (handed over as plain data)."""
    ref = RefLinkedConfig(**interop.linked_state(linked))
    B, M = mems.shape
    call = make_cgra_call(ref, M=M, bB=B, n_tiles=1, interpret=True)
    out = call(jnp.full((1, 1), n_iters, jnp.int32), jnp.asarray(ref.scalar),
               jnp.asarray(ref.ops), jnp.asarray(ref.regw),
               jnp.asarray(mems.T))
    return np.asarray(out).T


# ---------------------------------------------------------------------------
# the paper's kernels, mapped by the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kname", PAPER_KERNELS)
def test_plain_version_bitexact_on_paper_kernels(kname):
    program, exe, cfg, linked = _carried(kname)
    rng = np.random.default_rng(5)
    mems = program.flatten_batch([program.make_mem(rng) for _ in range(3)])
    n = program.n_iters
    got = _torch(linked, mems, n)
    np.testing.assert_array_equal(got, cgra_exec_ref(exe.map_result.config,
                                                     mems, n))
    want, _ = ref_simulate_batch(exe.lowered, mems, n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kname", ["gemm", "nw"])
def test_plain_version_bitexact_with_pallas_interpret(kname):
    program, exe, cfg, linked = _carried(kname)
    rng = np.random.default_rng(6)
    mems = program.flatten_batch([program.make_mem(rng) for _ in range(9)])
    for n in (1, program.n_iters):
        want = ref_cgra_exec_op(exe.map_result.config, mems, n,
                                interpret=True)
        np.testing.assert_array_equal(_torch(linked, mems, n), want)
        np.testing.assert_array_equal(
            ops.cgra_exec_op(cfg, mems, n, device="cpu"), want)


# ---------------------------------------------------------------------------
# hand-built tables: one semantic each
# ---------------------------------------------------------------------------

P_SMALL, R_SMALL, M_SMALL = 8, 2, 64
CORNERS = np.array([INT_MIN, INT_MIN + 1, -(1 << 16), -33, -32, -31, -1, 0,
                    1, 3, 31, 32, 33, 1 << 16, 46341, INT_MAX], np.int64)


def _table(instrs, mem_pes, II=1):
    """A LinkedConfig from ``(slot, pe, opcode, operands, const, use_const,
    t0)`` entries; an operand is ``(kind, pe, reg, dist, init)``, padded
    with zeros.  Unlisted PEs idle."""
    scalar = np.zeros((II, P_SMALL, 4), np.int32)
    optab = np.zeros((II, P_SMALL, 3, 5), np.int32)
    regw = np.zeros((II, P_SMALL, R_SMALL, 3), np.int32)
    scalar[:, :, 3] = -1
    for s, p, opc, operands, const, use_c, t0 in instrs:
        scalar[s, p] = (OPC[opc], const, use_c, t0)
        for k, o in enumerate(operands):
            optab[s, p, k] = (tuple(o) + (0, 0, 0, 0))[:5]
    return LinkedConfig(II=II, n_pes=P_SMALL, n_regs=R_SMALL,
                        mem_pes=tuple(mem_pes), scalar=scalar, ops=optab,
                        regw=regw)


def _images(rng, B):
    return rng.integers(INT_MIN, INT_MAX, size=(B, M_SMALL),
                        dtype=np.int64).astype(np.int32)


def _run_both(linked, mems, n_iters):
    """Plain version, wrapper and Pallas interpret on the same images: all
    three must agree; returns the result."""
    got = _torch(linked, mems, n_iters)
    np.testing.assert_array_equal(got, _pallas(linked, mems, n_iters))
    np.testing.assert_array_equal(_wrapper(linked, mems, n_iters), got)
    return got


def _w(x):
    return ((x + (1 << 31)) & ((1 << 32) - 1)) - (1 << 31)


#: the ALU's semantics, stated in numpy over int64 values of int32 inputs
NP_ALU = {
    "ADD": lambda a, b, c, k: _w(a + b), "SUB": lambda a, b, c, k: _w(a - b),
    "MUL": lambda a, b, c, k: _w(a * b),
    "SHL": lambda a, b, c, k: _w(a << (b & 31)),
    "SHR": lambda a, b, c, k: a >> (b & 31),
    "AND": lambda a, b, c, k: a & b, "OR": lambda a, b, c, k: a | b,
    "XOR": lambda a, b, c, k: a ^ b,
    "MIN": lambda a, b, c, k: np.minimum(a, b),
    "MAX": lambda a, b, c, k: np.maximum(a, b),
    "ABS": lambda a, b, c, k: _w(np.abs(a)),
    "CMPLT": lambda a, b, c, k: (a < b).astype(np.int64),
    "CMPGT": lambda a, b, c, k: (a > b).astype(np.int64),
    "CMPEQ": lambda a, b, c, k: (a == b).astype(np.int64),
    "CMPNE": lambda a, b, c, k: (a != b).astype(np.int64),
    "CMPLE": lambda a, b, c, k: (a <= b).astype(np.int64),
    "CMPGE": lambda a, b, c, k: (a >= b).astype(np.int64),
    "SELECT": lambda a, b, c, k: np.where(a != 0, b, c),
    "MOVC": lambda a, b, c, k: np.full_like(a, k),
    "ROUTE": lambda a, b, c, k: a,
}
N_OPERANDS = {"ABS": 1, "ROUTE": 1, "MOVC": 0, "SELECT": 3}


@pytest.mark.parametrize("opc", sorted(NP_ALU))
def test_alu_corners(opc):
    """mem[3] = r = opc(mem[0], mem[1], mem[2]) over every pair of corner
    values: wraparound of ADD/SUB/MUL/SHL, shifts by 31, 32 and negative
    amounts, ABS(INT_MIN) == INT_MIN; mem[4] = r < 0 shows that the next
    op sees the wrapped value too."""
    k = -7
    n_ops = N_OPERANDS.get(opc, 2)
    table = _table([
        (0, 0, "LOAD", [], 0, 0, 0),
        (0, 1, "LOAD", [], 1, 0, 0),
        (0, 2, "LOAD", [], 2, 0, 0),
        (0, 3, opc, [(K_O, 0), (K_O, 1), (K_O, 2)][:n_ops], k, 0, 1),
        (0, 4, "STORE", [(K_O, 3)], 3, 0, 2),
        (0, 5, "CMPLT", [(K_O, 3)], 0, 1, 2),
        (0, 6, "STORE", [(K_O, 5)], 4, 0, 3),
    ], mem_pes=(0, 1, 2, 4, 6))
    a, b = (x.reshape(-1) for x in np.meshgrid(CORNERS, CORNERS))
    rng = np.random.default_rng(1)
    mems = _images(rng, a.size)
    mems[:, 0], mems[:, 1] = a, b
    got = _run_both(table, mems, 1)
    want = mems.copy()
    want[:, 3] = NP_ALU[opc](a, b, mems[:, 2].astype(np.int64), k)
    want[:, 4] = want[:, 3] < 0
    np.testing.assert_array_equal(got, want)


def _addresses(rng, B):
    """Index words in and out of [0, M), negative, and at the int32 ends."""
    pool = np.array([INT_MIN, INT_MIN + 5, -M_SMALL, -5, -1, 0, 2, 5,
                     M_SMALL - 1, M_SMALL, M_SMALL + 1, 2 * M_SMALL,
                     INT_MAX - 3, INT_MAX], np.int64)
    return np.concatenate([pool, rng.integers(-8, M_SMALL + 8,
                                              size=B - pool.size)])


@pytest.mark.parametrize("const", [0, 7, -9, M_SMALL, INT_MIN, INT_MAX])
def test_load_addresses(const):
    """LOAD reads (has_idx ? v0 : 0) + const, int32-wrapped; an address
    outside [0, M) reads 0."""
    table = _table([
        (0, 0, "LOAD", [], 0, 0, 0),                  # idx = mem[0]
        (0, 1, "LOAD", [(K_O, 0)], const, 0, 1),      # mem[idx + const]
        (0, 2, "LOAD", [], const, 0, 1),              # mem[const]
        (0, 3, "STORE", [(K_O, 1)], 3, 0, 2),
        (0, 4, "STORE", [(K_O, 2)], 4, 0, 2),
    ], mem_pes=(0, 1, 2, 3, 4))
    rng = np.random.default_rng(2)
    mems = _images(rng, 48)
    idx = _addresses(rng, 48)
    mems[:, 0] = idx
    got = _run_both(table, mems, 1)

    def load(addr):
        ok = (addr >= 0) & (addr < M_SMALL)
        return np.where(ok, mems[np.arange(len(mems)),
                                 np.clip(addr, 0, M_SMALL - 1)], 0)

    want = mems.copy()
    want[:, 3] = load(_w(idx + const))
    want[:, 4] = load(np.full(len(mems), const))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("const", [0, 6, -3, M_SMALL, INT_MIN])
def test_store_addresses(const):
    """STORE writes v1 at v0 + const (int32-wrapped) or v0 at const; an
    address outside [0, M) drops the store; the store's PE result is the
    stored value either way."""
    table = _table([
        (0, 0, "LOAD", [], 0, 0, 0),                           # idx
        (0, 1, "LOAD", [], 1, 0, 0),                           # v
        (0, 2, "STORE", [(K_O, 0), (K_O, 1)], const, 0, 1),    # mem[idx+c]=v
        (0, 5, "STORE", [(K_O, 1)], -1, 0, 1),                 # dropped
        (0, 6, "STORE", [(K_O, 1)], M_SMALL, 0, 1),            # dropped
        (0, 3, "STORE", [(K_O, 2)], 2, 0, 2),                  # mem[2]=v
        (0, 4, "STORE", [(K_O, 5)], 3, 0, 2),                  # mem[3]=v
    ], mem_pes=(0, 1, 2, 5, 6, 3, 4))
    rng = np.random.default_rng(3)
    mems = _images(rng, 48)
    idx = _addresses(rng, 48)
    mems[:, 0] = idx
    got = _run_both(table, mems, 1)
    want = mems.copy()
    addr = _w(idx + const)
    rows = np.nonzero((addr >= 0) & (addr < M_SMALL))[0]
    want[rows, addr[rows]] = mems[rows, 1]
    want[:, 2] = mems[:, 1]
    want[:, 3] = mems[:, 1]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("store_first", [True, False])
def test_load_after_same_cycle_store(store_first):
    """Memory ops run in mem_pes order within a cycle: a load sees an
    earlier store of the same cycle, and not a later one."""
    order = (2, 3) if store_first else (3, 2)
    table = _table([
        (0, 0, "LOAD", [], 0, 0, 0),                        # idx
        (0, 1, "LOAD", [], 1, 0, 0),                        # v
        (0, 2, "STORE", [(K_O, 0), (K_O, 1)], 0, 0, 1),     # mem[idx] = v
        (0, 3, "LOAD", [(K_O, 0)], 0, 0, 1),                # mem[idx]
        (0, 4, "STORE", [(K_O, 3)], 2, 0, 2),
    ], mem_pes=(0, 1) + order + (4,))
    rng = np.random.default_rng(4)
    mems = _images(rng, 40)
    idx = np.concatenate([[-1, M_SMALL, 0, 1, 2], rng.integers(
        0, M_SMALL, size=35)])
    mems[:, 0] = idx
    got = _run_both(table, mems, 1)
    want = mems.copy()
    for lane, i in enumerate(idx):
        ok = 0 <= i < M_SMALL
        if store_first and ok:
            want[lane, i] = mems[lane, 1]
        loaded = want[lane, i] if ok else 0
        if not store_first and ok:
            want[lane, i] = mems[lane, 1]
        want[lane, 2] = loaded
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_iters", [1, 2, 5])
def test_loop_carried_init_after_late_t0(n_iters):
    """An operand with dist > 0 reads its init value for the first ``dist``
    iterations after t0 (it = floor((t - t0) / II)), then the latch."""
    table = _table([
        (0, 0, "ADD", [(K_O, 0, 0, 1, -1)], 1, 1, 2),       # i = 0, 1, ...
        (0, 1, "ADD", [(K_O, 1, 0, 2, 100)], 1, 1, 2),      # 101, 101, 102..
        (0, 2, "STORE", [(K_O, 0), (K_O, 0)], 8, 0, 3),     # mem[8+i] = i
        (0, 3, "STORE", [(K_O, 0), (K_O, 1)], 32, 0, 3),    # mem[32+i]
    ], mem_pes=(2, 3))
    mems = _images(np.random.default_rng(5), 6)
    got = _run_both(table, mems, n_iters)
    want = mems.copy()
    for k in range(n_iters):
        want[:, 8 + k] = k
        want[:, 32 + k] = 101 if k < 2 else 100 + k
    np.testing.assert_array_equal(got, want)


def test_trailing_immediate_and_const_operand():
    """use_const puts the immediate in the first absent operand slot k with
    n_ops == k; a K_CONST operand reads the immediate where it stands."""
    table = _table([
        (0, 0, "LOAD", [], 0, 0, 0),
        (0, 1, "SUB", [(K_O, 0)], 5, 1, 1),                 # a - 5
        (0, 2, "SUB", [(K_CONST,), (K_O, 0)], 5, 0, 1),     # 5 - a
        (0, 3, "SUB", [(K_NONE,), (K_O, 0)], 5, 1, 1),      # 0 - a
        (0, 4, "STORE", [(K_O, 1)], 3, 0, 2),
        (0, 5, "STORE", [(K_O, 2)], 4, 0, 2),
        (0, 6, "STORE", [(K_O, 3)], 5, 0, 2),
    ], mem_pes=(0, 4, 5, 6))
    mems = _images(np.random.default_rng(6), 16)
    mems[:4, 0] = (INT_MIN, INT_MAX, 0, 5)
    got = _run_both(table, mems, 1)
    a = mems[:, 0].astype(np.int64)
    want = mems.copy()
    want[:, 3], want[:, 4] = _w(a - 5), _w(5 - a)
    # slot 0 is absent but n_ops == 1: the immediate fills no slot
    want[:, 5] = _w(0 - a)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_iters", [1, 2, 6])
def test_edge_case_table_matches_pallas(n_iters):
    """The combined hand-built table that chip_smoke.py runs on the card."""
    linked = edge_case_config()
    mems = edge_case_images(np.random.default_rng(n_iters), 16, 256)
    got = _run_both(linked, mems, n_iters)
    assert (got != mems).any()


# ---------------------------------------------------------------------------
# the packed tables
# ---------------------------------------------------------------------------

def _source(kind, pe, reg, const, P, R):
    """Where an operand or register write of the dense tables reads."""
    if kind == K_O and 0 <= pe < P:
        return ("O", pe)
    if kind == K_R and 0 <= _w(pe * R + reg) < P * R:
        return ("R", _w(pe * R + reg))
    return ("imm", const if kind == K_CONST else 0)


def _reads(scalar, optab, regw, mem_pes):
    """What the kernel reads of dense tables, slot by slot: for each PE that
    can fire, its firing offset floor((s - t0) / II), opcode, immediate and
    the operands it reads (each a source and its loop-carried init, the
    trailing immediate placed); the memory PEs in port order with their
    index / second-operand flag; each live register write's source."""
    II, P, R = scalar.shape[0], scalar.shape[1], regw.shape[2]
    memory = (OPC["LOAD"], OPC["STORE"])
    slots = []
    for s in range(II):
        pes, mem, rws = {}, [], {}
        for p in range(P):
            opc, const, use_c, t0 = (int(v) for v in scalar[s, p])
            if opc == OPC["NOP"] or t0 < 0:
                continue
            kinds = [int(k) for k in optab[s, p, :, 0]]
            n_ops = sum(k != K_NONE for k in kinds)
            used = range(3)
            if opc in memory and p in mem_pes:
                has = kinds[int(opc == OPC["STORE"])] != K_NONE
                used = ([0] if has else []) if opc == OPC["LOAD"] else \
                    ([0, 1] if has else [0])
            operands = []
            for k in used:
                kind, pe, reg, dist, init = (int(v) for v in optab[s, p, k])
                src = _source(kind, pe, reg, const, P, R)
                if use_c and kind == K_NONE and n_ops == k:
                    src, dist = ("imm", const), 0
                operands.append((k, src, (dist, init) if dist > 0 else None))
            pes[p] = ((s - t0) // II, opc, const, tuple(operands))
        for p in mem_pes:
            opc = int(scalar[s, p, 0])
            if p in pes and opc in memory:
                store = int(opc == OPC["STORE"])
                mem.append((p, int(optab[s, p, store, 0]) != K_NONE))
        for p in range(P):
            for r in range(R):
                kind, sp, reg = (int(v) for v in regw[s, p, r])
                if kind in (K_O, K_R):
                    rws[p, r] = _source(kind, sp, reg, 0, P, R)
                elif kind == K_RESULT and sp in pes:
                    rws[p, r] = ("result", sp)
        slots.append((pes, tuple(mem), rws))
    return slots


def _packing_cases():
    return [*PAPER_KERNELS, "edge_cases", "large_state"]


def _linked_for(case):
    if case == "edge_cases":
        return edge_case_config(), 256
    if case == "large_state":
        return large_state_config(), LARGE_MIN_WORDS
    program, _, _, linked = _carried(case)
    return linked, program.layout.total_words


@pytest.mark.parametrize("case", _packing_cases())
def test_packed_tables_expand_to_the_dense_ones(case):
    """Every entry the kernel reads survives the packing: the packed form,
    expanded back, reads what the dense tables read, keeps each slot's
    memory PEs in port order, and runs to the same images."""
    linked, M = _linked_for(case)
    packed = ops.pack_tables(linked)
    scalar, optab, regw, mem_order = ops.unpack_tables(packed)
    mem_pes = tuple(linked.mem_pes)
    want = _reads(np.asarray(linked.scalar), np.asarray(linked.ops),
                  np.asarray(linked.regw), mem_pes)
    assert _reads(scalar, optab, regw, mem_pes) == want
    assert mem_order == [tuple(p for p, _ in mem) for _, mem, _ in want]
    assert packed.n_fire == max(len(pes) for pes, _, _ in want)
    assert packed.words.dtype == np.int32 and packed.words.size % 4 == 0
    expanded = LinkedConfig(II=linked.II, n_pes=linked.n_pes,
                            n_regs=linked.n_regs, mem_pes=mem_pes,
                            scalar=scalar, ops=optab, regw=regw)
    mems = edge_case_images(np.random.default_rng(7), 4, max(M, 256))[:, :M]
    for n in (1, 3):
        np.testing.assert_array_equal(_torch(expanded, mems, n),
                                      _torch(linked, mems, n))


def test_packing_keeps_port_order_and_drops_idle_entries():
    """Memory records follow ``mem_pes`` (not PE order) per slot; a
    LOAD/STORE PE off the ports and an ALU op on a port PE stay ALU
    records; NOP PEs, t0 < 0 PEs, idle register writes and K_RESULT writes
    whose source cannot fire pack to nothing."""
    table = _table([
        (0, 5, "LOAD", [(K_O, 0)], 4, 0, 0),
        (0, 1, "STORE", [(K_O, 0), (K_O, 2)], 8, 0, 0),
        (0, 3, "LOAD", [], 2, 0, 0),
        (0, 2, "ADD", [(K_O, 2)], 1, 1, 0),       # an ALU op on a port PE
        (0, 6, "STORE", [(K_O, 2)], 9, 0, 0),     # a store off the ports
        (0, 4, "LOAD", [], 3, 0, -1),             # never fires
        (1, 3, "STORE", [(K_O, 3)], 5, 0, 1),
        (1, 5, "LOAD", [], 6, 0, 1),
    ], mem_pes=(5, 3, 1, 2, 4), II=2)
    table.regw[0, 0, 1] = (K_RESULT, 2, 0)        # live
    table.regw[0, 1, 0] = (K_RESULT, 7, 0)        # source never fires
    table.regw[1, 4, 1] = (K_R, 6, 1)             # staged
    packed = ops.pack_tables(table)
    _, _, _, mem_order = ops.unpack_tables(packed)
    assert mem_order == [(5, 3, 1), (5, 3)]
    s0, s1 = packed.slot(0), packed.slot(1)
    assert [int(p) for p in s0["fire"][:, 0]] == [1, 2, 3, 5, 6]
    assert sorted(int(s0["fire"][j, 0]) for j in s0["alu"][:, 0]) == [2, 6]
    assert len(s0["rw"]) == 1 and s0["n_stage"] == 0
    assert len(s1["rw"]) == 1 and s1["n_stage"] == 1
    assert packed.n_fire == 5 and packed.n_stage == 1
    mems = _images(np.random.default_rng(8), 12)
    np.testing.assert_array_equal(_torch(LinkedConfig(
        II=2, n_pes=P_SMALL, n_regs=R_SMALL, mem_pes=table.mem_pes,
        scalar=ops.unpack_tables(packed)[0],
        ops=ops.unpack_tables(packed)[1],
        regw=ops.unpack_tables(packed)[2]), mems, 2), _run_both(table, mems, 2))


def test_launch_plan_picks_the_form_by_size():
    """The state goes to shared memory where a group's fits, the tables
    beside it where they fit too; neither size ever refuses a launch."""
    small = ops.pack_tables(edge_case_config())
    plan = ops.plan_launch(small)
    assert (plan.groups, plan.warps) == (ops.DEFAULT_GROUPS,
                                         ops.DEFAULT_WARPS)
    assert plan.state_shared and plan.tables_shared
    assert plan.smem_bytes == 4 * (small.words.size
                                   + 32 * small.state_rows)
    assert plan.lanes == 32 and plan.blocks(4096) == 128
    assert plan.blocks(33) == 2
    lane_per_thread = ops.plan_launch(small, 4, 1)
    assert lane_per_thread.lanes == 128 and lane_per_thread.state_shared
    # tables that do not fit beside the state are read from global memory
    tight = ops.plan_launch(small, budget=4 * 32 * small.state_rows + 4)
    assert tight.state_shared and not tight.tables_shared
    # fewer groups where a block's state would not fit
    assert ops.plan_launch(small, 4, 1,
                           budget=4 * 64 * small.state_rows).groups == 2
    large = ops.pack_tables(large_state_config())
    assert 4 * 32 * large.state_rows > ops.SMEM_BUDGET
    plan = ops.plan_launch(large)
    assert not plan.state_shared and plan.tables_shared
    assert plan.smem_bytes == 4 * large.words.size
    plan = ops.plan_launch(large, budget=4 * large.words.size - 4)
    assert not plan.state_shared and not plan.tables_shared
    assert plan.smem_bytes == 0
    with pytest.raises(ValueError, match="threads"):
        ops.plan_launch(small, 2, 8)
    with pytest.raises(ValueError, match="threads"):
        ops.plan_launch(small, 1, 0)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def test_wrapper_rejects_bad_arguments():
    linked = edge_case_config()
    tables = ops.upload_tables(linked, "cpu")
    good = torch.zeros((256, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        ops.cgra_exec(tables, good.long(), 1)
    with pytest.raises(ValueError, match="2-D"):
        ops.cgra_exec(tables, good[:, 0], 1)
    with pytest.raises(ValueError, match="contiguous"):
        ops.cgra_exec(tables, torch.zeros((4, 256), dtype=torch.int32).t(),
                      1)
    with pytest.raises(ValueError, match="is on meta"):
        ops.cgra_exec(tables, good.to("meta"), 1)
    with pytest.raises(ValueError, match="out of range"):
        ops.cgra_exec(tables, good, -1)
    with pytest.raises(TypeError):
        ops.cgra_exec(tables, good.numpy(), 1)
    bad = LinkedConfig(II=2, n_pes=4, n_regs=2, mem_pes=(0, 7),
                       scalar=np.zeros((2, 4, 4), np.int32),
                       ops=np.zeros((2, 4, 3, 5), np.int32),
                       regw=np.zeros((2, 4, 2, 3), np.int32))
    with pytest.raises(ValueError, match="mem_pes"):
        ops.upload_tables(bad, "cpu")
    with pytest.raises(ValueError, match="shape"):
        ops.upload_tables(LinkedConfig(
            II=2, n_pes=4, n_regs=2, mem_pes=(), scalar=bad.scalar[:1],
            ops=bad.ops, regw=bad.regw), "cpu")


def test_cpu_tensor_runs_the_plain_version_and_counts_no_launch():
    linked = edge_case_config()
    mems = edge_case_images(np.random.default_rng(0), 4, 256)
    before = ops.launches()
    np.testing.assert_array_equal(_wrapper(linked, mems, 2),
                                  _torch(linked, mems, 2))
    assert ops.launches() == before


def test_library_is_named_by_sources_flags_and_opcodes():
    """The opcode numbers reach the kernel only as -D flags taken from
    ``core.machine.OPC``, and they are part of the library's name: a
    changed opcode table can never load a stale library."""
    d = ops.defines()
    assert {k[4:]: v for k, v in d.items() if k.startswith("OPC_")} == OPC
    assert (d["K_NONE"], d["K_O"], d["K_CONST"]) == (K_NONE, K_O, K_CONST)
    path = _build.library_path("cgra_exec", ops.SOURCES, d)
    assert path.name.startswith("libcgra_exec_") and path.suffix == ".so"
    assert path == _build.library_path("cgra_exec", ops.SOURCES, dict(d))
    other = dict(d, OPC_ADD=d["OPC_ADD"] + 100)
    assert _build.library_path("cgra_exec", ops.SOURCES, other) != path
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ops.build()
    assert not list(tmp_path.glob("*.so"))


def test_wrap_i32():
    x = torch.tensor([INT_MAX + 1, INT_MIN - 1, 1 << 40, -(1 << 33) + 5, 7])
    assert wrap_i32(x).tolist() == [INT_MIN, INT_MAX, 0, 5, 7]
