"""Benchmark kernel DFGs (paper Table III / Fig. 9 workloads).

Loop bodies for fft, adpcm, aes, disparity, dct, nw and GeMM, written
against the ``DFGBuilder`` DSL (the annotated-kernel analogue).  Each entry
returns ``(dfg, make_mem(rng), n_iters)``; the DFG interpreter is the
oracle against which mapped configurations are validated, exactly like
Morpher's automated test-vector flow.

DFG sizes are chosen to be representative of the paper's kernels on a 4x4
fabric (ResMII in the 2-4 range, so routing pressure — not raw FU count —
decides II, which is what Table III measures).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

from repro_torch.core.dfg import DFG, DFGBuilder, trace_into

KernelEntry = Tuple[DFG, Callable[[np.random.Generator], Dict[str, np.ndarray]], int]

N_ITERS = 16


def _rand(rng, n, lo=-128, hi=128):
    return rng.integers(lo, hi, size=n).astype(np.int32)


# ---------------------------------------------------------------------------

def gemm() -> KernelEntry:
    """Inner-product accumulation, k-loop unrolled by 4."""
    b = DFGBuilder("gemm")
    K = 4 * N_ITERS
    b.array("A", K)
    b.array("B", K)
    b.array("C", 1, output=True)
    k = b.counter(0, 4)
    acc = b.recur(0)
    parts = []
    for u in range(4):
        idx = b.op("ADD", k, const=u)
        a = b.load("A", idx)
        bb = b.load("B", idx)
        parts.append(b.op("MUL", a, bb))
    s01 = b.op("ADD", parts[0], parts[1])
    s23 = b.op("ADD", parts[2], parts[3])
    s = b.op("ADD", s01, s23)
    acc2 = b.op("ADD", acc, s)
    b.bind(acc, acc2)
    b.store("C", 0, acc2)
    return b.build(), lambda r: {"A": _rand(r, K), "B": _rand(r, K)}, N_ITERS


def fft() -> KernelEntry:
    """Radix-2 butterfly, fixed-point (shift-scaled twiddles)."""
    b = DFGBuilder("fft")
    N = N_ITERS
    for nm in ("ar", "ai", "br", "bi", "wr", "wi"):
        b.array(nm, N)
    b.array("or0", N, output=True)
    b.array("oi0", N, output=True)
    b.array("or1", N, output=True)
    b.array("oi1", N, output=True)
    i = b.counter()
    ar, ai = b.load("ar", i), b.load("ai", i)
    br, bi = b.load("br", i), b.load("bi", i)
    wr, wi = b.load("wr", i), b.load("wi", i)
    t1 = b.op("MUL", br, wr)
    t2 = b.op("MUL", bi, wi)
    t3 = b.op("MUL", br, wi)
    t4 = b.op("MUL", bi, wr)
    tr = b.op("SHR", b.op("SUB", t1, t2), 8)
    ti = b.op("SHR", b.op("ADD", t3, t4), 8)
    b.store("or0", i, b.op("ADD", ar, tr))
    b.store("oi0", i, b.op("ADD", ai, ti))
    b.store("or1", i, b.op("SUB", ar, tr))
    b.store("oi1", i, b.op("SUB", ai, ti))
    def mk(r):
        return {nm: _rand(r, N) for nm in ("ar", "ai", "br", "bi", "wr", "wi")}
    return b.build(), mk, N


def adpcm() -> KernelEntry:
    """IMA-ADPCM decoder step: two recurrences + table lookups + clamps."""
    b = DFGBuilder("adpcm")
    N = N_ITERS
    b.array("code", N)
    b.array("steptab", 96)
    b.array("idxtab", 16)
    b.array("out", N, output=True)
    i = b.counter()
    index = b.recur(init=0)
    valpred = b.recur(init=0)
    code = b.op("AND", b.load("code", i), 15)
    step = b.load("steptab", index)
    # vpdiff = step>>3 + bits
    vp = b.op("SHR", step, 3)
    b4 = b.op("AND", code, 4)
    b2 = b.op("AND", code, 2)
    b1 = b.op("AND", code, 1)
    vp = b.op("ADD", vp, b.op("SELECT", b.op("CMPNE", b4, 0), step, 0))
    vp = b.op("ADD", vp, b.op("SELECT", b.op("CMPNE", b2, 0),
                              b.op("SHR", step, 1), 0))
    vp = b.op("ADD", vp, b.op("SELECT", b.op("CMPNE", b1, 0),
                              b.op("SHR", step, 2), 0))
    sign = b.op("AND", code, 8)
    nv = b.op("SELECT", b.op("CMPNE", sign, 0),
              b.op("SUB", valpred, vp), b.op("ADD", valpred, vp))
    nv = b.op("MAX", b.op("MIN", nv, 32767), -32768)
    didx = b.load("idxtab", code)
    nidx = b.op("MAX", b.op("MIN", b.op("ADD", index, didx), 88), 0)
    b.bind(index, nidx)
    b.bind(valpred, nv)
    b.store("out", i, nv)

    def mk(r):
        idxtab = np.array([-1, -1, -1, -1, 2, 4, 6, 8] * 2, np.int32)
        steptab = np.minimum(7 * (np.arange(96, dtype=np.int64) + 1) ** 2,
                             32767).astype(np.int32)
        return {"code": _rand(r, N, 0, 16), "steptab": steptab, "idxtab": idxtab}
    return b.build(), mk, N


def aes() -> KernelEntry:
    """SubBytes + AddRoundKey on a 32-bit word (4 sbox lookups)."""
    b = DFGBuilder("aes")
    N = N_ITERS
    b.array("state", N)
    b.array("rkey", N)
    b.array("sbox", 256)
    b.array("out", N, output=True)
    i = b.counter()
    w = b.load("state", i)
    k = b.load("rkey", i)
    bytes_out = []
    for s in range(4):
        byte = b.op("AND", b.op("SHR", w, 8 * s), 255)
        sub = b.load("sbox", byte)
        bytes_out.append(b.op("SHL", sub, 8 * s))
    w1 = b.op("OR", bytes_out[0], bytes_out[1])
    w2 = b.op("OR", bytes_out[2], bytes_out[3])
    sub_w = b.op("OR", w1, w2)
    b.store("out", i, b.op("XOR", sub_w, k))

    def mk(r):
        return {"state": _rand(r, N, 0, 1 << 30), "rkey": _rand(r, N, 0, 1 << 30),
                "sbox": _rand(r, 256, 0, 256)}
    return b.build(), mk, N


def disparity() -> KernelEntry:
    """Stereo SAD over an 8-pixel window + running argmin (two recurrences)."""
    b = DFGBuilder("disparity")
    N = N_ITERS
    W = 8
    b.array("left", N + W)
    b.array("right", N + W)
    b.array("best", 1, output=True)
    b.array("bestd", 1, output=True)
    d = b.counter()
    best = b.recur(init=1 << 20)
    bestd = b.recur(init=0)
    diffs = []
    for w in range(W):
        idx = b.op("ADD", d, const=w)
        lv = b.load("left", w)
        rr = b.load("right", idx)
        diffs.append(b.op("ABS", b.op("SUB", lv, rr)))
    while len(diffs) > 1:
        diffs = [b.op("ADD", diffs[2 * j], diffs[2 * j + 1])
                 for j in range(len(diffs) // 2)]
    sad = diffs[0]
    better = b.op("CMPLT", sad, best)
    nbest = b.op("SELECT", better, sad, best)
    nbestd = b.op("SELECT", better, d, bestd)
    b.bind(best, nbest)
    b.bind(bestd, nbestd)
    b.store("best", 0, nbest)
    b.store("bestd", 0, nbestd)
    def mk(r):
        return {"left": _rand(r, N + W, 0, 256),
                "right": _rand(r, N + W, 0, 256)}
    return b.build(), mk, N


def dct() -> KernelEntry:
    """8-point 1D DCT butterfly stage (feed-forward, wide)."""
    b = DFGBuilder("dct")
    N = N_ITERS
    b.array("x", 8 * N)
    b.array("y", 8 * N, output=True)
    i = b.counter(0, 8)
    x = [b.load("x", b.op("ADD", i, const=j)) for j in range(8)]
    s = [b.op("ADD", x[j], x[7 - j]) for j in range(4)]
    dd = [b.op("SUB", x[j], x[7 - j]) for j in range(4)]
    c = [64, 83, 36, 89, 75, 50, 18]
    y0 = b.op("SHR", b.op("MUL", b.op("ADD", b.op("ADD", s[0], s[3]),
                                      b.op("ADD", s[1], s[2])), c[0]), 7)
    y4 = b.op("SHR", b.op("MUL", b.op("SUB", b.op("ADD", s[0], s[3]),
                                      b.op("ADD", s[1], s[2])), c[0]), 7)
    y2 = b.op("SHR", b.op("ADD", b.op("MUL", b.op("SUB", s[0], s[3]), c[1]),
                          b.op("MUL", b.op("SUB", s[1], s[2]), c[2])), 7)
    y6 = b.op("SHR", b.op("SUB", b.op("MUL", b.op("SUB", s[0], s[3]), c[2]),
                          b.op("MUL", b.op("SUB", s[1], s[2]), c[1])), 7)
    y1 = b.op("SHR", b.op("ADD", b.op("MUL", dd[0], c[3]),
                          b.op("MUL", dd[1], c[4])), 7)
    y3 = b.op("SHR", b.op("ADD", b.op("MUL", dd[2], c[5]),
                          b.op("MUL", dd[3], c[6])), 7)
    y5 = b.op("SHR", b.op("SUB", b.op("MUL", dd[1], c[5]),
                          b.op("MUL", dd[3], c[3])), 7)
    y7 = b.op("SHR", b.op("SUB", b.op("MUL", dd[2], c[6]),
                          b.op("MUL", dd[0], c[2])), 7)
    for j, y in enumerate((y0, y1, y2, y3, y4, y5, y6, y7)):
        b.store("y", b.op("ADD", i, const=j), y)
    return b.build(), (lambda r: {"x": _rand(r, 8 * N)}), N


def nw() -> KernelEntry:
    """Needleman-Wunsch row sweep: tight recurrence on the left cell."""
    b = DFGBuilder("nw")
    N = N_ITERS
    b.array("above", N + 1)
    b.array("seqa", N)
    b.array("seqb", N)
    b.array("row", N, output=True)
    j = b.counter()
    left = b.recur(init=0)
    diag = b.load("above", j)
    up = b.load("above", b.op("ADD", j, const=1))
    a = b.load("seqa", j)
    bb = b.load("seqb", j)
    match = b.op("SELECT", b.op("CMPEQ", a, bb), 1, -1)
    c_diag = b.op("ADD", diag, match)
    c_up = b.op("SUB", up, 1)
    c_left = b.op("SUB", left, 1)
    score = b.op("MAX", b.op("MAX", c_diag, c_up), c_left)
    b.bind(left, score)
    b.store("row", j, score)
    def mk(r):
        return {"above": _rand(r, N + 1, -8, 8), "seqa": _rand(r, N, 0, 4),
                "seqb": _rand(r, N, 0, 4)}
    return b.build(), mk, N


def jax_poly() -> KernelEntry:
    """Traced compute kernel (exercises ``trace_into`` end-to-end).  The
    name is the JAX package's: the same polynomial, written there with
    ``jnp`` and here with torch ops, gives the same DFG and digest."""
    b = DFGBuilder("jax_poly")
    N = N_ITERS
    b.array("x", N)
    b.array("y", N, output=True)
    i = b.counter()
    x = b.load("x", i)

    def f(v):
        import torch
        p = v * v + 3 * v - 7
        q = torch.where(p > 0, p, -p)
        return torch.minimum(q, torch.tensor(1 << 20)) ^ 1023

    (out,) = trace_into(b, f, [x])
    b.store("y", i, out)
    return b.build(), (lambda r: {"x": _rand(r, N)}), N


KERNELS: Dict[str, Callable[[], KernelEntry]] = {
    "fft": fft,
    "adpcm": adpcm,
    "aes": aes,
    "disparity": disparity,
    "dct": dct,
    "nw": nw,
    "gemm": gemm,
    "jax_poly": jax_poly,
}
