"""The port's traced front end against the JAX package's.

``trace_into`` walks a ``torch.fx`` graph where the reference walks a jaxpr;
written with torch ops, a function must give the reference's DFG for the
same function written with ``jnp``: the same nodes in the same order, the
same immediates, hence the same ``Program.digest`` and interpreter outputs.
Also ``jax_poly`` (the library's traced kernel), ``Program.from_function``
on the reference's own lambdas (bit-exact on the port's ``torch`` backend
against the reference's ``sim``), and LISA: features bit-equal, ``score``
and the label bias within 1e-6 on the reference's weights carried across,
and ``train`` meeting the reference test's contract (the loss falls; the
learned bias keeps nw's II).  Everything is int32 and bit-exact, but the
LISA scores (f32, 1e-6).

On a card (``cuda`` marker, skipped without one): ``from_function`` and
``jax_poly`` on the ``cuda`` backend, and LISA trained on the card.  Those
tests import nothing of JAX:

    python -m pytest -q -m cuda tests/test_torch_frontend.py
"""
import numpy as np
import pytest
import torch

from repro_torch import ual as tual
from repro_torch.core import adl, lisa
from repro_torch.core import dfg as tdfg
from repro_torch.core.kernel_lib import KERNELS
from repro_torch.core.mapper import map_dfg


@pytest.fixture(autouse=True)
def port_cache(tmp_path):
    """The port's mapping cache in a tmp dir, as the process default."""
    cache = tual.MappingCache(disk_dir=tmp_path / "port_cache")
    prev = tual.set_default_cache(cache)
    yield cache
    tual.set_default_cache(prev)


def _jnp():
    import jax.numpy as jnp
    return jnp


# (name, torch version, jnp version, number of inputs): test_core_dfg's
# function, jax_poly's, and one with neg, **, abs, shifts, comparisons,
# min/max and a literal before the traced value
def _fns():
    jnp = _jnp()
    return {
        "core_dfg": (lambda v: torch.where(v > 2, v * v - 1, v + 5) & 0xFF,
                     lambda v: jnp.where(v > 2, v * v - 1, v + 5) & 0xFF, 1),
        "jax_poly": (
            lambda v: torch.minimum(torch.where(v * v + 3 * v - 7 > 0,
                                                v * v + 3 * v - 7,
                                                -(v * v + 3 * v - 7)),
                                    torch.tensor(1 << 20)) ^ 1023,
            lambda v: jnp.minimum(jnp.where(v * v + 3 * v - 7 > 0,
                                            v * v + 3 * v - 7,
                                            -(v * v + 3 * v - 7)),
                                  1 << 20) ^ 1023, 1),
        "mixed": (
            lambda v, w: ((abs(-v) ** 2 >> 1) + (v << 2) - (w >= v) * 3
                          + torch.maximum(v, w) - (7 - w)
                          + (v != w) + (v <= 3) + (w < v) + (v == 1)
                          + torch.where(w > v, 9, w) | (v ^ w)),
            lambda v, w: ((jnp.abs(-v) ** 2 >> 1) + (v << 2) - (w >= v) * 3
                          + jnp.maximum(v, w) - (7 - w)
                          + (v != w) + (v <= 3) + (w < v) + (v == 1)
                          + jnp.where(w > v, 9, w) | (v ^ w)), 2),
        "clamp": (lambda v: torch.clamp(v, max=40) + torch.clamp(v, min=-3)
                  + torch.clamp(v, -5, 5) + torch.abs(v) + -v.to(torch.int32),
                  lambda v: jnp.minimum(v, 40) + jnp.maximum(v, -3)
                  + jnp.minimum(jnp.maximum(v, -5), 5) + jnp.abs(v) + -v, 1),
    }


def _built(mod, fn, n_inputs, n=16):
    b = mod.DFGBuilder("t")
    names = [f"x{k}" for k in range(n_inputs)]
    for a in names:
        b.array(a, n)
    b.array("y", n, output=True)
    i = b.counter()
    (o,) = mod.trace_into(b, fn, [b.load(a, i) for a in names])
    b.store("y", i, o)
    return b.build(), names


def _nodes(dfg):
    return [(n.op, [(o.src, o.dist, o.init) for o in n.operands], n.const,
             n.array) for n in dfg.nodes]


@pytest.mark.parametrize("name", ["core_dfg", "jax_poly", "mixed", "clamp"])
def test_trace_into_matches_the_jaxpr_walker(name):
    from repro.core import dfg as rdfg
    torch_fn, jnp_fn, k = _fns()[name]
    got, names = _built(tdfg, torch_fn, k)
    want, _ = _built(rdfg, jnp_fn, k)
    assert _nodes(got) == _nodes(want)
    rng = np.random.default_rng(0)
    mem = {a: rng.integers(-300, 300, 16).astype(np.int32) for a in names}
    out = tdfg.interpret(got, mem, 16)
    np.testing.assert_array_equal(out["y"], rdfg.interpret(want, mem, 16)["y"])
    # and the outputs are the function's own, evaluated by torch on int32
    xs = [torch.from_numpy(mem[a]) for a in names]
    np.testing.assert_array_equal(out["y"], torch_fn(*xs).to(torch.int32))


def test_trace_into_folds_constants_and_keeps_literal_order():
    b = tdfg.DFGBuilder("t")
    b.array("x", 4)
    x = b.load("x", 0)
    outs = tdfg.trace_into(b, lambda v: (3 * v, v - torch.tensor(2) * 4, 5),
                           [x])
    nodes = b.build().nodes
    # 3 * v: a MOVC for the leading 3, then MUL with no immediate
    assert [(n.op, n.const) for n in nodes[1:3]] == [("MOVC", 3), ("MUL", None)]
    assert nodes[outs[0].id].operands[0].src == 1
    # a tensor constant times an int folds into SUB's immediate; the
    # returned int becomes a MOVC
    assert [n.const for n in nodes if n.op == "SUB"] == [8]
    assert nodes[outs[2].id].op == "MOVC" and nodes[outs[2].id].const == 5


@pytest.mark.parametrize("fn", [lambda v: v // 2, lambda v: v * 1.5,
                                lambda v: ~v, lambda v: torch.sin(v),
                                lambda v: v ** 0, lambda v: v.abs()],
                         ids=["floordiv", "float", "invert", "sin", "pow0",
                              "method"])
def test_unsupported_ops_raise(fn):
    b = tdfg.DFGBuilder("t")
    b.array("x", 4)
    with pytest.raises(NotImplementedError):
        tdfg.trace_into(b, fn, [b.load("x", 0)])


def test_kernel_library_has_jax_poly():
    from repro.core.kernel_lib import KERNELS as REF_KERNELS
    assert list(KERNELS) == list(REF_KERNELS)
    got, _, n = KERNELS["jax_poly"]()
    want, _, n_ref = REF_KERNELS["jax_poly"]()
    assert _nodes(got) == _nodes(want) and n == n_ref


def test_jax_poly_digest_and_validate(port_cache):
    from repro import ual as rual
    target = tual.Target.from_name("hycube", rows=4, cols=4, backend="torch")
    program = tual.Program.from_kernel("jax_poly")
    assert program.digest == rual.Program.from_kernel("jax_poly").digest
    exe = tual.compile(program, target)
    rep = exe.validate(seed=0, backends=("sim", "torch"), n_vectors=8)
    assert exe.success and rep.passed, rep


# the reference's tests/test_ual.py lambdas (Python operators only)
LAMBDAS = {"traced_mul": (lambda x, y: x * y + 1, {"x": 8, "y": 8}),
           "collide": (lambda n_iters: n_iters + 1, {"n_iters": 8})}


@pytest.mark.parametrize("name", sorted(LAMBDAS))
def test_from_function_digest_and_run_match_reference_sim(name, port_cache):
    from repro import ual as rual
    from repro.core.adl import hycube as ref_hycube
    fn, inputs = LAMBDAS[name]
    tprog = tual.Program.from_function(fn, inputs, name=name)
    rprog = rual.Program.from_function(fn, inputs, name=name)
    assert tprog.digest == rprog.digest and tprog.n_iters == rprog.n_iters
    rng = np.random.default_rng(0)
    mems = [{a: rng.integers(-10, 10, n).astype(np.int32)
             for a, n in inputs.items()} for _ in range(5)]
    texe = tual.compile(tprog, tual.Target(adl.hycube(4, 4),
                                           backend="torch"))
    rexe = rual.compile(rprog, rual.Target(ref_hycube(4, 4), backend="sim"))
    got = texe.run_batch(mems)
    want = rexe.run_batch(mems)
    for g, w, mem in zip(got, want, mems):
        np.testing.assert_array_equal(g["out"], w["out"])
        args = [mem[a] for a in inputs]
        np.testing.assert_array_equal(g["out"], fn(*args))
    assert texe.validate(seed=0, backends=("torch",), n_vectors=4).passed


def test_from_function_checks_its_outputs():
    with pytest.raises(ValueError, match="declared outputs"):
        tual.Program.from_function(lambda x: (x, x + 1), {"x": 4})
    prog = tual.Program.from_function(lambda x, y: (x - y, x * y),
                                      {"x": 6, "y": 4}, outputs=("d", "p"))
    assert prog.n_iters == 4 and prog.dfg.outputs == ("d", "p")


# ---------------------------------------------------------------------------
# LISA
# ---------------------------------------------------------------------------

def _laid(mod_kernels, mod_dfg, name):
    d, _, _ = mod_kernels[name]()
    return mod_dfg.apply_layout(d, mod_dfg.plan_layout(d))


def test_lisa_features_are_bit_equal():
    from repro.core import adl as radl
    from repro.core import dfg as rdfg
    from repro.core import lisa as rlisa
    from repro.core.kernel_lib import KERNELS as REF_KERNELS
    for name in ("gemm", "nw", "fft", "jax_poly"):
        np.testing.assert_array_equal(
            lisa.node_features(_laid(KERNELS, tdfg, name)),
            rlisa.node_features(_laid(REF_KERNELS, rdfg, name)))
    for fab, rfab in ((adl.hycube(4, 4), radl.hycube(4, 4)),
                      (adl.pace(), radl.pace())):
        np.testing.assert_array_equal(lisa.pe_features(fab),
                                      rlisa.pe_features(rfab))


def test_lisa_score_and_bias_match_on_carried_weights():
    import jax
    import jax.numpy as jnp
    from repro.core import adl as radl
    from repro.core import dfg as rdfg
    from repro.core import lisa as rlisa
    from repro.core.kernel_lib import KERNELS as REF_KERNELS
    rparams = rlisa.init_model(jax.random.PRNGKey(3))
    params = lisa.model_from_arrays(
        {k: np.asarray(v) for k, v in rparams.items()}, device="cpu")
    rng = np.random.default_rng(0)
    nf = rng.random((7, lisa.N_NODE_F), np.float32)
    pf = rng.random((7, lisa.N_PE_F), np.float32)
    np.testing.assert_allclose(
        lisa.score(params, torch.from_numpy(nf), torch.from_numpy(pf)),
        rlisa.score(rparams, jnp.asarray(nf), jnp.asarray(pf)),
        atol=1e-6, rtol=1e-6)
    fab, rfab = adl.hycube(4, 4), radl.hycube(4, 4)
    for mem_only in (True, False):
        got = lisa.make_label_fn(params, fab, mem_only=mem_only)(
            _laid(KERNELS, tdfg, "nw"))
        want = rlisa.make_label_fn(rparams, rfab, mem_only=mem_only)(
            _laid(REF_KERNELS, rdfg, "nw"))
        n = len(_laid(KERNELS, tdfg, "nw").nodes)
        for nid in range(n):
            for pe in range(fab.n_pes):
                assert abs(got(nid, pe, 4) - want(nid, pe, 4)) <= 1e-6


def test_lisa_lr_schedule_matches_the_reference():
    from repro.train.optimizer import OptConfig, lr_schedule
    opt = OptConfig(lr=1.0, warmup_steps=10, total_steps=60)
    for step in (1, 5, 10, 11, 30, 60, 61):
        assert abs(lisa.lr_factor(step, 60)
                   - float(lr_schedule(opt, step))) <= 1e-6


def _lisa_contract(device):
    """The reference's tests/test_core_mapper.py LISA contract, on the
    port: trained on gemm (60 steps), the loss falls; with the mem-only
    bias, nw maps with an II no worse than without."""
    fab = adl.hycube(4, 4)
    feats, labels, pf = lisa.collect_dataset(
        [(_laid(KERNELS, tdfg, "gemm"), 0)], fab)
    params, losses = lisa.train(feats, labels, pf, steps=60, device=device)
    assert losses[-1] < losses[0]
    assert params["w1"].device.type == torch.device(device).type
    label_for = lisa.make_label_fn(params, fab, mem_only=True)
    dfg = _laid(KERNELS, tdfg, "nw")
    base = map_dfg(dfg, fab, seed=3)
    learned = map_dfg(dfg, fab, seed=3, label_fn=label_for(dfg))
    assert learned.success and learned.II <= base.II


def test_lisa_train_meets_the_reference_contract_on_cpu():
    _lisa_contract("cpu")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cgra_exec kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["traced_mul", "jax_poly"])
def test_traced_programs_on_the_cuda_backend(card, which):
    from repro_torch.kernels.cgra_exec import ops
    if which == "jax_poly":
        program = tual.Program.from_kernel("jax_poly")
    else:
        fn, inputs = LAMBDAS[which]
        program = tual.Program.from_function(fn, inputs, name=which)
    exe = tual.compile(program, tual.Target.from_name("hycube", rows=4,
                                                      cols=4))
    assert exe.target.backend == "cuda"
    before = ops.launches()
    rep = exe.validate(seed=1, backends=("cuda", "sim"), n_vectors=64)
    assert rep.passed, rep
    assert ops.launches() > before


@pytest.mark.cuda
def test_lisa_trains_on_the_card(card):
    _lisa_contract("cuda")
