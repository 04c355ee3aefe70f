"""The port's dry-run and analysis against the JAX package's.

``launch/input_specs`` against the reference's ``jax.eval_shape`` stand-ins
(every arch at its published widths, every shape), ``roofline.model_flops``
against the reference's, the cost model's product FLOPs against an
analytic count, its ring factors against the reference's ``analyze_hlo``
on hand-written HLO lines, ``analysis/report`` against the reference's on
the same records (records the port's dry-run wrote among them), and the
dry-run CLI in a subprocess with its own time limit, at reduced depth.
Whatever starts a process group runs in a subprocess, or under
``dryrun.fake_group``, which destroys it on the way out.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.analysis import report as ref_report
from repro.analysis.hlo_cost import analyze_hlo
from repro.analysis.roofline import model_flops as ref_model_flops
from repro.configs import get_config as ref_get_config
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.launch import input_specs as ref_input_specs
from repro.train.optimizer import OptConfig as RefOptConfig
from repro_torch.analysis import report
from repro_torch.analysis.hlo_cost import CostModel, wire_bytes
from repro_torch.analysis.roofline import model_flops
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.configs.shapes import SHAPES, cell_skip_reason
from repro_torch.launch import input_specs
from repro_torch.launch.dryrun import fake_group, opt_for, run_cell
from repro_torch.train.optimizer import OptConfig

ROOT = Path(__file__).resolve().parents[1]
ARCH_NAMES = sorted(ARCHS)
#: the dry-run subprocess's time limit, seconds
CLI_LIMIT = 300


def _ref_shapes(tree):
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                  for k in path): (tuple(x.shape), str(np.dtype(x.dtype)))
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _shapes(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, path + (str(k),)))
        return out
    return {path: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_match_the_reference(arch):
    """Parameters, optimizer state (factored or not, as ``opt_for``
    decides, and with the compression error state), batches, caches and
    tokens: the same leaves, shapes and dtypes as the reference's
    ``jax.eval_shape`` stand-ins, for every shape."""
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    assert _shapes(input_specs.param_structs(cfg)) == _ref_shapes(
        ref_input_specs.param_structs(rcfg))
    factored = opt_for(cfg).factored
    assert _shapes(input_specs.opt_structs(
        cfg, OptConfig(factored=factored), compress=True)) == _ref_shapes(
        ref_input_specs.opt_structs(rcfg, RefOptConfig(factored=factored),
                                    compress=True))
    for name, shape in SHAPES.items():
        ref_shape = REF_SHAPES[name]
        assert _shapes(input_specs.batch_structs(cfg, shape)) == \
            _ref_shapes(ref_input_specs.batch_structs(rcfg, ref_shape))
        assert _shapes({"t": input_specs.token_structs(
            shape.global_batch)}) == _ref_shapes(
            {"t": ref_input_specs.token_structs(shape.global_batch)})
        if cell_skip_reason(cfg.family, name) or cfg.family == "hubert":
            continue
        assert _shapes(input_specs.cache_structs(
            cfg, shape.global_batch, shape.seq_len)) == _ref_shapes(
            ref_input_specs.cache_structs(rcfg, shape.global_batch,
                                          shape.seq_len))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_match_the_reference(arch):
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    for shape in SHAPES.values():
        for decode in (False, True):
            assert model_flops(cfg, shape.kind, shape.seq_len,
                               shape.global_batch, decode) == \
                ref_model_flops(rcfg, shape.kind, shape.seq_len,
                                shape.global_batch, decode)


def test_cost_model_counts_a_dense_forwards_products():
    """qwen3-8b's smoke forward on meta tensors: the products (q, k, v, o
    projections, the gated MLP, the tied logits) as counted by hand, and
    the attention as one flash kernel launch a layer, 4 D FLOPs a causal
    (query, key) pair, not the plain blockwise version's products."""
    from repro_torch.models.common import init_params
    from repro_torch.models.lm import forward
    cfg = dataclasses.replace(smoke_config("qwen3-8b"), dtype=torch.float32)
    Bt, S = 2, 16
    params = init_params(None, cfg, "meta")
    tokens = torch.zeros((Bt, S), dtype=torch.long, device="meta")
    with CostModel() as model:
        forward(params, cfg, tokens)
    T, d, H, KV, D = Bt * S, cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd
    layer = (2 * T * d * (H + 2 * KV) * D + 2 * T * H * D * d
             + 3 * 2 * T * d * cfg.d_ff + 4 * D * Bt * H * S * (S + 1) // 2)
    want = cfg.n_layers * layer + 2 * T * d * cfg.vocab
    result = model.result()
    assert result["product_flops_per_device"] == want
    assert result["kernel_launches"] == {"flash_attention": cfg.n_layers}


KERNEL_CASES = [("bfloat16", 2, 300, 4, 2, 64, True, 0, 0),
                ("bfloat16", 1, 256, 8, 8, 80, True, 64, 0),
                ("float32", 2, 300, 4, 1, 256, True, 0, 100),
                ("float32", 1, 96, 2, 2, 32, False, 0, 0)]


@pytest.mark.parametrize("case", KERNEL_CASES)
def test_kernel_costs_are_chip_smokes_bounds(case):
    """The dry-run's count of a kernel launch (``kernel_cost``) is the
    work ``chip_smoke.py`` bounds each kernel by on the card: the same
    FLOPs and bytes for the flash kernel and its backward, the SSD and the
    WKV and their backwards, on odd lengths, GQA, a window and a
    prefix."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from repro_torch.analysis import kernel_cost as kc
    dtype, B, S, H, KV, D, causal, window, prefix = case
    dt = getattr(torch, dtype)

    def t(*shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device="meta")
    q, k = t(B, S, H, D), t(B, S, KV, D)
    got = kc.flash_cost(q, k, k, causal=causal, window=window,
                        prefix_len=prefix)
    fwd = chip_smoke.attention_bound(B, S, S, H, KV, D, dtype, causal,
                                     window, prefix)
    bwd = chip_smoke.attention_bwd_bound(B, S, H, KV, D, dtype, causal,
                                         window, prefix)
    assert got == (fwd[2], fwd[3], bwd[2], bwd[3])
    f32 = torch.float32
    P, N = D, 2 * KV
    got = kc.ssd_cost(t(B, S, H, P), t(B, S, H, dtype=f32), t(H, dtype=f32),
                      t(B, S, N), t(B, S, N), t(H, dtype=f32))
    fwd = chip_smoke.ssd_bound(B, S, H, P, N, dtype)
    bwd = chip_smoke.ssd_bwd_bound(B, S, H, P, N, dtype)
    assert got == (fwd[2], fwd[4], bwd[2], bwd[4])
    r = t(B, S, H, D)
    got = kc.wkv_cost(r, r, r, t(B, S, H, D, dtype=f32), t(H, D))
    fwd = chip_smoke.wkv_bound(B, S, H, D, dtype)
    bwd = chip_smoke.wkv_bwd_bound(B, S, H, D, dtype)
    assert got == (fwd[2], fwd[3], bwd[2], bwd[3])


RING_CASES = [("all-gather", "f32[4096]", "f32[1024]"),
              ("reduce-scatter", "f32[256]", "f32[1024]"),
              ("all-reduce", "f32[1024]", "f32[1024]"),
              ("all-to-all", "f32[1024]", "f32[1024]"),
              ("collective-permute", "f32[1024]", "f32[1024]")]


def _ref_collective(kind, out, inp):
    hlo = (f"HloModule m\n\nENTRY %main (p0: {inp}) -> {out} {{\n"
           f"  %p0 = {inp}{{0}} parameter(0)\n"
           f"  ROOT %c = {out}{{0}} {kind}({inp}{{0}} %p0), "
           f"replica_groups=[1,4]<=[4], dimensions={{0}}\n}}\n")
    return analyze_hlo(hlo)["collectives"][kind]


@pytest.mark.parametrize("kind,out,inp", RING_CASES)
def test_ring_factors_match_the_reference(kind, out, inp):
    """A collective over a group of 4: ``wire_bytes`` and the cost model's
    record of the functional collective (a fake group of 4 ranks) against
    the reference's ``analyze_hlo`` on the same HLO line."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    want = _ref_collective(kind, out, inp)
    n_in, n_out = (int(s[4:-1]) for s in (inp, out))
    assert wire_bytes(kind, 4 * n_in, 4 * n_out, 4) == want["wire_bytes"]
    if kind == "collective-permute":
        return          # DTensor issues no permute of its own
    calls = {"all-gather": lambda x, g: funcol.all_gather_tensor(x, 0, g),
             "reduce-scatter": lambda x, g: funcol.reduce_scatter_tensor(
                 x, "sum", 0, g),
             "all-reduce": lambda x, g: funcol.all_reduce(x, "sum", g),
             "all-to-all": lambda x, g: funcol.all_to_all_single(
                 x, None, None, g)}
    with fake_group(4):
        x = torch.empty(n_in, dtype=torch.float32, device="meta")
        with CostModel() as model:
            calls[kind](x, dist.group.WORLD)
    got = model.result()["collectives"][kind]
    assert (got["count"], got["operand_bytes"], got["wire_bytes"]) == (
        want["count"], want["operand_bytes"], want["wire_bytes"])


def _dryrun(tmp, *argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--out", str(tmp), *argv], env=env, cwd=tmp,
                       capture_output=True, text=True, timeout=CLI_LIMIT)
    assert p.returncode == 0, p.stderr[-4000:]
    return p.stdout


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The dry-run CLI at reduced depth in a subprocess: qwen3-8b (1
    layer) on every shape of the single-pod mesh; then, in this process,
    its decode_32k on the 2-pod mesh and rwkv6-1.6b (1 layer) at
    long_500k (batch 1: the sequence-parallel fallback)."""
    tmp = tmp_path_factory.mktemp("dryrun")
    _dryrun(tmp, "--arch", "qwen3-8b", "--shape", "all", "--mesh", "single",
            "--overrides", json.dumps({"n_layers": 1}))
    # two more cells here, each under its own fake group (run_cell starts
    # and destroys it)
    run_cell("qwen3-8b", "decode_32k", True, tmp, {"n_layers": 1})
    run_cell("rwkv6-1.6b", "long_500k", False, tmp, {"n_layers": 1})
    return tmp


def test_dryrun_cli_writes_every_cell(records):
    recs = {r["cell"]: r for r in map(json.loads, (
        f.read_text() for f in sorted(records.glob("*.json"))))}
    want = {f"qwen3-8b__{s}__pod16x16" for s in SHAPES}
    want |= {"qwen3-8b__decode_32k__pod2x16x16",
             "rwkv6-1.6b__long_500k__pod16x16"}
    assert set(recs) == want
    for cell, rec in recs.items():
        if "long_500k" in cell and cell.startswith("qwen3"):
            assert rec["status"] == "skipped"
            continue
        assert rec["status"] == "ok", rec.get("traceback")
        roof, cost = rec["roofline"], rec["trace_cost"]
        assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
        assert rec["memory_analysis"]["temp_size_in_bytes"] > 0
        assert roof["hlo_flops"] == cost["flops_per_device"] > 0
        assert roof["bottleneck"] in ("compute", "memory", "collective")
        chips = 512 if "2x16x16" in cell else 256
        shape = SHAPES[rec["shape"]]
        cfg = get_config(rec["arch"]).scaled(n_layers=1)
        assert math.isclose(roof["model_flops"], model_flops(
            cfg, shape.kind, shape.seq_len, shape.global_batch,
            shape.kind == "decode") / chips)
        assert cost["collective_wire_bytes_per_device"] > 0


def test_dryrun_counts_kernel_launches_and_dropped_axes(records):
    """Each cell's trace counts the flash kernel's launches (the train
    step's forward twice, rematerialized, and its backward once; the
    WKV's in rwkv6's decode: none) and lists every axis a rule left off a
    dimension: none in qwen3-8b's cells, and at long_500k's one-token
    sequence the data axis of the ``hidden`` and ``logits`` rules."""
    def rec(cell):
        return json.loads((records / f"{cell}.json").read_text())
    want = {"train_4k": {"flash_attention": 2, "flash_attention_bwd": 1},
            "prefill_32k": {"flash_attention": 1}, "decode_32k": {}}
    for shape, launches in want.items():
        r = rec(f"qwen3-8b__{shape}__pod16x16")
        assert r["trace_cost"]["kernel_launches"] == launches, shape
        assert r["dropped_axes"] == [], shape
    r = rec("rwkv6-1.6b__long_500k__pod16x16")
    assert r["trace_cost"]["kernel_launches"] == {}
    dropped = {(d["rule"], d["spec"], d["applied"])
               for d in r["dropped_axes"]}
    assert dropped == {
        ("hidden", "P(None, 'data', None)", "P(None, None, None)"),
        ("logits", "P(None, 'data', 'model')", "P(None, None, 'model')")}


def test_dryrun_argument_bytes_are_the_local_shards(records):
    """The prefill cell's argument bytes: each parameter's bytes over the
    devices its sanitized spec splits it across, plus the batch's."""
    from repro_torch.launch.dryrun import make_production_mesh
    from repro_torch.sharding import specs
    rec = json.loads((records / "qwen3-8b__prefill_32k__pod16x16.json")
                     .read_text())
    cfg = get_config("qwen3-8b").scaled(n_layers=1)
    mesh = make_production_mesh()
    structs = input_specs.param_structs(cfg)
    table = specs.sanitize_specs(specs.param_specs(cfg, mesh), structs, mesh)
    shape = SHAPES["prefill_32k"]

    def local(spec, t):
        split = math.prod(specs._axes_size(mesh, e) for e in spec)
        return t.numel() * t.element_size() // split
    want = sum(_leaves(specs.tree_map(local, table, structs)))
    bspecs = specs.batch_specs(cfg, mesh, shape.global_batch, "prefill")
    want += sum(local(bspecs[k], t) for k, t in
                input_specs.batch_structs(cfg, shape).items())
    assert rec["memory_analysis"]["argument_size_in_bytes"] == want


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _synthetic():
    """Records of every status and bottleneck the report distinguishes."""
    def ok(cell, mesh, bottleneck, frac, colls):
        terms = {"compute": 1.0, "memory": 1.0, "collective": 1.0}
        terms[bottleneck] = 3.0
        return {"cell": cell, "arch": cell.split("__")[0],
                "shape": cell.split("__")[1], "mesh": mesh, "status": "ok",
                "compile_s": 12.5,
                "memory_analysis": {"argument_size_in_bytes": 3 * 2**30,
                                    "temp_size_in_bytes": 2**29},
                "roofline": {"bottleneck": bottleneck,
                             "t_compute_s": terms["compute"],
                             "t_memory_s": terms["memory"],
                             "t_collective_s": terms["collective"],
                             "useful_flops_ratio": frac,
                             "roofline_fraction": frac / 3,
                             "collectives": colls}}
    return [
        ok("a__train_4k__pod16x16", "pod16x16", "compute", 0.9, {}),
        ok("a__prefill_32k__pod16x16", "pod16x16", "memory", 0.3, {}),
        ok("b__prefill_32k__pod16x16", "pod16x16", "memory", 0.7, {}),
        ok("b__decode_32k__pod16x16", "pod16x16", "collective", 0.1,
           {"all-gather": {"wire_bytes": 5.0},
            "all-reduce": {"bytes": 9.0}}),
        ok("b__decode_32k__pod2x16x16", "pod2x16x16", "memory", 0.2, {}),
        {"cell": "c__long_500k__pod16x16", "arch": "c", "shape": "long_500k",
         "mesh": "pod16x16", "status": "skipped", "reason": "encoder-only"},
        {"cell": "d__train_4k__pod16x16", "arch": "d", "shape": "train_4k",
         "mesh": "pod16x16", "status": "error", "compile_s": 1.0,
         "error": "RuntimeError: " + "x" * 80},
    ]


def test_report_matches_the_reference(records):
    """The same records — synthetic ones of every status and bottleneck,
    and the port's dry-run's — through both reports: the same tables and
    summary, but for the name of the matrix units in the compute-bound
    note."""
    for i, rec in enumerate(_synthetic()):
        # tagged as the dry-run's records are (reduced depth: overrides)
        rec["overrides"] = {"synthetic": True}
        (records / f"zz_{i}.json").write_text(json.dumps(rec))
    cells = []
    for tag in ("", "reduced"):        # skipped cells carry no overrides
        got = report.load(records, tag)
        assert got == ref_report.load(records, tag)
        cells += got
    assert len(cells) == 6 + len(_synthetic())
    unit = ("push MXU utilization", "push tensor-core utilization")
    assert report.dryrun_table(cells) == ref_report.dryrun_table(cells)
    for mesh in ("pod16x16", "pod2x16x16"):
        assert report.roofline_table(cells, mesh) == ref_report.roofline_table(
            cells, mesh).replace(*unit)
    assert report.summary(cells) == ref_report.summary(cells)
    assert unit[1] in report.roofline_table(cells)


def test_sharding_and_analysis_import_no_jax_and_no_cuda():
    """The new modules stand alone too: no jax, no JAX package, no CUDA
    context at import (a fresh process: this test process imported both)."""
    code = (
        "import sys, torch\n"
        "import repro_torch.sharding.specs, repro_torch.sharding.ctx\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.input_specs\n"
        "import repro_torch.analysis.hlo_cost, repro_torch.analysis.roofline\n"
        "import repro_torch.analysis.report, repro_torch.analysis.collectives\n"
        "import repro_torch.analysis.memprof\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["ok"]
