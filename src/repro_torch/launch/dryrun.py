"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on its
production mesh (the JAX package's ``launch/dryrun.py``, in PyTorch).

Run it as a fresh process, as the reference is run::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
        --shape all --mesh single --out artifacts/dryrun_torch

For each cell it starts a ``fake`` process group of 256 (16x16) or 512
(2x16x16) ranks — this process is rank 0, and every collective returns
at once — builds the cell's sharded step (``make_sharded_train_step`` /
``make_sharded_prefill`` / ``make_sharded_decode``) on that mesh, lays
``meta`` stand-ins of its inputs out by the spec tables (no allocation:
``launch/input_specs``), and runs the step once on the ``meta`` local
shards under the cost model (``analysis/hlo_cost``).  The models take the
plain paths on ``meta`` (the kernels' plain versions), each counted as one
launch of its hand-written kernel (``analysis/kernel_cost``), so the
terms bound the program the card runs.  One JSON record a cell goes to
``<out>/<cell>.json`` with every key ``analysis/report`` reads:

  * ``compile_s``: the trace's seconds (there is no compile);
  * ``memory_analysis``: ``argument_size_in_bytes``, the exact sum of
    rank 0's local shards of the step's inputs; ``temp_size_in_bytes``,
    the peak of live intermediates during the trace; ``output_size_in_bytes``
    and ``generated_code_size_in_bytes`` 0 (not measured);
  * ``trace_cost``: the cost model's per-device FLOPs, bytes and
    collectives (the reference's ``hlo_cost``; no HLO is involved), and
    the kernel launches it counted;
  * ``dropped_axes``: every mesh axis a sharding rule left off a dimension
    it does not divide (``sharding.ctx.fit``: rule, spec, shape, the spec
    applied, count), where XLA would pad;
  * ``roofline``: ``analysis.roofline.analyze_per_device`` on H100 peaks.

A cell that fails is recorded as ``error`` with its traceback, and the run
goes on.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path

from repro_torch.analysis.hlo_cost import CostModel
from repro_torch.analysis.roofline import analyze_per_device, model_flops
from repro_torch.configs import ARCHS, FAMILIES, get_config
from repro_torch.configs.shapes import SHAPES, cell_skip_reason
from repro_torch.launch.input_specs import (batch_structs, cache_structs,
                                            opt_structs, port_params,
                                            token_structs)
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.sharding.ctx import record_drops
from repro_torch.train.optimizer import OptConfig


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 chips per pod; multi_pod adds the 2-pod axis (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def opt_for(cfg) -> OptConfig:
    # factored second moment for the very large configs (optimizer memory)
    factored = cfg.param_count() > 100e9
    return OptConfig(factored=factored)


@contextlib.contextmanager
def fake_group(n: int):
    """A ``fake`` process group of ``n`` ranks, this process rank 0, for
    the block."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry-run starts its own process group; one "
                           "is already running")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    from repro_torch.interop import lm_leaves
    total = 0
    for _, _, t in lm_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if hasattr(t, "element_size"):
            total += t.numel() * t.element_size()
    return total


def lower_cell(arch: str, shape_name, mesh: Mesh, mesh_name: str,
               overrides=None):
    """Trace one cell's step under the cost model; needs a process group of
    ``mesh.size`` ranks (``fake_group``).  ``shape_name`` names one of
    ``SHAPES`` or is a ``ShapeSpec`` of its own.  Returns (cfg, shape,
    cost, memory): the cost model's result with the trace's
    ``dropped_axes``, and the memory analysis."""
    from repro_torch.sharding.specs import (NamedSharding, distribute,
                                            is_spec, to_shardings)

    cfg = get_config(arch)
    if overrides:
        cfg = cfg.scaled(**overrides)
    shape = (SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    if shape.kind == "train":
        from repro_torch.train.train_step import make_sharded_train_step
        opt = opt_for(cfg)
        step, specs = make_sharded_train_step(cfg, opt, mesh,
                                              shape.global_batch)
        args = (port_params(cfg), opt_structs(cfg, opt),
                batch_structs(cfg, shape))
    elif shape.kind == "prefill":
        from repro_torch.serve.serve_step import make_sharded_prefill
        step, specs = make_sharded_prefill(cfg, mesh, shape.global_batch)
        args = (port_params(cfg), batch_structs(cfg, shape))
    else:  # decode
        from repro_torch.serve.serve_step import make_sharded_decode
        step, specs = make_sharded_decode(cfg, mesh, shape.global_batch)
        cache = cache_structs(cfg, shape.global_batch, shape.seq_len)
        cache["len"] = shape.seq_len - 1      # the last position's step
        args = (port_params(cfg), cache, token_structs(shape.global_batch))
    placed = [NamedSharding(mesh, s).place(a) if is_spec(s)
              else distribute(a, to_shardings(s, mesh))
              for a, s in zip(args, specs)]
    memory = {"argument_size_in_bytes": sum(_local_bytes(a)
                                            for a in placed),
              "output_size_in_bytes": 0, "generated_code_size_in_bytes": 0}
    with record_drops() as drops, CostModel() as model:
        out = step(*placed)
    del out
    cost = {**model.result(), "dropped_axes": drops}
    memory["temp_size_in_bytes"] = cost["peak_temp_bytes"]
    return cfg, shape, cost, memory


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             overrides=None, tag: str = "") -> dict:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell_id = f"{arch}__{shape_name}__{mesh_name}{tag}"
    out_path = out_dir / f"{cell_id}.json"
    skip = cell_skip_reason(FAMILIES[arch], shape_name)
    if skip:
        rec = {"cell": cell_id, "arch": arch, "shape": shape_name,
               "mesh": mesh_name, "status": "skipped", "reason": skip}
        out_path.write_text(json.dumps(rec, indent=1))
        return rec
    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        chips = mesh.size
        with fake_group(chips):
            cfg, shape, cost, mem_d = lower_cell(arch, shape_name, mesh,
                                                 mesh_name, overrides)
        mflops = model_flops(cfg, shape.kind, shape.seq_len,
                             shape.global_batch,
                             decode=(shape.kind == "decode"))
        per_dev_bytes = (mem_d["argument_size_in_bytes"]
                         + mem_d["temp_size_in_bytes"])
        res = analyze_per_device(arch, shape_name, mesh_name, chips, cost,
                                 mflops, per_dev_bytes)
        rec = {
            "cell": cell_id, "arch": arch, "shape": shape_name,
            "mesh": mesh_name, "status": "ok",
            "compile_s": time.time() - t0,
            "memory_analysis": mem_d,
            "trace_cost": {k: v for k, v in cost.items()
                           if k not in ("collectives", "top_memory",
                                        "top_collectives", "dropped_axes")},
            "dropped_axes": cost["dropped_axes"],
            "roofline": res.to_dict(),
            "overrides": overrides or {},
        }
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec = {"cell": cell_id, "arch": arch, "shape": shape_name,
               "mesh": mesh_name, "status": "error",
               "compile_s": time.time() - t0,
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:],
               "overrides": overrides or {}}
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--overrides", default=None,
                    help="JSON dict of ModelConfig overrides (perf exps)")
    ap.add_argument("--tag", default="", help="suffix for override runs")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = sorted(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    overrides = json.loads(args.overrides) if args.overrides else None
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "pod2x16x16" if mp else "pod16x16"
                cell = f"{arch}__{shape}__{mesh_name}{args.tag}"
                if args.skip_existing and (out_dir / f"{cell}.json").exists():
                    print(f"[skip-existing] {cell}", flush=True)
                    continue
                rec = run_cell(arch, shape, mp, out_dir, overrides, args.tag)
                status = rec["status"]
                extra = (f" bottleneck={rec['roofline']['bottleneck']}"
                         if status == "ok" else
                         f" reason={rec.get('reason', rec.get('error'))}")
                print(f"[{status}] {cell} ({rec.get('compile_s', 0):.0f}s)"
                      f"{extra}", flush=True)


if __name__ == "__main__":
    main()
