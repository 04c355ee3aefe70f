"""Smoke-size cells for the CPU tests: the benchmark's own cells with the
model's widths and depth and the traffic cut down so that a run takes
seconds here."""
from __future__ import annotations

import dataclasses

from portbench import harness

SMOKE_MODEL = {
    "zamba2": dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                   d_ff=128, vocab=256, shared_attn_every=2, ssm_state=16,
                   ssm_head_dim=16),
    "rwkv6": dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab=256),
}


def smoke_cell(name: str, **traffic) -> harness.Cell:
    cell = harness.resolve(harness.read_json(harness.ROOT / "BENCHMARK.json"),
                           name)
    fam = cell.config["family"]
    config = dict(cell.config, model={**cell.model, **SMOKE_MODEL[fam]})
    mix = dict(cell.traffic)
    if mix["kind"] == "train":
        mix.update(batch=2, seq_len=64, trace={"start": 0.5, "count": 2})
    else:
        mix.update(lengths={"min": 48, "ratio": 4, "n": 8}, sample=4,
                   trace={"start": 0.5, "count": 3})
    mix.update(traffic)
    return dataclasses.replace(cell, config=config, traffic=mix)
