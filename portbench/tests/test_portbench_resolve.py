"""Cells, configurations, traffic mixes, limits and metrics resolve by
name, and a new mix added as files is found without editing any file."""
import json
import shutil

import pytest

from portbench import harness, mixes

BENCH = harness.read_json(harness.ROOT / "BENCHMARK.json")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(name):
    cell = harness.resolve(BENCH, name)
    assert cell.config["name"] == cell.entry["config"]
    held = {k for k, v in cell.limits.items() if isinstance(v, float)}
    assert held and held <= set(harness.kind_module(cell).NAMES)
    for part in ("reference", "work"):
        assert harness.family_module(cell, part)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.metric_reader(metric))


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    layers = {m["layer"] for m in BENCH["per_layer"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert all(m["moves"] in e2e for m in BENCH["per_layer"])
    assert layers <= {"train loop", "model", "optimizer", "kernels",
                      "whole step", "device", "serve step"}
    for c in BENCH["configs"]:
        assert (harness.ROOT / c["file"]).is_file()


def test_a_new_mix_is_found_from_new_files_only(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    mix = json.loads((tmp_path / "portbench/traffic/train.json").read_text())
    mix.update(batch=1, seq_len=16384)
    (tmp_path / "portbench/traffic/train-long.json").write_text(
        json.dumps(mix))
    (tmp_path / "portbench/limits/zamba2-train-long.json").write_text(
        (tmp_path / "portbench/limits/zamba2-train.json").read_text())
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "zamba2-train-long",
                               "config": "zamba2-2.7b",
                               "traffic": "train-long", "chips": 1,
                               "why": "one long sequence"})
    cell = harness.resolve(bench, "zamba2-train-long",
                           pkg=tmp_path / "portbench")
    assert cell.traffic["seq_len"] == 16384
    assert cell.traffic["kind"] == "train"
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]


def test_train_rows_are_the_ports_host_batch():
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import DataConfig, host_batch
    cfg = smoke_config("zamba2-2.7b")
    seed = 2 ** 31 + 12345
    want = host_batch(cfg, DataConfig(seed=seed, global_batch=3, seq_len=40),
                      5)["tokens"]
    assert (mixes.train_rows(seed, 5, 3, 40, cfg.vocab) == want).all()


def test_prefill_lengths_are_the_same_set_for_every_seed():
    mix = harness.read_json(harness.HERE / "traffic/prefill.json")
    lengths = mixes.prefill_lengths(mix)
    assert 1024 <= lengths[0] < 1100
    assert max(lengths) <= 8192 and len(set(lengths)) == 64
    for seed in (1, 2 ** 33 + 7):
        first = [mixes.prefill_length(seed, j, mix) for j in range(64)]
        assert sorted(first) == lengths
