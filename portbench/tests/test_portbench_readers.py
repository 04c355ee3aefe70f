"""The metrics' readers on a made-up run: each reads what its definition
says, and returns nothing where it finds nothing to read."""
from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.work.peaks import PEAK_FLOPS
from portbench.work.ssd import ssd_bound, ssd_bwd_bound

BENCH = harness.read_json(harness.ROOT / "BENCHMARK.json")


def ctx(name, device="cuda"):
    cell = harness.resolve(BENCH, name)
    return SimpleNamespace(cell=cell, model=cell.model,
                           device=SimpleNamespace(type=device),
                           work=harness.family_module(cell, "work"))


def train_run(steps=10, traced=(6, 4)):
    tok = 4 * 2048
    summary = {"wall_s": 6.0, "busy_s": 4.0, "pre_units": traced[0],
               "pre_s": 11.0, "device_events": 100,
               "units": [{"tokens": tok}] * traced[1],
               "group_s": {"gemm": 0.8, "ssd": 0.2, "wkv": 0.0,
                           "flash": 0.05},
               "span_s": {"adamw": 0.6}}
    record = {"steps": steps, "tokens": steps * tok, "wall_s": 20.0,
              "units": [{"tokens": tok}] * steps, "peak_bytes": 2 ** 33,
              "batch_host_s": [0.002] * steps}
    return {"setup_s": 12.5, "record": record, "summary": summary}


def read(metric, c, run):
    return harness.metric_reader(metric)(c, run)


def test_train_readers():
    c, run = ctx("zamba2-train"), train_run()
    assert read("train_tokens_per_s", c, run) == 10 * 8192 / 20.0
    assert read("setup_s", c, run) == 12.5
    assert read("gemm_ms.train", c, run) == pytest.approx(200.0)
    assert read("adamw_ms.train", c, run) == pytest.approx(150.0)
    assert read("rest_ms.train", c, run) == pytest.approx(
        1e3 * (4.0 - 0.8 - 0.2 - 0.05 - 0.6) / 4)
    least = 54 * (ssd_bound(4, 2048, 80, 64, 64, "bfloat16")[0]
                  + ssd_bwd_bound(4, 2048, 80, 64, 64, "bfloat16")[0])
    assert read("ssd_roofline.train", c, run) == pytest.approx(
        100 * least / 1e3 / 0.05)
    assert read("wkv_roofline.train", c, run) is None
    flops = 3 * c.work.forward_flops(c.model, 4, 2048)
    # the 6 steps before the traced stretch, in 11 seconds
    assert read("mfu.train", c, run) == pytest.approx(
        100 * flops * 6 / 11.0 / PEAK_FLOPS["bfloat16"])
    assert read("idle_pct.train", c, run) == pytest.approx(
        100 * (1 - 4.0 / (4 * 8192) * (6 * 8192 / 11.0)))
    assert read("peak_mem_gib.train", c, run) == 8.0
    assert read("batch_host_ms.train", c, run) == pytest.approx(2.0)


def test_nothing_to_read_on_the_cpu():
    c, run = ctx("zamba2-train", "cpu"), train_run()
    for m in ("gemm_ms.train", "rest_ms.train", "adamw_ms.train",
              "ssd_roofline.train", "mfu.train", "idle_pct.train",
              "peak_mem_gib.train"):
        assert read(m, c, run) is None, m


def test_prefill_readers():
    c = ctx("zamba2-prefill")
    lat = [0.1 * (i + 1) for i in range(40)]
    record = {"requests": 40, "tokens": 40 * 3000, "wall_s": 12.0,
              "latency_s": lat, "lengths": [3000] * 40,
              "units": [{"tokens": 3000}] * 40}
    assert read("prefill_p95_ms", c, {"record": record}) == pytest.approx(
        1e3 * lat[37])
    assert read("prefill_tokens_per_s", c, {"record": record}) == 1e4


@pytest.mark.parametrize("name,seconds", [("zamba2-train", 4.0),
                                          ("zamba2-prefill", 1.0)])
def test_a_traced_run_profiles_from_half_the_window(name, seconds):
    import time

    import torch

    from portbench.tests.smoke import smoke_cell
    notes = {}
    out = harness.run(smoke_cell(name), 2 ** 31 + 5, seconds, True,
                      torch.device("cpu"), time.perf_counter(), notes=notes)
    s = notes["summary"]
    assert s["pre_units"] >= 1 and s["pre_s"] >= seconds / 2
    assert 1 <= len(s["units"]) <= smoke_cell(name).traffic["trace"]["count"]
    assert out["device"]["window_s"] == s["wall_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
