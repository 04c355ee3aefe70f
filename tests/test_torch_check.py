"""The port's verifier CLI against the reference's.

``python -m repro_torch.ual.check --smoke-suite --json PATH`` and
``python -m repro.ual.check --smoke-suite --json PATH`` run as two
subprocesses, side by side, each with a cold mapping cache of its own in a
tmp dir.  Their JSON reports must be equal: the same configs, in order, and
for each the same counts, codes and diagnostics; the exit codes and the
verdict lines too.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def test_smoke_suite_findings_match_the_reference(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "REPRO_UAL_CACHE": str(tmp_path / "ref_cache"),
           "REPRO_TORCH_UAL_CACHE": str(tmp_path / "port_cache")}
    procs = {}
    for side, module in (("ref", "repro.ual.check"),
                         ("port", "repro_torch.ual.check")):
        procs[side] = subprocess.Popen(
            [sys.executable, "-m", module, "--smoke-suite", "--json",
             str(tmp_path / f"{side}.json")],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    outs = {side: p.communicate(timeout=300) for side, p in procs.items()}
    for side, p in procs.items():
        assert p.returncode == 0, outs[side][1][-2000:]
    reports = {side: json.loads((tmp_path / f"{side}.json").read_text())
               for side in procs}
    port, ref = reports["port"], reports["ref"]
    assert [c["name"] for c in port["configs"]] == \
        [c["name"] for c in ref["configs"]]
    assert len(port["configs"]) == 4        # spatial is reported as skipped
    assert port == ref
    verdicts = {side: [ln for ln in out.splitlines()
                       if ln.startswith("check:")]
                for side, (out, _) in outs.items()}
    assert verdicts["port"] == verdicts["ref"] != []
