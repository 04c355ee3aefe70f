"""``python -m repro_torch.ual.check`` — compile-time config verification CLI.

Compiles kernels through the UAL pipeline with the verify pass in
*collect* mode (``default_pipeline(strict_verify=False)``), renders the
full ``CheckReport`` for every config — including ones whose errors
would abort a strict ``ual.compile()`` — and exits non-zero when any
error-severity finding (or, with ``--fail-on-warning``, any warning)
survives.  The diagnostic-code reference lives in
``docs/diagnostics.md``; the port's verifier reports the same findings as
the JAX package's ``python -m repro.ual.check``, config by config and code
by code.  It maps on the host and runs nothing on a device.

    # one kernel on the default fabrics
    python -m repro_torch.ual.check gemm

    # the CI verifier gate: every smoke-suite config
    python -m repro_torch.ual.check --smoke-suite

    # several kernels on named fabrics, JSON artifact for tooling
    python -m repro_torch.ual.check gemm fft --fabric hycube n2n \
        --json artifacts/check.json
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

#: the configs ``benchmarks/run.py --smoke`` compiles — the CLI's
#: ``--smoke-suite`` verifies exactly this set (spatial carries no
#: machine configuration and is reported as skipped)
SMOKE_SUITE: Tuple[Tuple[str, Dict[str, object]], ...] = (
    ("hycube", {"rows": 4, "cols": 4}),
    ("n2n", {"rows": 4, "cols": 4}),
    ("pace", {}),
    ("spatial", {"rows": 4, "cols": 4}),
)

DEFAULT_FABRICS = ("hycube", "n2n")


def _targets(args) -> List[Tuple[str, Dict[str, object]]]:
    if args.smoke_suite:
        return list(SMOKE_SUITE)
    names = args.fabric or list(DEFAULT_FABRICS)
    sized = {"hycube": {"rows": 4, "cols": 4}, "n2n": {"rows": 4, "cols": 4},
             "spatial": {"rows": 4, "cols": 4}}
    return [(n, dict(sized.get(n, {}))) for n in names]


def check_configs(kernels, fabrics, cache=None) -> Tuple[List[Dict], int, int]:
    """Compile every (kernel, fabric) pair and verify it; returns
    (per-config JSON payloads, total errors, total warnings)."""
    from repro_torch import ual
    from repro_torch.ual.pipeline import default_pipeline

    payloads: List[Dict] = []
    n_err = n_warn = 0
    for fab_name, kwargs in fabrics:
        spatial_like = fab_name == "spatial"
        target = ual.Target.from_name(
            fab_name, backend="interp" if spatial_like else "sim", **kwargs)
        for kernel in kernels:
            program = ual.Program.from_kernel(
                kernel, n_banks=max(1, target.fabric.n_mem_ports))
            label = f"{kernel} @ {target.fabric.name}"
            exe = ual.compile(program, target, cache=cache,
                              pipeline=default_pipeline(strict_verify=False))
            if not exe.success:
                print(f"verify {label}: SKIPPED (mapping failed)")
                payloads.append({"name": label, "skipped": "mapping failed"})
                continue
            rep = exe.check_report
            if rep is None:
                print(f"verify {label}: SKIPPED (no machine configuration)")
                payloads.append({"name": label,
                                 "skipped": "no machine configuration"})
                continue
            print(rep.render())
            c = rep.counts()
            n_err += c["errors"]
            n_warn += c["warnings"]
            payloads.append(rep.to_json())
    return payloads, n_err, n_warn


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.ual.check",
        description="statically verify mapped CGRA configurations "
                    "(see docs/diagnostics.md for the code reference)")
    ap.add_argument("kernels", nargs="*", default=None,
                    help="kernel-library names to compile (default: gemm)")
    ap.add_argument("--fabric", nargs="+", default=None,
                    help=f"registered fabric names (default: "
                         f"{' '.join(DEFAULT_FABRICS)})")
    ap.add_argument("--smoke-suite", action="store_true",
                    help="verify exactly the configs the --smoke bench "
                         "compiles (the CI verifier gate)")
    ap.add_argument("--fail-on-warning", action="store_true",
                    help="exit non-zero on warnings too, not just errors")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the reports as a JSON artifact")
    args = ap.parse_args(argv)

    kernels = args.kernels or ["gemm"]
    payloads, n_err, n_warn = check_configs(kernels, _targets(args))

    verdict = "FAIL" if (n_err or (args.fail_on_warning and n_warn)) else "ok"
    print(f"\ncheck: {len(payloads)} config(s), {n_err} error(s), "
          f"{n_warn} warning(s) -> {verdict}")
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"configs": payloads, "errors": n_err,
                       "warnings": n_warn}, f, indent=1)
        print(f"wrote {args.json}")
    return 1 if verdict == "FAIL" else 0


if __name__ == "__main__":
    sys.exit(main())
