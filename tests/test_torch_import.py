"""The PyTorch port stands alone: it imports neither ``jax`` (nor
``ml_dtypes``, which the card's machine does not have) nor the JAX package
``repro``, and importing it initialises no CUDA context.

The import check runs in a subprocess, because this test session's
conftest has already imported ``repro`` (and with it ``jax``).
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def test_import_pulls_in_no_jax_and_no_cuda():
    code = (
        "import sys, torch\n"
        "import repro_torch, repro_torch.ual, repro_torch.interop\n"
        "import repro_torch.ual.service, repro_torch.ual.faults\n"
        "import repro_torch.ual.cluster, repro_torch.ual.cluster.service\n"
        "import repro_torch.ual.cluster.supervision\n"
        "import repro_torch.ual.explore, repro_torch.ual.check\n"
        "import repro_torch.launch.mesh\n"
        "import repro_torch.core.energy, repro_torch.core.pipeline_schedule\n"
        "import repro_torch.kernels.cgra_exec.ops\n"
        "import repro_torch.kernels.cgra_exec.edge_cases\n"
        "import repro_torch.kernels.flash_attention.ops\n"
        "import repro_torch.kernels.mamba2_ssd.ops\n"
        "import repro_torch.kernels.rwkv6.ops\n"
        "import repro_torch.models.lm, repro_torch.models.rwkv6\n"
        "import repro_torch.models.moe, repro_torch.core.lisa\n"
        "import repro_torch.core.dfg, repro_torch.core.kernel_lib\n"
        "import repro_torch.configs, repro_torch.configs.shapes\n"
        "import repro_torch.serve.serve_step, repro_torch.launch.serve\n"
        "import repro_torch.train.optimizer, repro_torch.train.train_step\n"
        "import repro_torch.data.pipeline, repro_torch.checkpoint.checkpoint\n"
        "import repro_torch.runtime.fault_tolerance, repro_torch.launch.train\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro',\n"
        "                                    'ml_dtypes'))\n"
        "assert not bad, bad\n"
        "from repro_torch.launch.mesh import make_host_mesh\n"
        "assert len(make_host_mesh('cpu', 2)) == 2\n"
        "torch.cuda.device_count()\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ok', len(repro_torch.ual.list_backends()))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["ok", "6"]


def test_port_offers_every_name_of_the_reference_ual():
    import repro.ual
    import repro_torch.ual
    assert set(repro.ual.__all__) <= set(repro_torch.ual.__all__)
    assert set(repro.ual.cluster.__all__) <= set(
        repro_torch.ual.cluster.__all__)


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_repro(path):
    hits = [(name, line) for name, line in _imported_roots(path)
            if name in FORBIDDEN]
    assert not hits, f"{path.name} imports {hits}"
