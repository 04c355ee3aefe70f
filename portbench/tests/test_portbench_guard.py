"""The import guard and the refusals: no JAX, no JAX package, no card, no
port."""
import ast
import shutil
import subprocess
import sys

from portbench import guard, harness


def test_guard_names_jax_and_the_jax_package():
    mods = ["repro", "repro.core.adl", "jax", "jax.numpy", "jaxlib.xla",
            "flax", "repro_torch", "repro_torch.models.lm", "reprox",
            "numpy", "jaxtyping"]
    assert guard.foreign(mods) == ["flax", "jax", "jax.numpy", "jaxlib.xla",
                                   "repro", "repro.core.adl"]
    assert guard.foreign(["repro_torch", "repro_torch.ual"]) == []


def test_the_harness_loads_no_jax_module():
    code = ("import sys; sys.path[:0] = ['src', '.']\n"
            "from portbench import harness, guard, faults, mixes, weights\n"
            "from portbench.kinds import train, prefill\n"
            "import repro_torch.train.train_step, "
            "repro_torch.serve.serve_step\n"
            "print(guard.foreign())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_program():
    for path in (harness.HERE / "reference").glob("*.py"):
        names = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names |= {a.name for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                names.add(node.module or "")
        tops = {n.split(".", 1)[0] for n in names}
        assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
        assert tops <= {"__future__", "contextlib", "math", "torch",
                        "portbench"}, (path.name, tops)


def _run(cwd, *extra):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "zamba2-train", "--seed", str(2 ** 31 + 9),
                           "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_no_result_without_a_card():
    out = _run(harness.ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_no_result_without_the_port(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    assert "repro_torch" in out.stderr
