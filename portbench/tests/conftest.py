"""The harness's CPU tests: run them with

    python -m pytest -q portbench/tests

from the root of the repository."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
