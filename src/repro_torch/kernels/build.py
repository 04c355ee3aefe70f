"""Build the port's hand-written CUDA kernels at first use.

Each kernel's sources (``kernels/<name>/csrc/*.cu``) are compiled by ``nvcc``
for ``sm_90a`` into a shared library with a plain C entry point, which the
kernel's wrapper loads with ``ctypes``.  A kernel's sources may list headers
(``*.cuh``, such as the shared ``kernels/csrc/hopper.cuh``): they are hashed
with the rest, so an edited header rebuilds the library, and not compiled
on their own.  No PyTorch header is included, so a
build takes seconds, not minutes.

The library lands in ``artifacts/repro_torch/build/`` of the source checkout
(the user cache directory for an installed package), named by a hash of the
sources, the flags and the ``-D`` defines, so an edited source or a changed
opcode table builds anew and never loads a stale library.  Builds are
published with ``os.replace`` under a per-library file lock: test workers and
scripts that build the same library at the same time compile it once.

Nothing here runs at import time: this module imports no ``torch`` and
starts no compiler until a kernel is first launched on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Mapping, Sequence

#: target and flags of every kernel library (the ``a`` in sm_90a enables
#: Hopper's wgmma/setmaxnreg; ``-Xptxas -v`` puts registers, shared memory
#: and spills in the build log)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: ``nvcc`` runs this process has made (a process that found every library
#: built makes none: the cluster's respawned workers are checked by it)
compiles = 0


def build_dir() -> Path:
    """``artifacts/repro_torch/build`` in a source checkout, else the user
    cache directory (an installed package must not write into its prefix)."""
    root = Path(__file__).resolve().parents[3]
    if (root / "pyproject.toml").exists() or (root / ".git").exists():
        return root / "artifacts" / "repro_torch" / "build"
    xdg = os.environ.get("XDG_CACHE_HOME", str(Path.home() / ".cache"))
    return Path(xdg) / "repro_torch_build"


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the
    toolkit's default install location; raises when there is none."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the port's CUDA kernels are built from source at "
                       "first use")


def library_path(name: str, sources: Sequence[Path],
                 defines: Mapping[str, int]) -> Path:
    """Where the library for these sources, flags and defines lives."""
    h = hashlib.sha256()
    for part in (*NVCC_FLAGS, *_define_flags(defines)):
        h.update(part.encode() + b"\0")
    for src in sources:
        h.update(Path(src).name.encode() + b"\0" + Path(src).read_bytes())
    return build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


def _define_flags(defines: Mapping[str, int]) -> List[str]:
    return [f"-D{k}={int(v)}" for k, v in sorted(defines.items())]


def build(name: str, sources: Sequence[Path],
          defines: Mapping[str, int]) -> Path:
    """Compile ``sources`` into ``lib<name>_<hash>.so`` unless it exists;
    returns its path.  Safe against concurrent builders (file lock, atomic
    publish); raises with nvcc's output when the build fails."""
    global compiles
    out = library_path(name, sources, defines)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():                  # another process built it meanwhile
            return out
        compiles += 1
        tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}")
        cmd = [find_nvcc(), *NVCC_FLAGS, *_define_flags(defines),
               "-o", str(tmp),
               *[str(s) for s in sources if Path(s).suffix == ".cu"]]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed building {name} "
                                   f"(exit {proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{proc.stdout}"
                                   f"{proc.stderr}")
            out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            os.replace(tmp, out)
        finally:
            if tmp.exists():
                tmp.unlink()
    return out


def load(name: str, sources: Sequence[Path],
         defines: Mapping[str, int]) -> ctypes.CDLL:
    """Build the library if needed and load it (the kernel's wrapper keeps
    what it loads for the life of the process)."""
    return ctypes.CDLL(str(build(name, sources, defines)))
