"""Checkpoints: npz payloads + a JSON manifest, async save, restore onto a
device (the JAX package's ``checkpoint/checkpoint.py``, in PyTorch).

Layout:  <dir>/step_<n>/manifest.json + arrays.npz, as the reference writes
it, so that a checkpoint written by either package restores in the other,
bit for bit.  Leaf keys are the reference's: dict keys and list indices
joined by ``/``, with the port's per-layer model parameters (and any tree
that mirrors them) stacked on a leading ``(L, ...)`` axis as the reference
stacks them (``interop.map_lm_tree``), and dicts in sorted key order in
the manifest.  npz cannot hold bf16 or fp8: they are stored as a
same-width unsigned view (``uint16``, ``uint8``) with the true dtype's name
in the manifest; numpy has no such dtypes, so the port goes through
``tensor.view(torch.int16)`` and needs no ``ml_dtypes``.  The manifest
records the step, the time, each leaf's shape and dtype, and ``extra``.
A step directory is published by an atomic rename; ``keep`` bounds how
many are kept.

Sharded trees: ``save`` gathers each ``DTensor`` to its full tensor (every
rank calls it, in the same order), rank 0 writes and the ranks meet at a
barrier; ``restore(..., shardings=)`` re-shards on load, as the reference's
elastic path does: each rank keeps its own shard of each stored array.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.interop import lm_groups, lm_leaves, map_lm_tree
from repro_torch.sharding.ctx import is_dtensor
from repro_torch.sharding.specs import spec_at

# npz cannot round-trip these; store them bit-exactly as a same-width integer
# view and record the true dtype in the manifest
_VIEW_ENCODE = {
    torch.bfloat16: ("bfloat16", torch.int16, np.uint16),
    torch.float8_e4m3fn: ("float8_e4m3fn", torch.int8, np.uint8),
    torch.float8_e5m2: ("float8_e5m2", torch.int8, np.uint8),
}
_VIEW_DECODE = {name: (dt, view) for dt, (name, view, _) in
                _VIEW_ENCODE.items()}


def _sharded(tree) -> bool:
    """Whether ``tree`` holds a ``DTensor`` (then every rank saves it)."""
    return any(is_dtensor(leaf) for _, _, leaf in lm_leaves(tree))


def _key(path) -> str:
    return "/".join(path)


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as (the numpy array npz stores, its dtype's name)."""
    if isinstance(leaf, torch.Tensor):
        if is_dtensor(leaf):
            leaf = leaf.full_tensor()
        t = leaf.detach().cpu()
        enc = _VIEW_ENCODE.get(t.dtype)
        if enc is not None:
            name, view, store = enc
            return t.view(view).numpy().view(store), name
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _flatten(tree) -> Dict[str, Tuple[np.ndarray, str]]:
    """Every leaf of ``tree`` on the host, by its reference key, stacked
    where the reference stacks it: key -> (array, dtype name).  A stacked
    leaf is stacked where its layers lie (on the card, one leaf at a time)
    and copied to the host once, so the host holds one copy of the tree."""
    groups = {_key(path): e for path, e in lm_groups(tree).items()}
    flat = {}
    for key in sorted(groups):
        entries = groups.pop(key)
        if entries[0][0] is None:
            flat[key] = _host(entries[0][1])
            continue
        leaves = [leaf for _, leaf in entries]
        if all(isinstance(t, torch.Tensor) for t in leaves):
            flat[key] = _host(torch.stack([t.detach() for t in leaves]))
        else:
            hosted = [_host(t) for t in leaves]
            flat[key] = (np.stack([a for a, _ in hosted]), hosted[0][1])
    return flat


def _write(ckpt_dir: str, step: int, flat, extra, keep: int) -> str:
    out = Path(ckpt_dir) / f"step_{step:08d}"
    tmp = Path(ckpt_dir) / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    np.savez(tmp / "arrays.npz", **{k: a for k, (a, _) in flat.items()})
    manifest = {
        "step": step,
        "time": time.time(),
        "leaves": {k: {"shape": list(a.shape), "dtype": name}
                   for k, (a, name) in flat.items()},
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if out.exists():
        shutil.rmtree(out)
    os.rename(tmp, out)                      # atomic publish
    _gc(ckpt_dir, keep)
    return str(out)


def save(ckpt_dir: str, step: int, tree, *, extra: Optional[dict] = None,
         keep: int = 3) -> str:
    """Write ``tree`` at ``step``; a sharded tree is gathered on every rank,
    written by rank 0, and the ranks wait for the write."""
    sharded = _sharded(tree)
    flat = _flatten(tree)
    out = str(Path(ckpt_dir) / f"step_{step:08d}")
    if not sharded or torch.distributed.get_rank() == 0:
        out = _write(ckpt_dir, step, flat, extra, keep)
    if sharded:
        torch.distributed.barrier()
    return out


def save_async(ckpt_dir: str, step: int, tree, *, extra=None,
               keep: int = 3) -> threading.Thread:
    """Snapshot to host memory synchronously, write in a background thread
    (for a sharded tree, on rank 0 only)."""
    sharded = _sharded(tree)
    flat = _flatten(tree)
    writes = not sharded or torch.distributed.get_rank() == 0
    t = threading.Thread(target=_write if writes else (lambda *a: None),
                         args=(ckpt_dir, step, flat, extra, keep),
                         daemon=True)
    t.start()
    return t


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(Path(ckpt_dir).glob("step_*"))
    for old in steps[:-keep]:
        shutil.rmtree(old)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = sorted(Path(ckpt_dir).glob("step_*"))
    return int(steps[-1].name.split("_")[1]) if steps else None


def _tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A stored array as a tensor of its true dtype (on the host)."""
    arr = np.require(arr, requirements="C")
    if dtype_name in _VIEW_DECODE:
        dt, view = _VIEW_DECODE[dtype_name]
        signed = np.int16 if view == torch.int16 else np.int8
        return torch.from_numpy(arr.view(signed)).view(dt)
    return torch.from_numpy(arr)


def _same_device(have: torch.device, want) -> bool:
    """Whether a tensor on ``have`` already lies on ``want`` (None: any;
    ``"cuda"`` means the current card)."""
    if want is None:
        return True
    want = torch.device(want)
    if want.type != have.type:
        return False
    if want.index is None and want.type == "cuda":
        return have.index == torch.cuda.current_device()
    return want.index is None or want.index == have.index


def restore(ckpt_dir: str, template, step: Optional[int] = None,
            device=None, shardings=None) -> Tuple[Any, dict]:
    """Restore into the structure of ``template`` (the port's tree: tensors
    give each leaf's dtype and device; numpy arrays and numbers come back
    as numpy).  A tensor leaf on ``device`` (default: where the template's
    leaf lies) is filled in place and returned, so a state that fills the
    card is not held twice; a leaf the template has on another device
    comes back as a new tensor on ``device``.  ``shardings`` (a tree of
    ``sharding.specs.NamedSharding`` in the reference's layout, as
    ``to_shardings`` makes it) re-shards on load: each leaf comes back a
    ``DTensor`` of its sharding, each rank holding its own shard — the
    elastic-resize path, onto a smaller or larger mesh.  Returns (tree,
    manifest)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    src = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((src / "manifest.json").read_text())
    data = np.load(src / "arrays.npz")
    counts: Dict[str, int] = {}
    for path, layer, _ in lm_leaves(template):
        if layer is not None:
            counts[_key(path)] = counts.get(_key(path), 0) + 1
    # a stacked leaf is read once and kept until its last layer is placed
    cache: Dict[str, list] = {}

    def stored(key: str, layer) -> torch.Tensor:
        if key not in cache:
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key}")
            cache[key] = [_tensor(data[key], manifest["leaves"].get(
                key, {}).get("dtype", "")), 0]
        entry = cache[key]
        entry[1] += 1
        if layer is None or entry[1] == counts[key]:
            del cache[key]
        return entry[0]

    def rebuild(path, layer, leaf):
        key = _key(path)
        arr = stored(key, layer)
        want = ((counts[key], *np.shape(leaf)) if layer is not None
                else tuple(np.shape(leaf)))
        if tuple(arr.shape) != tuple(want):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{tuple(arr.shape)} vs {tuple(want)}")
        if layer is not None:
            arr = arr[layer]
        if shardings is not None:
            where = device if device is not None else (
                leaf.device if isinstance(leaf, torch.Tensor) else "cpu")
            dtype = leaf.dtype if isinstance(leaf, torch.Tensor) else None
            return spec_at(shardings, path, layer).place(
                arr.to(device=where, dtype=dtype))
        if not isinstance(leaf, torch.Tensor):
            return arr.numpy().astype(np.asarray(leaf).dtype)
        if _same_device(leaf.device, device):
            with torch.no_grad():
                leaf.copy_(arr)
            return leaf
        return arr.to(device=device, dtype=leaf.dtype)

    tree = map_lm_tree(template, rebuild)
    return tree, manifest


__all__ = ("latest_step", "restore", "save", "save_async")
