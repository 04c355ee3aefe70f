"""Weights from the seed, on the device, in the port's parameter layout.

A family's reference lists its leaves (``reference/<family>.py``'s
``leaves``): path, shape, initial value and dtype.  Every normal leaf is a
slice of one normal draw in the configuration's dtype (one call on the
device's generator), scaled in place; Mamba-2's ``A_log`` and ``dt_bias``
come from Mamba-2's initial ranges (A uniform over [1, 16] stratified by
head, dt log-uniform over [1e-3, 1e-1]) in two more draws; the rest are
constants.  The same seed gives the same tensors, bit for bit, so the
reference rebuilds what the program was handed."""
from __future__ import annotations

import math

import torch

#: Mamba-2's initial ranges (state-spaces/mamba, ``Mamba2``: A_init_range,
#: dt_min, dt_max)
A_RANGE, DT_RANGE = (1.0, 16.0), (1e-3, 1e-1)
#: every slice of the normal draw starts on a multiple of this many
#: elements (16-byte alignment for any dtype, with room)
ALIGN = 128


def _numel(shape) -> int:
    return math.prod(shape)


def put(tree, path, value) -> None:
    """Set ``tree``'s leaf at ``path`` (keys and list indices), making
    the dicts and lists on the way."""
    node = tree
    for k, nxt in zip(path[:-1], path[1:]):
        if isinstance(k, int):
            while len(node) <= k:
                node.append([] if isinstance(nxt, int) else {})
            node = node[k]
        else:
            node = node.setdefault(k, [] if isinstance(nxt, int) else {})
    if isinstance(path[-1], int):
        while len(node) <= path[-1]:
            node.append(None)
        node[path[-1]] = value
    else:
        node[path[-1]] = value


def build(leaves, seed: int, device, dtype):
    """The nested parameter tree (its normal leaves are views of one
    buffer)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    normal = [lf for lf in leaves if lf[2][0] == "normal"]
    sizes = [-(-_numel(lf[1]) // ALIGN) * ALIGN for lf in normal]
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    params: dict = {}
    off = 0
    for (path, shape, init, _), size in zip(normal, sizes):
        t = flat[off:off + _numel(shape)].view(shape)
        t.mul_(init[1])
        put(params, path, t)
        off += size
    for kind in ("mamba_A", "mamba_dt"):
        group = [lf for lf in leaves if lf[2][0] == kind]
        if not group:
            continue
        H = group[0][1][0]
        u = torch.rand((len(group), H), generator=gen, device=device,
                       dtype=torch.float32)
        if kind == "mamba_A":
            lo, hi = A_RANGE
            vals = torch.log(lo + (hi - lo) * (torch.arange(
                H, device=device) + u) / H)
        else:
            lo, hi = map(math.log, DT_RANGE)
            dt = torch.exp(lo + (hi - lo) * u)
            vals = dt + torch.log(-torch.expm1(-dt))    # softplus^-1(dt)
        for (path, _, _, _), row in zip(group, vals):
            put(params, path, row.clone())
    for path, shape, init, dt in leaves:
        if init[0] in ("ones", "const"):
            fill = 1.0 if init[0] == "ones" else init[1]
            put(params, path, torch.full(
                shape, fill, device=device,
                dtype=dtype if dt == "param" else torch.float32))
    return params


def at(tree, path):
    """``tree``'s leaf at ``path``."""
    for k in path:
        tree = tree[k]
    return tree
