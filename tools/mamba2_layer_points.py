#!/usr/bin/env python3
"""Where zamba2's first Mamba-2 layer in bf16 differs from the JAX package's.

Run from the root of a checkout, on the CPU (it imports both packages, as
the parity tests do; the port's own code imports no JAX):

    JAX_PLATFORMS=cpu python3 tools/mamba2_layer_points.py

It builds ``tests/test_torch_bf16_grads.py``'s case (the smoke config in
bf16, the reference's ``init_params(PRNGKey(0))``, the embedded inputs of
``host_batch`` 4 x 16 at step 0) and prints one JSON line per set of
points at which the reference's values are injected into the port's layer
(the input projection ``z``, softplus's ``dt``, the SSD scan's ``y``, the
output projection ``proj``): for each point and output, the elements whose
bits differ from the reference's and the first of them with both values.
Then one line for the gradient: with ``z`` and ``dt`` injected on both
sides (as inputs of the layer), the port's autograd against ``jax.vjp`` of
the reference's layer inside a one-step ``lax.scan`` (the compiled body the
model runs), on one bf16 cotangent drawn from a seed, per input.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))

POINTS = ("z", "dt", "y", "proj", "out", "conv")


def first_difference(got, want) -> dict:
    import numpy as np
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    where = np.argwhere(got != want)
    out = {"differ": int(len(where)), "of": int(got.size)}
    if len(where):
        at = tuple(int(i) for i in where[0])
        out.update(first=list(at), port=float(got[at]),
                   reference=float(want[at]))
    return out


def gradient(layer) -> dict:
    """Per input of the layer (z and dt injected), the port's gradient
    against the reference's, bit for bit."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.models import mamba2 as ref_mamba2
    from repro_torch.models import mamba2
    from test_torch_bf16_grads import _Taken, _zamba2_first_layer

    pcfg, x, p, ref = _zamba2_first_layer()
    names = ("x", "z", "dt", "conv_w", "A_log", "D", "gate_norm", "w_out")
    rng = np.random.default_rng(7)
    ct = jnp.asarray(rng.standard_normal(tuple(x.shape)).astype(np.float32)
                     ).astype(jnp.bfloat16)

    def jx(t):
        a = jnp.asarray(t.float().numpy())
        return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a
    args = [x, ref["z"], ref["dt"], *(p[k] for k in names[3:])]
    rcfg, lp = layer

    def ref_layer(x_, z, dt, conv_w, A_log, D, gate_norm, w_out):
        softplus = jax.nn.softplus
        jax.nn.softplus = lambda a: dt
        try:
            return ref_mamba2.mamba2_layer(
                x_, dict(lp, w_in=_Taken(None, z), conv_w=conv_w,
                         A_log=A_log, D=D, gate_norm=gate_norm,
                         w_out=w_out), rcfg)[0]
        finally:
            jax.nn.softplus = softplus

    def body(carry, xs):
        out, pull = jax.vjp(ref_layer, *xs)
        return carry, (out, *pull(ct))
    _, want = jax.lax.scan(body, 0, tuple(jx(a)[None] for a in args))
    want = [np.asarray(w[0], np.float32) for w in want]

    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    softplus = mamba2.F.softplus
    mamba2.F.softplus = lambda a: leaves[2]
    try:
        out = mamba2.mamba2_layer(leaves[0], dict(
            p, w_in=_Taken(None, leaves[1]),
            **dict(zip(names[3:], leaves[3:]))), pcfg)[0]
    finally:
        mamba2.F.softplus = softplus
    grads = torch.autograd.grad(out, leaves,
                                torch.from_numpy(np.asarray(
                                    ct.astype(jnp.float32))).bfloat16())
    got = [out.detach().float().numpy()] + [g.float().numpy()
                                             for g in grads]
    return {name: first_difference(g, w)
            for name, g, w in zip(("out",) + names, got, want)}


def main() -> int:
    import jax

    from repro.configs import smoke_config as ref_smoke_config
    from repro.models.common import init_params
    from test_torch_bf16_grads import _port_first_layer

    for put in ((), ("z",), ("z", "dt"), ("z", "dt", "y"),
                ("z", "dt", "y", "proj")):
        seen = {}
        ref = _port_first_layer(set(put), seen)
        print(json.dumps({"injected": list(put), "points": {
            name: first_difference(seen[name].float().detach().numpy(),
                                   ref[name].float().numpy())
            for name in POINTS if name not in put}}), flush=True)
    import jax.numpy as jnp
    rcfg = ref_smoke_config("zamba2-2.7b").scaled(dtype=jnp.bfloat16)
    lp = jax.tree.map(lambda w: w[0],
                      init_params(jax.random.PRNGKey(0), rcfg)["mamba"])
    print(json.dumps({"injected": ["z", "dt"],
                      "gradient": gradient((rcfg, lp))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
