#!/usr/bin/env python3
"""How far the port's bf16 gradients lie from the JAX package's, beside how
far the JAX package's own move when one weight moves by one bf16 ulp.

Run from the root of a checkout, on the CPU (it imports both packages, as
the parity tests do; the port's own code imports no JAX):

    JAX_PLATFORMS=cpu python3 tools/bf16_grad_sensitivity.py [ARCH ...]

For each architecture (default zamba2-2.7b and hubert-xlarge) it builds
``tests/test_torch_train.py``'s case: the smoke config in bf16, the
reference's ``init_params(PRNGKey(0))`` carried into the port, the
``host_batch`` of B 4 x 16 at step 0, and ``make_loss_and_grad`` with 1
and 2 microbatches in both packages.  It prints one JSON line a case: per
leaf with an element outside the tests' bound (5e-2 + 5e-2 |want|), the
count of such elements and the largest ratio of the difference to the
bound; then, for the reference alone, the same count between its
gradient and its gradient after one element of one weight (a Mamba-2 or
MLP input projection; three indices) is scaled by 1 + 2^-7, about one
bf16 ulp.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

TOL = 5e-2


def outside(got, want) -> dict:
    """Leaf -> [elements outside the bound, largest difference / bound]."""
    import jax
    import numpy as np
    out = {}
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(got)[0],
            jax.tree_util.tree_flatten_with_path(want)[0]):
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        ratio = np.abs(a - b) / (TOL + TOL * np.abs(b))
        if (ratio > 1).any():
            out[jax.tree_util.keystr(path)] = [int((ratio > 1).sum()),
                                               float(ratio.max())]
    return out


def main(argv=None) -> int:
    archs = (argv if argv is not None else sys.argv[1:]) or [
        "zamba2-2.7b", "hubert-xlarge"]
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.configs import smoke_config as ref_smoke_config
    from repro.models.common import init_params as ref_init_params
    from repro.train import train_step as ref_ts
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.interop import lm_params_from_state, lm_state_from_params
    from repro_torch.train.train_step import make_loss_and_grad

    for arch in archs:
        rcfg = ref_smoke_config(arch).scaled(dtype=jnp.bfloat16)
        rparams = jax.tree.map(np.asarray,
                               ref_init_params(jax.random.PRNGKey(0), rcfg))
        pcfg = smoke_config(arch).scaled(dtype=torch.bfloat16)
        arrs = host_batch(pcfg, DataConfig(global_batch=4, seq_len=16), 0)
        rbatch = {k: jnp.asarray(v) for k, v in arrs.items()}
        batch = {k: torch.from_numpy(v) for k, v in arrs.items()}
        for n_micro in (1, 2):
            params = lm_params_from_state(rparams, pcfg, "cpu")
            _, _, grads = make_loss_and_grad(pcfg, n_micro)(params, batch)
            _, _, rgrads = ref_ts.make_loss_and_grad(rcfg, n_micro)(
                jax.tree.map(jnp.asarray, rparams), rbatch)
            print(json.dumps({"arch": arch, "microbatches": n_micro,
                              "port_vs_reference": outside(
                                  lm_state_from_params(grads), rgrads)}),
                  flush=True)
        grad = jax.jit(ref_ts.make_loss_and_grad(rcfg, 1))
        _, _, base = grad(jax.tree.map(jnp.asarray, rparams), rbatch)
        group, leaf = (("mamba", "w_in") if "mamba" in rparams
                       else ("mlp", "w_up"))
        for index in (0, 1234, 5000):
            bumped = jax.tree.map(np.array, rparams)
            w = bumped[group][leaf].reshape(-1)
            w[index] = (w[index].astype(np.float32)
                        * (1 + 2.0 ** -7)).astype(w.dtype)
            _, _, moved = grad(jax.tree.map(jnp.asarray, bumped), rbatch)
            print(json.dumps({"arch": arch, "bumped": f"{group}.{leaf}",
                              "index": index,
                              "reference_vs_itself": outside(moved, base)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
