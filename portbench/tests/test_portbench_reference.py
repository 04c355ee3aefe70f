"""The plain reference agrees with the port at a smoke size on the CPU, in
float32: logits, loss, and every gradient leaf."""
import math

import pytest
import torch

from portbench import weights
from portbench.reference import common, rwkv6, zamba2
from portbench.tests.smoke import SMOKE_MODEL

REFS = {"zamba2": zamba2, "rwkv6": rwkv6}


def port_config(fam, m):
    from repro_torch.models.common import ModelConfig
    m = dict(m, dtype=torch.float32)
    return ModelConfig(name="smoke", family=fam, **m)


def model(fam):
    base = {"zamba2": dict(ssm_conv=4, mlp_act="silu", rope_theta=10000.0,
                           tie_embeddings=True),
            "rwkv6": dict(mlp_act="silu", tie_embeddings=True)}[fam]
    return {**base, **SMOKE_MODEL[fam]}


@pytest.mark.parametrize("fam", ["zamba2", "rwkv6"])
def test_reference_matches_the_port(fam):
    from repro_torch.interop import lm_leaves
    from repro_torch.models.lm import forward
    from repro_torch.train.train_step import make_loss_and_grad
    m = model(fam)
    ref = REFS[fam]
    cfg = port_config(fam, m)
    params = weights.build(ref.leaves(m), 2 ** 31 + 5, "cpu", torch.float32)
    tokens = torch.randint(0, m["vocab"], (2, 97),
                           generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got = forward(params, cfg, tokens[:, :-1])[0]
        want = ref.forward(params, m, tokens[:, :-1])
    assert float((got - want).norm() / want.norm()) < 1e-4
    loss_p, _, grads = make_loss_and_grad(cfg)(params, {"tokens": tokens})
    paths = [lf[0] for lf in ref.leaves(m)]
    live = [weights.at(params, p).clone().requires_grad_(True)
            for p in paths]
    tree = {}
    for p, t in zip(paths, live):
        weights.put(tree, p, t)
    loss_r = common.lm_loss(ref.forward(tree, m, tokens[:, :-1]),
                            tokens[:, 1:])
    assert math.isclose(float(loss_p), float(loss_r.detach()), rel_tol=1e-5)
    g_ref = torch.autograd.grad(loss_r, live)
    by_key = {}
    for path, layer, g in lm_leaves(grads):
        by_key[("/".join(path), layer)] = g
    assert len(by_key) == len(paths)
    for p, gr in zip(paths, g_ref):
        key = ref.stacked_key(p)
        layer = p[1] if p[0] == "layers" else (0 if p[0] == "shared"
                                               else None)
        gp = by_key[(key, layer)]
        err = float((gp - gr).norm() / gr.norm().clamp_min(1e-12))
        assert err < 1e-3, (p, err)


def test_loss_matches_the_ports_lm_loss():
    from repro_torch.configs import smoke_config
    from repro_torch.models import lm
    logits = torch.randn(2, 5, 11, generator=torch.Generator().manual_seed(0))
    targets = torch.randint(0, 11, (2, 5))
    want = common.lm_loss(logits, targets)
    logz = torch.logsumexp(logits, -1)
    nll = logz - logits.gather(-1, targets[..., None])[..., 0]
    assert torch.allclose(want, nll.mean() + 1e-4 * logz.square().mean())
    assert lm is not None and smoke_config("rwkv6-1.6b").family == "rwkv6"
