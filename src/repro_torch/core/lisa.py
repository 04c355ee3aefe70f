"""LISA-lite: a learned placement-bias model for the mapper (paper §III-D).

LISA [HPCA'22] replaces simulated-annealing mapping with GNN-predicted
labels that bias placement.  This is a deliberately small, fully
self-contained analogue: an MLP scores (node, PE) pairs from structural
features; it is trained with AdamW on (node -> chosen PE) pairs harvested
from successful low-II mappings of a training kernel set, and plugged into
the mapper through the ``label_fn`` hook (`ModuloMapper(label_fn=...)`),
biasing the PE ranking of the candidate enumerator on unseen kernels.

The point is the plumbing the paper calls for (a learned method swapped
into an architecture-adaptive mapper without toolchain changes), not SOTA
mapping quality.  The model is a dict of tensors (``w1``, ``b1``, ``w2``,
``b2``, the JAX package's names and shapes), so weights cross between the
two packages as numpy arrays.  ``train`` and ``make_label_fn`` run on the
card unless ``device`` says otherwise.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.adl import Fabric, MEM_OPS
from repro_torch.core.dfg import DFG
from repro_torch.core.mapper import map_dfg

N_NODE_F = 6
N_PE_F = 5


def node_features(dfg: DFG) -> np.ndarray:
    dfg.compute_asap_alap(4 * len(dfg.nodes))
    horizon = max(1, max(n.alap for n in dfg.nodes))
    rec_nodes = {nid for cyc in dfg.recurrence_cycles() for nid in cyc}
    out = np.zeros((len(dfg.nodes), N_NODE_F), np.float32)
    for n in dfg.nodes:
        out[n.id] = (
            n.asap / horizon,
            n.alap / horizon,
            float(n.op in MEM_OPS),
            len(n.operands) / 3.0,
            len(dfg.users[n.id]) / 4.0,
            float(n.id in rec_nodes),
        )
    return out


def pe_features(fabric: Fabric) -> np.ndarray:
    out = np.zeros((fabric.n_pes, N_PE_F), np.float32)
    for p in range(fabric.n_pes):
        r, c = fabric.pe_xy(p)
        out[p] = (
            r / max(1, fabric.rows - 1),
            c / max(1, fabric.cols - 1),
            float(fabric.pes[p].is_mem),
            c / max(1, fabric.cols - 1),          # distance to mem column 0
            min(r, fabric.rows - 1 - r) / max(1, fabric.rows - 1),
        )
    return out


# ---------------------------------------------------------------------------
# Model: MLP over [node_feat, pe_feat] -> score
# ---------------------------------------------------------------------------

def init_model(gen: torch.Generator, hidden: int = 32,
               device="cuda") -> Dict[str, torch.Tensor]:
    """Normal weights scaled by 1/sqrt(fan_in), zero biases, drawn from
    ``gen`` (a generator on ``device``)."""
    d_in = N_NODE_F + N_PE_F

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)
    return {
        "w1": normal(d_in, hidden) * (1.0 / d_in ** 0.5),
        "b1": torch.zeros(hidden, device=device),
        "w2": normal(hidden, 1) * (1.0 / hidden ** 0.5),
        "b2": torch.zeros(1, device=device),
    }


def model_from_arrays(arrays: Dict[str, np.ndarray],
                      device="cuda") -> Dict[str, torch.Tensor]:
    """A model from numpy arrays of its four tensors (e.g. another
    package's ``init_model``), in f32 on ``device``."""
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in arrays.items()}


def score(params, nf, pf):
    """nf: (..., N_NODE_F); pf: (..., N_PE_F) -> (...,) logits."""
    x = torch.cat([nf, pf], dim=-1)
    h = torch.relu(x @ params["w1"] + params["b1"])
    return (h @ params["w2"] + params["b2"])[..., 0]


def _pairs(params, nf, pf):
    """Logits of every (node, PE) pair: (n_nodes, n_pes)."""
    return score(params, nf[:, None, :].expand(-1, pf.shape[0], -1),
                 pf[None, :, :].expand(nf.shape[0], -1, -1))


def collect_dataset(kernels: Sequence[Tuple[DFG, int]], fabric: Fabric,
                    seed: int = 0):
    """Harvest (node_feat, chosen_pe) pairs from successful mappings."""
    pf = pe_features(fabric)
    feats, labels = [], []
    for dfg, _ in kernels:
        res = map_dfg(dfg, fabric, seed=seed)
        if not res.success:
            continue
        nf = node_features(dfg)
        for nid, (pe, _t) in res.placements.items():
            feats.append(nf[nid])
            labels.append(pe)
    return np.stack(feats), np.array(labels, np.int32), pf


#: the JAX package's optimiser settings for LISA (its ``OptConfig``): betas,
#: eps, gradient clip at global norm 1, 10 warmup steps, then a cosine from
#: lr down to 0.1 lr over the remaining steps
BETAS, EPS, GRAD_CLIP, WARMUP = (0.9, 0.95), 1e-8, 1.0, 10


def lr_factor(step: int, total_steps: int) -> float:
    """The learning-rate multiplier at update ``step`` (1-based): linear
    warmup, then a cosine to 0.1."""
    warm = min(step / max(1, WARMUP), 1.0)
    prog = min(max((step - WARMUP) / max(1, total_steps - WARMUP), 0.0), 1.0)
    return warm * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * prog)))


def train(feats: np.ndarray, labels: np.ndarray, pf: np.ndarray,
          steps: int = 300, lr: float = 1e-2, seed: int = 0,
          device="cuda"):
    """Softmax-over-PEs classification with ``torch.optim.AdamW`` (no
    weight decay) under the schedule of ``lr_factor``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = {k: v.requires_grad_() for k, v in
              init_model(gen, device=device).items()}
    opt = torch.optim.AdamW(params.values(), lr=lr, betas=BETAS, eps=EPS,
                            weight_decay=0.0)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda i: lr_factor(i + 1, steps))
    X = torch.as_tensor(feats, device=device)                 # (N, F)
    y = torch.as_tensor(labels, device=device).long()         # (N,)
    P = torch.as_tensor(pf, device=device)                    # (n_pes, PF)
    losses = []
    for _ in range(steps):
        logp = torch.log_softmax(_pairs(params, X, P), dim=-1)
        loss = -logp.gather(1, y[:, None]).mean()
        opt.zero_grad()
        loss.backward()
        torch.nn.utils.clip_grad_norm_(params.values(), GRAD_CLIP)
        opt.step()
        sched.step()
        losses.append(loss.item())
    return {k: v.detach() for k, v in params.items()}, losses


def make_label_fn(params, fabric: Fabric, weight: float = 0.5,
                  mem_only: bool = True) -> Callable[[DFG], Callable]:
    """Returns dfg -> label_fn(nid, pe, II) for ``map_dfg(label_fn=...)``.

    The bias is normalized to [0, weight) per node so it acts as a
    TIEBREAK on the mapper's proximity ranking (LISA labels guide, the
    router still decides) rather than overriding feasibility-driven
    placement.

    ``mem_only`` (measured ablation, examples/learned_mapper.py): the
    absolute-PE labels this small model learns transfer well for MEMORY
    nodes (mem-capable column structure is fabric-invariant) but mislead
    for compute nodes on unseen kernels (II 4->8 on nw even at weight
    0.2) — real LISA uses *relative* GNN labels for exactly this reason.
    Default applies the learned bias to memory nodes only, which gives
    II parity with no restart inflation on the held-out set.  The scores
    are computed on the device of ``params``.
    """
    device = params["w1"].device
    pf = torch.as_tensor(pe_features(fabric), device=device)

    def for_dfg(dfg: DFG):
        nf_np = node_features(dfg)
        with torch.no_grad():
            logits = _pairs(params, torch.as_tensor(nf_np, device=device), pf)
            p = torch.softmax(logits, -1).cpu().numpy()
        bias = weight * (1.0 - p / p.max(axis=1, keepdims=True))
        if mem_only:
            bias = bias * nf_np[:, 2:3]            # is_mem feature

        def label_fn(nid: int, pe: int, II: int) -> float:
            return float(bias[nid, pe])
        return label_fn
    return for_dfg
