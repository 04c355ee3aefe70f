"""The traffic generators, seeded by the run's ``--seed`` alone.  Each
mix's parameters are a data file, ``traffic/<mix>.json``; its ``kind``
names the runner (``kinds/<kind>.py``) and the generator here.

train: the rows of training step ``step``, a frozen copy of the port's
``data.pipeline.host_batch`` for token models: row ``i`` is
``seq_len + 1`` token ids drawn by a PCG64 keyed by (seed, step, i), so
every row of every step differs.

prefill: request ``j`` is one prompt whose length is taken, in order,
from seed-shuffled passes over a fixed stratified set of lengths,
``round(min_len * ratio ** ((i + 0.5) / n))`` for i < n (a log scale), so
that every seed sends the same lengths in another order; its token ids are
drawn by a PCG64 keyed by (seed, 1, j)."""
from __future__ import annotations

import numpy as np


def train_rows(seed: int, step: int, batch: int, seq_len: int,
               vocab: int) -> np.ndarray:
    """(batch, seq_len + 1) int32 token ids of training step ``step``."""
    rows = [np.random.Generator(np.random.PCG64((seed, step, i)))
            .integers(0, vocab, seq_len + 1).astype(np.int32)
            for i in range(batch)]
    return np.stack(rows)


def prefill_lengths(mix: dict) -> list:
    """The stratified set of prompt lengths, ascending."""
    L = mix["lengths"]
    return [round(L["min"] * L["ratio"] ** ((i + 0.5) / L["n"]))
            for i in range(L["n"])]


def prefill_length(seed: int, j: int, mix: dict) -> int:
    """The length of request ``j``: position ``j mod n`` of pass
    ``j // n``, each pass a seed-drawn permutation of the set."""
    lengths = prefill_lengths(mix)
    n = len(lengths)
    order = np.random.Generator(np.random.PCG64((seed, 0, j // n))) \
        .permutation(n)
    return lengths[int(order[j % n])]


def prefill_prompt(seed: int, j: int, length: int, vocab: int) -> np.ndarray:
    """(1, length) int32 token ids of request ``j``."""
    return np.random.Generator(np.random.PCG64((seed, 1, j))) \
        .integers(0, vocab, length).astype(np.int32)[None, :]


def warm_prompt(seed: int, i: int, length: int, vocab: int) -> np.ndarray:
    """A prompt of set-up's warm-up (never served, never checked)."""
    return np.random.Generator(np.random.PCG64((seed, 2, i))) \
        .integers(0, vocab, length).astype(np.int32)[None, :]
