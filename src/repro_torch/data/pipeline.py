"""Deterministic, host-shardable synthetic data pipeline (the JAX package's
``data/pipeline.py``; it is numpy only, and gives the same arrays bit for
bit).

Every (step, host, data-shard) produces the same tokens regardless of how
many hosts participate — restart/elastic-resharding safe by construction:
the RNG key is a pure function of (seed, step, global example index).
A background prefetch thread keeps ``PREFETCH`` batches ready.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict

import numpy as np

from repro_torch.models.common import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    global_batch: int = 32
    seq_len: int = 256
    mask_rate: float = 0.3       # hubert masked-prediction rate


def _example(seed: int, step: int, index: int, cfg: ModelConfig,
             dc: DataConfig) -> Dict[str, np.ndarray]:
    rng = np.random.Generator(np.random.PCG64((seed, step, index)))
    if cfg.family == "hubert":
        feats = rng.normal(size=(dc.seq_len, cfg.d_model)).astype(np.float32)
        mask = rng.random(dc.seq_len) < dc.mask_rate
        targets = rng.integers(0, cfg.vocab, dc.seq_len).astype(np.int32)
        return {"features": feats, "mask": mask, "targets": targets}
    out = {"tokens": rng.integers(0, cfg.vocab, dc.seq_len + 1)
           .astype(np.int32)}
    if cfg.family == "paligemma":
        out["img_embeds"] = rng.normal(
            size=(cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    return out


def host_batch(cfg: ModelConfig, dc: DataConfig, step: int,
               host_id: int = 0, n_hosts: int = 1) -> Dict[str, np.ndarray]:
    """This host's shard of the global batch at ``step`` (stacked arrays)."""
    per_host = dc.global_batch // n_hosts
    lo = host_id * per_host
    examples = [_example(dc.seed, step, lo + i, cfg, dc)
                for i in range(per_host)]
    return {k: np.stack([e[k] for e in examples]) for k in examples[0]}


class Prefetcher:
    """Background-thread prefetch over ``host_batch``."""

    def __init__(self, cfg: ModelConfig, dc: DataConfig, start_step: int = 0,
                 host_id: int = 0, n_hosts: int = 1, depth: int = 2):
        self.cfg, self.dc = cfg, dc
        self.host_id, self.n_hosts = host_id, n_hosts
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            b = host_batch(self.cfg, self.dc, step, self.host_id,
                           self.n_hosts)
            try:
                self._q.put((step, b), timeout=1.0)
                step += 1
            except queue.Full:
                continue

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
