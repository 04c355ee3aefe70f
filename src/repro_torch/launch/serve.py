"""Batched serving loop: prefill + greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b --smoke \
        --device cpu --requests 16 --max-new 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch paligemma-3b

Requests arrive with different prompt lengths, are left-padded into a
batch, run through the decode path token by token (which keeps the cache
semantics the same for every family), then decoded greedily.  paligemma
decodes text prompts with no image, as the reference does; hubert, an
encoder, has no decode path and is refused (it encodes through
``serve_step.prefill_fn``).  Runs on the
card unless ``--device cpu`` is given; a model whose weights do not fit the
card (arctic-480b's 960 GB in bf16 on one H100) is refused before any
weight is made.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.models.common import init_params
from repro_torch.models.lm import init_cache
from repro_torch.serve.serve_step import decode_fn


def greedy_generate(params, cfg, prompts, max_new: int, max_len: int):
    """prompts: list of 1D int arrays.  Returns (B, max_new) int32 tokens."""
    device = params["embed"].device
    B = len(prompts)
    cache = init_cache(cfg, B, max_len, device=device)
    decode = decode_fn(cfg)
    maxp = max(len(p) for p in prompts)
    padded = np.zeros((B, maxp), np.int32)
    for i, p in enumerate(prompts):
        padded[i, maxp - len(p):] = p          # left-pad
    padded = torch.from_numpy(padded).to(device)
    for t in range(maxp):
        tok, _, cache = decode(params, cache, padded[:, t:t + 1])
    out = []
    for _ in range(max_new):
        out.append(tok)
        tok, _, cache = decode(params, cache, tok)
    return torch.cat(out, dim=1).cpu().numpy()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the card)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "hubert":
        raise SystemExit("hubert is encoder-only: no decode path")
    device = torch.device(args.device)
    if device.type == "cuda":
        need = cfg.param_count() * torch.empty((), dtype=cfg.dtype).itemsize
        have = torch.cuda.get_device_properties(device).total_memory
        if need > have:
            raise SystemExit(f"{cfg.name}: {need / 1e9:.1f} GB of weights do "
                             f"not fit the card's {have / 1e9:.1f} GB; "
                             f"try --smoke")
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab, rng.integers(4, 12)).astype(np.int32)
               for _ in range(args.requests)]
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(gen, cfg, device)
    t0 = time.perf_counter()
    toks = greedy_generate(params, cfg, prompts, args.max_new,
                           max_len=64 + args.max_new)
    wall = time.perf_counter() - t0
    tput = args.requests * args.max_new / wall
    print(f"arch={cfg.name} device={device} requests={args.requests} "
          f"new={args.max_new} wall={wall:.1f}s  {tput:.1f} tok/s")
    print("sample:", toks[0][:16].tolist())
    if toks.shape != (args.requests, args.max_new):
        raise RuntimeError(f"generated {toks.shape}, expected "
                           f"{(args.requests, args.max_new)}")
    return {"tokens": toks, "wall_s": wall, "tok_s": tput}


if __name__ == "__main__":
    main()
