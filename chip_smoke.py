#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py [--seed N]

It builds the hand-written kernels from the checkout's sources (one nvcc
each, side by side), holds each against its plain PyTorch version on the
card, drives the port's paths through the user's entry points and times
the kernels.  The execution path: ``ual.compile`` ->
``Executable.validate`` / ``run_batch`` on the ``cuda`` backend at the sizes
the paper's users run (the benchmark kernels on HyCUBE 4x4 and PACE 8x8, an
8192-word scratchpad, batches of 4096 test vectors), then ``run_stream``,
the execution ``Service`` (``submit`` and ``submit_stream``) and its circuit
breaker on the same backend, the sharded engine (``cuda_sharded``), the
process cluster (``ClusterService``, with a worker killed and respawned),
the design-space front end (``explore``) and the traced front end
(``Program.from_function``, ``jax_poly``, LISA).  The serving paths:
qwen3-8b (36 layers), zamba2-2.7b (54 Mamba-2 layers and 9 applications
of the shared attention block), rwkv6-1.6b (24 RWKV-6 blocks) and
deepseek-moe-16b (28 layers of 64 routed experts top-6 and 2 shared) at
their published widths, random weights from the seed (zamba2's per-head
decay from Mamba-2's initial ranges), through ``prefill_fn`` and
``greedy_generate``.  The training paths: h2o-danube-1.8b whole (24
layers), zamba2-2.7b whole (54 Mamba-2 layers) and rwkv6-1.6b whole (24
blocks) through ``launch.train.main``, the gradients of attention, the
SSD and the WKV in their hand-written backward kernels.
Each phase prints one JSON line:

  device           the card's name and power limit (``nvidia-smi``), versions
  build            per kernel: build time, ptxas resource lines (for
                   cgra_exec per form, and the shared memory of its two
                   hand-built tables' launches), and the count of HGMMA
                   (wgmma), HMMA (mma.sync) and FFMA instructions in each
                   kernel's SASS (cuobjdump)
  kernel_vs_plain  cgra_exec per pair: kernel vs plain version, bit-exact at
                   B = 1, 129 and 4096, the launch's form; the hand-built
                   edge-case table, and the large-state table whose state
                   only global memory holds
  kernel_vs_reference  per pair: 4 lanes vs the scalar reference simulator
  main_path        per pair: validate vs the interp oracle, run_batch(4096)
                   vs the sim backend and one launch, throughput, traces,
                   launches
  timing           per pair: kernel and plain ms per launch at B = 1, 128 and
                   4096, the bound, the form and geometry of the launch
  geometry         gemm on HyCUBE: ms per launch at B = 128 and 4096 for
                   each geometry (one lane per thread, 32 lanes x W warps)
  breakdown        gemm on HyCUBE: run_batch(4096) on the host clock, its
                   block split into staging in (flattened straight into the
                   pinned buffer), device wait and unflatten, the array
                   path beside it; device time by kind (copies each way,
                   kernel, transposes) and idle share (torch.profiler);
                   every host copy pinned (checked)
  stream           gemm on HyCUBE and on PACE: run_stream of 16384 vectors,
                   bit-exact vs sim, no new trace, 4 launches (checked);
                   overlap_frac, wall, samples/s; the same stream profiled:
                   pinned copies, and copies overlapping a kernel or an
                   opposite copy on the device timeline (checked);
                   --stream-repeats N runs the phase N times
  service          Service on cuda, four tenant classes (gemm, fft, nw on
                   HyCUBE, gemm on PACE), 8 client threads x 8192 requests
                   and a fifth tenant's submit_stream of 16384: outputs vs
                   sim, all completed, no error, no reject, no sweep
                   degraded, launches >= sweeps, traces <= buckets
                   (checked); p50/p99, samples/s, mean batch, spans
  breaker          three injected cuda sweep faults: degraded_to sim x 4
                   then cuda, one trip, one restore, the restoring request
                   launched cgra_exec, outputs vs sim (checked)
  sharded          gemm on HyCUBE and PACE, run_batch of 4096 and 4097 on
                   cuda_sharded (every card, one block plan): vs sim, the
                   engine and n_devices (= the card count), one launch a
                   device a block, traces <= buckets (checked); wall
  cluster          ClusterService(workers=2) on cuda, a fresh cache dir,
                   the service phase's four classes, 8 client threads x
                   4096 requests in all: vs sim, every future resolved, no
                   error, reject, degraded batch or trip, each class mapped
                   once cluster-wide, every worker on cgra_exec-cuda with
                   launches (checked); p50/p99, samples/s, routing, and per
                   worker: mean batch, launches, start-up, pinned and device
                   memory
  cluster_heal     the same load with worker 0 killed (os._exit) at its
                   65th request: every future resolved, retries >= 1, one
                   death and one restart, the respawned worker answering
                   4 requests a class with no mapping and no nvcc run, vs
                   sim (checked); death to rejoin
  dse              explore(gemm) over HyCUBE 4x4, N2N 4x4 and PACE x the
                   built-in strategies x seeds 0, 1 with 4 forked mappers
                   after CUDA is initialised: each unique key mapped once, a
                   second sweep all cache hits, every Pareto point validated
                   on cuda against interp (checked); wall
  traced           per program (x * y + 1 and test_core_dfg's function
                   through Program.from_function, and jax_poly) and fabric
                   (HyCUBE 4x4, PACE 8x8): the reference's digest, validate
                   on cuda and sim against interp, run_batch(4096) in one
                   launch equal to sim (checked); compile s, wall
  lisa             LISA trained on the card (60 steps on gemm), nw mapped
                   with the mem-only learned bias: the loss falls and the
                   II is no worse (checked); train s cold and warm
  flash_attention  per case (bf16: the tensor-core form; f32: the CUDA-core
                   form): the kernel vs its plain version (per element
                   2e-3 + 2e-3 |want| in f32, 2e-3 + 1e-2 |want| in bf16),
                   a planted fault (one KV tile dropped) that the bound
                   must catch, kernel, plain and SDPA ms, the bound
  flash_bwd        per case (causal, window, prefix-LM with a prefix inside
                   a tile, full; GQA and MQA; D = 64, 80, 128, 256; ragged;
                   bf16: the tensor-core form; f32: the CUDA-core form):
                   the backward kernel's dQ, dK and dV vs its plain version
                   under the same bounds, three planted faults that must
                   exceed them (one KV tile left out of dQ; the D term left
                   out; the prefix ignored), kernel, plain and
                   SDPA-backward ms, the bound; two calls at danube's shape
                   bit-identical; HGMMA in the bf16 product kernels' SASS
                   and no ptxas spill in the bf16 form (checked)
  ssd              per case (bf16: the tensor-core form; f32: the
                   CUDA-core form): the Mamba-2 SSD kernel vs its plain
                   version (the same per-element bounds) on steps whose state
                   carries across chunks, two planted faults (the state
                   dropped at one chunk boundary; the carried state's decay
                   left out of every update) that the bound must catch,
                   kernel and plain ms, the bound
  wkv              per case (bf16: the tensor-core form, chunks of 64;
                   f32: the CUDA-core form, chunks of 32): the RWKV-6 WKV
                   kernel vs its plain version (the same per-element bounds)
                   on decays of the model's own slow range, under which the
                   state carries across chunks, three planted faults (the
                   state dropped at one boundary of the form's chunks; its
                   decayed term left out of every update; the u bonus left
                   out) that the bound must catch, kernel and plain ms, the
                   bound; then one ``geometry`` line per geometry of the
                   bf16 form: ms at rwkv6-1.6b's prefill shape at B = 2 and
                   B = 1, and at B = 2 with every log_w at the model's clamp
                   (the diagonal sub-blocks per (t, i, d)), each checked
                   against the plain version
  ssd_bwd          per case (zamba2's training shape in bf16 and f32, a
                   ragged length, a small shape; B and C views of one
                   tensor; bf16 on the chunk-parallel tensor-core form,
                   f32 on the CUDA-core form): the SSD backward kernel's
                   six gradients vs its plain version (``ssd_bwd_torch``)
                   under the same per-element bounds, four planted faults
                   that must exceed them (the carried dS dropped at the
                   middle chunk; the decay term of dcum_L left out; dD
                   left out; one head's dcb left out of dB's and dC's sum
                   over the heads), kernel and plain ms, the bound; two
                   calls at zamba2's shape bit-identical; HGMMA in the
                   bf16 form's product kernels' SASS
  wkv_bwd          the same for the WKV backward kernel's five gradients
                   (rwkv6-1.6b's training shape in bf16 and f32, a ragged
                   length with r, k, v views of one tensor, every log_w at
                   the clamp, a small head; bf16 on the chunk-parallel
                   tensor-core form, f32 on the CUDA-core form; the faults:
                   the carried dS, the decay term (not at the clamp, where
                   nothing carries), du, one off-diagonal sub-block's pairs
                   left out of dr's and dk's sums over E); two calls at
                   rwkv6-1.6b's shape bit-identical; HGMMA in the bf16
                   form's product kernels' SASS and no ptxas spill in the
                   bf16 form (checked)
  lm_prefill       per model, in bf16, B = 2 x 2048 tokens: wall ms, kernel
                   launches, peak memory; the kernel path vs the plain
                   path in f32 (checked; deepseek-moe-16b on its first 8
                   layers, F32_LAYERS) and in bf16, each vs the f32 model
                   (printed); for the MoE model its aux loss, the (token,
                   choice) pairs each layer drops at capacity factor 1.25,
                   and the f32 kernel and plain paths' routing decisions
                   that differ (printed)
  lm_serve         per model, greedy_generate, 4 requests x 16 new tokens:
                   tok/s, ms per decode step, decode path vs prefill
                   (checked in f32; the MoE model at its dropless capacity
                   factor n_experts / top_k)
  lm_breakdown     per model, prefill and decode under torch.profiler;
                   for training, a step's gradient part and its AdamW
                   update (device ms by group)
  lm_train         h2o-danube-1.8b: the f32 check on its first 4 layers at
                   B = 2 x 2048 (the loss and every gradient of the kernel
                   path vs the plain path within 2e-3 relative L2; 2
                   microbatches vs 1), then ``launch.train.main`` on the
                   whole model in bf16, B = 4 x 2048, 6 steps checkpointed
                   every 3 and resumed to 8 (48 forward and 24 backward
                   flash launches a step, finite losses, the restored
                   state bit for bit the saved one; step ms, tokens/s,
                   peak memory), one ``--compress`` step and one
                   factored-AdamW step (checked); then zamba2-2.7b and
                   rwkv6-1.6b: the f32 check on their first 6 (one group
                   of Mamba-2 layers and the shared block; Mamba-2's
                   initial decays) and 4 layers at B = 2 x 2048 (every
                   gradient leaf within 2e-3 relative L2 of the plain path;
                   A_log, D, dt_bias, conv_w, w_in, and u, ww, w_bias, mix
                   nonzero in every layer), then ``launch.train.main`` on
                   the whole model in bf16, B = 4 x 2048, 4 steps (finite
                   losses; launches a step: 108 SSD forward, 54 backward, 9
                   flash each way; 48 WKV forward, 24 backward; step ms,
                   tokens/s, peak memory) and a step's device time by group
  sharded_lm       the sharded entry points on a one-card (1, 1)
                   data,model mesh (a one-rank NCCL group), bf16, full
                   width, each against its unsharded step on the same
                   parameters: make_sharded_prefill of qwen3-8b,
                   zamba2-2.7b, rwkv6-1.6b (B = 2 x 2048; launches
                   checked: 36 flash; 9 flash and 54 SSD; 24 WKV),
                   make_sharded_decode of qwen3-8b (4 requests x 16 new
                   tokens, equal to greedy_generate's), one
                   make_sharded_train_step of h2o-danube-1.8b (B = 4 x
                   2048; 48 forward and 24 backward flash launches): the
                   largest difference (bound 5e-2, checked), sharded and
                   unsharded ms (median of 3 warm calls)
  dryrun           python -m repro_torch.launch.dryrun --arch qwen3-8b
                   --shape all --mesh single in a subprocess: every
                   non-skipped cell ok (checked), report.summary
  dryrun_roofline  the traced roofline of sharded_lm's qwen3-8b prefill
                   shape on a (1, 1) mesh beside its measured ms, and
                   model_flops / (measured s x 989e12)
  kernels          the summary line of every kernel (cgra_exec's launches
                   by path: run_batch, stream, service, breaker, sharded,
                   cluster and cluster_heal from the workers' engines, dse,
                   traced; flash_attention's, mamba2_ssd's and rwkv6's:
                   serving, training, sharded (sharded_lm); the flash
                   backward's training and sharded, the other two
                   backward kernels' from training)

The raw ``nvidia-smi`` line comes next, and the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
without that line; so does a machine without a CUDA device, or a directory
that holds this script and nothing else of the repo.  It imports nothing of
JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: (kernel, fabric, fabric kwargs) of the smoke set: the paper's kernels on
#: HyCUBE 4x4 and PACE 8x8 (dct is left out: it takes minutes to map)
PAIRS = ([(k, "hycube", {"rows": 4, "cols": 4})
          for k in ("gemm", "fft", "aes", "nw", "adpcm", "disparity")]
         + [(k, "pace", {}) for k in ("gemm", "fft", "nw")])
BATCH = 4096
#: the batch sizes each pair's kernel is checked and timed at
CHECK_B, TIME_B = (1, 129, BATCH), (1, 128, BATCH)
#: (groups of 32 lanes, warps a group) the geometry phase times: one lane
#: per thread (128 and 32 lanes a block), and 32 lanes x 2, 4, 8 warps
GEOMETRIES = ((4, 1), (1, 1), (1, 2), (1, 4), (1, 8))
#: H100 SXM peaks (NVIDIA data sheet; Hopper white paper for the int32
#: lanes): HBM3 bytes/s, and 132 SMs x 64 INT32 lanes x 1.98 GHz
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core FLOP/s, and
#: f32 FLOP/s without the tensor cores (the f32 kernel runs in full f32)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
#: (name, B, S, H, KV, D, dtype, causal, window, prefix_len) of the
#: flash-attention phase: qwen3-8b's attention at B = 1 and at the main
#: path's B = 2 (in bf16 and f32), danube-1.8b's width and 4096-token window
#: at S = 8192, an encoder's full attention, a ragged length, f32 at D = 64,
#: zamba2's shared attention (MHA, D = 80), deepseek-moe-16b's (MHA, 16
#: heads of 128), paligemma-3b's (MQA, 8 heads of 256, prefix-LM over its
#: 256 image tokens before 2048 text tokens; bf16 and f32) and
#: hubert-xlarge's (MHA, 16 heads of 80, full) at their prefill shapes, and
#: a prefix that ends inside a tile at a ragged length
FLASH_CASES = [
    ("qwen3-8b", 1, 2048, 32, 8, 128, "bfloat16", True, 0, 0),
    ("qwen3-8b-prefill", 2, 2048, 32, 8, 128, "bfloat16", True, 0, 0),
    ("qwen3-8b-prefill-f32", 2, 2048, 32, 8, 128, "float32", True, 0, 0),
    ("danube-window", 1, 8192, 32, 8, 80, "bfloat16", True, 4096, 0),
    ("non-causal", 1, 1024, 32, 8, 128, "bfloat16", False, 0, 0),
    ("ragged", 1, 200, 32, 8, 128, "bfloat16", True, 0, 0),
    ("f32-d64", 2, 512, 8, 2, 64, "float32", True, 0, 0),
    ("zamba2-prefill", 2, 2048, 32, 32, 80, "bfloat16", True, 0, 0),
    ("deepseek-moe-prefill", 2, 2048, 16, 16, 128, "bfloat16", True, 0, 0),
    ("paligemma-prefill", 2, 2304, 8, 1, 256, "bfloat16", True, 0, 256),
    ("paligemma-prefill-f32", 2, 2304, 8, 1, 256, "float32", True, 0, 256),
    ("hubert-prefill", 2, 2048, 16, 16, 80, "bfloat16", False, 0, 0),
    ("ragged-prefix", 1, 300, 8, 2, 128, "bfloat16", True, 0, 100),
]
#: a float kernel (flash_attention, mamba2_ssd, rwkv6) against its plain
#: version, per element |got - want| <= atol + rtol * |want|.  f32: the
#: reference's 2e-3 (tests/test_kernels.py).  bf16: each kernel's f32 result
#: agrees with the plain one's before the one rounding to bf16 (flash
#: attention's to about 1e-5: its P enters P V as two bf16 terms, 16 bits),
#: so the two differ by at most one bf16 ulp, 2^-7 |want| < 1e-2 |want|
KERNEL_TOL = {"bfloat16": (2e-3, 1e-2), "float32": (2e-3, 2e-3)}
#: the planted fault each case must be caught at: the kernel's last block of
#: FAULT_ROWS query rows skips the first tile of FAULT_TILE keys it sees
FAULT_ROWS, FAULT_TILE = 64, 32
#: (name, B, S, H, P, N, dtype, decay) of the SSD phase: zamba2's prefill
#: (B = 2, S = 2048, 80 heads of 64, state 64) in bf16 and f32, at B = 1, at
#: a ragged length, a small shape with P != N, and the prefill shape with
#: every head in Mamba-2's slow-decay ranges (``ssd_inputs``)
SSD_CASES = [
    ("zamba2-prefill", 2, 2048, 80, 64, 64, "bfloat16", "mixed"),
    ("zamba2-B1", 1, 2048, 80, 64, 64, "bfloat16", "mixed"),
    ("zamba2-prefill-f32", 2, 2048, 80, 64, 64, "float32", "mixed"),
    ("ragged", 2, 2000, 80, 64, 64, "bfloat16", "mixed"),
    ("small-p32-n16", 3, 200, 8, 32, 16, "float32", "mixed"),
    ("zamba2-slow-decay", 2, 2048, 80, 64, 64, "bfloat16", "slow"),
]
#: Mamba-2's initial ranges (state-spaces/mamba, ``Mamba2``: A_init_range,
#: dt_min, dt_max): A in [1, 16], dt log-uniform in [1e-3, 1e-1]
A_RANGE, DT_RANGE = (1.0, 16.0), (1e-3, 1e-1)
#: (name, B, S, H, K, dtype, decay) of the WKV phase: rwkv6-1.6b's prefill
#: (B = 2, S = 2048, 32 heads of 64) in bf16 and f32, at B = 1, at a ragged
#: length, a small head, and the prefill shape with every channel slow
#: (``wkv_inputs``)
WKV_CASES = [
    ("rwkv6-prefill", 2, 2048, 32, 64, "bfloat16", "mixed"),
    ("rwkv6-B1", 1, 2048, 32, 64, "bfloat16", "mixed"),
    ("rwkv6-prefill-f32", 2, 2048, 32, 64, "float32", "mixed"),
    ("ragged", 2, 2000, 32, 64, "bfloat16", "mixed"),
    ("small-k16", 3, 200, 8, 16, "float32", "mixed"),
    ("rwkv6-slow-decay", 2, 2048, 32, 64, "bfloat16", "slow"),
]
#: the serving phases: each model at full width, B = 2 prompts of 2048
#: tokens (paligemma's behind PREFILL_IMAGE image tokens; hubert's 2048
#: frames of features), 4 requests x 16 new tokens (hubert: none, an
#: encoder)
LM_ARCHS = ("qwen3-8b", "zamba2-2.7b", "rwkv6-1.6b", "deepseek-moe-16b",
            "paligemma-3b", "hubert-xlarge")
#: depth of the f32 checks where an f32 copy of the whole model does not fit
#: beside the bf16 one: deepseek-moe-16b's 16.7 B parameters are 33 GB in
#: bf16 and would be 67 GB more in f32 on an 80 GB card; its first 8 layers
#: in f32 are 19 GB
F32_LAYERS = {"deepseek-moe-16b": 8}
PREFILL_B, PREFILL_S = 2, 2048
#: paligemma-3b's image prefix: its published n_prefix_tokens (224 px
#: images in 14 px patches)
PREFILL_IMAGE = 256
SERVE_REQUESTS, SERVE_NEW = 4, 16
#: the serving profiles' kernel groups: the three kernels, and cuBLAS's
#: matrix products (its Hopper kernels are named nvjet / sm90_xmma)
LM_GROUPS = {
    "attn_kernel_ms": lambda n: "attn_kernel" in n,
    "ssd_kernel_ms": lambda n: "ssd_kernel" in n,
    "wkv_kernel_ms": lambda n: "wkv6_kernel" in n,
    # the MoE's routing, dispatch and combine: top-k, the prefix sum, the
    # one-hots, the index_add_ scatter and the gather
    "moe_dispatch_ms": lambda n: any(k in n for k in (
        "index", "scatter", "gather", "scan", "topk", "sort", "cumsum")),
    "gemm_ms": lambda n: ("gemm" in n or "cutlass" in n or "nvjet" in n
                          or "sm90_xmma" in n),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def bound_ms(linked, M: int, B: int, n_iters: int):
    """Least time the card needs for one launch: the images read and
    written once plus the tables, or cycles * P int32 ops per lane."""
    bytes_moved = 8 * M * B + linked.cm_bytes()
    ops = linked.total_cycles(n_iters) * linked.n_pes * B
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, reps: int, warmup: int = 1):
    """Mean ms per call over ``reps`` calls: on the device (CUDA events)
    and on the host (the time to enqueue them).  Where the host time
    reaches the device time, the card waited on the host."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host_ms


#: device time of a CGRA run by kind: the copies each way, the kernel, the
#: (B, M) <-> (M, B) transposes on the device (two elementwise copies), and
#: the wrapper's copy of the image into the kernel's output (DtoD)
CGRA_GROUPS = {
    "h2d_ms": lambda n: n.startswith("memcpy htod"),
    "d2h_ms": lambda n: n.startswith("memcpy dtoh"),
    "kernel_ms": lambda n: "cgra_exec_kernel" in n,
    "transpose_ms": lambda n: "elementwise_kernel" in n,
    "image_copy_ms": lambda n: n.startswith("memcpy dtod"),
}


def breakdown(program, exe, rng, backend) -> dict:
    """One warm ``run_batch`` of BATCH vectors on the ``cuda`` backend on
    the host clock; the same block once more through the engine
    ``run_batch`` uses (the backend's lanes and device), split into staging
    in (flattening straight into the pinned buffer, and the enqueue),
    waiting on the device and unflattening out of the pinned buffer; the
    array path beside it (a (B, M) array flattened first, copied into the
    pinned buffer, and out of it into a new (B, M) array, unflattened
    after); then
    ``run_batch`` under ``torch.profiler`` (``device_profile``, device time
    by kind), whose host copies must all be pinned."""
    from repro_torch import ual
    from repro_torch.ual.engine import Flattened
    mems = [program.random_inputs(rng) for _ in range(BATCH)]
    n = program.n_iters
    exe.run_batch(mems)                                     # warm
    engine = ual.default_engine().engine_for(
        exe.lowered, lanes=backend.lanes, device=backend.device)
    t0 = time.perf_counter()
    exe.run_batch(mems)
    t1 = time.perf_counter()
    block = engine._submit(Flattened(program, mems), n)
    t2 = time.perf_counter()
    _, waited = engine._drain(block, consume=program.unflatten_batch)
    t3 = time.perf_counter()
    flats = program.flatten_batch(mems)
    t4 = time.perf_counter()
    block = engine._submit(flats, n)
    t5 = time.perf_counter()
    out, array_wait = engine._drain(block)
    t6 = time.perf_counter()
    program.unflatten_batch(out)
    t7 = time.perf_counter()
    prof = device_profile(lambda: exe.run_batch(mems), CGRA_GROUPS)
    check(prof["memcpy_kinds"] and all("Pinned" in k
                                       for k in prof["memcpy_kinds"]
                                       if "DtoD" not in k),
          f"run_batch copied through pageable memory: "
          f"{prof['memcpy_kinds']}")
    return {
        "run_batch_s": t1 - t0, "stage_in_s": t2 - t1,
        "device_wait_s": waited, "unflatten_s": t3 - t2 - waited,
        "array_path": {"flatten_s": t4 - t3, "stage_in_s": t5 - t4,
                       "device_wait_s": array_wait,
                       "copy_out_s": t6 - t5 - array_wait,
                       "unflatten_s": t7 - t6, "total_s": t7 - t3},
        **prof}


def device_profile(fn, groups=None) -> dict:
    """Run ``fn`` once under ``torch.profiler``: its wall time, the
    device's busy time and idle share of it, device time by kernel name
    (the top ten, as [calls, ms]), and the device ms of each of
    ``groups`` (name -> predicate on a kernel's lower-cased name)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies): a CPU op's device time
    # repeats the time of the kernels it launched
    device = [ev for ev in prof.key_averages()
              if ev.device_type != DeviceType.CPU
              and ev.device_time_total > 0]
    busy_ms = sum(ev.device_time_total for ev in device) / 1e3
    top = sorted(device, key=lambda ev: -ev.device_time_total)[:10]
    out = {
        "memcpy_kinds": sorted(ev.key for ev in device
                               if ev.key.startswith("Memcpy")),
        "profiled_wall_ms": wall_ms,
        "device_busy_ms": busy_ms if device else None,
        "device_idle_share": 1 - busy_ms / wall_ms if device else None,
        "device_ms_by_kernel": {ev.key[:60]: [ev.count,
                                              ev.device_time_total / 1e3]
                                for ev in top}}
    for name, pred in (groups or {}).items():
        out[name] = sum(ev.device_time_total for ev in device
                        if pred(ev.key.lower())) / 1e3
    return out


#: the SASS opcodes the build lines count: wgmma, mma.sync, f32 FMA, and
#: local-memory loads and stores
SASS_OPS = ("HGMMA", "HMMA", "FFMA", "LDL", "STL")


def kernel_name(symbol: str) -> str:
    """A kernel's own name inside its mangled symbol: the shortest
    lower-case identifier that follows a digit (a length prefix) and
    contains "kernel"; the symbol itself if there is none."""
    names = [m.group(1) for m in re.finditer(r"\d(?=([a-z][a-z0-9_]*))",
                                              symbol)
             if "kernel" in m.group(1)]
    return min(names, key=len) if names else symbol


def sass_counts(lib: Path):
    """Per kernel of the library (``kernel_name``), the count of each of
    SASS_OPS in ``cuobjdump -sass``, or "not available" where the toolkit
    has no cuobjdump."""
    from repro_torch.kernels.build import find_nvcc
    tool = Path(find_nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return "not available"
    proc = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        return "not available"
    counts, name = {}, None
    for line in proc.stdout.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name = kernel_name(head.group(1))
            counts.setdefault(name, dict.fromkeys(SASS_OPS, 0))
            continue
        op = re.search(r"\b(" + "|".join(SASS_OPS) + r")\b", line)
        if op and name is not None:
            counts[name][op.group(1)] += 1
    return counts


def build_all():
    """Build every kernel library at once, one nvcc each, all started
    together; one ``build`` line per kernel.  Returns each library's SASS
    counts (``sass_counts``) and its ptxas lines (``ptxas_line``)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.cgra_exec import ops as cgra_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
    from repro_torch.kernels.rwkv6 import ops as wkv_ops

    def timed(mod):
        t0 = time.perf_counter()
        lib = mod.build()
        return lib, time.perf_counter() - t0

    kernels = (("cgra_exec", cgra_ops), ("flash_attention", fa_ops),
               ("flash_attention_bwd", SimpleNamespace(build=fa_ops.build_bwd)),
               ("mamba2_ssd", ssd_ops),
               ("mamba2_ssd_bwd", SimpleNamespace(build=ssd_ops.build_bwd)),
               ("rwkv6", wkv_ops),
               ("rwkv6_bwd", SimpleNamespace(build=wkv_ops.build_bwd)))
    sass, ptxas_by_lib = {}, {}
    with ThreadPoolExecutor(len(kernels)) as pool:
        futs = {name: pool.submit(timed, mod) for name, mod in kernels}
        for name, fut in futs.items():
            lib, seconds = fut.result()
            ptxas = [ptxas_line(ln) for ln in lib.with_suffix(".log")
                     .read_text().splitlines()
                     if "registers" in ln or "spill" in ln
                     or "Compiling entry" in ln]
            sass[name] = sass_counts(lib)
            ptxas_by_lib[name] = ptxas
            extra = cgra_shared_memory() if name == "cgra_exec" else {}
            emit("build", kernel=name, seconds=round(seconds, 3),
                 library=lib.name, ptxas=ptxas, sass=sass[name], **extra)
    return sass, ptxas_by_lib


def ptxas_entries(lines) -> dict:
    """Per entry of ``ptxas_line`` lines ("name<form>"): its registers and
    its spill stores and loads in bytes."""
    out, entry = {}, None
    for line in lines:
        if line.startswith("entry "):
            entry = line[len("entry "):]
            out[entry] = {"registers": None, "spill_bytes": 0}
            continue
        if entry is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if spill:
            out[entry]["spill_bytes"] = int(spill.group(1)) + int(
                spill.group(2))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            out[entry]["registers"] = int(regs.group(1))
    return out


def ptxas_line(line: str) -> str:
    """A ptxas resource line, or for an entry function its kernel's name
    and template arguments (cgra_exec's <state shared, tables shared>, the
    bf16 WKV form's <value columns>, the flash forms' <padded head>)."""
    head = re.search(r"Compiling entry function '(\S+)'", line)
    if not head:
        return line.strip()
    args = re.search(r"ILb([01])ELb([01])E", head.group(1))
    cols = re.search(r"(?:wkv6_kernel_wgmma|attn_kernel(?:_wgmma)?"
                     r"|bwd_\w+_kernel_wgmma)ILi(\d+)EE", head.group(1))
    bwd = re.search(r"bwd_\w+_kernelI(f|13__nv_bfloat16)Li(\d+)EE",
                    head.group(1))
    typed = re.search(r"(?:ssd_bwd|wkv6_bwd|sum_parts)_kernelI"
                      r"(f|13__nv_bfloat16)E", head.group(1))
    form = (f"<{args.group(1)},{args.group(2)}>" if args
            else f"<{cols.group(1)}>" if cols
            else f"<{'f32' if bwd.group(1) == 'f' else 'bf16'},"
                 f"{bwd.group(2)}>" if bwd
            else f"<{'f32' if typed.group(1) == 'f' else 'bf16'}>" if typed
            else "")
    return f"entry {kernel_name(head.group(1))}{form}"


def cgra_shared_memory() -> dict:
    """Dynamic shared memory of cgra_exec's launches on its two hand-built
    tables (a mapped pair's is in its kernel_vs_plain line)."""
    from repro_torch.kernels.cgra_exec import ops
    from repro_torch.kernels.cgra_exec.edge_cases import (edge_case_config,
                                                          large_state_config)
    out = {}
    for name, linked in (("edge_cases", edge_case_config()),
                         ("large_state", large_state_config())):
        plan = ops.plan_launch(ops.pack_tables(linked))
        out[name] = {"form": plan.form, "smem_bytes": plan.smem_bytes}
    return {"shared_memory": out}


def cgra_phases(dev, rng):
    """The execution path: every pair compiled through the port's own
    toolchain, the kernel against its plain version, ``validate`` and
    ``run_batch`` on the ``cuda`` backend with the launches counted, the
    kernel's time, and a profile of ``run_batch``.  Returns the kernel's
    summary entry and the compiled pairs."""
    import torch

    from repro_torch import ual
    from repro_torch.core.lowering import link_config
    from repro_torch.core.simulator import simulate_reference
    from repro_torch.kernels.cgra_exec import ops
    from repro_torch.kernels.cgra_exec.edge_cases import (edge_case_config,
                                                          edge_case_images,
                                                          large_state_config)
    from repro_torch.kernels.cgra_exec.ref import cgra_exec_torch

    backend = ual.get_backend("cuda")
    top = backend.lanes
    check(top == BATCH, f"the cuda backend's top bucket is {top}, not "
                        f"{BATCH}: a run_batch of {BATCH} is not one launch")

    # ---- compile every pair through the port's own toolchain -----------------
    compiled = {}
    for kname, fab, kw in PAIRS:
        program = ual.Program.from_kernel(kname)
        target = ual.Target.from_name(fab, backend="cuda", **kw)
        exe = ual.compile(program, target)
        check(exe.success, f"{kname} failed to map on {fab}")
        compiled[(kname, fab)] = (program, exe)

    def to_dev(flats):
        return torch.from_numpy(flats).to(dev).t().contiguous()

    # ---- kernel vs plain version -------------------------------------------
    max_err = 0
    mismatched = 0

    def against_plain(name, linked, flats, n, **fields):
        nonlocal max_err, mismatched
        tables = ops.upload_tables(linked, dev)
        plan = ops.plan_launch(tables.layout)
        for B in CHECK_B:
            memT = to_dev(flats[:B])
            got = ops.cgra_exec(tables, memT, n)
            want = cgra_exec_torch(linked, memT, n)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            bad = int((got != want).sum())
            max_err, mismatched = max(max_err, err), mismatched + bad
            emit("kernel_vs_plain", kernel=name, II=linked.II,
                 P=linked.n_pes, R=linked.n_regs, M=int(memT.shape[0]), B=B,
                 form=plan.form, smem_bytes=plan.smem_bytes,
                 packed_bytes=4 * int(tables.layout.words.size),
                 state_words_per_lane=tables.layout.state_rows,
                 max_abs_err=err, mismatched_words=bad, **fields)
            check(bad == 0, f"{name}: kernel disagrees with its plain "
                            f"version in {bad} words at B = {B}")
        return got, plan

    for (kname, fab), (program, exe) in compiled.items():
        linked = link_config(exe.map_result.config)
        flats = program.flatten_batch([program.random_inputs(rng)
                                       for _ in range(BATCH)])
        n = program.n_iters
        got, _ = against_plain(kname, linked, flats, n,
                               fabric=exe.target.fabric.name,
                               cycles=linked.total_cycles(n),
                               cm_bytes=linked.cm_bytes())
        got_h = got.t().cpu().numpy()
        ref_bad = 0
        for b in range(4):
            ref, _ = simulate_reference(exe.map_result.config, flats[b], n,
                                        check_ports=False)
            ref_bad += int((ref != got_h[b]).sum())
        mismatched += ref_bad
        emit("kernel_vs_reference", kernel=kname,
             fabric=exe.target.fabric.name, lanes=4,
             mismatched_words=ref_bad)
        check(ref_bad == 0, f"{kname}@{fab}: kernel disagrees with "
                            f"simulate_reference in {ref_bad} words")
    against_plain("edge_cases", edge_case_config(),
                  edge_case_images(rng, BATCH, 8192), 6)
    _, plan = against_plain("large_state", large_state_config(),
                            edge_case_images(rng, BATCH, 8192), 6)
    check(not plan.state_shared,
          "the large-state table did not run the global-state form")

    # ---- the main path, through the user's entry points ---------------------
    ops.reset_launches()
    per_run_batch = []
    for (kname, fab), (program, exe) in compiled.items():
        before = ops.launches()
        rep = exe.validate(backends=("cuda", "sim"), n_vectors=64)
        check(rep.passed, f"{kname}@{fab}: validate failed: "
                          f"{rep.backend_results}, {rep.mismatches} words")
        mems = [program.random_inputs(rng) for _ in range(BATCH)]
        engine = ual.default_engine().engine_for(exe.lowered, lanes=top,
                                                 device=backend.device)
        calls_before = dict(engine.stats()["bucket_calls"])
        rb_before = ops.launches()
        outs = exe.run_batch(mems)
        rb_launches = ops.launches() - rb_before
        per_run_batch.append(rb_launches)
        sps = exe.last_info["throughput_sps"]
        wall = exe.last_info["wall_s"]
        stats = engine.stats()
        rb_calls = {b: c - calls_before.get(b, 0)
                    for b, c in stats["bucket_calls"].items()
                    if c != calls_before.get(b, 0)}
        check(rb_launches == 1 and rb_calls == {BATCH: 1},
              f"{kname}@{fab}: run_batch({BATCH}) made {rb_launches} "
              f"launches, bucket calls {rb_calls}")
        sims = exe.run_batch(mems, backend="sim")
        diff = sum(int((o[a] != s[a]).sum()) for o, s in zip(outs, sims)
                   for a in program.outputs)
        check(diff == 0, f"{kname}@{fab}: run_batch(cuda) != sim in "
                         f"{diff} words")
        launched = ops.launches() - before
        check(stats["traces"] <= len(stats["buckets"]),
              f"{kname}@{fab}: {stats['traces']} traces > buckets")
        emit("main_path", kernel=kname, fabric=exe.target.fabric.name,
             II=exe.II, validate=rep.passed, n_vectors=64,
             run_batch=BATCH, agrees_with_sim=True, wall_s=wall,
             throughput_sps=sps, traces=stats["traces"],
             buckets=list(stats["buckets"]),
             bucket_calls=stats["bucket_calls"],
             run_batch_bucket_calls=rb_calls,
             run_batch_launches=rb_launches, launches=launched)
    main_launches = ops.launches()
    check(main_launches > 0, "the main path never launched cgra_exec")

    # ---- timing --------------------------------------------------------------
    rows = {}
    for (kname, fab), (program, exe) in compiled.items():
        linked = exe.lowered
        tables = ops.upload_tables(linked, dev)
        plan = ops.plan_launch(tables.layout)
        n = program.n_iters
        flats = program.flatten_batch([program.random_inputs(rng)
                                       for _ in range(BATCH)])
        row = {"kernel": kname, "fabric": exe.target.fabric.name,
               "M": flats.shape[1], "n_iters": n, "form": plan.form}
        for B in TIME_B:
            memT = to_dev(flats[:B])
            row[f"ms_B{B}"], row[f"host_ms_B{B}"] = time_ms(
                lambda: ops.cgra_exec(tables, memT, n), reps=20, warmup=3)
            row[f"plain_ms_B{B}"], _ = time_ms(
                lambda: cgra_exec_torch(linked, memT, n), reps=2)
            row[f"bound_ms_B{B}"], row["bound_by"] = bound_ms(
                linked, flats.shape[1], B, n)
        rows[(kname, fab)] = row
        emit("timing", **row)

    # ---- geometries, on gemm ----------------------------------------------
    program, exe = compiled[("gemm", "hycube")]
    tables = ops.upload_tables(exe.lowered, dev)
    flats = program.flatten_batch([program.random_inputs(rng)
                                   for _ in range(BATCH)])
    kept = ops.plan_launch(tables.layout)
    for groups, warps in GEOMETRIES:
        plan = ops.plan_launch(tables.layout, groups, warps)
        row = {"kernel": "gemm", "fabric": exe.target.fabric.name,
               "groups": groups, "warps": warps, "form": plan.form,
               "kept": (groups, warps) == (kept.groups, kept.warps)}
        for B in (128, BATCH):
            memT = to_dev(flats[:B])
            row[f"ms_B{B}"], _ = time_ms(
                lambda: ops.cgra_exec(tables, memT, program.n_iters, plan),
                reps=20, warmup=3)
        emit("geometry", **row)

    # ---- where run_batch's time goes ----------------------------------------
    emit("breakdown", kernel="gemm", fabric=exe.target.fabric.name,
         B=BATCH, **breakdown(program, exe, rng, backend))

    # ---- summary -------------------------------------------------------------
    lead = rows[("gemm", "hycube")]
    return compiled, {
        "name": "cgra_exec", "route": "cuda",
        "source": "src/repro_torch/kernels/cgra_exec/csrc/cgra_exec.cu",
        "replaces": "src/repro/kernels/cgra_exec/kernel.py:83",
        "launches": main_launches, "launches_per_run_batch": max(per_run_batch),
        "max_abs_err": max_err, "max_mismatch": mismatched,
        "ms": lead[f"ms_B{BATCH}"], "plain_ms": lead[f"plain_ms_B{BATCH}"],
        "bound_ms": lead[f"bound_ms_B{BATCH}"], "bound_by": lead["bound_by"],
        "library_ms": None, "form": lead["form"],
        "shape": f"gemm on {lead['fabric']}, M={lead['M']}, B={BATCH}, "
                 f"n_iters={lead['n_iters']}"}


#: the stream phase: 16384 vectors, four chunks of the cuda engine's 4096
STREAM_B = 4 * BATCH
STREAM_PAIRS = (("gemm", "hycube"), ("gemm", "pace"))
#: the service phase: four tenant classes at M = 8192, 8 client threads
#: submitting 8192 single-vector requests in all, and a fifth tenant's
#: stream of STREAM_B vectors beside them
SERVICE_CLASSES = (("gemm", "hycube"), ("fft", "hycube"), ("nw", "hycube"),
                   ("gemm", "pace"))
SERVICE_REQUESTS, SERVICE_CLIENTS = 8192, 8
#: room for every request of the phase at once: a stream is admitted all
#: or nothing, so with room for the stream alone no discrete request would
#: be admitted while the stream waits
SERVICE_QUEUE = SERVICE_REQUESTS + STREAM_B


def words_differ(outs, want, program) -> int:
    return sum(int((o[a] != w[a]).sum()) for o, w in zip(outs, want)
               for a in program.outputs)


def timeline(fn) -> dict:
    """Run ``fn`` under ``torch.profiler`` and read the device timeline:
    the memcpy kinds, the device's busy time (the union of its events)
    and idle share, and the copies that overlap a kernel or a copy of the
    other direction (the work of one block runs in order, so such an
    overlap is between two blocks)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                    for ev in prof.events()
                    if ev.device_type == DeviceType.CUDA
                    and ev.time_range.end > ev.time_range.start)

    def kind(name):
        for d in ("HtoD", "DtoH"):
            if name.startswith("Memcpy " + d):
                return d
        return "other copy" if name.startswith("Mem") else "kernel"

    busy, end = 0.0, None
    for a, z, _ in events:
        if end is None or a > end:
            busy += z - a
            end = z
        elif z > end:
            busy += z - end
            end = z
    copies = [(a, z, kind(n)) for a, z, n in events
              if kind(n) in ("HtoD", "DtoH")]
    overlapping, overlap_us = 0, 0.0
    for a, z, k in copies:
        spans = [(max(a, a2), min(z, z2)) for a2, z2, n2 in events
                 if kind(n2) not in (k, "other copy")
                 and a2 < z and a < z2]
        if spans:
            overlapping += 1
            overlap_us += max(b - a1 for a1, b in spans)
    kinds: dict = {}
    for _, _, n in events:
        if n.startswith("Memcpy"):
            kinds[n] = kinds.get(n, 0) + 1
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1 - busy / 1e3 / wall_ms,
            "memcpy_kinds": kinds, "copies": len(copies),
            "overlapping_copies": overlapping,
            "overlapped_copy_ms": overlap_us / 1e3}


def stream_phases(dev, rng, compiled) -> int:
    """``Executable.run_stream`` of STREAM_B vectors on the ``cuda``
    backend, gemm on HyCUBE 4x4 and on PACE 8x8: bit-exact against
    ``sim``, no new trace after the warm-up, one launch a chunk; then the
    same stream once more under ``torch.profiler``, whose copies must all
    be pinned and at least one of them overlap a kernel or a copy of the
    other direction.  Returns the launches."""
    from repro_torch import ual
    from repro_torch.kernels.cgra_exec import ops

    backend = ual.get_backend("cuda")
    launches = 0
    for kname, fab in STREAM_PAIRS:
        program, exe = compiled[(kname, fab)]
        mems = [program.random_inputs(rng) for _ in range(STREAM_B)]
        exe.warmup()
        engine = ual.default_engine().engine_for(
            exe.lowered, lanes=backend.lanes, device=backend.device)
        traces = engine.traces
        ops.reset_launches()
        outs = [out for chunk in exe.run_stream(mems) for out in chunk]
        n = ops.launches()
        info = dict(exe.last_info)
        diff = words_differ(outs, exe.run_batch(mems, backend="sim"),
                            program)
        check(diff == 0, f"{kname}@{fab}: run_stream(cuda) != sim in "
                         f"{diff} words")
        check(engine.traces == traces and info["traced"] == 0,
              f"{kname}@{fab}: the warm stream traced "
              f"{engine.traces - traces} new shapes")
        check(n == STREAM_B // BATCH and info["stream_chunks"] == n,
              f"{kname}@{fab}: a stream of {STREAM_B} made {n} launches in "
              f"{info['stream_chunks']} chunks")
        launches += n

        def drain():
            for _ in exe.run_stream(mems):
                pass

        prof = timeline(drain)
        check(prof["memcpy_kinds"] and all(
            "Pinned" in k for k in prof["memcpy_kinds"] if "DtoD" not in k),
            f"{kname}@{fab}: the stream copied through pageable memory: "
            f"{prof['memcpy_kinds']}")
        check(prof["overlapping_copies"] > 0,
              f"{kname}@{fab}: no copy of the stream overlapped a kernel or "
              f"an opposite copy on the device")
        emit("stream", kernel=kname, fabric=exe.target.fabric.name,
             samples=STREAM_B, chunks=info["stream_chunks"], launches=n,
             agrees_with_sim=True, new_traces=0,
             overlap_frac=info["overlap_frac"], wall_s=info["wall_s"],
             wait_s=info["wait_s"], throughput_sps=info["throughput_sps"],
             profiled=prof)
    return launches


def service_phase(rng, compiled) -> int:
    """``Service`` on the ``cuda`` backend: SERVICE_CLIENTS threads submit
    SERVICE_REQUESTS single-vector requests over four tenant classes while
    a fifth tenant streams STREAM_B vectors (``submit_stream``).  Every
    output bit-equal to ``sim``, every request completed, no error, no
    reject, no sweep degraded to ``sim``, at least one launch a sweep, and
    at most one trace a bucket per engine.  Returns the launches."""
    import threading

    from repro_torch import ual
    from repro_torch.kernels.cgra_exec import ops

    classes = [compiled[key] for key in SERVICE_CLASSES]
    mems = [classes[i % len(classes)][0].random_inputs(rng)
            for i in range(SERVICE_REQUESTS)]
    bulk_program, bulk_exe = compiled[SERVICE_CLASSES[0]]
    bulk = [bulk_program.random_inputs(rng) for _ in range(STREAM_B)]
    futs = [None] * SERVICE_REQUESTS
    svc = ual.Service(max_batch=512, max_wait_ms=2,
                      max_queue=SERVICE_QUEUE)

    def client(c: int) -> None:
        for i in range(c, SERVICE_REQUESTS, SERVICE_CLIENTS):
            program, exe = classes[i % len(classes)]
            futs[i] = svc.submit(program, exe.target, mems[i],
                                 tenant=f"{program.name}@"
                                        f"{exe.target.fabric.name}")

    ops.reset_launches()
    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(SERVICE_CLIENTS)]
        for t in threads:
            t.start()
        stream = svc.submit_stream(bulk_program, bulk_exe.target, bulk,
                                   tenant="bulk")
        for t in threads:
            t.join()
        outs = [f.result(timeout=600) for f in futs]
        bulk_outs = stream.results(timeout=600)
        wall = time.perf_counter() - t0
        stats = svc.stats()
    finally:
        svc.shutdown()
    launches = ops.launches()
    diff = 0
    for k, (program, exe) in enumerate(classes):
        idx = range(k, SERVICE_REQUESTS, len(classes))
        diff += words_differ([outs[i] for i in idx], exe.run_batch(
            [mems[i] for i in idx], backend="sim"), program)
    diff += words_differ(bulk_outs, bulk_exe.run_batch(bulk, backend="sim"),
                         bulk_program)
    check(diff == 0, f"service outputs != sim in {diff} words")
    total = SERVICE_REQUESTS + STREAM_B
    check(stats["completed"] == total and stats["errors"] == 0
          and stats["rejected"] == 0,
          f"service: {stats['completed']} of {total} completed, "
          f"{stats['errors']} errors, rejects {stats['rejects']}")
    check(stats["breaker"]["degraded_batches_total"] == 0,
          f"service: {stats['breaker']['degraded_batches_total']} sweeps "
          f"degraded to sim")
    sweeps = stats["batches"] + stats["stream"]["chunks"]
    check(launches >= sweeps, f"service: {launches} launches for {sweeps} "
                              f"sweeps")
    engines = stats["engine"]["per_engine"]
    check(all(e["traces"] <= len(e["buckets"]) for e in engines.values()),
          "service: an engine traced more shapes than it has buckets")
    emit("service", classes=[f"{k}@{f}" for k, f in SERVICE_CLASSES],
         M=classes[0][0].layout.total_words, requests=SERVICE_REQUESTS,
         clients=SERVICE_CLIENTS, stream_samples=STREAM_B,
         max_batch=512, max_wait_ms=2, max_queue=SERVICE_QUEUE,
         agrees_with_sim=True, wall_s=wall, samples_per_s=total / wall,
         completed=stats["completed"], errors=stats["errors"],
         rejected=stats["rejected"],
         degraded_batches=stats["breaker"]["degraded_batches_total"],
         p50_ms=stats["p50_ms"], p99_ms=stats["p99_ms"],
         mean_batch=stats["mean_batch"], batches=stats["batches"],
         exec_samples_per_s=stats["exec_samples_per_s"],
         stream=stats["stream"], stream_info=stream.info,
         launches=launches, sweeps=sweeps,
         traces={k: e["traces"] for k, e in engines.items()})
    return launches


def breaker_phase(rng, compiled) -> int:
    """The circuit breaker on the card: three injected ``cuda`` sweep
    failures (threshold 2, cooldown 0.8 s) degrade four requests to
    ``sim`` and trip the class once; the second half-open probe restores
    it, and that request launches ``cgra_exec``.  Outputs bit-exact.
    Returns the launches of the restoring request."""
    from repro_torch import ual
    from repro_torch.kernels.cgra_exec import ops
    from repro_torch.ual import faults

    program, exe = compiled[("gemm", "hycube")]
    mems = [program.random_inputs(rng) for _ in range(5)]
    want = exe.run_batch(mems, backend="sim")
    cooldown = 0.8
    infos, launched = [], []
    faults.install(ual.FaultPlan(
        [ual.FaultSpec("exec_fault", backend="cuda", count=3)]))
    try:
        with ual.Service(max_batch=4, max_wait_ms=5, breaker_threshold=2,
                         breaker_cooldown_s=cooldown) as svc:
            outs = []
            for i, mem in enumerate(mems):
                if i in (3, 4):
                    time.sleep(cooldown + 0.1)    # let the class half-open
                ops.reset_launches()
                resp = svc.submit(program, exe.target, mem)
                outs.append(resp.result(timeout=600))
                launched.append(ops.launches())
                infos.append(resp.info.get("degraded_to"))
            stats = svc.stats()
    finally:
        faults.clear()
    diff = words_differ(outs, want, program)
    check(diff == 0, f"breaker: outputs != sim in {diff} words")
    check(infos == ["sim"] * 4 + [None],
          f"breaker: degraded_to {infos}, want ['sim'] * 4 + [None]")
    brk = stats["breaker"]
    (cls,) = brk["classes"].values()
    check(brk["trips_total"] == 1 and cls["restores"] == 1
          and cls["state"] == "closed",
          f"breaker: {brk['trips_total']} trips, {cls['restores']} restores, "
          f"state {cls['state']}")
    check(launched[-1] >= 1, "breaker: the restoring request did not "
                             "launch cgra_exec")
    emit("breaker", kernel="gemm", fabric=exe.target.fabric.name,
         degraded_to=infos, trips=brk["trips_total"],
         restores=cls["restores"], degraded_batches=cls["degraded_batches"],
         launches_per_request=launched, agrees_with_sim=True)
    return launched[-1]


#: the sharded phase: gemm on HyCUBE 4x4 and on PACE 8x8 through
#: ``cuda_sharded``, a batch of one block and a ragged batch one row past it
SHARDED_B = (BATCH, BATCH + 1)
#: the cluster phases: two spawned workers (one card each; on a one-card
#: machine both share it), the service phase's four classes, 8 client
#: threads submitting 4096 single-vector requests in all; cluster_heal
#: kills worker 0 at its 65th request, then sends HEAL_PROBES requests a
#: class, one at a time, to the respawned worker (under the re-armed kill)
CLUSTER_WORKERS, CLUSTER_REQUESTS, CLUSTER_CLIENTS = 2, 4096, 8
HEAL_AFTER, HEAL_PROBES = 64, 4
#: the dse phase: gemm over 3 fabrics x the built-in strategies x 2 seeds,
#: mapped by 4 forked workers after this process has initialised CUDA
DSE_SPACE = {"fabric": [("hycube", {"rows": 4, "cols": 4}),
                        ("n2n", {"rows": 4, "cols": 4}), ("pace", {})],
             "seed": [0, 1]}
DSE_WORKERS, DSE_VECTORS = 4, 256


def sharded_phase(rng, compiled) -> int:
    """``run_batch`` of BATCH and BATCH + 1 vectors on ``cuda_sharded``
    (every card of the process, one block plan), gemm on HyCUBE and PACE:
    bit-exact against ``sim``, the engine's name and device count, one
    launch a device a block, at most one trace a bucket.  Returns the
    launches."""
    import torch

    from repro_torch import ual
    from repro_torch.kernels.cgra_exec import ops
    from repro_torch.launch.mesh import make_host_mesh

    lanes = ual.get_backend("cuda_sharded").lanes
    n_dev = torch.cuda.device_count()
    launches = 0
    for kname, fab in STREAM_PAIRS:
        program, exe = compiled[(kname, fab)]
        engine = ual.default_engine().sharded_engine_for(
            exe.lowered, lanes=lanes, mesh=make_host_mesh())
        for B in SHARDED_B:
            mems = [program.random_inputs(rng) for _ in range(B)]
            ops.reset_launches()
            t0 = time.perf_counter()
            outs = exe.run_batch(mems, backend="cuda_sharded")
            wall = time.perf_counter() - t0
            n = ops.launches()
            info = dict(exe.last_info)
            diff = words_differ(outs, exe.run_batch(mems, backend="sim"),
                                program)
            check(diff == 0, f"{kname}@{fab}: run_batch({B}) on cuda_sharded "
                             f"!= sim in {diff} words")
            check(info["engine"] == "cgra_exec-cuda-sharded"
                  and info["n_devices"] == n_dev,
                  f"{kname}@{fab}: engine {info['engine']} over "
                  f"{info.get('n_devices')} devices, {n_dev} cards")
            blocks = -(-B // (n_dev * lanes))
            check(n == blocks * n_dev, f"{kname}@{fab}: run_batch({B}) made "
                                       f"{n} launches, want {blocks * n_dev}")
            stats = engine.stats()
            check(stats["traces"] <= len(stats["buckets"]),
                  f"{kname}@{fab}: {stats['traces']} traces > buckets")
            emit("sharded", kernel=kname, fabric=exe.target.fabric.name,
                 B=B, engine=info["engine"], n_devices=info["n_devices"],
                 launches=n, buckets=info["buckets"],
                 traces=stats["traces"], n_buckets=len(stats["buckets"]),
                 agrees_with_sim=True, wall_s=wall,
                 throughput_sps=B / wall)
            launches += n
    return launches


def cluster_drive(cs, classes, mems) -> tuple:
    """CLUSTER_CLIENTS threads submit ``mems`` round-robin over the
    classes; returns (futures, outputs, wall seconds)."""
    import threading

    futs = [None] * len(mems)

    def client(c: int) -> None:
        for i in range(c, len(mems), CLUSTER_CLIENTS):
            program, exe = classes[i % len(classes)]
            futs[i] = cs.submit(program, exe.target, mems[i],
                                tenant=f"{program.name}@"
                                       f"{exe.target.fabric.name}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(CLUSTER_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    outs = [f.result(timeout=600) for f in futs]
    return futs, outs, time.perf_counter() - t0


def cluster_diff(classes, mems, outs) -> int:
    """Words of ``outs`` that differ from ``sim`` on the same requests."""
    diff = 0
    for k, (program, exe) in enumerate(classes):
        idx = range(k, len(mems), len(classes))
        diff += words_differ([outs[i] for i in idx], exe.run_batch(
            [mems[i] for i in idx], backend="sim"), program)
    return diff


def cluster_workers(stats, procs, phase: str) -> tuple:
    """Each worker's line (engine, launches, batches, memory, start-up) and
    the launches of all of them, summed from their engines' bucket calls
    (the launches happen in the workers' processes).  Every worker ran
    ``cgra_exec`` on the card and nothing degraded to ``sim``."""
    per, launches = {}, 0
    for i, snap in sorted(stats["per_worker"].items()):
        engines = list(snap["engine"]["per_engine"].values())
        calls = sum(sum(e["bucket_calls"].values()) for e in engines)
        names = sorted({e["engine"] for e in engines})
        check(names == ["cgra_exec-cuda"] and calls > 0,
              f"{phase}: worker {i} ran engines {names}, {calls} launches")
        brk = snap["breaker"]
        check(brk["degraded_batches_total"] == 0 and brk["trips_total"] == 0,
              f"{phase}: worker {i} degraded {brk['degraded_batches_total']} "
              f"batches, {brk['trips_total']} trips")
        info = procs.get(i, {})
        per[i] = {"completed": snap["completed"],
                  "mean_batch": snap["mean_batch"],
                  "batches": snap["batches"], "launches": calls,
                  "wrapper_launches": info.get("cgra_exec_launches"),
                  "mapping_stores": snap["cache"]["mapping"]["stores"],
                  "mapping_disk_hits": snap["cache"]["mapping"]["disk_hits"],
                  "startup_s": info.get("startup_s"),
                  "nvcc_builds": info.get("nvcc_builds"),
                  "cuda_visible_devices": info.get("cuda_visible_devices"),
                  "pinned_bytes": info.get("pinned_bytes"),
                  "device_max_reserved_bytes":
                      info.get("device_max_reserved_bytes"),
                  "device_max_allocated_bytes":
                      info.get("device_max_allocated_bytes")}
        launches += calls
    return per, launches


def cluster_phase(rng, compiled) -> int:
    """``ClusterService(workers=2)`` on ``cuda`` with a fresh cache
    directory, serving the service phase's four classes: 8 clients x
    CLUSTER_REQUESTS requests in all.  Outputs bit-equal to ``sim``, every
    future resolved, no error, reject, degraded batch or trip, each class
    mapped once cluster-wide, every worker on ``cgra_exec-cuda``.  Returns
    the workers' launches."""
    import shutil
    import tempfile

    from repro_torch import ual

    classes = [compiled[key] for key in SERVICE_CLASSES]
    mems = [classes[i % len(classes)][0].random_inputs(rng)
            for i in range(CLUSTER_REQUESTS)]
    cache_dir = tempfile.mkdtemp(prefix="cluster_cache_")
    try:
        t0 = time.perf_counter()
        with ual.ClusterService(workers=CLUSTER_WORKERS, max_batch=512,
                                max_wait_ms=2, max_queue=CLUSTER_REQUESTS,
                                cache_dir=cache_dir) as cs:
            ready_s = time.perf_counter() - t0
            _, outs, wall = cluster_drive(cs, classes, mems)
            stats = cs.stats(timeout=120)
            procs = cs.worker_info()
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    diff = cluster_diff(classes, mems, outs)
    check(diff == 0, f"cluster: outputs != sim in {diff} words")
    check(stats["completed"] == CLUSTER_REQUESTS and stats["errors"] == 0
          and stats["rejected"] == 0,
          f"cluster: {stats['completed']} of {CLUSTER_REQUESTS} completed, "
          f"{stats['errors']} errors, rejects {stats['rejects']}")
    check(sorted(stats["per_worker"]) == list(range(CLUSTER_WORKERS)),
          f"cluster: workers answering {sorted(stats['per_worker'])}")
    per, launches = cluster_workers(stats, procs, "cluster")
    stores = sum(w["mapping_stores"] for w in per.values())
    check(stores == len(SERVICE_CLASSES),
          f"cluster: {stores} mappings cluster-wide for "
          f"{len(SERVICE_CLASSES)} classes")
    emit("cluster", workers=CLUSTER_WORKERS, backend="cuda",
         classes=[f"{k}@{f}" for k, f in SERVICE_CLASSES],
         requests=CLUSTER_REQUESTS, clients=CLUSTER_CLIENTS, max_batch=512,
         max_wait_ms=2, agrees_with_sim=True, ready_s=ready_s, wall_s=wall,
         samples_per_s=CLUSTER_REQUESTS / wall,
         stats_samples_per_s=stats["samples_per_s"],
         p50_ms=stats["p50_ms"], p99_ms=stats["p99_ms"],
         completed=stats["completed"], errors=stats["errors"],
         rejected=stats["rejected"], routing=stats["routing"],
         mappings=stores, launches=launches, per_worker=per)
    return launches


def cluster_heal_phase(rng, compiled) -> int:
    """The same load with a fault plan that kills worker 0 (``os._exit``,
    CUDA context and all) at its 65th request: every future resolves
    bit-equal to ``sim``, at least one request retried, one death and one
    restart; then HEAL_PROBES requests a class, one at a time, go to the
    respawned worker, which maps nothing, builds nothing and answers
    bit-equal to ``sim``.  Returns the launches of the surviving
    processes."""
    import shutil
    import tempfile

    from repro_torch import ual

    classes = [compiled[key] for key in SERVICE_CLASSES]
    mems = [classes[i % len(classes)][0].random_inputs(rng)
            for i in range(CLUSTER_REQUESTS)]
    plan = ual.FaultPlan([ual.FaultSpec("kill_worker", worker=0,
                                        after=HEAL_AFTER)])
    cache_dir = tempfile.mkdtemp(prefix="cluster_heal_cache_")
    try:
        with ual.ClusterService(
                workers=CLUSTER_WORKERS, max_batch=512, max_wait_ms=2,
                max_queue=CLUSTER_REQUESTS, cache_dir=cache_dir,
                worker_env=plan.to_env(),
                restart_policy=ual.RestartPolicy(
                    max_restarts=1, backoff_base_s=0.1)) as cs:
            futs, outs, wall = cluster_drive(cs, classes, mems)
            deadline = time.perf_counter() + 300
            while True:
                sup = cs.stats(timeout=60)["supervision"]["workers"][0]
                if sup["restarts"] >= 1 and sup["alive"]:
                    break
                check(time.perf_counter() < deadline,
                      f"cluster_heal: worker 0 never rejoined: {sup}")
                time.sleep(0.2)
            probes = []
            for program, exe in classes:
                for _ in range(HEAL_PROBES):
                    mem = program.random_inputs(rng)
                    resp = cs.submit(program, exe.target, mem)
                    out = resp.result(timeout=600)
                    probes.append((program, exe, mem, out,
                                   resp.info.get("worker")))
            stats = cs.stats(timeout=120)
            procs = cs.worker_info()
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    diff = cluster_diff(classes, mems, outs)
    for program, exe, mem, out, _ in probes:
        diff += words_differ([out], exe.run_batch([mem], backend="sim"),
                             program)
    check(diff == 0, f"cluster_heal: outputs != sim in {diff} words")
    retried = sum(1 for f in futs if f.info.get("retries", 0) >= 1)
    sup = stats["supervision"]
    w0 = sup["workers"][0]
    check(retried >= 1 and sup["retries_total"] >= 1,
          f"cluster_heal: {retried} requests retried")
    check(sup["restarts_total"] == 1 and sup["deaths_total"] == 1,
          f"cluster_heal: {sup['deaths_total']} deaths, "
          f"{sup['restarts_total']} restarts")
    check(all(w == 0 for *_, w in probes),
          f"cluster_heal: probes answered by workers "
          f"{sorted({w for *_, w in probes})}, not the respawned 0")
    per, launches = cluster_workers(stats, procs, "cluster_heal")
    check(per[0]["mapping_stores"] == 0
          and stats["per_worker"][0]["cache"]["lowered"]["stores"] == 0
          and per[0]["mapping_disk_hits"] >= 1,
          f"cluster_heal: the respawned worker mapped "
          f"{per[0]['mapping_stores']} classes, "
          f"{per[0]['mapping_disk_hits']} disk hits")
    check(per[0]["nvcc_builds"] == 0,
          f"cluster_heal: the respawned worker ran nvcc "
          f"{per[0]['nvcc_builds']} times")
    check(stats["errors"] == 0, f"cluster_heal: {stats['errors']} errors")
    emit("cluster_heal", workers=CLUSTER_WORKERS, backend="cuda",
         requests=CLUSTER_REQUESTS, kill_after=HEAL_AFTER,
         probes=len(probes), agrees_with_sim=True, wall_s=wall,
         samples_per_s=CLUSTER_REQUESTS / wall, retried_requests=retried,
         retries_total=sup["retries_total"], deaths=sup["deaths_total"],
         restarts=sup["restarts_total"],
         death_to_rejoin_s=w0["last_recovery_s"],
         p50_ms=stats["p50_ms"], p99_ms=stats["p99_ms"],
         routing=stats["routing"], launches=launches, per_worker=per)
    return launches


def dse_phase(rng) -> int:
    """``explore`` of gemm over DSE_SPACE (the built-in strategies added)
    with DSE_WORKERS forked mappers, run after this process has
    initialised CUDA: every unique key mapped once, a second sweep all
    cache hits, every Pareto point's executable ``validate``d bit-exact on
    ``cuda`` against ``interp``.  Returns the launches of the validations."""
    import shutil
    import tempfile

    import torch

    from repro_torch import ual
    from repro_torch.kernels.cgra_exec import ops

    check(torch.cuda.is_initialized(), "dse: CUDA is not initialised yet")
    program = ual.Program.from_kernel("gemm")
    space = dict(DSE_SPACE, strategy=ual.list_strategies())
    cache_dir = tempfile.mkdtemp(prefix="dse_cache_")
    try:
        cache = ual.MappingCache(disk_dir=cache_dir)
        t0 = time.perf_counter()
        report = ual.explore(program, space, workers=DSE_WORKERS,
                             cache=cache)
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = ual.explore(program, space, workers=DSE_WORKERS, cache=cache)
        warm_wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    keys = {p.executable.target.digest for p in report.points}
    check(all(p.success for p in report.points),
          f"dse: {sum(not p.success for p in report.points)} points failed "
          f"to map")
    check(report.n_mapped == len(keys) == cache.stats.stores,
          f"dse: {report.n_mapped} mappings for {len(keys)} unique keys "
          f"({cache.stats.stores} stored)")
    check(again.n_mapped == 0 and again.n_warm == len(again.points),
          f"dse: the warm sweep mapped {again.n_mapped}, "
          f"{again.n_warm} hits of {len(again.points)}")
    ops.reset_launches()
    for p in report.pareto:
        rep = p.executable.validate(backends=("cuda",),
                                    n_vectors=DSE_VECTORS)
        check(rep.passed, f"dse: {p.fabric}/{p.strategy}/{p.knobs} failed "
                          f"validate on cuda: {rep.mismatches} words")
    launches = ops.launches()
    check(launches >= len(report.pareto),
          f"dse: {launches} launches for {len(report.pareto)} validations")
    emit("dse", kernel="gemm", workers=DSE_WORKERS,
         points=len(report.points), unique_keys=len(keys),
         n_mapped=report.n_mapped, warm_hits=again.n_warm, wall_s=wall,
         warm_wall_s=warm_wall, pareto=[p.row() for p in report.pareto],
         rows=[p.row() for p in report.points],
         validated_on_cuda=len(report.pareto), n_vectors=DSE_VECTORS,
         launches=launches)
    return launches


#: the traced phase: two functions of torch ops through
#: ``Program.from_function`` (the reference's tests/test_ual.py lambda and
#: tests/test_core_dfg.py's function) and the library's traced kernel, each
#: with the JAX package's ``Program.digest`` of the same program
#: (tests/test_torch_frontend.py holds the port to it on the CPU), compiled
#: for HyCUBE 4x4 and PACE 8x8; then LISA trained on the card
TRACED_DIGESTS = {
    "traced_mul": "a2d1686f809a40893ac5ca288c2b40a4080ca6bb789c84a59c6776613fac65be",
    "traced_select": "541a0b2fe3dbb6bcf3828b5acb508365561381919d0512f0f06c76a1527e8ba3",
    "jax_poly": "3d6c53fc780b38b7a2c7d489b5bfd9914bdfca026539fee0b57cff53d7af0098",
}
TRACED_FABRICS = (("hycube", {"rows": 4, "cols": 4}), ("pace", {}))
LISA_STEPS = 60


def traced_programs():
    """The traced phase's programs, by name."""
    import torch

    from repro_torch import ual
    return {
        "traced_mul": ual.Program.from_function(
            lambda x, y: x * y + 1, {"x": 8, "y": 8}, name="traced_mul"),
        "traced_select": ual.Program.from_function(
            lambda v: torch.where(v > 2, v * v - 1, v + 5) & 0xFF, {"x": 8},
            name="traced_select"),
        "jax_poly": ual.Program.from_kernel("jax_poly")}


def traced_phase(dev, rng) -> int:
    """The traced front end on the card: each of ``traced_programs`` with
    the reference's digest, compiled for each of TRACED_FABRICS on ``cuda``,
    ``validate``d bit-exact against the interp oracle (``cuda`` and
    ``sim``), a ``run_batch`` of BATCH in one launch (bucket calls
    {BATCH: 1}) equal to the sim backend's; then LISA trained on the card
    (LISA_STEPS steps on gemm's mapping on HyCUBE 4x4; then once more,
    warm, for its time) and nw mapped with the mem-only learned bias: the
    loss falls and the II is no worse than without it (the reference's
    tests/test_core_mapper.py contract).
    Returns the launches of the validations and run_batch calls."""
    from repro_torch import ual
    from repro_torch.core import adl, lisa
    from repro_torch.core.dfg import apply_layout, plan_layout
    from repro_torch.core.kernel_lib import KERNELS
    from repro_torch.core.mapper import map_dfg
    from repro_torch.kernels.cgra_exec import ops

    backend = ual.get_backend("cuda")
    ops.reset_launches()
    for name, program in traced_programs().items():
        check(program.digest == TRACED_DIGESTS[name],
              f"traced: {name}'s digest {program.digest} is not the "
              f"reference's")
        for fab, kw in TRACED_FABRICS:
            t0 = time.perf_counter()
            exe = ual.compile(program, ual.Target.from_name(
                fab, backend="cuda", **kw))
            compile_s = time.perf_counter() - t0
            check(exe.success, f"traced: {name} failed to map on {fab}")
            before = ops.launches()
            rep = exe.validate(backends=("cuda", "sim"), n_vectors=64)
            check(rep.passed, f"traced: {name}@{fab}: validate failed: "
                              f"{rep.backend_results}, {rep.mismatches} words")
            mems = [program.random_inputs(rng) for _ in range(BATCH)]
            engine = ual.default_engine().engine_for(
                exe.lowered, lanes=backend.lanes, device=backend.device)
            calls_before = dict(engine.stats()["bucket_calls"])
            rb_before = ops.launches()
            outs = exe.run_batch(mems)
            rb_launches = ops.launches() - rb_before
            rb_calls = {b: c - calls_before.get(b, 0)
                        for b, c in engine.stats()["bucket_calls"].items()
                        if c != calls_before.get(b, 0)}
            check(rb_launches == 1 and rb_calls == {BATCH: 1},
                  f"traced: {name}@{fab}: run_batch({BATCH}) made "
                  f"{rb_launches} launches, bucket calls {rb_calls}")
            sims = exe.run_batch(mems, backend="sim")
            diff = sum(int((o[a] != s[a]).sum()) for o, s in zip(outs, sims)
                       for a in program.outputs)
            check(diff == 0, f"traced: {name}@{fab}: run_batch(cuda) != sim "
                             f"in {diff} words")
            emit("traced", program=name, digest=program.digest,
                 fabric=exe.target.fabric.name, nodes=len(program.dfg.nodes),
                 II=exe.II, compile_s=compile_s, validate=rep.passed,
                 n_vectors=64, run_batch=BATCH, agrees_with_sim=True,
                 run_batch_launches=rb_launches,
                 run_batch_bucket_calls=rb_calls,
                 wall_s=exe.last_info["wall_s"],
                 throughput_sps=exe.last_info["throughput_sps"],
                 launches=ops.launches() - before)
    launches = ops.launches()

    fab = adl.hycube(4, 4)

    def laid(name):
        d, _, _ = KERNELS[name]()
        return apply_layout(d, plan_layout(d))
    t0 = time.perf_counter()
    feats, labels, pf = lisa.collect_dataset([(laid("gemm"), 0)], fab)
    t1 = time.perf_counter()
    params, losses = lisa.train(feats, labels, pf, steps=LISA_STEPS,
                                device=dev)
    t2 = time.perf_counter()
    lisa.train(feats, labels, pf, steps=LISA_STEPS, device=dev)   # warm
    warm_s = time.perf_counter() - t2
    check(all(t.is_cuda for t in params.values()),
          "lisa: the model did not train on the card")
    check(losses[-1] < losses[0], f"lisa: the loss did not fall: "
                                  f"{losses[0]} -> {losses[-1]}")
    label_for = lisa.make_label_fn(params, fab, mem_only=True)
    dfg = laid("nw")
    base = map_dfg(dfg, fab, seed=3)
    learned = map_dfg(dfg, fab, seed=3, label_fn=label_for(dfg))
    check(learned.success and learned.II <= base.II,
          f"lisa: nw maps at II {learned.II} with the learned bias, "
          f"{base.II} without")
    emit("lisa", train_kernel="gemm", fabric=fab.name, samples=len(labels),
         steps=LISA_STEPS, device=str(params["w1"].device),
         loss_first=losses[0], loss_last=losses[-1], collect_s=t1 - t0,
         train_s=t2 - t1, warm_train_s=warm_s, held_out="nw",
         II_base=base.II,
         II_learned=learned.II, restarts_base=base.restarts,
         restarts_learned=learned.restarts)
    return launches


def attention_pairs(Sq, Skv, causal, window, prefix_len=0) -> int:
    """The (query, key) pairs the mask keeps, per batch row and head (a
    causal query also sees the keys before ``prefix_len``)."""
    import torch
    q = torch.arange(Sq, dtype=torch.int64)
    lo = (q - window + 1).clamp_min(0) if window > 0 else torch.zeros_like(q)
    hi = (q.clamp_min(prefix_len - 1).clamp_max(Skv - 1) if causal
          else torch.full_like(q, Skv - 1))
    return int((hi - lo + 1).clamp_min(0).sum())


def roofline(flops, nbytes, dtype):
    """(ms, bound_by): the larger of the operations at ``dtype``'s peak and
    the bytes at HBM's rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def attention_bound(B, Sq, Skv, H, KV, D, dtype, causal, window,
                    prefix_len=0):
    """Least time for one attention call: 4 * D flops per (query, key)
    pair the mask keeps, over the peak rate of ``dtype``, against q, k, v
    read once and the output written once over HBM's rate."""
    pairs = attention_pairs(Sq, Skv, causal, window, prefix_len)
    flops = 4 * D * pairs * B * H
    item = 2 if dtype == "bfloat16" else 4
    nbytes = item * (2 * B * Sq * H * D + 2 * B * Skv * KV * D)
    return (*roofline(flops, nbytes, dtype), flops, nbytes)


def attention_bwd_bound(B, S, H, KV, D, dtype, causal, window, prefix_len=0):
    """Least time for one backward call: 10 * D flops per kept pair (S
    again, dP, dV, dS K, dS^T Q) over the peak rate of ``dtype``, against
    q, o, dO, dQ, k, v, dK, dV read or written once and the f32 lse."""
    pairs = attention_pairs(S, S, causal, window, prefix_len)
    flops = 10 * D * pairs * B * H
    item = 2 if dtype == "bfloat16" else 4
    nbytes = item * (4 * B * S * H * D + 4 * B * S * KV * D) + 4 * B * H * S
    return (*roofline(flops, nbytes, dtype), flops, nbytes)


def sdpa(q, k, v, causal, window, prefix_len=0):
    """One PyTorch call computing the same attention (the yardstick only:
    the port never calls it); a window or a prefix goes in as an explicit
    boolean mask."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window > 0 or (causal and prefix_len > 0):
        Sq, Skv = q.shape[1], k.shape[1]
        qp = torch.arange(Sq, device=q.device)[:, None]
        kp = torch.arange(Skv, device=q.device)[None, :]
        keep = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
        if window > 0:
            keep &= (qp - kp) < window
        if causal:
            keep &= (qp >= kp) | (kp < prefix_len)
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep,
                                              enable_gqa=True)
    return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                          enable_gqa=True)


def excess(got, want, dt: str) -> float:
    """The largest amount by which ``got`` lies outside the bound of
    ``KERNEL_TOL[dt]`` around ``want`` (<= 0: within it everywhere)."""
    atol, rtol = KERNEL_TOL[dt]
    want = want.float()
    return float(((got.float() - want).abs()
                  - (atol + rtol * want.abs())).max())


def check_case(phase: str, name: str, dt: str, run_kernel, run_plain,
               faults, timed=None) -> dict:
    """One case of a float kernel's phase: the kernel's output against its
    plain version within ``KERNEL_TOL[dt]`` per element, each planted fault
    held to the same bound (it must fail it), and both versions timed
    (``run_kernel`` and ``run_plain``, or the pair ``timed`` where the
    checked outputs are assembled from the calls).  ``faults`` maps a
    fault's name to a function that returns its output and the first step
    (axis 1) it covers.  Returns the row's numbers."""
    import torch
    got, want = run_kernel(), run_plain()
    torch.cuda.synchronize()
    atol, rtol = KERNEL_TOL[dt]
    err = float((got.float() - want.float()).abs().max())
    over = excess(got, want, dt)
    check(bool(torch.isfinite(got).all()), f"{phase} {name}: non-finite")
    check(over <= 0, f"{phase} {name}: max |err| {err} beyond {atol} + "
                     f"{rtol} |want| (by {over})")
    row = {"max_abs_err": err, "atol": atol, "rtol": rtol, "excess": over}
    for fault_name, run_fault in faults.items():
        fault, at = run_fault()
        fault_err = float((fault.float() - want[:, at:].float()).abs().max())
        fault_over = excess(fault, want[:, at:], dt)
        check(fault_over > 0, f"{phase} {name}: the bound {atol} + {rtol} "
                              f"|want| lets the fault {fault_name} through "
                              f"(max |err| {fault_err})")
        row[f"{fault_name}_max_abs_err"] = fault_err
        row[f"{fault_name}_excess"] = fault_over
    del got, want
    time_kernel, time_plain = timed or (run_kernel, run_plain)
    row["ms"], row["host_ms"] = time_ms(time_kernel, reps=10, warmup=2)
    row["plain_ms"], _ = time_ms(time_plain, reps=2)
    return row


def dropped_tile(q, k, v, causal: bool, window: int, prefix_len: int = 0):
    """What a faulty kernel returns for the last FAULT_ROWS query rows if
    its walk skips the first KV tile of FAULT_TILE keys those rows see: the
    plain arithmetic in f32 with those keys masked, in q's dtype."""
    import torch
    B, S, H, D = q.shape
    G = H // k.shape[2]
    qf = q[:, -FAULT_ROWS:].float() * (1.0 / math.sqrt(D))
    s = torch.einsum("bqhd,bkhd->bhqk", qf,
                     k.float().repeat_interleave(G, dim=2))
    qp = torch.arange(S - FAULT_ROWS, S, device=q.device)[:, None]
    kp = torch.arange(S, device=q.device)[None, :]
    keep = torch.ones((FAULT_ROWS, S), dtype=torch.bool, device=q.device)
    if causal:
        keep &= (qp >= kp) | (kp < prefix_len)
    if window > 0:
        keep &= (qp - kp) < window
    first = max(0, S - FAULT_ROWS - window + 1) if window > 0 else 0
    lo = first // FAULT_TILE * FAULT_TILE
    keep[:, lo:lo + FAULT_TILE] = False
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p,
                        v.float().repeat_interleave(G, dim=2)).to(q.dtype)


def kernel_forms(table, rows, case: str, sass) -> dict:
    """Per dtype of ``table`` (dtype -> (kernel name, source)): the form's
    kernel, source, ms, bound and library ms at ``case`` (``case``-f32 for
    f32) from ``rows``, and its SASS counts from ``sass`` (the library's:
    kernel name -> counts, or "not available").  Checks that the bf16 form
    runs on the tensor cores (HGMMA in its SASS) where SASS is known."""
    forms = {}
    for dt, (kernel, source) in table.items():
        row = rows[case + ("" if dt == "bfloat16" else "-f32")]
        forms[dt] = {"kernel": kernel, "source": source, "ms": row["ms"],
                     "bound_ms": row["bound_ms"],
                     "library_ms": row["library_ms"],
                     "sass": (sass.get(kernel) if isinstance(sass, dict)
                              else sass)}
    kernel, counts = table["bfloat16"][0], forms["bfloat16"]["sass"]
    if isinstance(sass, dict):
        check(bool(counts) and counts["HGMMA"] > 0,
              f"{kernel} has no HGMMA in its SASS: {counts}")
    return forms


#: the two forms of the flash-attention kernel: (kernel name, source)
FLASH_FORMS = {
    "bfloat16": ("attn_kernel_wgmma", "src/repro_torch/kernels/"
                 "flash_attention/csrc/flash_attention_wgmma.cu"),
    "float32": ("attn_kernel", "src/repro_torch/kernels/flash_attention/"
                "csrc/flash_attention.cu"),
}


def flash_phases(dev, sass) -> dict:
    """The flash-attention kernel against its plain version on every case,
    with the planted fault of ``dropped_tile`` held to the same bound (it
    must fail it), and on a case with a prefix the prefix-blind answer too
    (plain causal attention, which differs from row 0 on), the kernel's
    time, the plain version's, SDPA's and the bound.  Returns the kernel's
    summary entry, less the main path's launches; it names both forms
    (``FLASH_FORMS``, ``kernel_forms``)."""
    import torch

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_torch

    gen = torch.Generator(device=dev).manual_seed(1)
    rows = {}
    max_err = 0.0
    for name, B, S, H, KV, D, dt, causal, window, prefix in FLASH_CASES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
        faults = {"dropped_tile": lambda: (
            dropped_tile(q, k, v, causal, window, prefix), S - FAULT_ROWS)}
        if prefix:
            faults["prefix_blind"] = lambda: (flash_attention_torch(
                q, k, v, causal=causal, window=window), 0)
        res = check_case(
            "flash", name, dt,
            lambda: ops.flash_attention(q, k, v, causal=causal,
                                        window=window, prefix_len=prefix),
            lambda: flash_attention_torch(q, k, v, causal=causal,
                                          window=window, prefix_len=prefix),
            faults)
        max_err = max(max_err, res["max_abs_err"])
        lib_ms, _ = time_ms(lambda: sdpa(q, k, v, causal, window, prefix),
                            reps=10, warmup=2)
        b_ms, b_by, flops, nbytes = attention_bound(B, S, S, H, KV, D, dt,
                                                    causal, window, prefix)
        rows[name] = row = {
            "case": name, "B": B, "S": S, "H": H, "KV": KV, "D": D,
            "dtype": dt, "causal": causal, "window": window,
            "prefix_len": prefix, **res,
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
            "flops": flops, "bytes": nbytes,
            "tflop_s": flops / res["ms"] / 1e9}
        emit("flash_attention", **row)
    lead = rows["qwen3-8b-prefill"]
    forms = kernel_forms(FLASH_FORMS, rows, "qwen3-8b-prefill", sass)
    return {
        "name": "flash_attention", "route": "cuda",
        "source": FLASH_FORMS["bfloat16"][1],
        "replaces": "src/repro/kernels/flash_attention/kernel.py:29",
        "launches": None, "max_abs_err": max_err,
        "ms": lead["ms"], "plain_ms": lead["plain_ms"],
        "bound_ms": lead["bound_ms"], "bound_by": lead["bound_by"],
        "library_ms": lead["library_ms"],
        "shape": "qwen3-8b prefill attention: B=2, S=2048, H=32, KV=8, "
                 "D=128, bf16, causal", "forms": forms}


#: (name, B, S, H, KV, D, dtype, causal, window, prefix_len) of the
#: flash_bwd phase: danube-1.8b's training attention (B 4 x 2048, 32 heads
#: and 8 KV heads of 80, its 4096-token window) in bf16 and, at the f32
#: check's B = 2, in f32; a window shorter than S; paligemma's prefix-LM
#: shape (MQA, D = 256, prefix 256) and a prefix that ends inside a tile;
#: full attention (hubert-like, D = 80) in bf16 and f32; ragged lengths at
#: D = 64 (f32) and D = 128 (MQA, bf16); a prefix in f32
FLASH_BWD_CASES = [
    ("danube-train", 4, 2048, 32, 8, 80, "bfloat16", True, 4096, 0),
    ("danube-train-f32", 2, 2048, 32, 8, 80, "float32", True, 4096, 0),
    ("window", 1, 1000, 8, 2, 64, "bfloat16", True, 200, 0),
    ("paligemma-prefix", 1, 2304, 8, 1, 256, "bfloat16", True, 0, 256),
    ("prefix-in-tile", 2, 600, 8, 1, 256, "bfloat16", True, 0, 100),
    ("prefix-f32", 1, 300, 4, 2, 128, "float32", True, 0, 70),
    ("full", 2, 512, 16, 16, 80, "bfloat16", False, 0, 0),
    ("full-f32", 1, 256, 4, 4, 64, "float32", False, 0, 0),
    ("ragged-f32-d64", 1, 333, 8, 2, 64, "float32", True, 0, 0),
    ("mqa-d128", 1, 777, 8, 1, 128, "bfloat16", True, 0, 0),
]
FLASH_BWD_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                    "flash_attention_bwd.cu")
#: the backward's two forms: (kernels, the ones that do products, source);
#: the C entry point is in FLASH_BWD_SOURCE
FLASH_BWD_FORMS = {
    "bfloat16": (["bwd_prep_kernel", "bwd_dkdv_kernel_wgmma",
                  "bwd_dq_kernel_wgmma"],
                 ["bwd_dkdv_kernel_wgmma", "bwd_dq_kernel_wgmma"],
                 "src/repro_torch/kernels/flash_attention/csrc/"
                 "flash_attention_bwd_wgmma.cu"),
    "float32": (["bwd_delta_kernel", "bwd_dkdv_kernel", "bwd_dq_kernel"],
                ["bwd_dkdv_kernel", "bwd_dq_kernel"], FLASH_BWD_SOURCE),
}
#: the case whose two backward calls must give the same bits
FLASH_BWD_REPEAT_CASE = "danube-train"


def bwd_cat(grads):
    """dq, dk, dv as one (B, n) tensor, so that one bound covers all three."""
    import torch
    return torch.cat([g.flatten(1) for g in grads], dim=1)


def bwd_dq_dropped_tile(q, k, v, o, do, lse, causal, window, prefix_len):
    """What a faulty backward returns if the dQ of the last FAULT_ROWS
    query rows leaves out the first KV tile of FAULT_TILE keys they see:
    the plain backward in f32 less that tile's share of dQ, in q's dtype
    (dK, dV as the plain version's)."""
    import torch

    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bwd_torch
    B, S, H, D = q.shape
    G = H // k.shape[2]
    scale = 1.0 / math.sqrt(D)
    dq, dk, dv = flash_attention_bwd_torch(
        q.float(), k.float(), v.float(), o.float(), do.float(), lse,
        causal=causal, window=window, prefix_len=prefix_len)
    first = max(0, S - FAULT_ROWS - window + 1) if window > 0 else 0
    lo = first // FAULT_TILE * FAULT_TILE
    kt = k[:, lo:lo + FAULT_TILE].float().repeat_interleave(G, dim=2)
    vt = v[:, lo:lo + FAULT_TILE].float().repeat_interleave(G, dim=2)
    rows = slice(S - FAULT_ROWS, S)
    s = torch.einsum("bqhd,bkhd->bhqk", q[:, rows].float() * scale, kt)
    qp = torch.arange(S - FAULT_ROWS, S, device=q.device)[:, None]
    kp = torch.arange(lo, lo + kt.shape[1], device=q.device)[None, :]
    keep = torch.ones_like(qp >= kp)
    if causal:
        keep &= (qp >= kp) | (kp < prefix_len)
    if window > 0:
        keep &= (qp - kp) < window
    p = torch.exp(s - lse[:, :, rows, None]).masked_fill(~keep, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do[:, rows].float(), vt)
    delta = (do[:, rows].float() * o[:, rows].float()).sum(-1)
    ds = p * (dp - delta.permute(0, 2, 1)[..., None])
    dq[:, rows] -= scale * torch.einsum("bhqk,bkhd->bqhd", ds, kt)
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


def sdpa_bwd_ms(q, k, v, do, causal, window, prefix_len):
    """SDPA's backward alone (``torch.autograd.grad`` of one forward with
    its graph kept), ms a call: the yardstick only."""
    import torch
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    S = q.shape[1]
    out = sdpa(*leaves, causal, window if window < S else 0, prefix_len)
    do_t = do.transpose(1, 2)
    ms, _ = time_ms(lambda: torch.autograd.grad(out, leaves, do_t,
                                                retain_graph=True),
                    reps=5, warmup=1)
    return ms


def flash_bwd_phases(dev, sass, ptxas) -> dict:
    """The backward kernel against its plain version on every case
    (``FLASH_BWD_CASES``: dQ, dK and dV under one per-element bound; bf16
    on the tensor-core form, f32 on the CUDA-core form), with three
    planted faults held to the same bound (they must fail it): one KV tile
    left out of dQ (``bwd_dq_dropped_tile``), the D term left out (o taken
    as 0), and on a prefix case the prefix ignored (its pairs dropped,
    what a tile range blind to the prefix leaves out); the kernel's time,
    the plain version's, SDPA's backward and the bound; two calls at
    ``FLASH_BWD_REPEAT_CASE`` giving the same bits.  Checks, where the
    toolkit shows them, that each bf16 kernel that does products runs on
    the tensor cores (HGMMA in its SASS) and that ptxas spills nothing in
    the bf16 form.  Returns the kernel's summary entry, less the main
    path's launches."""
    import torch

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bwd_torch

    gen = torch.Generator(device=dev).manual_seed(2)
    rows, max_err = {}, 0.0
    for name, B, S, H, KV, D, dt, causal, window, prefix in FLASH_BWD_CASES:
        dtype = getattr(torch, dt)
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                       for shape in ((B, S, H, D), (B, S, KV, D),
                                     (B, S, KV, D), (B, S, H, D)))
        mask = {"causal": causal, "window": window, "prefix_len": prefix}
        o, lse = ops._forward(q, k, v, causal, window, prefix, True)
        faults = {
            "dq_dropped_tile": lambda: (bwd_cat(bwd_dq_dropped_tile(
                q, k, v, o, do, lse, causal, window, prefix)), 0),
            "no_delta": lambda: (bwd_cat(flash_attention_bwd_torch(
                q, k, v, torch.zeros_like(o), do, lse, **mask)), 0)}
        if prefix:
            faults["prefix_blind"] = lambda: (bwd_cat(
                flash_attention_bwd_torch(q, k, v, o, do, lse, causal=causal,
                                          window=window, prefix_len=0)), 0)
        res = check_case(
            "flash_bwd", name, dt,
            lambda: bwd_cat(ops.flash_attention_bwd(q, k, v, o, do, lse,
                                                    **mask)),
            lambda: bwd_cat(flash_attention_bwd_torch(q, k, v, o, do, lse,
                                                      **mask)),
            faults)
        max_err = max(max_err, res["max_abs_err"])
        b_ms, b_by, flops, nbytes = attention_bwd_bound(B, S, H, KV, D, dt,
                                                        causal, window,
                                                        prefix)
        rows[name] = row = {
            "case": name, "B": B, "S": S, "H": H, "KV": KV, "D": D,
            "dtype": dt, "causal": causal, "window": window,
            "prefix_len": prefix, **res,
            "library_ms": sdpa_bwd_ms(q, k, v, do, causal, window, prefix),
            "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
            "bytes": nbytes, "tflop_s": flops / res["ms"] / 1e9}
        if name == FLASH_BWD_REPEAT_CASE:
            calls = [ops.flash_attention_bwd(q, k, v, o, do, lse, **mask)
                     for _ in range(2)]
            row["repeat_bit_identical"] = all(
                bits_equal(a, b) for a, b in zip(*calls))
            check(row["repeat_bit_identical"],
                  f"flash_bwd {name}: two calls differ in their bits")
            del calls
        emit("flash_bwd", **row)
        del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    lead = rows["danube-train"]
    entries = ptxas_entries(ptxas)
    forms = {}
    for dt, case in (("bfloat16", "danube-train"),
                     ("float32", "danube-train-f32")):
        kernels, products, source = FLASH_BWD_FORMS[dt]
        forms[dt] = {
            "kernels": kernels, "source": source, "ms": rows[case]["ms"],
            "bound_ms": rows[case]["bound_ms"],
            "library_ms": rows[case]["library_ms"],
            "sass": ({n: sass.get(n) for n in kernels}
                     if isinstance(sass, dict) else sass),
            "ptxas": {e: v for e, v in entries.items()
                      if e.split("<")[0] in kernels}}
    bf16 = forms["bfloat16"]
    if isinstance(sass, dict):
        for n in FLASH_BWD_FORMS["bfloat16"][1]:
            check(bool(sass.get(n)) and sass[n]["HGMMA"] > 0,
                  f"{n} has no HGMMA in its SASS: {sass.get(n)}")
    spilled = {e: v for e, v in bf16["ptxas"].items() if v["spill_bytes"]}
    check(bool(bf16["ptxas"]) and not spilled,
          f"the bf16 backward form spills: {spilled or 'no ptxas lines'}")
    return {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": FLASH_BWD_FORMS["bfloat16"][2],
        "replaces": "src/repro/models/layers.py:77",
        "replaces_note": "XLA's autodiff of blockwise_attention; the JAX "
                         "package has no backward pallas_call",
        "launches": None, "max_abs_err": max_err,
        "ms": lead["ms"], "plain_ms": lead["plain_ms"],
        "bound_ms": lead["bound_ms"], "bound_by": lead["bound_by"],
        "library_ms": lead["library_ms"],
        "shape": "h2o-danube-1.8b training attention: B=4, S=2048, H=32, "
                 "KV=8, D=80, bf16, causal, window 4096", "forms": forms}


def ssd_bound(B, S, H, P, N, dtype):
    """Least time for one SSD call: per chunk of l steps, C B^T over the
    l (l + 1) / 2 causal pairs once per batch row (B and C are shared by
    the heads), and per head C S^T, W x over the causal pairs, and the
    state update, at 2 flops a multiply-add over the peak rate of
    ``dtype``; against x, dt, B, C, A_log, D read once and y written once
    over HBM's rate.  Also the flops the kernel issues per (batch, head,
    chunk): seven full L^3 products in the bf16 form (W, S and kdec x
    split into bf16 hi + lo), four in the f32 form."""
    from repro_torch.kernels.mamba2_ssd.ops import CHUNK
    item = 2 if dtype == "bfloat16" else 4
    lens = [min(CHUNK, S - s0) for s0 in range(0, S, CHUNK)]
    flops = sum(B * (2 * N * ln * (ln + 1) // 2
                     + H * (2 * ln * P * N + 2 * P * ln * (ln + 1) // 2
                            + 2 * ln * P * N)) for ln in lens)
    L = CHUNK
    if dtype == "bfloat16":
        products = L * L * N + 2 * (L * P * N + L * L * P + P * L * N)
    else:
        products = L * L * N + 2 * L * P * N + L * L * P
    kernel_flops = len(lens) * B * H * 2 * products
    nbytes = (2 * item * B * S * H * P + 4 * B * S * H + 2 * item * B * S * N
              + 2 * 4 * H)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops,
            kernel_flops, nbytes)


def mamba2_decay(gen, H: int, *dt_shape):
    """A (H,) and dt ``dt_shape`` from Mamba-2's initial ranges: dt
    log-uniform in DT_RANGE, A uniform over A_RANGE stratified by head (one
    draw in each of H equal strata), so that even a few heads include one
    with A near 1, whose state carries across chunks."""
    import torch
    A = A_RANGE[0] + (A_RANGE[1] - A_RANGE[0]) * (
        torch.arange(H, device=gen.device)
        + torch.rand((H,), generator=gen, device=gen.device)) / H
    lo, hi = map(math.log, DT_RANGE)
    dt = torch.exp(lo + (hi - lo) * torch.rand(dt_shape, generator=gen,
                                               device=gen.device))
    return A, dt


def ssd_inputs(gen, B, S, H, P, N, dtype, decay: str):
    """x, dt, A_log, B, C, D of one SSD case: x, B, C normal in ``dtype``,
    D normal, A = exp(A_log) and dt from Mamba-2's initial ranges
    (``mamba2_decay``), where a head's state decays by exp(-dt A) a step
    and with A near 1 carries across chunks.  With ``decay="mixed"`` the odd heads
    take dt = softplus(normal), the steps of the random-weight model, whose
    state dies within a chunk and whose exponents above the diagonal
    overflow unless guarded."""
    import torch
    import torch.nn.functional as F
    dev = gen.device

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    x = randn(B, S, H, P).to(dtype)
    Bm, Cm = randn(B, S, N).to(dtype), randn(B, S, N).to(dtype)
    A, dt = mamba2_decay(gen, H, B, S, H)
    if decay == "mixed":
        dt[..., 1::2] = F.softplus(randn(B, S, H)[..., 1::2])
    return x, dt, torch.log(A), Bm, Cm, randn(H)


def ssd_window(x, dt, A_log, B, C, D):
    """The plain SSD over a slice of the steps, from a zero state."""
    from repro_torch.kernels.mamba2_ssd.ops import CHUNK
    from repro_torch.kernels.mamba2_ssd.ref import ssd_torch

    def run(w: slice):
        return ssd_torch(x[:, w], dt[:, w], A_log, B[:, w], C[:, w], D,
                         chunk=CHUNK)
    return run


def undecayed(run, S: int, chunk: int):
    """What a faulty scan returns if its state update leaves out the
    carried state's term (the SSD's exp(cum_L) S, the WKV's diag(exp(cum_L))
    S): each chunk then sees the state of the chunk before it alone, so its
    output is the plain arithmetic over that pair of chunks from a zero
    state.  ``run(w)`` is the plain version over the steps of slice ``w``
    (``ssd_window``, ``wkv_window``); a faulty kernel that drops the state
    at a chunk boundary ``at`` returns ``run(slice(at, None))`` from there."""
    import torch
    outs = [run(slice(0, chunk))]
    for s0 in range(chunk, S, chunk):
        outs.append(run(slice(s0 - chunk, min(s0 + chunk, S)))[:, chunk:])
    return torch.cat(outs, dim=1)


#: the two forms of the SSD kernel: (kernel name, source)
SSD_FORMS = {
    "bfloat16": ("ssd_kernel_wgmma", "src/repro_torch/kernels/mamba2_ssd/"
                 "csrc/mamba2_ssd_wgmma.cu"),
    "float32": ("ssd_kernel", "src/repro_torch/kernels/mamba2_ssd/csrc/"
                "mamba2_ssd.cu"),
}


def ssd_phases(dev, sass) -> dict:
    """The Mamba-2 SSD kernel against its plain version on every case, with
    the planted faults ``dropped_state`` (at the middle chunk boundary)
    and ``undecayed_state`` (``undecayed``) held to the same bound (each
    must fail it), the kernel's time, the plain version's and the bound.
    Returns the kernel's summary entry, less the main path's launches; it
    names both forms (``SSD_FORMS``, ``kernel_forms``)."""
    import torch

    from repro_torch.kernels.mamba2_ssd import ops
    from repro_torch.kernels.mamba2_ssd.ops import CHUNK
    from repro_torch.kernels.mamba2_ssd.ref import ssd_torch

    gen = torch.Generator(device=dev).manual_seed(2)
    rows = {}
    max_err = 0.0
    for name, B, S, H, P, N, dt_name, decay in SSD_CASES:
        args = ssd_inputs(gen, B, S, H, P, N, getattr(torch, dt_name), decay)
        # the middle chunk boundary (every case has two chunks or more)
        at = ((S - 1) // CHUNK + 1) // 2 * CHUNK
        check(0 < at < S, f"ssd {name}: S = {S} has no chunk boundary")
        run = ssd_window(*args)
        res = check_case(
            "ssd", name, dt_name, lambda: ops.ssd(*args),
            lambda: ssd_torch(*args, chunk=CHUNK),
            {"dropped_state": lambda: (run(slice(at, None)), at),
             "undecayed_state": lambda: (undecayed(run, S, CHUNK), 0)})
        max_err = max(max_err, res["max_abs_err"])
        b_ms, b_by, flops, kflops, nbytes = ssd_bound(B, S, H, P, N, dt_name)
        rows[name] = row = {
            "case": name, "B": B, "S": S, "H": H, "P": P, "N": N,
            "dtype": dt_name, "decay": decay, "fault_at": at, **res,
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "flops": flops, "kernel_flops": kflops, "bytes": nbytes,
            "tflop_s": kflops / res["ms"] / 1e9,
            "gb_s": nbytes / res["ms"] / 1e6}
        emit("ssd", **row)
    lead = rows["zamba2-prefill"]
    forms = kernel_forms(SSD_FORMS, rows, "zamba2-prefill", sass)
    return {
        "name": "mamba2_ssd", "route": "cuda",
        "source": SSD_FORMS["bfloat16"][1],
        "replaces": "src/repro/kernels/mamba2_ssd/kernel.py:25",
        "launches": None, "max_abs_err": max_err,
        "ms": lead["ms"], "plain_ms": lead["plain_ms"],
        "bound_ms": lead["bound_ms"], "bound_by": lead["bound_by"],
        "library_ms": None,
        "shape": "zamba2-2.7b prefill SSD: B=2, S=2048, H=80, P=64, N=64, "
                 "bf16 x/B/C, f32 dt", "forms": forms}


def wkv_bound(B, S, H, K, dtype):
    """Least time for one WKV call: per (batch, head) and chunk of l steps,
    (r exp(cum_ex)) S and the state update (2 l K^2 multiply-adds), a and
    a v over the l (l - 1) / 2 causal pairs (K each), and the bonus (2 l K),
    at 2 flops a multiply-add over the peak rate of ``dtype``; against r,
    k, v, u read once in ``dtype``, log_w in f32 and o written once over
    HBM's rate."""
    from repro_torch.kernels.rwkv6.ops import CHUNK
    item = 2 if dtype == "bfloat16" else 4
    lens = [min(CHUNK, S - s0) for s0 in range(0, S, CHUNK)]
    flops = sum(B * H * 2 * (2 * ln * K * K + K * ln * (ln - 1) + 2 * ln * K)
                for ln in lens)
    nbytes = 4 * item * B * S * H * K + 4 * B * S * H * K + item * H * K
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def wkv_inputs(gen, B, S, H, K, dtype, decay: str):
    """r, k, v, log_w, u of one WKV case: r, k, v normal and u 0.5 normal in
    ``dtype``, log_w in f32.  "slow": log_w = -exp(-5 + 0.5 normal), about
    -0.0067 a step, the model's own range at its initialisation (w_bias =
    -5, ww at 0.01), under which the state decays by about 0.81 over a
    chunk and carries across chunks; "mixed": the odd channels instead
    -exp(normal), about -1 a step, under which it dies within a chunk.
    Both clamped at LOG_W_MIN = -8."""
    import torch

    from repro_torch.models.rwkv6 import LOG_W_MIN
    dev = gen.device

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    r, k, v = (randn(B, S, H, K).to(dtype) for _ in range(3))
    log_w = -torch.exp(-5.0 + 0.5 * randn(B, S, H, K))
    if decay == "mixed":
        log_w[..., 1::2] = -torch.exp(randn(B, S, H, K)[..., 1::2])
    return r, k, v, log_w.clamp_min(LOG_W_MIN), (0.5 * randn(H, K)).to(dtype)


def wkv_window(r, k, v, log_w, u):
    """The plain WKV over a slice of the steps, from a zero state."""
    from repro_torch.kernels.rwkv6.ops import CHUNK
    from repro_torch.kernels.rwkv6.ref import wkv6_torch

    def run(w: slice):
        return wkv6_torch(r[:, w], k[:, w], v[:, w], log_w[:, w], u,
                          chunk=CHUNK)
    return run


#: the two forms of the WKV kernel: (kernel name, source)
WKV_FORMS = {
    "bfloat16": ("wkv6_kernel_wgmma", "src/repro_torch/kernels/rwkv6/csrc/"
                 "wkv6_wgmma.cu"),
    "float32": ("wkv6_kernel", "src/repro_torch/kernels/rwkv6/csrc/wkv6.cu"),
}


def wkv_geometries(dev) -> None:
    """One ``geometry`` line per geometry of the bf16 WKV form: its ms at
    rwkv6-1.6b's prefill shape (H = 32, K = 64, S = 2048, mixed decays) at
    B = 2 and B = 1, and at B = 2 with every log_w at the model's clamp,
    where every sub-chunk's cum falls past the form's range and the diagonal
    sub-blocks are formed per (t, i, d); each output checked against the
    plain version."""
    import torch

    from repro_torch.kernels.rwkv6 import ops
    from repro_torch.kernels.rwkv6.ref import wkv6_torch
    from repro_torch.models.rwkv6 import LOG_W_MIN

    gen = torch.Generator(device=dev).manual_seed(4)
    inputs = {f"B{B}": wkv_inputs(gen, B, 2048, 32, 64, torch.bfloat16,
                                  "mixed") for B in (2, 1)}
    r, k, v, log_w, u = inputs["B2"]
    inputs["B2_clamp"] = (r, k, v, torch.full_like(log_w, LOG_W_MIN), u)
    kept = ops.kept_geometry()
    for geometry in ops.GEOMETRIES:
        row = {"kernel": "rwkv6", "geometry": geometry,
               "kept": geometry == kept, "log_w_clamp": LOG_W_MIN}
        for key, args in inputs.items():
            over = excess(ops.wkv6(*args, geometry=geometry),
                          wkv6_torch(*args, chunk=ops.CHUNK), "bfloat16")
            check(over <= 0, f"wkv geometry {geometry}, {key}: beyond the "
                             f"bound by {over}")
            row[f"ms_{key}"], _ = time_ms(
                lambda: ops.wkv6(*args, geometry=geometry), reps=10,
                warmup=2)
            row[f"excess_{key}"] = over
        emit("geometry", **row)


def wkv_phases(dev, sass) -> dict:
    """The RWKV-6 WKV kernel against its plain version on every case, with
    the planted faults ``dropped_state`` (at the middle boundary of the
    form's chunks), ``undecayed_state`` (``undecayed``, over the form's
    chunks) and ``no_bonus`` (u = 0) held to the same bound (each must fail
    it), the kernel's time, the plain version's and the bound; then the bf16
    form's geometries (``wkv_geometries``).  Returns the kernel's summary
    entry, less the main path's launches; it names both forms
    (``WKV_FORMS``, ``kernel_forms``)."""
    import torch

    from repro_torch.kernels.rwkv6 import ops
    from repro_torch.kernels.rwkv6.ops import CHUNK
    from repro_torch.kernels.rwkv6.ref import wkv6_torch

    gen = torch.Generator(device=dev).manual_seed(3)
    rows = {}
    max_err = 0.0
    for name, B, S, H, K, dt_name, decay in WKV_CASES:
        args = wkv_inputs(gen, B, S, H, K, getattr(torch, dt_name), decay)
        r, k, v, log_w, u = args
        # the faults a kernel could make: at its own chunks' boundaries
        chunk = ops.FORM_CHUNK[getattr(torch, dt_name)]
        at = ((S - 1) // chunk + 1) // 2 * chunk
        check(0 < at < S, f"wkv {name}: S = {S} has no chunk boundary")
        run = wkv_window(*args)
        res = check_case(
            "wkv", name, dt_name, lambda: ops.wkv6(*args),
            lambda: wkv6_torch(*args, chunk=CHUNK),
            {"dropped_state": lambda: (run(slice(at, None)), at),
             "undecayed_state": lambda: (undecayed(run, S, chunk), 0),
             "no_bonus": lambda: (wkv6_torch(r, k, v, log_w,
                                             torch.zeros_like(u),
                                             chunk=CHUNK), 0)})
        max_err = max(max_err, res["max_abs_err"])
        b_ms, b_by, flops, nbytes = wkv_bound(B, S, H, K, dt_name)
        rows[name] = row = {
            "case": name, "B": B, "S": S, "H": H, "K": K, "dtype": dt_name,
            "decay": decay, "chunk": chunk, "fault_at": at, **res,
            "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
            "bytes": nbytes, "tflop_s": flops / res["ms"] / 1e9,
            "gb_s": nbytes / res["ms"] / 1e6}
        emit("wkv", **row)
    wkv_geometries(dev)
    lead = rows["rwkv6-prefill"]
    forms = kernel_forms(WKV_FORMS, rows, "rwkv6-prefill", sass)
    return {
        "name": "rwkv6", "route": "cuda", "source": WKV_FORMS["bfloat16"][1],
        "replaces": "src/repro/kernels/rwkv6/kernel.py:24",
        "launches": None, "max_abs_err": max_err,
        "ms": lead["ms"], "plain_ms": lead["plain_ms"],
        "bound_ms": lead["bound_ms"], "bound_by": lead["bound_by"],
        "library_ms": None,
        "shape": "rwkv6-1.6b prefill WKV: B=2, S=2048, H=32, K=64, bf16 "
                 "r/k/v/u, f32 log_w", "forms": forms}


def grad_cat(grads):
    """A tuple of gradients as one (1, n) f32 tensor, so that one bound
    covers all of them."""
    import torch
    return torch.cat([g.float().reshape(1, -1) for g in grads], dim=1)


def zeroed(grads, i: int):
    """``grads`` with its ``i``-th gradient zero: what a backward that
    leaves that gradient out returns."""
    import torch
    return tuple(torch.zeros_like(g) if j == i else g
                 for j, g in enumerate(grads))


def scan_bwd_summary(name: str, rows: dict, lead: str, source: str,
                     replaces: str, note: str, shape: str, kernels,
                     ptxas) -> dict:
    """The summary entry of a scan's backward kernel (its ``lead`` case's
    numbers, both dtypes' rows named in ``forms``), with the ptxas lines of
    its kernels (``kernels``), less the main path's launches."""
    entries = ptxas_entries(ptxas)
    forms = {dt: {"case": case, "ms": rows[case]["ms"],
                  "bound_ms": rows[case]["bound_ms"],
                  "bound_by": rows[case]["bound_by"], "library_ms": None}
             for dt, case in (("bfloat16", lead), ("float32", lead + "-f32"))}
    row = rows[lead]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "replaces_note": note, "launches": None,
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None, "shape": shape, "forms": forms,
        "ptxas": {e: v for e, v in entries.items()
                  if e.split("<")[0] in kernels},
        "repeat_bit_identical": row["repeat_bit_identical"]}


#: (name, B, S, H, P, N, dtype, decay) of the SSD backward phase: zamba2's
#: training shape (B = 4, S = 2048, 80 heads of 64, state 64) in bf16 and
#: f32 on Mamba-2's slow decays, a ragged length on mixed decays, and a
#: small shape with P != N; B and C are views of one tensor, as the model
#: hands them over
SSD_BWD_CASES = [
    ("zamba2-train", 4, 2048, 80, 64, 64, "bfloat16", "slow"),
    ("zamba2-train-f32", 4, 2048, 80, 64, 64, "float32", "slow"),
    ("ragged", 2, 2000, 80, 64, 64, "bfloat16", "slow"),
    ("small-p32-n16", 3, 200, 8, 32, 16, "float32", "mixed"),
]
SSD_BWD_SOURCE = ("src/repro_torch/kernels/mamba2_ssd/csrc/"
                  "mamba2_ssd_bwd.cu")
#: the backward's two forms: (kernels, the ones that do products, source);
#: the C entry point is in SSD_BWD_SOURCE
SSD_BWD_FORMS = {
    "bfloat16": (["ssd_bwd_state_kernel_wgmma", "ssd_bwd_chunk_kernel_wgmma",
                  "ssd_bwd_sum_bc_kernel", "ssd_bwd_sum_h_kernel"],
                 ["ssd_bwd_state_kernel_wgmma", "ssd_bwd_chunk_kernel_wgmma"],
                 "src/repro_torch/kernels/mamba2_ssd/csrc/"
                 "mamba2_ssd_bwd_wgmma.cu"),
    "float32": (["ssd_bwd_kernel", "sum_parts_kernel"], ["ssd_bwd_kernel"],
                SSD_BWD_SOURCE),
}
#: the products of 64^3 the bf16 form issues: per (batch, head) and chunk
#: boundary the two walks' state updates; per (batch, chunk) per head phase
#: 2's five and trace(S^T G)'s three, and per group of SSD_BWD_GROUP heads
#: B C^T and dcb's two; each f32 operand counted once a bf16 part
#: (mamba2_ssd_bwd_wgmma.cu: the walks' as hi + mid + lo, the rest hi + lo)
SSD_BWD_PRODUCTS = {"per_boundary": 2 * 3,
                    "per_head": 1 + 2 + 2 + 2 + 2 + 3,
                    "per_group": 1 + 2 + 2}
SSD_BWD_GROUP = 8


def ssd_bwd_bound(B, S, H, P, N, dtype):
    """Least time for one SSD backward call: per chunk of l steps, per head
    the state recomputed (x kdec^T B), dy S_c, (dy exp(cum))^T C, B dS^T
    and x dS (2 l P N each), dy x^T and W^T dy over the l (l + 1) / 2
    causal pairs (2 P each), and per batch row (B and C shared by the
    heads, dcb summed over them first) C B^T, dcb B and dcb^T C over the
    causal pairs (2 N each), over the peak rate of ``dtype``; against x,
    dy, dt, B, C, A_log, D read once and their gradients written once over
    HBM's rate.  Also the flops the kernel issues: in f32 ten full L^3
    products per (batch, head, chunk), in bf16 ``SSD_BWD_PRODUCTS`` per
    (batch, chunk)."""
    from repro_torch.kernels.mamba2_ssd.ops import CHUNK
    item = 2 if dtype == "bfloat16" else 4
    lens = [min(CHUNK, S - s0) for s0 in range(0, S, CHUNK)]
    pairs = [ln * (ln + 1) // 2 for ln in lens]
    flops = sum(B * H * (5 * 2 * ln * P * N + 2 * 2 * P * pr)
                + B * 3 * 2 * N * pr for ln, pr in zip(lens, pairs))
    if dtype == "bfloat16":
        groups = -(-H // SSD_BWD_GROUP)
        products = B * (len(lens) * (H * SSD_BWD_PRODUCTS["per_head"]
                                     + groups * SSD_BWD_PRODUCTS["per_group"])
                        + (len(lens) - 1) * H
                        * SSD_BWD_PRODUCTS["per_boundary"])
    else:
        products = len(lens) * B * H * 10
    kernel_flops = products * 2 * CHUNK ** 3
    nbytes = (3 * item * B * S * H * P + 2 * 4 * B * S * H
              + 4 * item * B * S * N + 4 * 4 * H)
    return (*roofline(flops, nbytes, dtype), flops, kernel_flops, nbytes)


def ssd_bwd_phases(dev, sass, ptxas) -> dict:
    """The SSD backward kernel against its plain version
    (``ssd_bwd_torch``) on every case (bf16 on the tensor-core form, f32
    on the CUDA-core form), all six gradients under one per-element bound,
    with four planted faults held to the same bound (each must fail it):
    the carried dS dropped at the middle chunk, the decay term of dcum_L
    left out, one head's dcb left out of dB's and dC's sum over the heads
    (all three ``omit``), and dD left out; the kernel's time, the plain
    version's and the bound; two calls at zamba2's training shape giving
    the same bits.  Checks, where the toolkit shows them, that each bf16
    kernel that does products runs on the tensor cores (HGMMA in its
    SASS) and that ptxas spills nothing in the bf16 form.  Returns the
    kernel's summary entry, less the main path's launches."""
    import torch

    from repro_torch.kernels.mamba2_ssd import ops
    from repro_torch.kernels.mamba2_ssd.ref import ssd_bwd_torch

    gen = torch.Generator(device=dev).manual_seed(5)
    rows = {}
    for name, B, S, H, P, N, dt_name, decay in SSD_BWD_CASES:
        dtype = getattr(torch, dt_name)
        x, dt, A_log, Bm, Cm, D = ssd_inputs(gen, B, S, H, P, N, dtype, decay)
        bc = torch.cat([Bm, Cm], dim=-1)
        args = (x, dt, A_log, bc[..., :N], bc[..., N:], D)
        dy = torch.randn(x.shape, generator=gen, device=dev).to(dtype)

        def plain(*omit):
            return ssd_bwd_torch(*args, dy, chunk=ops.CHUNK, omit=omit)
        res = check_case(
            "ssd_bwd", name, dt_name, lambda: grad_cat(ops.ssd_bwd(*args, dy)),
            lambda: grad_cat(plain()),
            {"dropped_carry": lambda: (grad_cat(plain("carry")), 0),
             "no_decay_term": lambda: (grad_cat(plain("decay_term")), 0),
             "no_head_dcb": lambda: (grad_cat(plain("head_dcb")), 0),
             "no_dD": lambda: (grad_cat(zeroed(plain(), 5)), 0)},
            timed=(lambda: ops.ssd_bwd(*args, dy), plain))
        b_ms, b_by, flops, kflops, nbytes = ssd_bwd_bound(B, S, H, P, N,
                                                          dt_name)
        rows[name] = row = {
            "case": name, "B": B, "S": S, "H": H, "P": P, "N": N,
            "dtype": dt_name, "decay": decay, **res, "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
            "kernel_flops": kflops, "bytes": nbytes,
            "tflop_s": kflops / res["ms"] / 1e9,
            "gb_s": nbytes / res["ms"] / 1e6}
        if name == "zamba2-train":
            calls = [ops.ssd_bwd(*args, dy) for _ in range(2)]
            row["repeat_bit_identical"] = all(
                bits_equal(a, b) for a, b in zip(*calls))
            check(row["repeat_bit_identical"],
                  f"ssd_bwd {name}: two calls differ in their bits")
            del calls
        emit("ssd_bwd", **row)
        del x, dt, A_log, Bm, Cm, D, bc, args, dy
    torch.cuda.empty_cache()
    if isinstance(sass, dict):
        for n in SSD_BWD_FORMS["bfloat16"][1]:
            check(bool(sass.get(n)) and sass[n]["HGMMA"] > 0,
                  f"{n} has no HGMMA in its SASS: {sass.get(n)}")
    entry = scan_bwd_summary(
        "mamba2_ssd_bwd", rows, "zamba2-train", SSD_BWD_FORMS["bfloat16"][2],
        "src/repro/models/mamba2.py:43",
        "XLA's autodiff of ssd_chunked; the JAX package has no backward "
        "pallas_call",
        "zamba2-2.7b training SSD: B=4, S=2048, H=80, P=64, N=64, bf16 "
        "x/B/C/dy, f32 dt",
        [n for form in SSD_BWD_FORMS.values() for n in form[0]], ptxas)
    for dt, form in entry["forms"].items():
        kernels, _, source = SSD_BWD_FORMS[dt]
        form.update(kernels=kernels, source=source,
                    sass=({n: sass.get(n) for n in kernels}
                          if isinstance(sass, dict) else sass),
                    ptxas={e: v for e, v in entry["ptxas"].items()
                           if e.split("<")[0] in kernels})
    spilled = {e: v for e, v in entry["forms"]["bfloat16"]["ptxas"].items()
               if v["spill_bytes"]}
    check(bool(entry["forms"]["bfloat16"]["ptxas"]) and not spilled,
          f"the bf16 SSD backward form spills: {spilled or 'no ptxas lines'}")
    return entry


#: (name, B, S, H, K, dtype, decay) of the WKV backward phase: rwkv6-1.6b's
#: training shape (B = 4, S = 2048, 32 heads of 64) in bf16 and f32 on the
#: model's slow decays, a ragged length on mixed decays with r, k, v as
#: views of one tensor, every log_w at the model's clamp, and a small head
WKV_BWD_CASES = [
    ("rwkv6-train", 4, 2048, 32, 64, "bfloat16", "slow"),
    ("rwkv6-train-f32", 4, 2048, 32, 64, "float32", "slow"),
    ("ragged", 2, 2000, 32, 64, "bfloat16", "slow"),
    ("clamp", 2, 512, 32, 64, "bfloat16", "clamp"),
    ("small-k16", 3, 200, 8, 16, "float32", "mixed"),
]
WKV_BWD_SOURCE = "src/repro_torch/kernels/rwkv6/csrc/wkv6_bwd.cu"
#: the backward's two forms: (kernels, the ones that do products, source);
#: the C entry point is in WKV_BWD_SOURCE
WKV_BWD_FORMS = {
    "bfloat16": (["wkv6_bwd_walk_kernel_wgmma", "wkv6_bwd_chunk_kernel_wgmma",
                  "wkv6_bwd_sum_u_kernel"],
                 ["wkv6_bwd_walk_kernel_wgmma", "wkv6_bwd_chunk_kernel_wgmma"],
                 "src/repro_torch/kernels/rwkv6/csrc/wkv6_bwd_wgmma.cu"),
    "float32": (["wkv6_bwd_kernel", "sum_parts_kernel"], ["wkv6_bwd_kernel"],
                WKV_BWD_SOURCE),
}


def wkv_bwd_bound(B, S, H, K, dtype):
    """Least time for one WKV backward call: per (batch, head) and chunk of
    l steps, the state recomputed, do S_c^T, (r exp(cum_ex))^T do, v dS^T
    and kdec dS (2 l K^2 each), A, dA, A^T do and the two sums over E over
    the l (l - 1) / 2 causal pairs (2 K each), and the bonus's five terms
    (2 l K each), over the peak rate of ``dtype``; against r, k, v, do, u
    read once in ``dtype`` and log_w in f32, and their gradients written
    once, over HBM's rate."""
    from repro_torch.kernels.rwkv6.ops import CHUNK
    item = 2 if dtype == "bfloat16" else 4
    lens = [min(CHUNK, S - s0) for s0 in range(0, S, CHUNK)]
    flops = sum(B * H * (5 * 2 * ln * K * K + 5 * K * ln * (ln - 1)
                         + 5 * 2 * ln * K) for ln in lens)
    nbytes = (7 * item * B * S * H * K + 2 * 4 * B * S * H * K
              + 2 * item * H * K)
    return (*roofline(flops, nbytes, dtype), flops, nbytes)


def wkv_bwd_phases(dev, sass, ptxas) -> dict:
    """The WKV backward kernel against its plain version
    (``wkv6_bwd_torch``) on every case (bf16 on the tensor-core form, f32
    on the CUDA-core form), all five gradients under one per-element bound,
    with four planted faults held to the same bound (each must fail it):
    the carried dS dropped at the middle chunk and the decay term of dcum_L
    left out (both ``omit``; not at the clamp, where the state dies within
    a step), du left out, and one off-diagonal sub-block's pairs left out
    of dr's and dk's sums over E (``omit=("subblock",)``); the kernel's
    time, the plain version's and the bound; two calls at rwkv6-1.6b's
    training shape giving the same bits.  Checks, where the toolkit shows
    them, that each bf16 kernel that does products runs on the tensor cores
    (HGMMA in its SASS) and that ptxas spills nothing in the bf16 form.
    Returns the kernel's summary entry, less the main path's launches."""
    import torch

    from repro_torch.kernels.rwkv6 import ops
    from repro_torch.kernels.rwkv6.ref import wkv6_bwd_torch
    from repro_torch.models.rwkv6 import LOG_W_MIN

    gen = torch.Generator(device=dev).manual_seed(6)
    rows = {}
    for name, B, S, H, K, dt_name, decay in WKV_BWD_CASES:
        dtype = getattr(torch, dt_name)
        r, k, v, log_w, u = wkv_inputs(gen, B, S, H, K, dtype,
                                       "slow" if decay == "clamp" else decay)
        if decay == "clamp":
            log_w.fill_(LOG_W_MIN)
        if name == "ragged":
            rkv = torch.cat([r, k, v], dim=-1)
            r, k, v = rkv[..., :K], rkv[..., K:2 * K], rkv[..., 2 * K:]
        args = (r, k, v, log_w, u)
        do = torch.randn(r.shape, generator=gen, device=dev).to(dtype)

        def plain(*omit):
            return wkv6_bwd_torch(*args, do, chunk=ops.CHUNK, omit=omit)
        faults = {"no_du": lambda: (grad_cat(zeroed(plain(), 4)), 0),
                  "no_subblock": lambda: (grad_cat(plain("subblock")), 0)}
        if decay != "clamp":
            # at the clamp the state dies within a step: nothing to carry
            faults.update(
                dropped_carry=lambda: (grad_cat(plain("carry")), 0),
                no_decay_term=lambda: (grad_cat(plain("decay_term")), 0))
        res = check_case(
            "wkv_bwd", name, dt_name, lambda: grad_cat(ops.wkv6_bwd(*args, do)),
            lambda: grad_cat(plain()), faults,
            timed=(lambda: ops.wkv6_bwd(*args, do), plain))
        b_ms, b_by, flops, nbytes = wkv_bwd_bound(B, S, H, K, dt_name)
        rows[name] = row = {
            "case": name, "B": B, "S": S, "H": H, "K": K, "dtype": dt_name,
            "decay": decay, **res, "library_ms": None, "bound_ms": b_ms,
            "bound_by": b_by, "flops": flops, "bytes": nbytes,
            "tflop_s": flops / res["ms"] / 1e9,
            "gb_s": nbytes / res["ms"] / 1e6}
        if name == "rwkv6-train":
            calls = [ops.wkv6_bwd(*args, do) for _ in range(2)]
            row["repeat_bit_identical"] = all(
                bits_equal(a, b) for a, b in zip(*calls))
            check(row["repeat_bit_identical"],
                  f"wkv_bwd {name}: two calls differ in their bits")
            del calls
        emit("wkv_bwd", **row)
        del r, k, v, log_w, u, args, do
    torch.cuda.empty_cache()
    if isinstance(sass, dict):
        for n in WKV_BWD_FORMS["bfloat16"][1]:
            check(bool(sass.get(n)) and sass[n]["HGMMA"] > 0,
                  f"{n} has no HGMMA in its SASS: {sass.get(n)}")
    entry = scan_bwd_summary(
        "wkv6_bwd", rows, "rwkv6-train", WKV_BWD_FORMS["bfloat16"][2],
        "src/repro/models/rwkv6.py:44",
        "XLA's autodiff of wkv6_chunked; the JAX package has no backward "
        "pallas_call",
        "rwkv6-1.6b training WKV: B=4, S=2048, H=32, K=64, bf16 r/k/v/u/do, "
        "f32 log_w",
        [n for form in WKV_BWD_FORMS.values() for n in form[0]], ptxas)
    for dt, form in entry["forms"].items():
        kernels, _, source = WKV_BWD_FORMS[dt]
        form.update(kernels=kernels, source=source,
                    sass=({n: sass.get(n) for n in kernels}
                          if isinstance(sass, dict) else sass),
                    ptxas={e: v for e, v in entry["ptxas"].items()
                           if e.split("<")[0] in kernels})
    spilled = {e: v for e, v in entry["forms"]["bfloat16"]["ptxas"].items()
               if v["spill_bytes"]}
    check(bool(entry["forms"]["bfloat16"]["ptxas"]) and not spilled,
          f"the bf16 WKV backward form spills: {spilled or 'no ptxas lines'}")
    return entry


def to_f32(tree):
    """An f32 copy of a parameter tree."""
    if isinstance(tree, dict):
        return {k: to_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_f32(v) for v in tree]
    return tree.float()


@contextlib.contextmanager
def plain_kernels():
    """Within the block, the model's kernels on the card are their plain
    versions (``flash_attention_torch``, ``ssd_torch``, ``wkv6_torch``) in
    place of the kernels: the plain path the kernel path is held against."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_torch
    from repro_torch.kernels.mamba2_ssd.ref import ssd_torch
    from repro_torch.kernels.rwkv6.ref import wkv6_torch
    from repro_torch.models import layers, mamba2, rwkv6
    swaps = ((layers, "flash_attention", flash_attention_torch),
             (mamba2, "ssd", ssd_torch), (rwkv6, "wkv6", wkv6_torch))
    kernels = [getattr(module, name) for module, name, _ in swaps]
    for module, name, plain in swaps:
        setattr(module, name, plain)
    try:
        yield
    finally:
        for (module, name, _), kernel in zip(swaps, kernels):
            setattr(module, name, kernel)


def mamba2_decay_init(layers, gen) -> None:
    """Give every Mamba-2 layer Mamba-2's initial decay in place of the
    reference's zeros: A_log = log A and dt_bias = softplus^-1(dt), with A
    and dt per head from Mamba-2's initial ranges (``mamba2_decay``).
    With zeros (A = 1, dt = softplus(about N(0, 1))) every head's state dies
    within a chunk; with these it carries across chunks, as in a trained
    model, so the kernel's carried state reaches the logits."""
    import torch
    for p in layers:
        H = p["A_log"].shape[0]
        A, dt = mamba2_decay(gen, H, H)
        p["A_log"].copy_(torch.log(A))
        p["dt_bias"].copy_(dt + torch.log(-torch.expm1(-dt)))


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


@contextlib.contextmanager
def routing_log():
    """Within the block, every MoE routing of the model
    (``models.moe.route``) appends its (idx, keep) to the yielded list, one
    entry a layer."""
    from repro_torch.models import moe
    route = moe.route
    log = []

    def logged(*args, **kw):
        r = route(*args, **kw)
        log.append((r.idx, r.keep))
        return r
    moe.route = logged
    try:
        yield log
    finally:
        moe.route = route


def routing_diff(a, b, n_experts: int):
    """Between two routing logs of the same tokens, summed over the
    layers: the top-k choices that differ (an expert one path picked for a
    token and the other did not) and the keep decisions that differ (a
    (token, expert) pair kept on one path and not on the other)."""
    import torch.nn.functional as F
    topk = kept = 0
    for (ia, ka), (ib, kb) in zip(a, b):
        oa, ob = F.one_hot(ia, n_experts), F.one_hot(ib, n_experts)
        topk += int((oa.sum(-2) - ob.sum(-2)).clamp_min(0).sum())
        kept += int(((oa * ka[..., None]).sum(-2)
                     != (ob * kb[..., None]).sum(-2)).sum())
    return topk, kept


def lm_phases(dev, seed: int, arch: str) -> dict:
    """One model at full width: the main path (``prefill_fn`` on B = 2
    prompts of 2048 tokens, paligemma's behind PREFILL_IMAGE image
    embeddings and hubert's 2048 frames of features;
    ``greedy_generate`` for 4 requests, but not for hubert, an encoder,
    and paligemma's with no image, as the reference's) with the
    launches of each kernel checked, the kernel path against the plain path
    and both against the f32 model (all layers, or the first
    ``F32_LAYERS[arch]``), the decode path against prefill, and profiles;
    for a MoE model also its aux loss, the (token, choice) pairs each layer
    drops at the published capacity factor, and the routing decisions that
    differ between the f32 kernel and plain paths.  Returns the main
    path's launches by kernel."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.models.common import init_params, param_bytes
    from repro_torch.models.lm import forward, init_cache
    from repro_torch.models.moe import expert_capacity
    from repro_torch.serve.serve_step import decode_fn, prefill_fn

    cfg = get_config(arch)
    kernels = {"flash_attention": fa_ops, "mamba2_ssd": ssd_ops,
               "rwkv6": wkv_ops}
    # launches a prefill must make: one attention per attention block, one
    # SSD scan per Mamba-2 layer, one WKV per RWKV-6 block; decode none
    per_prefill = dict.fromkeys(kernels, 0)
    if cfg.family == "zamba2":
        per_prefill.update(flash_attention=cfg.n_layers
                           // cfg.shared_attn_every, mamba2_ssd=cfg.n_layers)
    elif cfg.family == "rwkv6":
        per_prefill["rwkv6"] = cfg.n_layers
    else:
        per_prefill["flash_attention"] = cfg.n_layers
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (PREFILL_B, PREFILL_S)).astype(np.int32)).to(dev)
    prompts = [rng.integers(0, cfg.vocab, rng.integers(4, 12))
               .astype(np.int32) for _ in range(SERVE_REQUESTS)]
    # the model's inputs besides tokens: paligemma's image embeddings and
    # hubert's frame features (the stub front ends' outputs), normal f32
    gen_in = torch.Generator(device=dev).manual_seed(seed + 2)
    batch, fwd_kw, prefix = {"tokens": tokens}, {}, 0
    if cfg.family == "paligemma":
        prefix = PREFILL_IMAGE
        fwd_kw["img_embeds"] = torch.randn(
            (PREFILL_B, prefix, cfg.d_model), generator=gen_in, device=dev)
        batch["img_embeds"] = fwd_kw["img_embeds"]
    elif cfg.family == "hubert":
        fwd_kw["features"] = torch.randn(
            (PREFILL_B, PREFILL_S, cfg.d_model), generator=gen_in, device=dev)
        batch = {"features": fwd_kw["features"]}
    encoder = cfg.family == "hubert"

    def last_logits(params, cfg):
        """``forward``'s last-position logits on this phase's inputs."""
        if encoder:
            return forward(params, cfg, **fwd_kw)[0][:, -1]
        return forward(params, cfg, tokens, **fwd_kw)[0][:, -1]

    # ---- the main path, through the user's entry points ------------------
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=dev).manual_seed(seed), cfg,
                         dev)
    if cfg.family == "zamba2":
        mamba2_decay_init(params["layers"],
                          torch.Generator(device=dev).manual_seed(seed + 1))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prefill = prefill_fn(cfg)
    torch.cuda.reset_peak_memory_stats()
    for mod in kernels.values():
        mod.reset_launches()
    walls = []
    for _ in range(2):                       # cold, then warm
        t0 = time.perf_counter()
        last = prefill(params, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    prefill_launches = {k: mod.launches() for k, mod in kernels.items()}
    peak_prefill = torch.cuda.max_memory_allocated()
    serve_walls, outs = [], []
    for _ in range(0 if encoder else 2):     # cold, then warm
        t0 = time.perf_counter()
        outs.append(greedy_generate(params, cfg, prompts, SERVE_NEW,
                                    max_len=64 + SERVE_NEW))
        serve_walls.append(time.perf_counter() - t0)
    main_launches = {k: mod.launches() for k, mod in kernels.items()}
    for k, n in per_prefill.items():
        check(prefill_launches[k] == 2 * n,
              f"{arch}: two prefills launched {k} {prefill_launches[k]} "
              f"times, expected {n} per prefill")
    check(main_launches == prefill_launches,
          f"{arch}: decode launched kernels: {main_launches} after the "
          f"prefills' {prefill_launches}")
    check(bool(torch.isfinite(last).all()), "prefill logits not finite")
    check(tuple(last.shape) == (PREFILL_B, cfg.vocab),
          f"prefill logits {tuple(last.shape)}")

    # ---- the kernel path against the plain path ----------------------------
    # checked in f32, on all layers or the first F32_LAYERS[arch] (the cut:
    # ``cut_params``, ``cut_cfg``; the bf16 model is held to the f32 one at
    # the same cut).  In bf16 a one-ulp difference in one kernel output
    # grows layer by layer with these random weights, so any two bf16 paths
    # end 0.1-0.3 apart at the logits: the bf16 numbers are printed, not
    # checked, and the kernels' bf16 arithmetic is held per call above
    t0 = time.perf_counter()
    with plain_kernels():
        plain = last_logits(params, cfg)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    n32 = F32_LAYERS.get(arch, cfg.n_layers)
    cut_cfg = cfg.scaled(n_layers=n32)
    cut_params = {**params, "layers": params["layers"][:n32]}
    if n32 < cfg.n_layers:
        last_c = last_logits(cut_params, cut_cfg)
        with plain_kernels():
            plain_c = last_logits(cut_params, cut_cfg)
    else:
        last_c, plain_c = last, plain
    cfg32 = cut_cfg.scaled(dtype=torch.float32)
    params32 = to_f32(cut_params)             # the same weights, in f32
    with routing_log() as kern_routes:
        kern32 = last_logits(params32, cfg32)
    with plain_kernels(), routing_log() as plain_routes:
        plain32 = last_logits(params32, cfg32)
    err = {"kernel_vs_plain": rel_l2(last, plain),
           "kernel_vs_f32": rel_l2(last_c, plain32),
           "plain_vs_f32": rel_l2(plain_c, plain32),
           "f32_kernel_vs_f32_plain": rel_l2(kern32, plain32)}
    top1 = {name: float((a.argmax(-1) == b.argmax(-1)).float().mean())
            for name, a, b in (("kernel_vs_plain", last, plain),
                               ("kernel_vs_f32", last_c, plain32),
                               ("plain_vs_f32", plain_c, plain32))}
    moe_info = None
    if cfg.family == "moe":
        # the main path's routing at the published capacity factor: the
        # (token, choice) pairs each layer's experts had no room for
        with routing_log() as routes:
            _, aux = forward(params, cfg, tokens)
        T = PREFILL_B * PREFILL_S
        flips, keep_flips = routing_diff(kern_routes, plain_routes,
                                         cfg.n_experts)
        moe_info = {
            "aux": float(aux), "capacity_factor": cfg.capacity_factor,
            "capacity": expert_capacity(T, cfg.n_experts, cfg.top_k,
                                        cfg.capacity_factor),
            "choices_per_layer": T * cfg.top_k,
            "dropped_per_layer": [int((~keep).sum()) for _, keep in routes],
            "f32_topk_choices_differing": flips,
            "f32_keep_decisions_differing": keep_flips,
            "f32_routing_decisions": n32 * T * cfg.top_k}
        del routes
    emit("lm_prefill", arch=cfg.name, n_layers=cfg.n_layers, dtype="bfloat16",
         B=PREFILL_B, S=PREFILL_S, prefix_len=prefix,
         inputs=("features" if encoder else "tokens"),
         params=cfg.param_count(),
         param_bytes=param_bytes(params), init_s=init_s,
         wall_ms_cold=walls[0], wall_ms=walls[1],
         tokens_per_s=PREFILL_B * (PREFILL_S + prefix) / walls[1] * 1e3,
         plain_path_wall_ms=plain_ms, launches=prefill_launches,
         launches_per_prefill={k: n // 2 for k, n in prefill_launches.items()},
         peak_memory_bytes=peak_prefill, f32_layers=n32, rel_l2=err,
         top1_agreement=top1, tol_f32=2e-3, moe=moe_info)
    check(err["f32_kernel_vs_f32_plain"] <= 2e-3,
          f"{arch}: f32 {n32}-layer prefill: kernel vs plain rel L2 "
          f"{err['f32_kernel_vs_f32_plain']} (moe: {moe_info})")
    del plain, kern32, plain32, last_c, plain_c, kern_routes, plain_routes

    # ---- where the prefill's time goes ------------------------------------
    emit("lm_breakdown", arch=cfg.name, step="prefill", B=PREFILL_B,
         S=PREFILL_S, prefix_len=prefix,
         **device_profile(lambda: prefill(params, batch), LM_GROUPS))
    if encoder:                              # no decode
        del params, cut_params, params32
        torch.cuda.empty_cache()
        return main_launches

    # ---- serving ------------------------------------------------------------
    toks = outs[1]
    steps = max(len(p) for p in prompts) + SERVE_NEW
    check(toks.shape == (SERVE_REQUESTS, SERVE_NEW), f"tokens {toks.shape}")
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()), "token ids")
    check(bool((outs[0] == outs[1]).all()), "greedy decoding not repeatable")
    # the decode path against prefill on request 0's prompt (its last
    # logits after the prompt ran token by token): checked in f32 at the
    # f32 cut; the bf16 numbers, as above, are printed (decode_vs_prefill
    # at full depth, the others at the cut).  A MoE model runs this check at
    # the dropless factor n_experts / top_k (C >= the tokens routed): at
    # its published 1.25 a prefill of the prompt drops (token, choice)
    # pairs that decode, routing one token a step, keeps, so the two
    # differ by the model's own semantics
    factor = (cfg.n_experts / cfg.top_k if cfg.family == "moe"
              else cfg.capacity_factor)
    p0 = torch.from_numpy(prompts[0][None, :]).to(dev)

    def decoded(params, cfg):
        cache = init_cache(cfg, 1, p0.shape[1], device=dev)
        decode = decode_fn(cfg)
        for t in range(p0.shape[1]):
            _, logits, cache = decode(params, cache, p0[:, t:t + 1])
        return logits[:, -1]
    runs = {name: (p, c.scaled(capacity_factor=factor)) for name, p, c in (
        ("full", params, cfg), ("cut", cut_params, cut_cfg),
        ("f32", params32, cfg32)) if name != "cut" or n32 < cfg.n_layers}
    dec = {name: decoded(p, c) for name, (p, c) in runs.items()}
    pre = {name: prefill_fn(c)(p, {"tokens": p0})
           for name, (p, c) in runs.items()}
    dec.setdefault("cut", dec["full"])
    pre.setdefault("cut", pre["full"])
    del params32, runs
    torch.cuda.empty_cache()
    err = {"decode_vs_prefill": rel_l2(dec["full"], pre["full"]),
           "decode_vs_f32": rel_l2(dec["cut"], pre["f32"]),
           "prefill_vs_f32": rel_l2(pre["cut"], pre["f32"]),
           "f32_decode_vs_f32_prefill": rel_l2(dec["f32"], pre["f32"])}
    emit("lm_serve", arch=cfg.name, requests=SERVE_REQUESTS,
         new_tokens=SERVE_NEW, decode_steps=steps, wall_s_cold=serve_walls[0],
         wall_s=serve_walls[1],
         tok_s=SERVE_REQUESTS * SERVE_NEW / serve_walls[1],
         ms_per_decode_step=serve_walls[1] / steps * 1e3,
         prompt_len=int(p0.shape[1]), f32_layers=n32,
         capacity_factor_of_check=factor, rel_l2=err,
         note=(None if cfg.family != "moe" else
               f"decode vs prefill at the dropless factor n_experts/top_k = "
               f"{factor:.4g}, not the published {cfg.capacity_factor}, "
               f"under which a prefill of the prompt may drop (token, "
               f"choice) pairs that decode keeps"),
         sample=toks[0].tolist())
    check(err["f32_decode_vs_f32_prefill"] <= 2e-3,
          f"{arch}: f32 {n32}-layer decode vs prefill rel L2 "
          f"{err['f32_decode_vs_f32_prefill']}")

    # ---- where decode's time goes -------------------------------------------
    decode = decode_fn(cfg)
    cache = init_cache(cfg, SERVE_REQUESTS, 64, device=dev)
    tok = torch.zeros((SERVE_REQUESTS, 1), dtype=torch.int32, device=dev)
    for _ in range(8):
        tok, _, cache = decode(params, cache, tok)

    def four_steps():
        nonlocal tok, cache
        for _ in range(4):
            tok, _, cache = decode(params, cache, tok)
    # the host's time to enqueue a step against the card's time to run it
    step_ms, enqueue_ms = time_ms(four_steps, reps=2)
    emit("lm_breakdown", arch=cfg.name, step="decode x4", B=SERVE_REQUESTS,
         cache_len=cache["len"], device_ms_per_step=step_ms / 4,
         host_enqueue_ms_per_step=enqueue_ms / 4,
         **device_profile(four_steps, LM_GROUPS))
    del params, cut_params, cache
    torch.cuda.empty_cache()
    return main_launches


#: the training phase: h2o-danube-1.8b whole (24 layers, published widths)
#: through ``launch.train.main``, B = 4 sequences of 2048 tokens, 6 steps
#: with a checkpoint every 3, then resumed to step 8; the f32 check on its
#: first TRAIN_F32_LAYERS layers at B = 2 x 2048
TRAIN_ARCH, TRAIN_B, TRAIN_S = "h2o-danube-1.8b", 4, 2048
TRAIN_STEPS, TRAIN_RESUME, TRAIN_CKPT_EVERY = 6, 8, 3
TRAIN_F32_LAYERS, TRAIN_F32_B = 4, 2
#: a training step's kernel groups: the flash forward (with the remat
#: recompute), the backward kernel's three passes, cuBLAS's products
TRAIN_GROUPS = {
    "flash_fwd_ms": lambda n: "attn_kernel" in n,
    "flash_bwd_ms": lambda n: n.startswith("void (anonymous namespace)::bwd_")
    or "bwd_delta_kernel" in n or "bwd_prep_kernel" in n
    or "bwd_dkdv_kernel" in n or "bwd_dq_kernel" in n,
    "gemm_ms": LM_GROUPS["gemm_ms"],
}


def bits_equal(a, b) -> bool:
    """Two tensors hold the same bits (-0.0 and 0.0 differ)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = (t.view(view[t.element_size()]) for t in (a, b))
    return bool(torch.equal(a, b))


def lm_train_phases(dev, seed: int) -> dict:
    """Training on the card.  The f32 check: danube-1.8b's first
    TRAIN_F32_LAYERS layers at full width, B = 2 x 2048: the loss and every
    gradient of the kernel path (flash forward and backward kernels)
    against the plain path (``plain_kernels``) within 2e-3 relative L2,
    with 2 forward and 1 backward launch a layer, and 2 microbatches
    against 1 under the reference test's 5e-3 / 5e-2.  The main path:
    ``launch.train.main`` on the whole model in bf16, 6 steps checkpointed
    every 3, resumed to step 8, with 48 forward and 24 backward launches a
    step, finite losses, and the checkpoint of step 6 restored bit for bit
    equal to the state that was saved; step ms, tokens/s, peak memory and
    the device time of a step by group.  Then one ``--compress`` step and
    one factored-AdamW step, each finite.  Returns the main path's
    launches by kernel."""
    import numpy as np
    import torch

    from repro_torch.checkpoint.checkpoint import restore
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.interop import lm_leaves, map_lm_tree
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.train import main as train_main
    from repro_torch.models.common import init_params
    from repro_torch.train.optimizer import OptConfig, adamw_update
    from repro_torch.train.train_step import (make_loss_and_grad,
                                              make_train_state, train_step_fn)

    cfg = get_config(TRAIN_ARCH)
    L = cfg.n_layers

    # ---- the f32 check: kernel path against plain path --------------------
    cfg32 = cfg.scaled(n_layers=TRAIN_F32_LAYERS, dtype=torch.float32)
    params = init_params(torch.Generator(device=dev).manual_seed(seed), cfg32,
                         dev)
    batch = {k: torch.from_numpy(a).to(dev) for k, a in host_batch(
        cfg32, DataConfig(seed=seed, global_batch=TRAIN_F32_B,
                          seq_len=TRAIN_S), 0).items()}
    fa_ops.reset_launches()
    loss_k, _, grads_k = make_loss_and_grad(cfg32, 1)(params, batch)
    torch.cuda.synchronize()
    f32_launches = (fa_ops.launches(), fa_ops.bwd_launches())
    check(f32_launches == (2 * TRAIN_F32_LAYERS, TRAIN_F32_LAYERS),
          f"f32 check: flash launches (forward, backward) {f32_launches}, "
          f"expected {(2 * TRAIN_F32_LAYERS, TRAIN_F32_LAYERS)}")
    with plain_kernels():
        loss_p, _, grads_p = make_loss_and_grad(cfg32, 1)(params, batch)
    gk = {"/".join(p) + ("" if i is None else f"[{i}]"): t
          for p, i, t in lm_leaves(grads_k)}
    gp = {"/".join(p) + ("" if i is None else f"[{i}]"): t
          for p, i, t in lm_leaves(grads_p)}
    grad_err = {k: rel_l2(gk[k], gp[k]) for k in gk}
    worst = max(grad_err, key=grad_err.get)
    loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    del grads_p, gp
    loss_2, _, grads_2 = make_loss_and_grad(cfg32, 2)(params, batch)
    micro_loss = abs(float(loss_2) - float(loss_k))
    micro_over = 0.0
    for (_, _, a), (_, _, b) in zip(lm_leaves(grads_2), lm_leaves(grads_k)):
        micro_over = max(micro_over, float(((a - b).abs()
                                            - (5e-3 + 5e-2 * b.abs())).max()))
    attn_grads = [gk[k] for k in gk if "/attn/" in "/" + k]
    emit("lm_train", step="f32_check", arch=cfg.name,
         n_layers=TRAIN_F32_LAYERS, B=TRAIN_F32_B, S=TRAIN_S,
         loss_kernel=float(loss_k), loss_plain=float(loss_p),
         loss_rel=loss_err, grad_rel_l2_max=grad_err[worst],
         grad_rel_l2_worst_leaf=worst, tol=2e-3,
         attention_grads_nonzero=all(float(g.abs().max()) > 0
                                     for g in attn_grads),
         launches={"forward": f32_launches[0], "backward": f32_launches[1]},
         microbatch_loss_diff=micro_loss, microbatch_excess=micro_over)
    check(loss_err <= 2e-3 and grad_err[worst] <= 2e-3,
          f"f32 train check: loss rel {loss_err}, gradient {worst} rel L2 "
          f"{grad_err[worst]}")
    check(all(float(g.abs().max()) > 0 for g in attn_grads),
          "an attention weight got no gradient on the kernel path")
    check(micro_loss < 5e-3 and micro_over <= 0,
          f"2 microbatches vs 1: loss {micro_loss}, excess {micro_over}")
    del params, batch, grads_k, grads_2, gk, attn_grads
    torch.cuda.empty_cache()

    # ---- the main path: launch.train on the whole model, bf16 -------------
    root = ROOT / "artifacts"
    root.mkdir(exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=root)
    argv = ["--arch", TRAIN_ARCH, "--batch", str(TRAIN_B), "--seq",
            str(TRAIN_S), "--ckpt-dir", ckpt, "--ckpt-every",
            str(TRAIN_CKPT_EVERY), "--log-every", "1", "--seed", str(seed)]
    try:
        fa_ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out1 = train_main(argv + ["--steps", str(TRAIN_STEPS)])
        run1_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        run1 = (fa_ops.launches(), fa_ops.bwd_launches())
        check(run1 == (2 * L * TRAIN_STEPS, L * TRAIN_STEPS),
              f"train: flash launches (forward, backward) {run1} in "
              f"{TRAIN_STEPS} steps, expected {2 * L} and {L} a step")
        saved = out1.pop("state")
        shutil.rmtree(Path(ckpt) / f"step_{TRAIN_CKPT_EVERY:08d}")
        fa_ops.reset_launches()
        t0 = time.perf_counter()
        out2 = train_main(argv + ["--steps", str(TRAIN_RESUME)])
        run2_s = time.perf_counter() - t0
        run2 = (fa_ops.launches(), fa_ops.bwd_launches())
        n2 = TRAIN_RESUME - TRAIN_STEPS
        check(run2 == (2 * L * n2, L * n2) and len(out2["losses"]) == n2,
              f"resume: launches {run2}, losses {out2['losses']}")
        del out2["state"]
        losses = out1["losses"] + out2["losses"]
        check(all(math.isfinite(x) for x in losses), f"losses {losses}")
        # the checkpoint of step TRAIN_STEPS against what was saved
        template = map_lm_tree(saved, lambda _p, _i, t: torch.empty_like(t))
        t0 = time.perf_counter()
        restored, manifest = restore(ckpt, template, step=TRAIN_STEPS)
        restore_s = time.perf_counter() - t0
        pairs = list(zip(lm_leaves(restored), lm_leaves(saved)))
        differ = [("/".join(p), i) for (p, i, a), (_, _, b) in pairs
                  if not bits_equal(a, b)]
        check(not differ and manifest["extra"]["step"] == TRAIN_STEPS,
              f"restored state differs from the saved one at {differ[:5]}")
        del restored, template, pairs
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)

    step_s = sorted(out1["step_s"][1:] + out2["step_s"][1:])
    step_ms = step_s[len(step_s) // 2] * 1e3
    emit("lm_train", step="main_path", arch=cfg.name, n_layers=L,
         params=out1["params"], dtype="bfloat16", B=TRAIN_B, S=TRAIN_S,
         steps=TRAIN_STEPS, resumed_to=TRAIN_RESUME, losses=losses,
         first_loss=out1["first_loss"], last_loss=out2["last_loss"],
         step_ms=step_ms, step_ms_all=[x * 1e3 for x in out1["step_s"]
                                       + out2["step_s"]],
         tokens_per_s=TRAIN_B * TRAIN_S / step_ms * 1e3,
         peak_memory_bytes=peak, run_s=run1_s, resume_run_s=run2_s,
         restore_s=restore_s, restored_bit_equal=True,
         launches_per_step={"forward": run1[0] // TRAIN_STEPS,
                            "backward": run1[1] // TRAIN_STEPS})

    # ---- where a step's time goes -----------------------------------------
    params, opt_state = saved["params"], saved["opt"]["opt"]
    opt = OptConfig(total_steps=TRAIN_STEPS)
    batch = {k: torch.from_numpy(a).to(dev) for k, a in host_batch(
        cfg, DataConfig(seed=seed, global_batch=TRAIN_B, seq_len=TRAIN_S),
        TRAIN_RESUME).items()}
    total_grad = make_loss_and_grad(cfg, 1)
    grads = None

    def grad_part():
        nonlocal grads
        grads = total_grad(params, batch)[2]
    grad_prof = device_profile(grad_part, TRAIN_GROUPS)
    opt_prof = device_profile(lambda: adamw_update(params, grads, opt_state,
                                                   opt))
    busy = grad_prof["device_busy_ms"]
    named = sum(grad_prof[g] for g in TRAIN_GROUPS)
    emit("lm_breakdown", arch=cfg.name, step="train step", B=TRAIN_B,
         S=TRAIN_S, grad=grad_prof, optimizer=opt_prof,
         groups_ms={**{g: grad_prof[g] for g in TRAIN_GROUPS},
                    "optimizer_ms": opt_prof["device_busy_ms"],
                    "rest_ms": busy - named})
    del params, opt_state, saved, grads, batch
    torch.cuda.empty_cache()

    # ---- one int8-compressed step and one factored step --------------------
    fa_ops.reset_launches()
    out3 = train_main(["--arch", TRAIN_ARCH, "--batch", str(TRAIN_B),
                       "--seq", str(TRAIN_S), "--steps", "1", "--compress",
                       "--seed", str(seed)])
    del out3["state"]
    torch.cuda.empty_cache()
    params = init_params(torch.Generator(device=dev).manual_seed(seed), cfg,
                         dev)
    fopt = OptConfig(total_steps=1, warmup_steps=1, factored=True)
    fstate = make_train_state(cfg, fopt, params)
    batch = {k: torch.from_numpy(a).to(dev) for k, a in host_batch(
        cfg, DataConfig(seed=seed, global_batch=TRAIN_B, seq_len=TRAIN_S),
        0).items()}
    params, fstate, fm = train_step_fn(cfg, fopt)(params, fstate, batch)
    factored_loss = float(fm["total_loss"])
    finite = all(bool(torch.isfinite(t).all())
                 for _, _, t in lm_leaves(params))
    extra = (fa_ops.launches(), fa_ops.bwd_launches())
    emit("lm_train", step="variants", compress_loss=out3["last_loss"],
         factored_loss=factored_loss, factored_params_finite=finite,
         launches={"forward": extra[0], "backward": extra[1]})
    check(math.isfinite(out3["last_loss"]) and math.isfinite(factored_loss)
          and finite, f"compress {out3['last_loss']}, factored "
                      f"{factored_loss}, params finite {finite}")
    del params, fstate, batch
    torch.cuda.empty_cache()
    launches = {"flash_attention": run1[0] + run2[0],
                "flash_attention_bwd": run1[1] + run2[1]}
    for arch in RECURRENT_TRAIN:
        for k, n in recurrent_train_phases(dev, seed, arch).items():
            launches[k] = launches.get(k, 0) + n
    return launches


#: the recurrent models trained on the card: arch -> (the f32 check's
#: layers, the per-layer gradient leaves that must be nonzero).  zamba2's 6
#: layers are one group of Mamba-2 layers and its shared attention block
RECURRENT_TRAIN = {
    "zamba2-2.7b": (6, ("A_log", "D", "dt_bias", "conv_w", "w_in")),
    "rwkv6-1.6b": (4, ("u", "ww", "w_bias", "mix")),
}
RECURRENT_TRAIN_STEPS = 4


def train_groups(arch: str) -> dict:
    """A training step's kernel groups for ``arch``: cuBLAS's products,
    the scan's forward (with the remat replay) and backward kernels, and
    zamba2's flash forward and backward."""
    if arch.startswith("zamba2"):
        scan = {"ssd_fwd_ms": lambda n: "ssd_kernel" in n,
                "ssd_bwd_ms": lambda n: "ssd_bwd_" in n
                or "sum_parts_kernel" in n}
        flash = {g: TRAIN_GROUPS[g] for g in ("flash_fwd_ms", "flash_bwd_ms")}
    else:
        scan = {"wkv_fwd_ms": lambda n: "wkv6_kernel" in n,
                "wkv_bwd_ms": lambda n: "wkv6_bwd_" in n
                or "sum_parts_kernel" in n}
        flash = {}
    return {"gemm_ms": LM_GROUPS["gemm_ms"], **scan, **flash}


def recurrent_train_phases(dev, seed: int, arch: str) -> dict:
    """Training a recurrent model on the card.  The f32 check: its first
    layers (``RECURRENT_TRAIN``) at full width, B = 2 x 2048, zamba2's with
    Mamba-2's initial decays (``mamba2_decay_init``; the reference's zeros
    kill every head's state within a chunk, so a backward without the
    carried dS would still match), rwkv6's with the model's own slow
    decays: the loss and every gradient leaf of the kernel path against the
    plain path (``plain_kernels``: autograd of the plain forwards) within
    2e-3 relative L2, the listed leaves nonzero in every layer, and the
    launches (the scan's forward twice a layer, its remat replay
    included, and its backward once; zamba2's flash once each way a group).
    The main path: ``launch.train.main`` on the whole model in bf16,
    B = 4 x 2048, RECURRENT_TRAIN_STEPS steps, finite losses and the same
    launches a step; step ms, tokens/s, peak memory, then the device time
    of a step by group.  Returns the main path's launches by kernel."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.interop import lm_leaves
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.launch.train import main as train_main
    from repro_torch.models.common import init_params
    from repro_torch.train.optimizer import OptConfig, adamw_update
    from repro_torch.train.train_step import make_loss_and_grad

    cfg = get_config(arch)
    zamba = cfg.family == "zamba2"
    scan_ops, scan = (ssd_ops, "mamba2_ssd") if zamba else (wkv_ops, "rwkv6")

    def counts():
        out = {scan: scan_ops.launches(), scan + "_bwd": scan_ops.bwd_launches()}
        if zamba:
            out.update(flash_attention=fa_ops.launches(),
                       flash_attention_bwd=fa_ops.bwd_launches())
        return out

    def reset():
        scan_ops.reset_launches()
        fa_ops.reset_launches()

    def expected(n_layers: int) -> dict:
        out = {scan: 2 * n_layers, scan + "_bwd": n_layers}
        if zamba:
            groups = n_layers // cfg.shared_attn_every
            out.update(flash_attention=groups, flash_attention_bwd=groups)
        return out

    # ---- the f32 check: kernel path against plain path --------------------
    n_f32, nonzero = RECURRENT_TRAIN[arch]
    cfg32 = cfg.scaled(n_layers=n_f32, dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(gen, cfg32, dev)
    if zamba:
        with torch.no_grad():
            mamba2_decay_init(params["layers"], gen)
    batch = {k: torch.from_numpy(a).to(dev) for k, a in host_batch(
        cfg32, DataConfig(seed=seed, global_batch=TRAIN_F32_B,
                          seq_len=TRAIN_S), 0).items()}
    reset()
    loss_k, _, grads_k = make_loss_and_grad(cfg32, 1)(params, batch)
    torch.cuda.synchronize()
    f32_launches = counts()
    check(f32_launches == expected(n_f32),
          f"{arch} f32 check: launches {f32_launches}, expected "
          f"{expected(n_f32)}")
    with plain_kernels():
        loss_p, _, grads_p = make_loss_and_grad(cfg32, 1)(params, batch)

    def named(grads):
        return {"/".join(p) + ("" if i is None else f"[{i}]"): t
                for p, i, t in lm_leaves(grads)}
    gk, gp = named(grads_k), named(grads_p)
    grad_err = {k: rel_l2(gk[k], gp[k]) for k in gk}
    worst = max(grad_err, key=grad_err.get)
    loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    # the scan layers' own leaves (the reference's stacked "mamba" / "rwkv")
    scan_leaves = [("/".join(p) + f"[{i}]", p[-1], t)
                   for p, i, t in lm_leaves(grads_k)
                   if p[0] in ("mamba", "rwkv") and p[-1] in nonzero]
    zero = [k for k, _, t in scan_leaves if not float(t.abs().max()) > 0]
    checked = sorted({n for _, n, _ in scan_leaves})
    emit("lm_train", step="f32_check", arch=cfg.name, n_layers=n_f32,
         B=TRAIN_F32_B, S=TRAIN_S, loss_kernel=float(loss_k),
         loss_plain=float(loss_p), loss_rel=loss_err,
         grad_rel_l2_max=grad_err[worst], grad_rel_l2_worst_leaf=worst,
         grad_rel_l2={k: grad_err[k] for k in gk
                      if any(k.split("[")[0].endswith("/" + n)
                             for n in nonzero)},
         tol=2e-3, nonzero_checked=checked, zero_grads=zero,
         decay="mamba2_decay_init" if zamba else "the model's own",
         launches=f32_launches)
    check(loss_err <= 2e-3 and grad_err[worst] <= 2e-3,
          f"{arch} f32 train check: loss rel {loss_err}, gradient {worst} "
          f"rel L2 {grad_err[worst]}")
    check(checked == sorted(nonzero) and not zero,
          f"{arch}: leaves {checked} checked, zero gradients at {zero}")
    del params, batch, grads_k, grads_p, gk, gp
    torch.cuda.empty_cache()

    # ---- the main path: launch.train on the whole model, bf16 -------------
    L, steps = cfg.n_layers, RECURRENT_TRAIN_STEPS
    reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train_main(["--arch", arch, "--batch", str(TRAIN_B), "--seq",
                      str(TRAIN_S), "--steps", str(steps), "--log-every",
                      "1", "--seed", str(seed)])
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    run = counts()
    want = {k: n * steps for k, n in expected(L).items()}
    check(run == want, f"{arch} train: launches {run} in {steps} steps, "
                       f"expected {want}")
    losses = out["losses"]
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"{arch} losses {losses}")
    step_s = sorted(out["step_s"][1:])
    step_ms = step_s[len(step_s) // 2] * 1e3
    emit("lm_train", step="main_path", arch=cfg.name, n_layers=L,
         params=out["params"], dtype="bfloat16", B=TRAIN_B, S=TRAIN_S,
         steps=steps, losses=losses, first_loss=out["first_loss"],
         last_loss=out["last_loss"], step_ms=step_ms,
         step_ms_all=[x * 1e3 for x in out["step_s"]],
         tokens_per_s=TRAIN_B * TRAIN_S / step_ms * 1e3,
         peak_memory_bytes=peak, run_s=run_s,
         launches_per_step={k: n // steps for k, n in run.items()})

    # ---- where a step's time goes -----------------------------------------
    state = out.pop("state")
    params, opt_state = state["params"], state["opt"]["opt"]
    opt = OptConfig(total_steps=steps)
    batch = {k: torch.from_numpy(a).to(dev) for k, a in host_batch(
        cfg, DataConfig(seed=seed, global_batch=TRAIN_B, seq_len=TRAIN_S),
        steps).items()}
    total_grad = make_loss_and_grad(cfg, 1)
    grads = None

    def grad_part():
        nonlocal grads
        grads = total_grad(params, batch)[2]
    groups = train_groups(arch)
    grad_prof = device_profile(grad_part, groups)
    opt_prof = device_profile(lambda: adamw_update(params, grads, opt_state,
                                                   opt))
    busy = grad_prof["device_busy_ms"]
    emit("lm_breakdown", arch=cfg.name, step="train step", B=TRAIN_B,
         S=TRAIN_S, grad=grad_prof, optimizer=opt_prof,
         groups_ms={**{g: grad_prof[g] for g in groups},
                    "optimizer_ms": opt_prof["device_busy_ms"],
                    "rest_ms": busy - sum(grad_prof[g] for g in groups)})
    del params, opt_state, state, grads, batch, out
    torch.cuda.empty_cache()
    return run


#: the sharded serving paths (one prefill each, qwen3-8b's decode too)
SHARDED_ARCHS = ("qwen3-8b", "zamba2-2.7b", "rwkv6-1.6b")
#: the dry-run phase's model; its cells are traced on the 16x16 mesh
DRYRUN_ARCH = "qwen3-8b"
DRYRUN_LIMIT_S = 600


@contextlib.contextmanager
def one_rank_group():
    """A one-rank NCCL process group on the card, destroyed on the way
    out."""
    import socket

    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def median_ms(fn, reps: int = 3) -> float:
    """Median wall ms of ``reps`` warm calls (one call first, untimed),
    each ended by a device synchronize: the host's time is the step's
    time where the host holds the card back."""
    import torch
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return sorted(walls)[len(walls) // 2]


def max_diff(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def profiled_ms(fn, reps: int = 3) -> tuple:
    """(median wall ms, median device-busy ms) of ``reps`` warm calls, each
    under ``torch.profiler`` (the kernels' own device time) and ended by a
    synchronize: 1 - busy / wall is the share of the call the card sat
    idle."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    walls, busy = [], []
    for _ in range(reps):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        busy.append(sum(e.self_device_time_total
                        for e in prof.key_averages()) / 1e3)
    return sorted(walls)[reps // 2], sorted(busy)[reps // 2]


def adamw_ms(fn, reps: int = 3) -> float:
    """Median ms of the AdamW update inside ``reps`` warm train steps
    ``fn()``, a synchronize on both sides of it (``train_step``'s
    ``adamw_update`` wrapped while they run)."""
    import torch
    from repro_torch.train import train_step as ts
    update, times = ts.adamw_update, []

    def timed(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = update(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out
    ts.adamw_update = timed
    try:
        for _ in range(reps):
            fn()
    finally:
        ts.adamw_update = update
    return sorted(times)[reps // 2]


def leaves_of(tree, path=()):
    """(path, tensor) of a tree of nested dicts and lists, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_of(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_of(v, path + (i,))
    else:
        yield path, tree


def scaled_diff(got, want) -> float:
    """max |got - want| over the largest |want| (0 where both are 0)."""
    scale = float(want.float().abs().max())
    diff = max_diff(got, want)
    return diff / scale if scale else diff


def sharded_lm_phases(dev, seed: int) -> dict:
    """The sharded entry points on a one-card (1, 1) ``data,model`` mesh
    (a one-rank NCCL group), at full width in bf16, each against its
    unsharded step on the same parameters: ``make_sharded_prefill`` of
    qwen3-8b, zamba2-2.7b and rwkv6-1.6b (B = 2 x 2048; the launches of a
    prefill checked: 36 flash; 9 flash and 54 SSD; 24 WKV),
    ``make_sharded_decode`` of qwen3-8b (4 requests x 16 new tokens, equal
    to ``greedy_generate``'s), and one ``make_sharded_train_step`` of
    h2o-danube-1.8b (B = 4 x 2048; 48 forward and 24 backward flash
    launches; the loss and every updated parameter).  A one-card mesh
    shards nothing: each line prints the largest difference from the
    unsharded output (bound 5e-2, checked) and both times (median of 3
    warm calls).  A wrapper that receives a ``DTensor`` raises.  Returns
    the sharded path's launches by kernel.

    The train step is held by its gradients too: its gradient norm within
    2e-3 and each AdamW moment (m, v) within 2e-3 of its leaf's largest
    value (checked), since one Adam step moves each parameter by about lr
    whatever its gradient; at warm-up 1 that first step's lr is the full
    3e-4, which bf16 parameters of about 0.02 keep.  The decode and train
    lines also split the time: the decode step's device-busy ms (its idle
    share) and the train step's AdamW ms, sharded beside unsharded."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.interop import lm_leaves, map_lm_tree
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import init_params
    from repro_torch.serve.serve_step import make_sharded_prefill, prefill_fn
    from repro_torch.sharding.specs import distribute, full, to_shardings
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (make_sharded_train_step,
                                              make_train_state,
                                              train_step_fn)

    mods = {"flash_attention": fa_ops, "mamba2_ssd": ssd_ops,
            "rwkv6": wkv_ops}
    launches = dict.fromkeys(list(mods) + ["flash_attention_bwd"], 0)

    def counted(fn):
        """``fn()`` with every kernel count set to 0 before it; returns
        (its result, the launches it made by kernel)."""
        for mod in mods.values():
            mod.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        made = {k: mod.launches() for k, mod in mods.items()}
        made["flash_attention_bwd"] = fa_ops.bwd_launches()
        for k, n in made.items():
            launches[k] += n
        return out, made

    mesh = make_mesh((1, 1), ("data", "model"))
    rows = {}
    with one_rank_group():
        mesh.device_mesh("cuda")
        for arch in SHARDED_ARCHS:
            cfg = get_config(arch)
            params = init_params(torch.Generator(device=dev).manual_seed(
                seed), cfg, dev)
            if cfg.family == "zamba2":
                mamba2_decay_init(params["layers"], torch.Generator(
                    device=dev).manual_seed(seed + 1))
            rng = np.random.default_rng(seed)
            batch = {"tokens": torch.from_numpy(rng.integers(
                0, cfg.vocab, (PREFILL_B, PREFILL_S)).astype(np.int32)
            ).to(dev)}
            step, (p_specs, _) = make_sharded_prefill(cfg, mesh, PREFILL_B)
            sparams = distribute(params, to_shardings(p_specs, mesh))
            plain = prefill_fn(cfg)
            want = plain(params, batch)
            got, made = counted(lambda: step(sparams, batch).full_tensor())
            expected = {"flash_attention": 0, "mamba2_ssd": 0, "rwkv6": 0,
                        "flash_attention_bwd": 0}
            if cfg.family == "zamba2":
                expected.update(flash_attention=cfg.n_layers
                                // cfg.shared_attn_every,
                                mamba2_ssd=cfg.n_layers)
            elif cfg.family == "rwkv6":
                expected["rwkv6"] = cfg.n_layers
            else:
                expected["flash_attention"] = cfg.n_layers
            check(made == expected, f"sharded {arch} prefill launched "
                                    f"{made}, expected {expected}")
            diff = max_diff(got, want)
            check(diff <= 5e-2, f"sharded {arch} prefill differs from the "
                                f"unsharded one by {diff}")
            rows[arch, "prefill"] = ms = {
                "sharded_ms": median_ms(lambda: step(sparams, batch)),
                "unsharded_ms": median_ms(lambda: plain(params, batch))}
            emit("sharded_lm", arch=arch, step="prefill", mesh=[1, 1],
                 B=PREFILL_B, S=PREFILL_S, launches=made,
                 max_abs_diff=diff, bound=5e-2, **ms)
            if arch == "qwen3-8b":
                rows[arch, "decode"] = sharded_decode(
                    cfg, params, sparams, mesh, seed, dev, counted)
            del params, sparams, got, want
            torch.cuda.empty_cache()

        cfg = get_config(TRAIN_ARCH)
        opt = OptConfig(total_steps=100, warmup_steps=1)
        params = init_params(torch.Generator(device=dev).manual_seed(seed),
                             cfg, dev)
        state = make_train_state(cfg, opt, params)
        tstep, (p_specs, o_specs, _) = make_sharded_train_step(
            cfg, opt, mesh, TRAIN_B)
        sparams = distribute(map_lm_tree(params, lambda p, i, t: t.clone()),
                             to_shardings(p_specs, mesh))
        sstate = distribute(map_lm_tree(state, lambda p, i, t: t.clone()),
                            to_shardings(o_specs, mesh))
        batch = {k: torch.from_numpy(a).to(dev) for k, a in host_batch(
            cfg, DataConfig(seed=seed, global_batch=TRAIN_B,
                            seq_len=TRAIN_S), 0).items()}
        plain = train_step_fn(cfg, opt)
        _, _, want = plain(params, state, batch)
        (sparams, sstate, got), made = counted(
            lambda: tstep(sparams, sstate, batch))
        expected = {"flash_attention": 2 * cfg.n_layers, "mamba2_ssd": 0,
                    "rwkv6": 0, "flash_attention_bwd": cfg.n_layers}
        check(made == expected, f"sharded {TRAIN_ARCH} step launched "
                                f"{made}, expected {expected}")
        loss_diff = abs(float(got["total_loss"]) - float(want["total_loss"]))
        new = {(p, i): t for p, i, t in lm_leaves(full(sparams))}
        param_diff = max(max_diff(new[p, i], t)
                         for p, i, t in lm_leaves(params))
        gnorm_diff = abs(float(got["grad_norm"]) / float(want["grad_norm"])
                         - 1)
        moments = dict(leaves_of(full(sstate)["opt"]["state"]))
        moment_diff = max(scaled_diff(moments[path], t) for path, t in
                          leaves_of(state["opt"]["state"]))
        check(loss_diff <= 5e-2 and param_diff <= 5e-2,
              f"sharded {TRAIN_ARCH} step: loss differs by {loss_diff}, "
              f"parameters by {param_diff}")
        check(gnorm_diff <= 2e-3 and moment_diff <= 2e-3,
              f"sharded {TRAIN_ARCH} step: gradient norm differs by "
              f"{gnorm_diff} of it, the AdamW moments by {moment_diff} of "
              f"their scale")
        del new, moments
        rows[TRAIN_ARCH, "train"] = ms = {
            "sharded_ms": median_ms(lambda: tstep(sparams, sstate, batch)),
            "unsharded_ms": median_ms(lambda: plain(params, state, batch)),
            "sharded_adamw_ms": adamw_ms(
                lambda: tstep(sparams, sstate, batch)),
            "unsharded_adamw_ms": adamw_ms(
                lambda: plain(params, state, batch))}
        emit("sharded_lm", arch=TRAIN_ARCH, step="train", mesh=[1, 1],
             B=TRAIN_B, S=TRAIN_S, launches=made,
             loss=float(got["total_loss"]), loss_diff=loss_diff,
             max_abs_diff=param_diff, bound=5e-2,
             grad_norm=float(got["grad_norm"]), grad_norm_rel_diff=gnorm_diff,
             moment_scaled_diff=moment_diff, gradient_bound=2e-3,
             lr=float(got["lr"]), **ms)
        del params, state, sparams, sstate
        torch.cuda.empty_cache()
    check("jax" not in sys.modules and "repro" not in sys.modules,
          "the sharded path imported jax or the JAX package")
    return launches, rows


def sharded_decode(cfg, params, sparams, mesh, seed, dev, counted) -> dict:
    """qwen3-8b through ``make_sharded_decode``: ``greedy_generate``'s loop
    (left-padded prompts fed a token at a time, then 16 greedy tokens) on
    the sharded step, its tokens equal to ``greedy_generate``'s; ms per
    decode step of both (median of 3 warm steps)."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import greedy_generate
    from repro_torch.models.lm import init_cache
    from repro_torch.serve.serve_step import decode_fn, make_sharded_decode

    rng = np.random.default_rng(seed + 3)
    prompts = [rng.integers(0, cfg.vocab, rng.integers(4, 12))
               .astype(np.int32) for _ in range(SERVE_REQUESTS)]
    max_len = 64 + SERVE_NEW
    want = greedy_generate(params, cfg, prompts, SERVE_NEW, max_len=max_len)
    dstep, _ = make_sharded_decode(cfg, mesh, SERVE_REQUESTS)
    maxp = max(len(p) for p in prompts)
    padded = np.zeros((SERVE_REQUESTS, maxp), np.int32)
    for i, p in enumerate(prompts):
        padded[i, maxp - len(p):] = p
    padded = torch.from_numpy(padded).to(dev)

    def generate():
        cache = init_cache(cfg, SERVE_REQUESTS, max_len, device=dev)
        for t in range(maxp):
            tok, _, cache = dstep(sparams, cache, padded[:, t:t + 1])
        out = []
        for _ in range(SERVE_NEW):
            out.append(tok.full_tensor())
            tok, _, cache = dstep(sparams, cache, tok)
        return torch.cat(out, dim=1).cpu().numpy(), cache, tok
    (got, cache, tok), made = counted(generate)
    differing = int((got != want).sum())
    check(differing == 0, f"sharded qwen3-8b decode: {differing} tokens "
                          f"differ from greedy_generate's")
    check(not any(made.values()), f"decode launched kernels: {made}")
    plain_cache = init_cache(cfg, SERVE_REQUESTS, max_len, device=dev)
    plain_cache["len"] = cache["len"]
    plain_tok = tok.full_tensor()
    decode = decode_fn(cfg)
    ms = {"sharded_ms": median_ms(lambda: dstep(sparams, cache, tok)),
          "unsharded_ms": median_ms(lambda: decode(params, plain_cache,
                                                   plain_tok))}
    for name, fn in (("sharded", lambda: dstep(sparams, cache, tok)),
                     ("unsharded", lambda: decode(params, plain_cache,
                                                  plain_tok))):
        wall, busy = profiled_ms(fn)
        ms.update({f"{name}_profiled_ms": wall, f"{name}_busy_ms": busy,
                   f"{name}_idle_share": 1 - busy / wall})
    emit("sharded_lm", arch=cfg.name, step="decode", mesh=[1, 1],
         requests=SERVE_REQUESTS, new_tokens=SERVE_NEW, prompt=maxp,
         tokens_differing=differing, launches=made, per="decode step",
         **ms)
    return ms


def dryrun_phase(prefill_ms: float) -> None:
    """``python -m repro_torch.launch.dryrun --arch qwen3-8b --shape all
    --mesh single`` in a subprocess into a temporary directory: every
    non-skipped cell ok (checked), ``report.summary`` printed.  Then the
    roofline of ``sharded_lm``'s own qwen3-8b prefill (B = 2 x 2048) on a
    (1, 1) mesh, traced here under a fake group of one rank, beside the
    measured prefill ms: model_flops / (measured s x 989e12), the share of
    the card's peak the whole step reaches."""
    from repro_torch.analysis import report
    from repro_torch.analysis.roofline import (PEAK_FLOPS_BF16,
                                               analyze_per_device,
                                               model_flops)
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.dryrun import fake_group, lower_cell
    from repro_torch.launch.mesh import make_mesh

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             DRYRUN_ARCH, "--shape", "all", "--mesh", "single", "--out",
             tmp], env={**os.environ, "PYTHONPATH": str(SRC)},
            capture_output=True, text=True, timeout=DRYRUN_LIMIT_S)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"dry-run failed: {proc.stderr[-2000:]}")
        cells = report.load(Path(tmp))
        bad = [c["cell"] for c in cells if c["status"] == "error"]
        check(not bad, f"dry-run cells in error: {bad}")
        emit("dryrun", arch=DRYRUN_ARCH, mesh="pod16x16", wall_s=wall,
             summary=report.summary(cells),
             cells=[{"cell": c["cell"], "status": c["status"],
                     "trace_s": c.get("compile_s"),
                     "bottleneck": c.get("roofline", {}).get("bottleneck"),
                     "roofline_fraction": c.get("roofline", {}).get(
                         "roofline_fraction")} for c in cells])
    shape = ShapeSpec("sharded_lm_prefill", PREFILL_S, PREFILL_B, "prefill")
    with fake_group(1):
        cfg, _, cost, mem = lower_cell(DRYRUN_ARCH, shape, make_mesh(
            (1, 1), ("data", "model")), "1x1")
    mflops = model_flops(cfg, "prefill", PREFILL_S, PREFILL_B)
    roof = analyze_per_device(DRYRUN_ARCH, shape.name, "1x1", 1, cost,
                              mflops, mem["argument_size_in_bytes"]
                              + mem["temp_size_in_bytes"]).to_dict()
    emit("dryrun_roofline", arch=DRYRUN_ARCH, B=PREFILL_B, S=PREFILL_S,
         mesh=[1, 1], t_compute_ms=roof["t_compute_s"] * 1e3,
         t_memory_ms=roof["t_memory_s"] * 1e3,
         t_collective_ms=roof["t_collective_s"] * 1e3,
         bottleneck=roof["bottleneck"], model_flops=mflops,
         trace_flops=roof["hlo_flops"], trace_bytes=roof["hlo_bytes"],
         measured_prefill_ms=prefill_ms,
         step_share=mflops / (prefill_ms / 1e3 * PEAK_FLOPS_BF16))


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the prompts and the random weights")
    ap.add_argument("--stream-repeats", type=int, default=1,
                    help="rounds of the stream phase (each checked and "
                         "printed)")
    args = ap.parse_args(argv)
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: run from the root of a repo checkout "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run on the "
              "card only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    # f32 products in full f32, as the reference's tolerances assume
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit("device", name=kind, nvidia_smi=smi, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    sass, ptxas = build_all()
    rng = np.random.default_rng(args.seed)
    compiled, cgra = cgra_phases(dev, rng)
    cgra["launches_by_path"] = {
        "run_batch": cgra["launches"],
        "stream": sum(stream_phases(dev, rng, compiled)
                      for _ in range(args.stream_repeats)),
        "service": service_phase(rng, compiled),
        "breaker": breaker_phase(rng, compiled),
        "sharded": sharded_phase(rng, compiled),
        "cluster": cluster_phase(rng, compiled),
        "cluster_heal": cluster_heal_phase(rng, compiled),
        "dse": dse_phase(rng),
        "traced": traced_phase(dev, rng)}
    flash = flash_phases(dev, sass["flash_attention"])
    flash_bwd = flash_bwd_phases(dev, sass["flash_attention_bwd"],
                                 ptxas["flash_attention_bwd"])
    ssd = ssd_phases(dev, sass["mamba2_ssd"])
    ssd_bwd = ssd_bwd_phases(dev, sass["mamba2_ssd_bwd"],
                             ptxas["mamba2_ssd_bwd"])
    wkv = wkv_phases(dev, sass["rwkv6"])
    wkv_bwd = wkv_bwd_phases(dev, sass["rwkv6_bwd"], ptxas["rwkv6_bwd"])
    launches = {"flash_attention": 0, "mamba2_ssd": 0, "rwkv6": 0}
    for arch in LM_ARCHS:
        for k, n in lm_phases(dev, args.seed, arch).items():
            launches[k] += n
    train = lm_train_phases(dev, args.seed)
    sharded, rows = sharded_lm_phases(dev, args.seed)
    dryrun_phase(rows[DRYRUN_ARCH, "prefill"]["sharded_ms"])
    for entry, kernel in ((flash, "flash_attention"), (ssd, "mamba2_ssd"),
                          (wkv, "rwkv6")):
        entry["launches_by_path"] = {"serving": launches[kernel],
                                     "training": train[kernel],
                                     "sharded": sharded[kernel]}
        entry["launches"] = sum(entry["launches_by_path"].values())
    flash_bwd["launches_by_path"] = {
        "training": train["flash_attention_bwd"],
        "sharded": sharded["flash_attention_bwd"]}
    flash_bwd["launches"] = sum(flash_bwd["launches_by_path"].values())
    ssd_bwd["launches"] = train["mamba2_ssd_bwd"]
    wkv_bwd["launches"] = train["rwkv6_bwd"]
    entries = [cgra, flash, flash_bwd, ssd, ssd_bwd, wkv, wkv_bwd]
    for entry in entries[1:]:
        check(entry["launches"] > 0, f"the main path never launched "
                                     f"{entry['name']}")
    check("jax" not in sys.modules and "repro" not in sys.modules,
          "the port imported jax or the JAX package")
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
