"""Public wrapper of the hand-written flash-attention kernel.

``flash_attention(q, k, v, causal=..., window=..., prefix_len=...)``
launches the kernel when the tensors lie on a CUDA device and raises if it
cannot: bf16 runs the tensor-core form (``csrc/flash_attention_wgmma.cu``:
wgmma and TMA), f32 the CUDA-core form (``csrc/flash_attention.cu``, whose
C entry point picks the form by dtype).  Only CPU tensors go to the plain
PyTorch version (``ref.flash_attention_torch``).  Every launch adds one to
the module's launch count (``launches()``), so a run can show that it went
through the kernel.

Its gradient: when grad is enabled and q, k or v requires grad,
``flash_attention`` goes through ``FlashAttentionFn``, an autograd Function
whose forward is the same launch with each row's log-sum-exp kept, and
whose backward launches the hand-written backward kernel (a library of its
own, whose C entry point in ``csrc/flash_attention_bwd.cu`` sends bf16 to
the tensor-core form, ``csrc/flash_attention_bwd_wgmma.cu``, and f32 to
its CUDA-core form) on CUDA tensors, adding one to ``bwd_launches()``, or
runs its plain version (``ref.flash_attention_bwd_torch``) on CPU tensors.
Serving, with no gradient, launches exactly the forward.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from pathlib import Path
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build as _build
from repro_torch.kernels import refuse_dtensor
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_torch, flash_attention_torch)

_CSRC = Path(__file__).resolve().parent / "csrc"
#: the two forms' sources and the Hopper header the bf16 form includes
SOURCES = (_CSRC / "flash_attention.cu", _CSRC / "flash_attention_wgmma.cu",
           _CSRC.parents[1] / "csrc" / "hopper.cuh")
#: the backward kernel's sources, a library of its own: the C entry point
#: and the f32 CUDA-core form, the bf16 tensor-core form and its header
BWD_SOURCES = (_CSRC / "flash_attention_bwd.cu",
               _CSRC / "flash_attention_bwd_wgmma.cu",
               _CSRC.parents[1] / "csrc" / "hopper.cuh")
#: the dtypes the kernel takes, by the code its C entry point reads
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the widest head the kernel's templates cover (D is padded to 32s in f32,
#: 16s in bf16)
MAX_HEAD_DIM = 256
#: the bf16 form's TMA reads rows of 16-byte multiples from 16-byte
#: aligned tensors: a bf16 head is padded with zeros to a multiple of this
BF16_HEAD_ALIGN = 8
#: the bf16 backward's row vectors (lse, Drow) are padded to this many rows
BWD_ROW_PAD = 128

_launches = 0
_bwd_launches = 0
_count_lock = threading.Lock()


def launches() -> int:
    """Forward kernel launches since the last ``reset_launches`` (CUDA
    only)."""
    with _count_lock:
        return _launches


def bwd_launches() -> int:
    """Backward kernel launches since the last ``reset_launches`` (CUDA
    only)."""
    with _count_lock:
        return _bwd_launches


def reset_launches() -> None:
    """Set both counts to 0."""
    global _launches, _bwd_launches
    with _count_lock:
        _launches = _bwd_launches = 0


def build() -> Path:
    """Build the kernel library (no-op when it exists); returns its path."""
    return _build.build("flash_attention", SOURCES, {})


def build_bwd() -> Path:
    """Build the backward kernel's library (no-op when it exists)."""
    return _build.build("flash_attention_bwd", BWD_SOURCES, {})


@functools.cache
def _launcher():
    """The library's C entry point, built and loaded once per process."""
    fn = _build.load("flash_attention", SOURCES,
                     {}).flash_attention_launch
    # q, k, v, o, lse; dtype, B, Sq, Skv, H, KV, D, causal, window,
    # prefix_len; scale; stream
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_launcher():
    """The backward library's C entry point, built and loaded once."""
    fn = _build.load("flash_attention_bwd", BWD_SOURCES,
                     {}).flash_attention_bwd_launch
    # q, k, v, o, dout, lse, delta, dq, dk, dv; dtype, B, Sq, Skv, H, KV, D,
    # causal, window, prefix_len; scale; stream
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, window: int,
           prefix_len: int) -> Tuple[int, int, int, int, int, int]:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
    B, Sq, H, D = q.shape
    Bk, Skv, KV, Dk = k.shape
    if tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if Bk != B or Dk != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch or head width")
    if min(B, Sq, Skv, H, KV, D) < 1 or H % KV:
        raise ValueError(f"need non-empty shapes and H % KV == 0, got "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype or q.dtype not in DTYPES:
        raise ValueError(f"q, k, v must share one dtype of "
                         f"{sorted(map(str, DTYPES))}, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v lie on {q.device}, {k.device}, {v.device}")
    if int(window) < 0:
        raise ValueError(f"window must be >= 0 (0: none), got {window}")
    if int(prefix_len) < 0:
        raise ValueError(f"prefix_len must be >= 0 (0: none), got "
                         f"{prefix_len}")
    if window > 0 and Sq - Skv >= window:
        # rows qp >= Skv - 1 + window see no key: the TPU kernel gives them
        # the mean of V over every key, padding included, which the kernel's
        # tile skipping does not reproduce
        raise ValueError(f"window {window} leaves query rows from "
                         f"{Skv - 1 + window} on with no key (Sq {Sq}, "
                         f"Skv {Skv})")
    return B, Sq, H, D, Skv, KV


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    prefix_len: int = 0) -> torch.Tensor:
    """Causal / sliding-window / full / prefix-LM GQA attention.

    q: (B, Sq, H, D); k/v: (B, Skv, KV, D); f32 or bf16, accumulated in f32;
    returns (B, Sq, H, D) in q's dtype.  ``window`` > 0 keeps keys with
    ``q_pos - k_pos < window``; ``prefix_len`` > 0 (read only when causal)
    also keeps every key before it, whatever the query: the reference's
    prefix-LM mask.  Positions are absolute and 0-based for both q and
    k.  A window that leaves a query row no key raises on every
    device.  On CUDA tensors this launches the kernel on the current
    stream, without synchronising, or raises; CPU tensors run the plain
    version.  When grad is enabled and an input requires grad, the call
    goes through ``FlashAttentionFn``, whose backward is the backward
    kernel (CUDA) or its plain version (CPU)."""
    refuse_dtensor("flash_attention", q, k, v)
    _check(q, k, v, window, prefix_len)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, bool(causal), int(window),
                                      int(prefix_len))
    return _forward(q, k, v, bool(causal), int(window), int(prefix_len),
                    False)[0]


def _forward(q, k, v, causal: bool, window: int, prefix_len: int,
             with_lse: bool):
    """The forward on checked inputs: (out, lse or None), lse the f32
    (B, H, Sq) log-sum-exp of each row when ``with_lse``."""
    global _launches
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if q.device.type == "cpu":
        if with_lse:
            return flash_attention_torch(q, k, v, causal=causal,
                                         window=window,
                                         prefix_len=prefix_len,
                                         return_lse=True)
        return flash_attention_torch(q, k, v, causal=causal, window=window,
                                     prefix_len=prefix_len), None
    _check_cuda(q, k, v)
    Dk = D
    if q.dtype == torch.bfloat16:
        if D % BF16_HEAD_ALIGN:
            # zero columns change no score and come out as zero columns
            Dk = D + (-D % BF16_HEAD_ALIGN)
            q, k, v = (F.pad(t, (0, Dk - D)) for t in (q, k, v))
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("the bf16 kernel takes 16-byte aligned q, k, v")
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    fn = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 DTYPES[q.dtype], B, Sq, Skv, H, KV, Dk, int(causal),
                 window, prefix_len, 1.0 / math.sqrt(D), stream)
    if err < 0:
        raise RuntimeError(f"flash_attention: cuTensorMapEncodeTiled failed "
                           f"(CUresult {-err}; 1 also when libcuda has no "
                           f"such entry point)")
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    with _count_lock:
        _launches += 1
    return (out if Dk == D else out[..., :D].contiguous()), lse


def _check_cuda(q, k, v) -> None:
    """What the CUDA kernels take beyond ``_check``."""
    B, _, H, D = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the kernel takes contiguous q, k, v")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head width {D} > {MAX_HEAD_DIM}")
    if B * H > 65535:
        raise ValueError(f"B * H = {B * H} exceeds the grid's 65535 rows")


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True,
                        window: int = 0, prefix_len: int = 0):
    """dq, dk, dv of ``flash_attention`` from its inputs, its output ``o``,
    the output's gradient ``do`` and the forward's log-sum-exp ``lse``
    (B, H, Sq) f32.  On CUDA tensors this launches the backward kernel on
    the current stream (three passes, one count in ``bwd_launches``) or
    raises: bf16 on the tensor-core form, its head padded with zero
    columns to a multiple of ``BF16_HEAD_ALIGN`` as the forward's, f32 on
    the CUDA-core form.  CPU tensors run ``flash_attention_bwd_torch``.
    The gradients are of the caller's own head width, scaled by
    1/sqrt(D)."""
    global _bwd_launches
    refuse_dtensor("flash_attention_bwd", q, k, v, o, do, lse)
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    do = do.contiguous()
    if q.device.type == "cpu":
        return flash_attention_bwd_torch(q, k, v, o, do, lse, causal=causal,
                                         window=window, prefix_len=prefix_len)
    _check_cuda(q, k, v)
    for name, t, want in (("o", o, q), ("do", do, q)):
        if t.shape != want.shape or t.dtype != want.dtype or \
                t.device != want.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {want.dtype} "
                             f"{tuple(want.shape)} on {want.device}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 or \
            not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous f32 {(B, H, Sq)}")
    Dk = D
    if q.dtype == torch.bfloat16:
        if D % BF16_HEAD_ALIGN:
            # zero columns change no score, no Drow and no gradient column
            Dk = D + (-D % BF16_HEAD_ALIGN)
            q, k, v, o, do = (F.pad(t, (0, Dk - D)) for t in (q, k, v, o, do))
        if any(t.data_ptr() % 16 for t in (q, k, v, o, do)):
            raise ValueError("the bf16 backward takes 16-byte aligned q, k, "
                             "v, o, do")
        # lse in log2 units and Drow, each (B, H, Sq padded to 128 rows)
        scratch = torch.empty(2 * B * H * -(-Sq // BWD_ROW_PAD)
                              * BWD_ROW_PAD, dtype=torch.float32,
                              device=q.device)
    else:
        scratch = torch.empty_like(lse)               # Drow
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    fn = _bwd_launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 DTYPES[q.dtype], B, Sq, Skv, H, KV, Dk, int(bool(causal)),
                 int(window), int(prefix_len), 1.0 / math.sqrt(D), stream)
    if err < 0:
        raise RuntimeError(f"flash_attention backward: cuTensorMapEncodeTiled "
                           f"failed (CUresult {-err}; 1 also when libcuda has "
                           f"no such entry point)")
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch failed: CUDA "
                           f"error {err}")
    with _count_lock:
        _bwd_launches += 1
    if Dk != D:
        dq, dk, dv = (t[..., :D].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with its gradient: the forward saves q, k, v,
    the output and each row's log-sum-exp; the backward hands them with the
    output's gradient to ``flash_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, prefix_len: int):
        out, lse = _forward(q, k, v, causal, window, prefix_len, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = {"causal": causal, "window": window,
                    "prefix_len": prefix_len}
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do, lse, **ctx.mask)
        return dq, dk, dv, None, None, None
