"""Public wrapper of the hand-written RWKV-6 WKV kernel.

``wkv6(r, k, v, log_w, u)`` launches the kernel (``csrc/wkv6.cu``) when the
tensors lie on a CUDA device and raises if it cannot; only CPU tensors go to
the plain PyTorch version (``ref.wkv6_torch``).  Every launch adds one to
the module's launch count (``launches()``), so a run can show that it went
through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.rwkv6.ref import wkv6_torch

SOURCES = (Path(__file__).resolve().parent / "csrc" / "wkv6.cu",)
#: the dtypes of r, k, v and o the kernel takes, by the code its C entry
#: point reads (log_w and u are handed over in f32)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's chunk length (fixed in csrc/wkv6.cu) and its widest head
CHUNK = 32
MAX_HEAD = 64

_launches = 0
_count_lock = threading.Lock()


def launches() -> int:
    """Kernel launches since the last ``reset_launches`` (CUDA only)."""
    with _count_lock:
        return _launches


def reset_launches() -> None:
    global _launches
    with _count_lock:
        _launches = 0


def build() -> Path:
    """Build the kernel library (no-op when it exists); returns its path."""
    return _build.build("rwkv6", SOURCES, {})


@functools.cache
def _launcher():
    """The library's C entry point, built and loaded once per process."""
    fn = _build.load("rwkv6", SOURCES, {}).wkv6_launch
    # r, k, v, log_w, u, o; dtype, B, S, H, K; strides; stream
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(r, k, v, log_w, u):
    for name, t in (("r", r), ("k", k), ("v", v), ("log_w", log_w),
                    ("u", u)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
        if t.device != r.device:
            raise ValueError(f"{name} lies on {t.device}, r on {r.device}")
    if r.dim() != 4:
        raise ValueError(f"r must be (B, S, H, K), got {tuple(r.shape)}")
    for name, t in (("k", k), ("v", v), ("log_w", log_w)):
        if t.shape != r.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(r.shape)}")
    B, S, H, K = r.shape
    if tuple(u.shape) != (H, K):
        raise ValueError(f"u has shape {tuple(u.shape)}, expected {(H, K)}")
    if min(B, S, H, K) < 1:
        raise ValueError(f"empty shape: r {tuple(r.shape)}")
    return B, S, H, K


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         log_w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Chunked WKV6 over chunks of ``CHUNK`` steps.  r, k, v, log_w: (B, S,
    H, K), log_w <= 0 the per-channel log decay; u: (H, K), the bonus.
    Returns o: (B, S, H, K) in r's dtype, rounded once.

    On CUDA tensors this launches the kernel on the current stream, without
    synchronising, or raises: r, k and v share one dtype of f32 or bf16,
    log_w is f32 or r's dtype, K is at most 64, and the last axis of r, k, v
    and log_w is contiguous (other strides are read as they are).  CPU
    tensors run the plain version."""
    global _launches
    B, S, H, K = _check(r, k, v, log_w, u)
    if r.device.type == "cpu":
        return wkv6_torch(r, k, v, log_w, u, chunk=CHUNK)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6 runs on cuda or cpu, not {r.device}")
    if r.dtype not in DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"r, k, v must share one dtype of "
                         f"{sorted(map(str, DTYPES))}, got {r.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if log_w.dtype not in (torch.float32, r.dtype):
        raise ValueError(f"log_w must be float32 or r's dtype, got "
                         f"{log_w.dtype}")
    if K > MAX_HEAD:
        raise ValueError(f"K = {K} must be at most {MAX_HEAD}")
    if any(t.stride(-1) != 1 for t in (r, k, v, log_w)):
        raise ValueError("r, k, v and log_w need a contiguous last axis")
    log_w, u = log_w.float(), u.float().contiguous()
    o = torch.empty((B, S, H, K), dtype=r.dtype, device=r.device)
    strides = (ctypes.c_longlong * 12)(
        *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *log_w.stride()[:3])
    fn = _launcher()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
                 u.data_ptr(), o.data_ptr(), DTYPES[r.dtype], B, S, H, K,
                 strides, stream)
    if err != 0:
        raise RuntimeError(f"rwkv6 wkv6 launch failed: CUDA error {err}")
    with _count_lock:
        _launches += 1
    return o
