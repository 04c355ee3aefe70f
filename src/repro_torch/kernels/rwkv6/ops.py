"""Public wrapper of the hand-written RWKV-6 WKV kernel.

``wkv6(r, k, v, log_w, u)`` launches the kernel when the tensors lie on a
CUDA device and raises if it cannot: bf16 runs the tensor-core form
(``csrc/wkv6_wgmma.cu``: wgmma and TMA, kernel ``wkv6_kernel_wgmma``), f32
the CUDA-core form (``csrc/wkv6.cu``, kernel ``wkv6_kernel``, whose C entry
point picks the form by dtype).  Only CPU tensors go to the plain PyTorch
version (``ref.wkv6_torch``).  Every call that launches adds one to the
module's launch count (``launches()``), so a run can show that it went
through the kernel.

Its gradient: when grad is enabled and an input requires grad, ``wkv6``
goes through ``WKV6Fn``, an autograd Function whose forward is the same
launch and whose backward launches the hand-written backward kernel (a
library of its own: bf16 on the tensor cores, ``csrc/wkv6_bwd_wgmma.cu``,
kernels ``wkv6_bwd_walk_kernel_wgmma``, ``wkv6_bwd_chunk_kernel_wgmma`` and
``wkv6_bwd_sum_u_kernel``; f32 on the CUDA cores, ``csrc/wkv6_bwd.cu``,
whose C entry point picks the form by dtype) on CUDA tensors, adding one to
``bwd_launches()``, or runs its plain version (``ref.wkv6_bwd_torch``) on
CPU tensors.  Serving, with no gradient, launches exactly the forward.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import build as _build
from repro_torch.kernels import refuse_dtensor
from repro_torch.kernels.rwkv6.ref import wkv6_bwd_torch, wkv6_torch

_CSRC = Path(__file__).resolve().parent / "csrc"
#: the two forms' sources and the Hopper header the bf16 form includes
SOURCES = (_CSRC / "wkv6.cu", _CSRC / "wkv6_wgmma.cu",
           _CSRC.parents[1] / "csrc" / "hopper.cuh")
#: the backward kernel's sources, a library of its own: the C entry point
#: and the f32 form (chunks of ``CHUNK`` on the CUDA cores), the bf16 form
#: (chunks of 64 on the tensor cores) and the Hopper header it includes
BWD_SOURCES = (_CSRC / "wkv6_bwd.cu", _CSRC / "wkv6_bwd_wgmma.cu",
               _CSRC.parents[1] / "csrc" / "hopper.cuh")
#: the dtypes of r, k, v and o the kernel takes, by the code its C entry
#: point reads (log_w and u are handed over in f32)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the plain version's chunk length on the CPU (the reference's), and each
#: form's own (fixed in its source): the f32 form's 32, the bf16 form's 64
#: (four sub-chunks of 16, wgmma's rows)
CHUNK = 32
FORM_CHUNK = {torch.float32: 32, torch.bfloat16: 64}
MAX_HEAD = 64
#: the bf16 form's geometries by the value columns a block, which its C
#: entry point reads ("n64": one block a (batch, head); "n32": two, each
#: forming all of A).  The entry point runs its own default
#: (``kept_geometry()``) unless asked for one (``wkv6(..., geometry=...)``)
GEOMETRIES = {"n64": 64, "n32": 32}
#: the bf16 form's TMA reads tensors that start on 16 bytes and whose strides
#: (but the last) are multiples of 16 bytes
TMA_ALIGN = 16

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
    return _build.build("rwkv6", SOURCES, {})


def build_bwd() -> Path:
    """Build the backward kernel's library (no-op when it exists)."""
    return _build.build("rwkv6_bwd", BWD_SOURCES, {})


def kept_geometry() -> str:
    """The geometry the bf16 form runs when the caller names none, as its C
    entry point states it (builds the library if it is not built)."""
    columns = _build.load("rwkv6", SOURCES, {}).wkv6_kept_columns()
    return {n: g for g, n in GEOMETRIES.items()}[columns]


@functools.cache
def _launcher():
    """The library's C entry point, built and loaded once per process."""
    fn = _build.load("rwkv6", SOURCES, {}).wkv6_launch
    # r, k, v, log_w, u, o; dtype, B, S, H, K; strides; columns; stream
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_launcher():
    """The backward library's C entry point and its scratch size, built
    and loaded once per process."""
    lib = _build.load("rwkv6_bwd", BWD_SOURCES, {})
    fn = lib.wkv6_bwd_launch
    # r, k, v, log_w, u, do, dr, dk, dv, dlog_w, du, scratch; dtype, B, S,
    # H, K; strides; stream
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    size = lib.wkv6_bwd_scratch_floats
    # dtype, B, S, H, K
    size.argtypes = [ctypes.c_int] * 5
    size.restype = ctypes.c_longlong
    return fn, size


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


def _tma_readable(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the bf16 form's TMA can read it as it lies, else a
    contiguous copy with its last axis zero-padded to 16 bytes (the kernel
    still reads only the first ``t.shape[-1]`` columns)."""
    size = t.element_size()
    if t.data_ptr() % TMA_ALIGN == 0 and all(
            st * size % TMA_ALIGN == 0 for st in t.stride()[:-1]):
        return t
    return F.pad(t, (0, -t.shape[-1] % (TMA_ALIGN // size))).contiguous()


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         log_w: torch.Tensor, u: torch.Tensor,
         geometry: str | None = None) -> torch.Tensor:
    """Chunked WKV6.  r, k, v, log_w: (B, S, H, K), log_w <= 0 the
    per-channel log decay; u: (H, K), the bonus.  Returns o: (B, S, H, K)
    in r's dtype, rounded once.

    On CUDA tensors this launches the kernel on the current stream, without
    synchronising, or raises: r, k and v share one dtype of f32 or bf16,
    log_w is f32 or r's dtype, K is at most 64, and the last axis of r, k, v
    and log_w is contiguous (other strides are read as they are).  bf16
    runs the tensor-core form over chunks of 64 (``geometry``, a key of
    ``GEOMETRIES``, picks its geometry; None ``kept_geometry()``), whose
    TMA reads tensors that start on 16 bytes with every other stride a
    multiple of 16 bytes: an r, k, v or log_w that is not so (an odd
    offset, a head of 12) is copied first, contiguous and zero-padded
    (``_tma_readable``), and still runs that form.  f32 runs the CUDA-core
    form over chunks of 32.  CPU tensors run the plain version over chunks
    of ``CHUNK``.  When grad is enabled and an input requires grad, the
    call goes through ``WKV6Fn``, whose backward is the backward kernel
    (CUDA) or its plain version (CPU)."""
    refuse_dtensor("wkv6", r, k, v, log_w, u)
    _check(r, k, v, log_w, u)
    if torch.is_grad_enabled() and any(t.requires_grad for t in
                                       (r, k, v, log_w, u)):
        return WKV6Fn.apply(r, k, v, log_w, u, geometry)
    return _forward(r, k, v, log_w, u, geometry)


def _check_cuda(r, k, v, log_w) -> None:
    """What the CUDA kernels take beyond ``_check``."""
    if r.device.type != "cuda":
        raise ValueError(f"wkv6 runs on cuda or cpu, not {r.device}")
    if r.dtype not in DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"r, k, v must share one dtype of "
                         f"{sorted(map(str, DTYPES))}, got {r.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if log_w.dtype not in (torch.float32, r.dtype):
        raise ValueError(f"log_w must be float32 or r's dtype, got "
                         f"{log_w.dtype}")
    if r.shape[-1] > MAX_HEAD:
        raise ValueError(f"K = {r.shape[-1]} must be at most {MAX_HEAD}")
    if any(t.stride(-1) != 1 for t in (r, k, v, log_w)):
        raise ValueError("r, k, v and log_w need a contiguous last axis")


def _forward(r, k, v, log_w, u, geometry):
    """The forward on checked inputs."""
    global _launches
    B, S, H, K = r.shape
    if r.device.type == "cpu":
        return wkv6_torch(r, k, v, log_w, u, chunk=CHUNK)
    _check_cuda(r, k, v, log_w)
    bf16 = r.dtype == torch.bfloat16
    if geometry is not None and (not bf16 or geometry not in GEOMETRIES):
        raise ValueError(f"geometry {geometry!r}: the bf16 form takes one of "
                         f"{sorted(GEOMETRIES)}, the f32 form none")
    log_w, u = log_w.float(), u.float().contiguous()
    if bf16:
        r, k, v, log_w = map(_tma_readable, (r, k, v, log_w))
    # the bf16 form stores o with TMA: rows of a multiple of 16 bytes
    KO = K + (-K % (TMA_ALIGN // 2)) if bf16 else K
    o = torch.empty((B, S, H, KO), dtype=r.dtype, device=r.device)
    strides = (ctypes.c_longlong * 12)(
        *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *log_w.stride()[:3])
    fn = _launcher()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
                 u.data_ptr(), o.data_ptr(), DTYPES[r.dtype], B, S, H, K,
                 strides, GEOMETRIES.get(geometry, 0), stream)
    if err < 0:
        raise RuntimeError(f"rwkv6 wkv6: cuTensorMapEncodeTiled failed "
                           f"(CUresult {-err}; 1 also when libcuda has no "
                           f"such entry point)")
    if err != 0:
        raise RuntimeError(f"rwkv6 wkv6 launch failed: CUDA error {err}")
    with _count_lock:
        _launches += 1
    return o if KO == K else o[..., :K].contiguous()


def wkv6_bwd(r, k, v, log_w, u, do):
    """dr, dk, dv, dlog_w, du of ``wkv6`` from its inputs and the output's
    gradient ``do``, each in its input's dtype and shape (a gradient of a
    strided view comes back contiguous).  On CUDA tensors this launches the
    backward kernel on the current stream (one count in ``bwd_launches``),
    without synchronising, or raises, under what the forward takes; the
    kernel reads r, k, v and do in their dtype and log_w in f32, and
    accumulates in f32: bf16 on the tensor-core form over chunks of 64,
    whose TMA reads tensors as the forward's does (an r, k, v, do or log_w
    it cannot read is copied first, ``_tma_readable``), f32 on the
    CUDA-core form over chunks of ``CHUNK``.  It allocates an f32 scratch
    for the chunks' states and du's partial sums (bf16: each chunk's S_c
    and G_c, 134 MB at rwkv6-1.6b's training shape; f32: the entry states,
    134 MB).  CPU tensors run ``wkv6_bwd_torch``."""
    global _bwd_launches
    B, S, H, K = _check(r, k, v, log_w, u)
    if r.device.type == "cpu":
        return wkv6_bwd_torch(r, k, v, log_w, u, do, chunk=CHUNK)
    _check_cuda(r, k, v, log_w)
    if tuple(do.shape) != tuple(r.shape) or do.device != r.device:
        raise ValueError(f"do {tuple(do.shape)} on {do.device} must match "
                         f"r {tuple(r.shape)} on {r.device}")
    do = do.to(r.dtype).contiguous()
    lw32, u32 = log_w.float(), u.float().contiguous()
    bf16 = r.dtype == torch.bfloat16
    if bf16:
        r, k, v, lw32, do = map(_tma_readable, (r, k, v, lw32, do))
    # the bf16 form stores dr, dk, dv with TMA: rows of a multiple of 16
    # bytes
    KO = K + (-K % (TMA_ALIGN // 2)) if bf16 else K
    dr, dk, dv = (torch.empty((B, S, H, KO), dtype=r.dtype, device=r.device)
                  for _ in range(3))
    dlw = torch.empty((B, S, H, K), dtype=torch.float32, device=r.device)
    du = torch.empty((H, K), dtype=torch.float32, device=r.device)
    fn, size = _bwd_launcher()
    scratch = torch.empty((size(DTYPES[r.dtype], B, S, H, K),),
                          dtype=torch.float32, device=r.device)
    strides = (ctypes.c_longlong * 15)(
        *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *lw32.stride()[:3], *do.stride()[:3])
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), lw32.data_ptr(),
                 u32.data_ptr(), do.data_ptr(), dr.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), dlw.data_ptr(), du.data_ptr(),
                 scratch.data_ptr(), DTYPES[r.dtype], B, S, H, K, strides,
                 stream)
    if err < 0:
        raise RuntimeError(f"rwkv6 wkv6 backward: cuTensorMapEncodeTiled "
                           f"failed (CUresult {-err})")
    if err != 0:
        raise RuntimeError(f"rwkv6 wkv6 backward launch failed: CUDA error "
                           f"{err}")
    with _count_lock:
        _bwd_launches += 1
    if KO != K:
        dr, dk, dv = (t[..., :K].contiguous() for t in (dr, dk, dv))
    return dr, dk, dv, dlw.to(log_w.dtype), du.to(u.dtype)


class WKV6Fn(torch.autograd.Function):
    """``wkv6`` with its gradient: the forward saves its inputs as the
    caller gave them; the backward hands them with the output's gradient
    to ``wkv6_bwd``."""

    @staticmethod
    def forward(ctx, r, k, v, log_w, u, geometry):
        ctx.save_for_backward(r, k, v, log_w, u)
        return _forward(r, k, v, log_w, u, geometry)

    @staticmethod
    def backward(ctx, do):
        return (*wkv6_bwd(*ctx.saved_tensors, do), None)
