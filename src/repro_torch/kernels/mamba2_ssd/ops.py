"""Public wrapper of the hand-written Mamba-2 SSD kernel.

``ssd(x, dt, A_log, B, C, D)`` launches the kernel when the tensors lie on a
CUDA device and raises if it cannot: bf16 runs the tensor-core form
(``csrc/mamba2_ssd_wgmma.cu``: wgmma and TMA, kernel ``ssd_kernel_wgmma``),
f32 the CUDA-core form (``csrc/mamba2_ssd.cu``, kernel ``ssd_kernel``, whose
C entry point picks the form by dtype).  Only CPU tensors go to the plain
PyTorch version (``ref.ssd_torch``).  Every launch adds one to the module's
launch count (``launches()``), so a run can show that it went through the
kernel.

Its gradient: when grad is enabled and an input requires grad, ``ssd``
goes through ``SSDFn``, an autograd Function whose forward is the same
launch and whose backward launches the hand-written backward kernel (a
library of its own: ``csrc/mamba2_ssd_bwd.cu``, the C entry point and the
f32 CUDA-core form, and ``csrc/mamba2_ssd_bwd_wgmma.cu``, the bf16
tensor-core form, chunk-parallel) on CUDA tensors, adding one to
``bwd_launches()``, or runs its plain version (``ref.ssd_bwd_torch``) on
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
from repro_torch.kernels.mamba2_ssd.ref import ssd_bwd_torch, ssd_torch

_CSRC = Path(__file__).resolve().parent / "csrc"
#: the two forms' sources and the Hopper header the bf16 form includes
SOURCES = (_CSRC / "mamba2_ssd.cu", _CSRC / "mamba2_ssd_wgmma.cu",
           _CSRC.parents[1] / "csrc" / "hopper.cuh")
#: the backward kernel's two forms' sources, a library of their own, and
#: the Hopper header the bf16 form includes
BWD_SOURCES = (_CSRC / "mamba2_ssd_bwd.cu", _CSRC / "mamba2_ssd_bwd_wgmma.cu",
               _CSRC.parents[1] / "csrc" / "hopper.cuh")
#: the dtypes of x, B, C and y the kernel takes, by the code its C entry
#: point reads (dt, A_log and D are handed over in f32)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's chunk length (fixed in csrc/mamba2_ssd.cu) and its widest
#: head (P) and state (N)
CHUNK = 64
MAX_WIDTH = 64
#: the bf16 form's TMA reads tensors that start on 16 bytes and whose strides
#: (but the last) are multiples of 16 bytes: 8 bf16 elements
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
    return _build.build("mamba2_ssd", SOURCES, {})


def build_bwd() -> Path:
    """Build the backward kernel's library (no-op when it exists)."""
    return _build.build("mamba2_ssd_bwd", BWD_SOURCES, {})


@functools.cache
def _launcher():
    """The library's C entry point, built and loaded once per process."""
    fn = _build.load("mamba2_ssd", SOURCES, {}).mamba2_ssd_launch
    # x, dt, A_log, B, C, D, y; dtype, B, S, H, P, N; strides; stream
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_launcher():
    """The backward library's C entry point and its scratch size, built
    and loaded once per process."""
    lib = _build.load("mamba2_ssd_bwd", BWD_SOURCES, {})
    fn = lib.mamba2_ssd_bwd_launch
    # x, dt, A_log, B, C, D, dy, dx, ddt, dA_log, dB, dC, dD, scratch;
    # dtype, B, S, H, P, N; strides; stream
    fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    size = lib.mamba2_ssd_bwd_scratch_floats
    size.argtypes = [ctypes.c_int] * 6
    size.restype = ctypes.c_longlong
    return fn, size


def _check(x, dt, A_log, B, C, D):
    for name, t in (("x", x), ("dt", dt), ("A_log", A_log), ("B", B),
                    ("C", C), ("D", D)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
        if t.device != x.device:
            raise ValueError(f"{name} lies on {t.device}, x on {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    Bsz, S, H, P = x.shape
    N = B.shape[-1] if B.dim() == 3 else -1
    want = {"dt": (Bsz, S, H), "A_log": (H,), "B": (Bsz, S, N),
            "C": (Bsz, S, N), "D": (H,)}
    for name, t in (("dt", dt), ("A_log", A_log), ("B", B), ("C", C),
                    ("D", D)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{want[name]} for x {tuple(x.shape)}")
    if min(Bsz, S, H, P, N) < 1:
        raise ValueError(f"empty shape: x {tuple(x.shape)}, B "
                         f"{tuple(B.shape)}")
    return Bsz, S, H, P, N


def _tma_readable(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the bf16 form's TMA can read it as it lies, else a
    contiguous copy with its last axis zero-padded to a multiple of 8
    (the kernel still reads only the first ``t.shape[-1]`` columns)."""
    size = t.element_size()
    if t.data_ptr() % TMA_ALIGN == 0 and all(
            st * size % TMA_ALIGN == 0 for st in t.stride()[:-1]):
        return t
    return F.pad(t, (0, -t.shape[-1] % (TMA_ALIGN // size))).contiguous()


def ssd(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
        B: torch.Tensor, C: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """Chunked SSD over chunks of ``CHUNK`` steps.  x: (B, S, H, P); dt:
    (B, S, H); B/C: (B, S, N), one group shared by all heads; A_log/D:
    (H,).  Returns y: (B, S, H, P) in x's dtype, with the D * x skip added
    in f32 and rounded once.

    On CUDA tensors this launches the kernel on the current stream, without
    synchronising, or raises: x, B and C share one dtype of f32 or bf16,
    their last axis is contiguous (other strides are read as they are),
    and P and N are at most 64.  bf16 runs the tensor-core form, whose TMA
    reads tensors that start on 16 bytes with every other stride a multiple
    of 8 elements; x, B or C that is not so (a state of 12, an odd offset)
    is copied first, contiguous and zero-padded (``_tma_readable``), and
    still runs that form.  f32 runs the CUDA-core form.  CPU tensors run
    the plain version.  When grad is enabled and an input requires grad,
    the call goes through ``SSDFn``, whose backward is the backward kernel
    (CUDA) or its plain version (CPU)."""
    refuse_dtensor("ssd", x, dt, A_log, B, C, D)
    _check(x, dt, A_log, B, C, D)
    if torch.is_grad_enabled() and any(t.requires_grad for t in
                                       (x, dt, A_log, B, C, D)):
        return SSDFn.apply(x, dt, A_log, B, C, D)
    return _forward(x, dt, A_log, B, C, D)


def _check_cuda(x, B, C) -> None:
    """What the CUDA kernels take beyond ``_check``."""
    P, N = x.shape[-1], B.shape[-1]
    if x.device.type != "cuda":
        raise ValueError(f"ssd runs on cuda or cpu, not {x.device}")
    if x.dtype not in DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"x, B, C must share one dtype of "
                         f"{sorted(map(str, DTYPES))}, got {x.dtype}, "
                         f"{B.dtype}, {C.dtype}")
    if max(P, N) > MAX_WIDTH:
        raise ValueError(f"P = {P} and N = {N} must be at most {MAX_WIDTH}")
    if x.stride(-1) != 1 or B.stride(-1) != 1 or C.stride(-1) != 1:
        raise ValueError("x, B and C need a contiguous last axis")


def _forward(x, dt, A_log, B, C, D):
    """The forward on checked inputs."""
    global _launches
    Bsz, S, H, P = x.shape
    N = B.shape[-1]
    if x.device.type == "cpu":
        return ssd_torch(x, dt, A_log, B, C, D, chunk=CHUNK)
    _check_cuda(x, B, C)
    if x.dtype == torch.bfloat16:
        x, B, C = _tma_readable(x), _tma_readable(B), _tma_readable(C)
    dt, A_log, D = dt.float(), A_log.float().contiguous(), \
        D.float().contiguous()
    # the bf16 form stores y with TMA: rows of a multiple of 16 bytes
    PY = P + (-P % (TMA_ALIGN // 2)) if x.dtype == torch.bfloat16 else P
    y = torch.empty((Bsz, S, H, PY), dtype=x.dtype, device=x.device)
    strides = (ctypes.c_longlong * 10)(
        *x.stride()[:3], *dt.stride(), *B.stride()[:2], *C.stride()[:2])
    fn = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A_log.data_ptr(),
                 B.data_ptr(), C.data_ptr(), D.data_ptr(), y.data_ptr(),
                 DTYPES[x.dtype], Bsz, S, H, P, N, strides, stream)
    if err < 0:
        raise RuntimeError(f"mamba2_ssd: cuTensorMapEncodeTiled failed "
                           f"(CUresult {-err}; 1 also when libcuda has no "
                           f"such entry point)")
    if err != 0:
        raise RuntimeError(f"mamba2_ssd launch failed: CUDA error {err}")
    with _count_lock:
        _launches += 1
    return y if PY == P else y[..., :P].contiguous()


def ssd_bwd(x, dt, A_log, B, C, D, dy):
    """dx, ddt, dA_log, dB, dC, dD of ``ssd`` from its inputs and the
    output's gradient ``dy``, each in its input's dtype and shape (a
    gradient of a strided view comes back contiguous).  On CUDA tensors
    this launches the backward kernel on the current stream (one count in
    ``bwd_launches``), without synchronising, or raises, under what the
    forward takes; the kernel reads x, B, C and dy in their dtype (f32 or
    bf16) and accumulates in f32.  bf16 runs the tensor-core form, whose
    TMA reads x, B, C and dy as the forward's does (``_tma_readable``
    copies what it cannot); f32 the CUDA-core form.  It allocates an f32
    scratch: in bf16 the chunks' entry states and the gradients leaving
    them (168 MB each at zamba2-2.7b's training shape) and partial sums of
    dB and dC per group of 8 heads (21 MB each); in f32 the entry states
    and per-head partials of dB and dC (168 MB each).  CPU tensors run
    ``ssd_bwd_torch``."""
    global _bwd_launches
    Bsz, S, H, P, N = _check(x, dt, A_log, B, C, D)
    if x.device.type == "cpu":
        return ssd_bwd_torch(x, dt, A_log, B, C, D, dy, chunk=CHUNK)
    _check_cuda(x, B, C)
    if tuple(dy.shape) != tuple(x.shape) or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} on {dy.device} must match "
                         f"x {tuple(x.shape)} on {x.device}")
    dy = dy.to(x.dtype).contiguous()
    if x.dtype == torch.bfloat16:
        x, B, C, dy = (_tma_readable(t) for t in (x, B, C, dy))
    dt32, A32, D32 = dt.float(), A_log.float().contiguous(), \
        D.float().contiguous()
    dx = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
    ddt = torch.empty((Bsz, S, H), dtype=torch.float32, device=x.device)
    dB = torch.empty((Bsz, S, N), dtype=x.dtype, device=x.device)
    dC = torch.empty_like(dB)
    dA, dD = (torch.empty((H,), dtype=torch.float32, device=x.device)
              for _ in range(2))
    fn, size = _bwd_launcher()
    scratch = torch.empty((size(DTYPES[x.dtype], Bsz, S, H, P, N),),
                          dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 13)(
        *x.stride()[:3], *dt32.stride(), *B.stride()[:2], *C.stride()[:2],
        *dy.stride()[:3])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt32.data_ptr(), A32.data_ptr(), B.data_ptr(),
                 C.data_ptr(), D32.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                 ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
                 dD.data_ptr(), scratch.data_ptr(), DTYPES[x.dtype], Bsz, S,
                 H, P, N, strides, stream)
    if err < 0:
        raise RuntimeError(f"mamba2_ssd backward: cuTensorMapEncodeTiled "
                           f"failed (CUresult {-err}; 1 also when libcuda "
                           f"has no such entry point)")
    if err != 0:
        raise RuntimeError(f"mamba2_ssd backward launch failed: CUDA error "
                           f"{err}")
    with _count_lock:
        _bwd_launches += 1
    return (dx, ddt.to(dt.dtype), dA.to(A_log.dtype), dB, dC,
            dD.to(D.dtype))


class SSDFn(torch.autograd.Function):
    """``ssd`` with its gradient: the forward saves its inputs as the
    caller gave them; the backward hands them with the output's gradient
    to ``ssd_bwd``."""

    @staticmethod
    def forward(ctx, x, dt, A_log, B, C, D):
        ctx.save_for_backward(x, dt, A_log, B, C, D)
        return _forward(x, dt, A_log, B, C, D)

    @staticmethod
    def backward(ctx, dy):
        return ssd_bwd(*ctx.saved_tensors, dy)
