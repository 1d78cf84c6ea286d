"""Build, load and launch the port's CUDA kernels.

All ``csrc/*.cu`` sources compile with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes`` at first
use (never at import: the CPU tests import every module). The library lands
in ``csrc/build/`` under a name keyed by a hash of the sources and flags, so
an edited source rebuilds and a finished build is reused. A missing
``nvcc`` or a failed build raises; nothing falls back.

Each C entry point returns its launch status (``cudaGetLastError``) and the
wrapper raises on anything but success. ``LAUNCHES`` counts the launches of
each kernel; it moves only where a kernel is launched.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["LAUNCHES", "library", "launch", "reset_launch_counts",
           "check_cuda_input", "check_forward_only"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry point -> argument types (pointers and the stream as c_void_p)
_SIGNATURES = {
    "m3seg_freq_chain": [_P, _P, _P, _LL, _I, _I, _P],
    "m3seg_conv_in": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "m3seg_tail_resize_softmax": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _I, _P],
}

LAUNCHES = {"conv_in": 0, "freq_chain": 0, "tail_resize": 0}

_lock = threading.Lock()
_library = None


class KernelLibrary:
    """The loaded ``.so`` plus how it was obtained."""

    def __init__(self, cdll: ctypes.CDLL, path: Path, build_seconds: float):
        self.cdll = cdll
        self.path = path
        self.build_seconds = build_seconds  # 0.0 when a build was reused


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the port's "
                       "CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _build() -> KernelLibrary:
    cu, cuh = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    path = BUILD_DIR / f"libm3seg_kernels_{digest.hexdigest()[:16]}.so"
    seconds = 0.0
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, cu)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp, path)  # atomic: concurrent builds race safely
    cdll = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    cdll.m3seg_error_string.argtypes = [ctypes.c_int]
    cdll.m3seg_error_string.restype = ctypes.c_char_p
    return KernelLibrary(cdll, path, seconds)


def library() -> KernelLibrary:
    """Build (or reuse) and load the kernel library, once per process."""
    global _library
    with _lock:
        if _library is None:
            _library = _build()
        return _library


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_cuda_input(name: str, t: torch.Tensor, device: torch.device,
                     ndim: int) -> None:
    """Raise unless ``t`` is what the kernels take: fp32, contiguous, on
    ``device``, with ``ndim`` axes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} axes, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_forward_only(*tensors: torch.Tensor) -> None:
    """The CUDA kernels have no backward yet: refuse to run where autograd
    would need one."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the CUDA kernels are forward-only: their backward passes come "
            "with training (ROADMAP.md, Open items 1, item 7); run under "
            "torch.no_grad() / torch.inference_mode()")


def launch(kernel: str, entry: str, device: torch.device, *args) -> None:
    """Call C entry ``entry`` on ``device``'s current stream, raise on a
    failed launch, and count one launch of ``kernel``."""
    if device.type != "cuda":
        raise ValueError(f"{kernel}: CUDA kernel launched for {device}")
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib.cdll, entry)(*args, stream)
    if rc != 0:
        msg = lib.cdll.m3seg_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: {entry} failed: {msg} ({rc})")
    LAUNCHES[kernel] += 1
