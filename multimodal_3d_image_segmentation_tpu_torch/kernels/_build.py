"""Build, load and launch the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with its own ``nvcc`` for ``sm_90a``,
all started together, and the objects link into one shared library with a
plain C interface, loaded with ``ctypes`` at first use (never at import:
the CPU tests import every module). ``-Xptxas -v`` puts each kernel's
registers, shared memory and spills in the build log. The library lands
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
           "check_cuda_input", "needs_grad", "replay_grads", "call",
           "occupancy", "phase_clock"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry point -> argument types (pointers and the stream as c_void_p)
_SIGNATURES = {
    "m3seg_freq_chain": [_P, _P, _P, _LL, _I, _I, _P],
    "m3seg_conv_in": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "m3seg_tail_resize_softmax": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _I, _P],
    "m3seg_conv_in_bf16": [_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _P],
    "m3seg_conv_in_phase_ns": [_P, _I, ctypes.POINTER(_I)],
    "m3seg_freq_chain_bf16": [_P, _P, _P, _LL, _I, _I, _P],
    "m3seg_tail_resize_softmax_bf16": [_P, _P, _I, _P, _P, _I, _I, _I, _I,
                                       _I, _I, _I, _P],
    "m3seg_conv3": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                    _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                    ctypes.POINTER(_I), _I, _I, _P],
    "m3seg_conv3_bf16": [_P, _P, _P, _I, _P, _P, _P, _I, _P, _I, _P, _P,
                         _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         ctypes.POINTER(_I), _I, _I, _P],
    "m3seg_conv3_plan": [_I, _I, _I, _I, _I, _I, ctypes.POINTER(_I)],
    "m3seg_conv3_mma_plan": [_I] * 8 + [ctypes.POINTER(_I)],
    "m3seg_tower_block": [_P] * 11 + [_I] * 8 + [_P],
    "m3seg_tower_block_s": [_P] * 12 + [_I] * 9 + [_P],
    "m3seg_tower_resident": [_P] * 12 + [_I] * 10 + [_P],
    "m3seg_tower_block_occupancy": [_I] * 6 + [ctypes.POINTER(_I)] * 2,
    "m3seg_tower_block_s_occupancy": [_I] * 6 + [ctypes.POINTER(_I)] * 2,
    "m3seg_tower_resident_occupancy": [_I] * 5 + [ctypes.POINTER(_I)] * 2,
    "m3seg_tower_smem_bytes": [_I] * 5 + [ctypes.POINTER(_I)],
    "m3seg_tower_spectrum_groups": [ctypes.POINTER(_I)] * 2,
    "m3seg_tail_smem_bytes": [_I] * 7 + [ctypes.POINTER(_I)],
    "m3seg_tail_phase_ns": [_P, _I, ctypes.POINTER(_I)],
    "m3seg_tower_resident_phase_ns": [_P, _I],
    "m3seg_tower_block_phase_ns": [_P, _I],
    "m3seg_tower_block_s_phase_ns": [_P, _I],
    "m3seg_tower_resident_mma_phase_ns": [_P, _I],
}

# the bf16 instances (and the towers' and conv3's 'mixed' ones) count apart
# from the fp32 ones, and conv3's halo mode (depth-sharded volumes) apart
# from its other modes
LAUNCHES = {"conv_in": 0, "freq_chain": 0, "tail_resize": 0, "conv3": 0,
            "tower_block": 0, "tower_block_s": 0, "tower_resident": 0,
            "conv_in_bf16": 0, "freq_chain_bf16": 0, "tail_resize_bf16": 0,
            "tower_block_bf16": 0, "tower_block_mixed": 0,
            "tower_block_s_bf16": 0, "tower_block_s_mixed": 0,
            "tower_resident_bf16": 0, "tower_resident_mixed": 0,
            "conv3_bf16": 0, "conv3_mixed": 0, "conv3_halo": 0,
            "conv3_halo_bf16": 0, "conv3_halo_mixed": 0}

_lock = threading.Lock()
_library = None


class KernelLibrary:
    """The loaded ``.so`` plus how it was obtained."""

    def __init__(self, cdll: ctypes.CDLL, path: Path, build_seconds: float,
                 build_log: str):
        self.cdll = cdll
        self.path = path
        self.build_seconds = build_seconds  # 0.0 when a build was reused
        self.build_log = build_log          # "" when a build was reused


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the port's "
                       "CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _run(cmd) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait(proc: subprocess.Popen, cmd) -> str:
    out = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{out}")
    return out


def _build() -> KernelLibrary:
    cu, cuh = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    path = BUILD_DIR / f"libm3seg_kernels_{digest.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
        t0 = time.perf_counter()
        objs, jobs = [], []
        for src in cu:  # one nvcc per source, all at once
            obj = BUILD_DIR / f"{src.stem}.{tag}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            objs.append(obj)
            jobs.append((_run(cmd), cmd))
        log = "".join(_wait(p, cmd) for p, cmd in jobs)
        tmp = path.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        log += _wait(_run(cmd), cmd)
        for obj in objs:
            obj.unlink()
        seconds = time.perf_counter() - t0
        os.replace(tmp, path)  # atomic: concurrent builds race safely
    cdll = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    cdll.m3seg_error_string.argtypes = [ctypes.c_int]
    cdll.m3seg_error_string.restype = ctypes.c_char_p
    return KernelLibrary(cdll, path, seconds, log)


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
                     ndim: int, dtype: torch.dtype = torch.float32) -> None:
    """Raise unless ``t`` is what the kernels take: ``dtype`` (fp32 unless
    an instance takes another), contiguous, on ``device``, with ``ndim``
    axes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} axes, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd would record a call on ``tensors``: the kernel
    Functions are applied only then, so that a serving call pays no
    ``autograd.Function`` overhead (about 20 us of host time a call)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def replay_grads(plain, saved, need, grads):
    """The backward of a kernel Function whose reference VJP is
    ``jax.vjp`` of its plain twin: replay ``plain(*saved)`` under autograd
    and return the gradients of the saved tensors whose ``need`` is True
    (None elsewhere) for the output gradients ``grads`` (None for an
    output that got no gradient)."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(bool(n))
                  for t, n in zip(saved, need)]
        outs = plain(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        wrt = [t for t in leaves if t is not None and t.requires_grad]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], wrt, [g for _, g in pairs],
            allow_unused=True) if pairs and wrt else [None] * len(wrt))
    return [next(got) if t is not None and t.requires_grad else None
            for t in leaves]


def launch(kernel: str, entry: str, device: torch.device, *args) -> None:
    """Call C entry ``entry`` on ``device``'s current stream, raise on a
    failed launch, and count one launch of ``kernel``."""
    if device.type != "cuda":
        raise ValueError(f"{kernel}: CUDA kernel launched for {device}")
    lib = library()
    current = torch._C._cuda_getDevice()
    index = current if device.index is None else device.index
    # raw handles: current_stream(...).cuda_stream builds a Stream object,
    # torch.cuda.current_device() and entering torch.cuda.device cost a few
    # us each even when the device is current (utils/tower_sweep.py times
    # each step)
    stream = torch._C._cuda_getCurrentRawStream(index)
    if current == index:
        rc = getattr(lib.cdll, entry)(*args, stream)
    else:
        with torch.cuda.device(index):
            rc = getattr(lib.cdll, entry)(*args, stream)
    if rc != 0:
        msg = lib.cdll.m3seg_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: {entry} failed: {msg} ({rc})")
    LAUNCHES[kernel] += 1


def call(entry: str, *args) -> None:
    """Call C entry ``entry``, which launches nothing, and raise on an
    error."""
    lib = library()
    rc = getattr(lib.cdll, entry)(*args)
    if rc != 0:
        msg = lib.cdll.m3seg_error_string(rc).decode()
        raise RuntimeError(f"{entry} failed: {msg} ({rc})")


def phase_clock(entry: str, phases, n: int = 4096):
    """A persistent kernel's phase clock of its last launch, read by C
    entry ``entry`` (n blocks x 6: globaltimer at the block's start and
    end, the summed ns of its items' three ``phases``, its item count):
    ({phase: mean us an item}, the launch's span in us, the mean us a block
    was resident, the grid). Waits for the device; launches nothing."""
    buf = (ctypes.c_longlong * (6 * n))()
    grid = _I(0)
    call(entry, ctypes.cast(buf, ctypes.c_void_p), n, ctypes.byref(grid))
    g = min(grid.value, n)
    t = [buf[6 * i:6 * i + 6] for i in range(g)]
    items = max(sum(r[5] for r in t), 1)
    return ({k: sum(r[2 + i] for r in t) / items / 1e3
             for i, k in enumerate(phases)},
            (max(r[1] for r in t) - min(r[0] for r in t)) / 1e3 if t
            else 0.0,
            sum(r[1] - r[0] for r in t) / max(g, 1) / 1e3, grid.value)


def occupancy(entry: str, *args: int):
    """(blocks per SM, registers per thread) that C entry ``entry`` reports
    for a kernel instance (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    with the instance's dynamic shared memory); launches nothing."""
    blocks, regs = _I(0), _I(0)
    call(entry, *args, ctypes.byref(blocks), ctypes.byref(regs))
    return blocks.value, regs.value
