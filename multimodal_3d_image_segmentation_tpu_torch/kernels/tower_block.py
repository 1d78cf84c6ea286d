"""Fused tower block of the spectral towers, the port of
``multimodal_3d_image_segmentation_tpu/kernels/tower_block.py``.

One tower block (HartleyMHASeg's, NeuralOperatorSeg's) is, per depth
plane d of the tower grid (D, H, W) with C channels::

    y1    = inverse H/W stage of z[d]                   (H, W, C)
    p, q  = [W_conv ; W_cc_x] @ x[d] + [b_conv ; b_cc]
    ds[d] = ds_prev[d] + W_ds @ x[d]                    (bias-free, fp32)
    t     = selu(y1 + p);   out[d] = selu(W_cc_t @ t + q)
    f[d]  = forward H/W stage of out[d]                 (2, C, KH, KW)

so each block crosses device memory once for the volume; the depth stages
(``d_stage_forward`` / ``d_stage_inverse``) and the spectrum update between
blocks (``block_spectrum_update``) run on the small (D, 2, C, KH, KW)
tensors as torch einsums, as the reference leaves them to XLA.
``fused_tower_block`` launches the CUDA kernel (``csrc/tower_block.cu``) on
CUDA tensors; ``tower_block_plain`` is the same block in torch ops (the
reference's ``_block_reference``). Under autograd the block is a
``torch.autograd.Function`` whose backward is the reference's
``_fused_bwd``: a replay of ``tower_block_plain``.

Transforms: Hartley (KW = 2 * mw, a real packed spectrum (KD, C, KH, KW))
and Fourier (KW = mw, the rfft half spectrum of the last axis with the
Hermitian doubling in the inverse W stage; the complex packed spectrum is
[re; im] stacked on the first axis, (2 * KD, C, KH, KW)). The kernel reads
its stage matrices from a buffer, so the two differ only in the matrices.

Layouts: the volume is channels-last per plane, x (D, H, W, C), as the
port's conv_in emits it (the TPU kernel's lane-padded (D, C, W*HL) layout
and its padded stage matrices exist only for the TPU); the per-plane
spectra keep the reference's (D, 2, C, KH, KW). Stage matrices are the
float64 ones of ``ops/spectral.py``, rounded to the tensor's dtype once and
cached on the device.

Instances (``instance``), chosen by the operands' dtypes: fp32 (x and the
channel-mix weights fp32); 'bfloat16' (x and the weights bf16: every
product's operands are bf16 values, as each product of the TPU kernel is
one bf16 pass with fp32 accumulation, so z, the inverse W stage's output,
t, out and the forward H stage's output are rounded to bf16 where the TPU
kernel rounds them, the stage matrices are bf16-rounded, and f is written
as bf16, the TPU kernel's f in the volume's dtype); 'mixed' (x bf16, the
weights fp32: the reference's fp32 islands on a bf16 volume, f fp32).
z, the biases, ds_prev and ds are fp32 in every instance. The fp32
instance runs the FMA body (``csrc/tower_block.cuh``); the two bf16
instances (here and in tower_block_s and tower_resident) run the
tensor-core body (``csrc/tower_block_mma.cuh``: every
product as ``mma.sync``, one pass of bf16 values in 'bfloat16'; in
'mixed' each fp32 value as three bf16 parts, ``parts3``, and the six
products of order up to 2^-16, fp32-class sums), on the stage matrices
and weights packed once in fragment order (``mma_mats`` per spec,
``mma_weights`` per weight version). The plain twin
of a bf16 instance (``tower_block_plain`` on a bf16 x) computes in fp32
from the bf16 values and rounds where the kernel rounds; ``acc=float64``
sums in float64 instead (the precision gate's twins64 path).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import device as _device  # noqa: F401  (fp32 policy)
from ..ops.spectral import _dft_mats_np, _rfft_mats_np
from . import _build
from ._common import instance
from .conv3 import _kept

__all__ = ["TowerSpec", "make_tower_spec", "fused_tower_block",
           "tower_block_plain", "entry_forward_hw", "d_stage_forward",
           "d_stage_inverse", "spectrum_mix", "block_spectrum_update",
           "spectrum_rows", "kernel_smem_bytes", "occupancy", "instance",
           "mma_geom", "mma_mats", "mma_weights", "mma_weight_stack",
           "mma_clock", "mma_phase_us",
           "MMA_PHASES", "MMA_TILE_W", "MMA_THREADS", "MMA_MAX_KW",
           "MMA_PARTS", "parts3",
           "INSTANCES", "SUPPORTED_CHANNELS", "MAX_DS_ROWS", "MAX_KH"]

# template instances in the .cu: the configs' width 24, and 8 for tests
SUPPORTED_CHANNELS = (8, 24)
MAX_DS_ROWS = 8           # per-thread register bound of the ds rows
MAX_KH = 32               # csrc/tower_block.cuh kMaxKH: F's registers
_TILE_W, _TILE_H = 8, 32  # csrc/tower_block.cuh kTW, kTH
MMA_TILE_W = 16           # csrc/tower_block_mma.cuh kMmaTW
MMA_THREADS = 512         # csrc/tower_block_mma.cuh kMmaThreads
MMA_MAX_KW = 32           # csrc/tower_block_mma.cuh kMmaMaxKW
MMA_PARTS = {"bfloat16": 1, "mixed": 3}  # bf16 parts of a matrix's value
_MAX_SMEM_BYTES = 227 * 1024
# instance -> (the C entries' mode, csrc/tower_block.cuh kFp32 / kBf16 /
# kMixed; the suffix its launches count under)
INSTANCES = {"float32": (0, ""), "bfloat16": (1, "_bf16"),
             "mixed": (2, "_mixed")}
_BF16 = torch.bfloat16


class TowerSpec(NamedTuple):
    """Static description of one tower-block problem."""
    transform: str                  # 'Hartley' | 'Fourier'
    sizes: Tuple[int, int, int]     # (D, H, W) of the tower grid
    modes: Tuple[int, int, int]     # kept modes per axis
    channels: int
    kd: int                         # 2 * md
    kh: int                         # 2 * mh
    kw: int                         # 2 * mw (Hartley) | mw (Fourier)
    n_ds: int                       # deep-supervision rows (0 = off)


def make_tower_spec(transform: str, sizes, modes, channels,
                    n_ds: int = 0) -> TowerSpec:
    d, h, w = (int(s) for s in sizes)
    md, mh, mw = (int(m) for m in modes)
    if transform not in ("Hartley", "Fourier"):
        raise ValueError(f"transform must be 'Hartley' or 'Fourier', got "
                         f"{transform!r}")
    if d < 2 * md or h < 2 * mh or w < 2 * mw:
        raise ValueError(f"tower grid {(d, h, w)} is smaller than 2 * modes "
                         f"{(md, mh, mw)}")
    kw = 2 * mw if transform == "Hartley" else mw
    return TowerSpec(transform, (d, h, w), (md, mh, mw), int(channels),
                     2 * md, 2 * mh, kw, int(n_ds))


def spectrum_rows(spec: TowerSpec) -> int:
    """KS, the first axis of the packed spectrum: KD (Hartley, real) or
    2 * KD (Fourier, [re; im])."""
    return spec.kd if spec.transform == "Hartley" else 2 * spec.kd


@functools.lru_cache(maxsize=32)
def _spec_mats(spec: TowerSpec):
    """float64 stage matrices:
      h_fwd (H, KH) x2  cos, sin / H       forward H stage
      w_fwd (W, KW) x2  cos, sin / W       forward W stage ('mid')
      w_inv (KW, W) x2                     inverse W stage ('mid'; Fourier:
                                           times the Hermitian (1, 2, 2, ..))
      h_inv (KH, H) x2                     inverse H stage: Hartley's fold
                                           C - S, -(C + S); Fourier's real
                                           part C, -S of e^{+i theta}
      d_fwd (D, 2, KS)  depth forward: s[k] = sum_dq f[d, q] d_fwd[d, q, k]
      d_inv (D, 2, KS)  depth inverse: z[d, q] = sum_k d_inv[d, q, k] s[k]
    Hartley's depth stages are the fold and the 'first'; Fourier's are the
    complex 'mid' pair on [re; im] (e^{-i theta} / D forward, e^{+i theta}
    inverse)."""
    d, h, w = spec.sizes
    md, mh, mw = spec.modes
    kd = spec.kd
    ch, sh = _dft_mats_np(h, mh, True)
    cd, sd = _dft_mats_np(d, md, True)                 # (D, KD)
    d_fwd = np.zeros((d, 2, spectrum_rows(spec)))
    d_inv = np.zeros_like(d_fwd)
    if spec.transform == "Hartley":
        cw, sw = _dft_mats_np(w, mw, True)
        cwi, swi = _dft_mats_np(w, mw, False)
        chi, shi = _dft_mats_np(h, mh, False)
        h_inv = (chi - shi, -(chi + shi))
        cdi, sdi = _dft_mats_np(d, md, False)          # (KD, D)
        d_fwd[:, 0], d_fwd[:, 1] = cd - sd, -(cd + sd)
        d_inv[:, 0], d_inv[:, 1] = cdi.T, sdi.T
    else:
        cw, sw = _rfft_mats_np(w, mw, True)
        cwi, swi = _rfft_mats_np(w, mw, False)
        chi, shi = _dft_mats_np(h, mh, False, 1)
        h_inv = (chi, -shi)
        cdi, sdi = _dft_mats_np(d, md, False, 1)
        # s_re = f_re cd - f_im sd;  s_im = f_re sd + f_im cd
        d_fwd[:, 0, :kd], d_fwd[:, 1, :kd] = cd, -sd
        d_fwd[:, 0, kd:], d_fwd[:, 1, kd:] = sd, cd
        # z_re = s_re cdi - s_im sdi;  z_im = s_re sdi + s_im cdi
        d_inv[:, 0, :kd], d_inv[:, 0, kd:] = cdi.T, -sdi.T
        d_inv[:, 1, :kd], d_inv[:, 1, kd:] = sdi.T, cdi.T
    return {"h_fwd": (ch, sh), "w_fwd": (cw, sw), "w_inv": (cwi, swi),
            "h_inv": h_inv, "d_fwd": d_fwd, "d_inv": d_inv}


@functools.lru_cache(maxsize=None)
def _stage(spec: TowerSpec, key: str, device: torch.device,
           dtype: torch.dtype):
    """Device copy of one stage matrix (or pair), uploaded once: float64,
    or rounded to fp32 and then to ``dtype`` (bf16)."""
    m = _spec_mats(spec)[key]
    np_dt = np.float64 if dtype == torch.float64 else np.float32

    def put(a):
        return torch.from_numpy(np.asarray(a, np_dt)).to(device, dtype)
    with torch.inference_mode(False):  # see ops/spectral.py::_stage_tensor
        return tuple(put(a) for a in m) if isinstance(m, tuple) else put(m)


def _buffer(parts, device: torch.device, rounded: bool) -> torch.Tensor:
    """``parts`` flattened into one fp32 device buffer, each value rounded
    to bf16 where ``rounded`` (the 'bfloat16' instance's matrices)."""
    flat = torch.from_numpy(np.concatenate(
        [np.asarray(p, np.float32).ravel() for p in parts]))
    if rounded:
        flat = flat.to(_BF16).float()
    with torch.inference_mode(False):  # see ops/spectral.py::_stage_tensor
        return flat.to(device)


@functools.lru_cache(maxsize=None)
def _kernel_mats(spec: TowerSpec, device: torch.device,
                 rounded: bool = False) -> torch.Tensor:
    """The kernel's fp32 stage matrices in one buffer, in the order the
    .cu reads them: mhf (H, 2KH) = [cos | sin]; cwi, swi (KW, W); ha, hb
    (KH, H); cw, sw (W, KW). ``rounded``: bf16-rounded values, packed once
    per spec and device."""
    m = _spec_mats(spec)
    return _buffer([np.concatenate(m["h_fwd"], axis=1), *m["w_inv"],
                    *m["h_inv"], *m["w_fwd"]], device, rounded)


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def _pitch(n: int) -> int:
    """A shared-memory row of at least n bf16 values in the tensor-core
    body: a whole and odd number of 16-byte units (``mma_pitch``)."""
    p = _up(n, 8)
    return p if (p // 8) % 2 else p + 8


class MmaGeom(NamedTuple):
    """The tensor-core body's GEMM sizes and shared memory
    (``csrc/tower_block_mma.cuh`` MmaGeom)."""
    n_tiles: int   # W tiles of MMA_TILE_W columns
    nht: int       # tiles of 16 H rows
    kih: int       # K of the inverse H stage, 2KH rounded up to 8
    kwp: int       # KW rounded up to 8
    mth: int       # m tiles of the forward H stage (2KH rows)
    smem: int      # bytes of shared memory a block


@functools.lru_cache(maxsize=None)
def mma_geom(spec: TowerSpec, passes: int = 1) -> MmaGeom:
    """The tensor-core body's sizes at ``spec`` with ``passes`` parts a
    matrix (1 'bfloat16', 3 'mixed'); its shared memory holds the
    weights' B fragments (room for 2C + 8 rows of w_cat), the tile's
    inverse and forward W fragments, the y tile (reused by the F tile, 2TW
    values a row; bf16 values in 'bfloat16', fp32 in 'mixed') and the out
    tile."""
    _, h, w = spec.sizes
    c, kh = spec.channels, spec.kh
    nht, kih, kwp = -(-h // 16), _up(2 * kh, 8), _up(spec.kw, 8)
    ksc, nc, tw = -(-c // 16), c // 8, MMA_TILE_W
    frags = passes * (ksc * (2 * nc + 1) * 256 + ksc * nc * 256
                      + 2 * tw // 16 * (2 * kwp // 16) * 512
                      + 2 * tw // 16 * (2 * kwp // 8) * 256)
    tiles = (2 if passes == 1 else 4) * max(tw * (c * _pitch(kih) + 8),
                                            c * kh * 2 * tw)
    out = max(2 * tw * c * _pitch(16 * nht), 4 * 16 * 16 * (2 * kwp + 8))
    return MmaGeom(-(-w // tw), nht, kih, kwp, -(-2 * kh // 16),
                   frags + tiles + out)


def _a_fragments(a: torch.Tensor) -> torch.Tensor:
    """(M, K) bf16 -> mma.sync's A fragments, M and K padded to 16 with
    zeros: (M/16, K/16, 8, 4, 2, 2, 2), element [mt, ks, g, t, kh, rh, j] =
    a[16 mt + 8 rh + g, 16 ks + 8 kh + 2 t + j], so lane 4g + t of a warp
    loads its four registers of m tile mt, k step ks as 16 contiguous
    bytes."""
    m, k = a.shape
    mp, kp = _up(m, 16), _up(k, 16)
    f = F.pad(a, (0, kp - k, 0, mp - m)).reshape(mp // 16, 2, 8, kp // 16,
                                                  2, 4, 2)
    return f.permute(0, 3, 2, 5, 4, 1, 6).contiguous()


def _b_fragments(b: torch.Tensor) -> torch.Tensor:
    """(K, N) bf16 -> mma.sync's B fragments, K padded to 16 and N to 8
    with zeros: (K/16, N/8, 8, 4, 2, 2), element [ks, nt, g, t, half, j] =
    b[16 ks + 8 half + 2 t + j, 8 nt + g], so lane 4g + t loads its two
    registers of k step ks, n tile nt as 8 contiguous bytes."""
    k, n = b.shape
    kp, np_ = _up(k, 16), _up(n, 8)
    f = F.pad(b, (0, np_ - n, 0, kp - k)).reshape(kp // 16, 2, 4, 2,
                                                  np_ // 8, 8)
    return f.permute(0, 4, 5, 2, 1, 3).contiguous()


def parts3(m: torch.Tensor):
    """fp32 -> its three bf16 parts (hi, mid, lo), each the rounding of
    what the parts before leave (each difference exact in fp32): hi + mid +
    lo carries m to 2^-27; hi and mid are the reference's ``hi_lo``
    (``kernels/_common.py``)."""
    parts, rest = [], m.float()
    for _ in range(3):
        parts.append(rest.to(_BF16))
        rest = rest - parts[-1].float()
    return tuple(parts)


def _mma_passes(m: torch.Tensor, passes: int):
    """An fp32 matrix's parts: its bf16 values (1, 'bfloat16') or its three
    parts (3, 'mixed'; ``parts3``)."""
    return (m.to(_BF16),) if passes == 1 else parts3(m)


def _mma_stage_parts(spec: TowerSpec, passes: int):
    """The four stage-matrix parts of the tensor-core body, each with its
    passes stacked (``csrc/tower_block_mma.cuh`` MmaMats): iw (n_tiles, NP,
    2TW/16, 2kwp/16, ...) the tiles' inverse W matrices, rows [re w | im
    w], columns [re j | im j]; ih (NP, nht, ceil(2KH/16), ...) [ha ; hb]^T;
    fh (NP, mth, nht, ...) Mh^T; fw (n_tiles, NP, 2TW/16, 2kwp/8, ...) the
    tiles' forward W matrices, rows [re w | im w], columns [re j | im j].
    The fp32 matrices are the kernel's (``_kernel_mats``)."""
    m = _spec_mats(spec)
    g = mma_geom(spec)
    _, _, w = spec.sizes
    kw, tw = spec.kw, MMA_TILE_W

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32))
    cwi, swi = (f32(a) for a in m["w_inv"])            # (KW, W)
    cw, sw = (f32(a) for a in m["w_fwd"])              # (W, KW)
    ih = torch.cat([f32(a) for a in m["h_inv"]]).t()   # (H, 2KH)
    fh = f32(np.concatenate(m["h_fwd"], axis=1)).t()   # (2KH, H)

    def tile_pair(c, s, w0):
        """The tile's columns w0 .. of (W, KW) matrices c, s as (TW, kwp)
        blocks, zero past W and KW."""
        cc, ss = torch.zeros(tw, g.kwp), torch.zeros(tw, g.kwp)
        n = min(tw, w - w0)
        cc[:n, :kw], ss[:n, :kw] = c[w0:w0 + n], s[w0:w0 + n]
        return cc, ss
    iw, fw = [], []
    for t in range(g.n_tiles):
        c, s = tile_pair(cwi.t(), swi.t(), t * tw)
        a = torch.cat([torch.cat([c, -s], 1), torch.cat([s, c], 1)])
        iw.append(torch.stack([_a_fragments(p)
                               for p in _mma_passes(a, passes)]))
        c, s = tile_pair(cw, sw, t * tw)
        b = torch.cat([torch.cat([c, s], 1), torch.cat([-s, c], 1)])
        fw.append(torch.stack([_b_fragments(p)
                               for p in _mma_passes(b, passes)]))
    return (torch.stack(iw),
            torch.stack([_a_fragments(p) for p in _mma_passes(ih, passes)]),
            torch.stack([_a_fragments(p) for p in _mma_passes(fh, passes)]),
            torch.stack(fw))


@functools.lru_cache(maxsize=None)
def mma_mats(spec: TowerSpec, device: torch.device,
             passes: int) -> torch.Tensor:
    """The tensor-core body's stage matrices packed in fragment order, one
    bf16 buffer of ``_mma_stage_parts`` in order, packed once per spec,
    device and number of parts (1 'bfloat16', 3 'mixed')."""
    flat = torch.cat([p.reshape(-1) for p in _mma_stage_parts(spec,
                                                              passes)])
    with torch.inference_mode(False):  # see ops/spectral.py::_stage_tensor
        return flat.to(device)


def _mma_pack(t: torch.Tensor) -> torch.Tensor:
    """A channel-mix weight (rows = outputs) as the tensor-core body's B
    fragments of t^T: one part of a bf16 weight's values, three of an fp32
    weight's (``parts3``)."""
    return torch.stack([_b_fragments(p) for p in (
        (t.t(),) if t.dtype == _BF16 else parts3(t.float().t()))])


def mma_weights(w_cat: torch.Tensor, w_cc_t: torch.Tensor):
    """The channel-mix weights as the tensor-core body's B fragments, kept
    per weight version (``conv3._kept``): (NP, ceil(C/16), ceil((2C +
    n_ds)/8), ...) of w_cat^T and (NP, ceil(C/16), C/8, ...) of w_cc_t^T
    (``_mma_pack``)."""
    return (_kept(w_cat, "_m3seg_tower_mma", _mma_pack),
            _kept(w_cc_t, "_m3seg_tower_mma", _mma_pack))


def mma_weight_stack(wcat_stack: torch.Tensor, wcc_stack: torch.Tensor):
    """A tower's stacked weights (B, 2C, C) and (B, C, C) as one stack of
    packed B fragments each, block b's slice ``mma_weights(wcat_stack[b],
    wcc_stack[b])``'s, so that the resident kernel finds block b's at a
    fixed stride; kept per weight version of the stacks."""
    def stack(s):
        return torch.stack([_mma_pack(w) for w in s])
    return (_kept(wcat_stack, "_m3seg_tower_mma_stack", stack),
            _kept(wcc_stack, "_m3seg_tower_mma_stack", stack))


# the tensor-core body's phases, in the order its phase clock reads them
MMA_PHASES = ("inverse W", "inverse H and tail", "forward H", "forward W")


def mma_clock(spec: TowerSpec, entry: str) -> np.ndarray:
    """The raw phase clock of one kernel's tensor-core body (each .cu keeps
    its own; ``entry`` its reader): (D x n_tiles, 5) globaltimer readings
    in us, one row per (plane, tile) item of the last launch. Waits for
    the device; launches nothing."""
    n = spec.sizes[0] * mma_geom(spec).n_tiles
    buf = (ctypes.c_longlong * (5 * n))()
    _build.call(entry, ctypes.cast(buf, ctypes.c_void_p), n)
    return np.frombuffer(buf, np.int64).reshape(n, 5).astype(
        np.float64) / 1e3


def mma_phase_us(spec: TowerSpec, entry: str = "m3seg_tower_block_phase_ns",
                 phases: int = 4):
    """The tensor-core body's phase clock of its last launch at ``spec``
    (thread 0 of each block reads the card's globaltimer at the block's
    start and after each phase): ({phase: mean us a block} of the first
    ``phases`` phases, the launch's span in us from the first block's start
    to the last block's end of them, the blocks' summed us). ``entry``:
    the kernel's reader (tower_block's by default). Waits for the device;
    launches nothing."""
    t = mma_clock(spec, entry)[:, :phases + 1]
    got = dict(zip(MMA_PHASES, np.diff(t, axis=1).mean(0).tolist()))
    return got, float(t[:, -1].max() - t[:, 0].min()), float(
        (t[:, -1] - t[:, 0]).sum())


def entry_forward_hw(x: torch.Tensor, spec: TowerSpec,
                     island: Optional[torch.dtype] = None) -> torch.Tensor:
    """Forward H/W stages of a whole volume: (D, H, W, C) -> per-plane
    partial spectra (D, 2, C, KH, KW), computed in the island dtype
    ``island`` (default x's; bf16: each stage's output in bf16, as the
    reference's bf16 einsums)."""
    x = x if island is None else x.to(island)
    ch, sh = _stage(spec, "h_fwd", x.device, x.dtype)
    cw, sw = _stage(spec, "w_fwd", x.device, x.dtype)
    fre = torch.einsum("dhwc,hk->dcwk", x, ch)
    fim = torch.einsum("dhwc,hk->dcwk", x, sh)
    gre = torch.einsum("dcwk,wj->dckj", fre, cw) \
        - torch.einsum("dcwk,wj->dckj", fim, sw)
    gim = torch.einsum("dcwk,wj->dckj", fre, sw) \
        + torch.einsum("dcwk,wj->dckj", fim, cw)
    return torch.stack([gre, gim], dim=1)


def _widened(t: torch.Tensor) -> torch.Tensor:
    """``t`` at fp32 at least (bf16 widened; float64 kept)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def d_stage_forward(f: torch.Tensor, spec: TowerSpec) -> torch.Tensor:
    """(D, 2, C, KH, KW) per-plane partial spectra -> the packed spectrum
    (KS, C, KH, KW) (Fourier: [re; im], the reference's (2, KD, ...)
    merged on the first axis). Computed in fp32 at least: a bf16 f is
    widened first, so the sum over the D planes runs in fp32, as the
    reference pins it."""
    f = _widened(f)
    m = _stage(spec, "d_fwd", f.device, f.dtype)
    return torch.einsum("dqcxy,dqk->kcxy", f, m)


def d_stage_inverse(s: torch.Tensor, spec: TowerSpec) -> torch.Tensor:
    """Packed spectrum (KS, C, KH, KW) -> per-plane complex pre-images
    (D, 2, C, KH, KW), in fp32 at least."""
    s = _widened(s)
    m = _stage(spec, "d_inv", s.device, s.dtype)
    return torch.einsum("kcxy,dqk->dqcxy", s, m)


def spectrum_mix(s: torch.Tensor, op_params, spec: TowerSpec
                 ) -> torch.Tensor:
    """The shared-weight operator on a packed spectrum (KS, C, KH, KW):
    Hartley mixes the channels with ``weight`` and applies the frequency-
    domain SELU; Fourier mixes [re; im] with the complex weight
    (``weight_real``, ``weight_imag``). ``op_params``: the (O, I) weights,
    (weight,) or (weight_real, weight_imag)."""
    if spec.transform == "Hartley":
        return torch.selu(torch.einsum("kcxy,oc->koxy", s,
                                       op_params[0].to(s.dtype)))
    wr, wi = (w.to(s.dtype) for w in op_params)
    re, im = s[:spec.kd], s[spec.kd:]
    return torch.cat([
        torch.einsum("kcxy,oc->koxy", re, wr)
        - torch.einsum("kcxy,oc->koxy", im, wi),
        torch.einsum("kcxy,oc->koxy", re, wi)
        + torch.einsum("kcxy,oc->koxy", im, wr)])


def block_spectrum_update(f: torch.Tensor, op_params, spec: TowerSpec
                          ) -> torch.Tensor:
    """Between kernels: the depth forward stage of a block's partial
    spectra f, the operator (``spectrum_mix``), the depth inverse stage:
    the next block's z (D, 2, C, KH, KW)."""
    return d_stage_inverse(spectrum_mix(d_stage_forward(f, spec), op_params,
                                        spec), spec)


def _operands(rounded: bool, acc: torch.dtype):
    """The rounding of a bf16 instance's product operands: to bf16 and
    back to ``acc`` where ``rounded`` ('bfloat16'), else only to ``acc``."""
    if rounded:
        return lambda t: t.to(_BF16).to(acc)
    return lambda t: t.to(acc)


def _plain_mats(spec: TowerSpec, device, rounded: bool, acc: torch.dtype):
    """Stage-matrix getter of a bf16 instance's twin: the kernel's values
    (bf16-rounded where ``rounded``) in ``acc``."""
    dt = _BF16 if rounded else torch.float32

    def mats(key):
        m = _stage(spec, key, device, dt)
        return (tuple(a.to(acc) for a in m) if isinstance(m, tuple)
                else m.to(acc))
    return mats


# the operand roundings of the 'bfloat16' twin, in the block's order
ROUNDINGS = ("z", "y", "t", "F", "f")


def _tower_block_plain_bf16(x, z, w_cat, w_cc_t, b_cat, spec: TowerSpec,
                            ds_prev, acc: torch.dtype,
                            unrounded=frozenset()):
    """The 'bfloat16' or 'mixed' instance (by ``w_cat``'s dtype) in torch
    ops: sums in ``acc`` from the kernel's operand values, rounded where
    the kernel rounds; out bf16, f bf16 ('bfloat16') or fp32, ds fp32.
    ``unrounded``: roundings of ``ROUNDINGS`` to leave out, the controls
    that a check of the kernel's roundings must fail."""
    c = spec.channels
    rounded = w_cat.dtype == _BF16
    ops = {k: _operands(rounded and k not in unrounded, acc)
           for k in ROUNDINGS}
    mats = _plain_mats(spec, x.device, rounded, acc)
    cwi, swi = mats("w_inv")
    ha, hb = mats("h_inv")
    z = ops["z"](z)
    zre, zim = z[:, 0], z[:, 1]
    yre = ops["y"](torch.einsum("dcxj,jw->dcxw", zre, cwi)
                   - torch.einsum("dcxj,jw->dcxw", zim, swi))
    yim = ops["y"](torch.einsum("dcxj,jw->dcxw", zre, swi)
                   + torch.einsum("dcxj,jw->dcxw", zim, cwi))
    y1 = torch.einsum("dcxw,xh->dhwc", yre, ha) \
        + torch.einsum("dcxw,xh->dhwc", yim, hb)
    pq = torch.einsum("dhwc,oc->dhwo", x.to(acc), w_cat.to(acc))
    ds = pq[..., 2 * c:]
    pq = pq[..., :2 * c] + b_cat.to(acc)
    t = ops["t"](torch.selu(y1 + pq[..., :c]))
    o = torch.selu(torch.einsum("dhwc,oc->dhwo", t, w_cc_t.to(acc))
                   + pq[..., c:]).to(_BF16)
    ch, sh = mats("h_fwd")
    cw, sw = mats("w_fwd")
    of = o.to(acc)
    fre = ops["F"](torch.einsum("dhwc,hk->dcwk", of, ch))
    fim = ops["F"](torch.einsum("dhwc,hk->dcwk", of, sh))
    gre = torch.einsum("dcwk,wj->dckj", fre, cw) \
        - torch.einsum("dcwk,wj->dckj", fim, sw)
    gim = torch.einsum("dcwk,wj->dckj", fre, sw) \
        + torch.einsum("dcwk,wj->dckj", fim, cw)
    f = torch.stack([gre, gim], dim=1).to(
        _BF16 if rounded and "f" not in unrounded else torch.float32)
    if not spec.n_ds:
        return o, f
    return o, f, (ds_prev.to(acc) + ds).float()


def tower_block_plain(x, z, w_cat, w_cc_t, b_cat, spec: TowerSpec,
                      ds_prev: Optional[torch.Tensor] = None,
                      acc: torch.dtype = torch.float32,
                      unrounded=frozenset()):
    """The block in torch ops over all planes at once: the kernel's oracle
    and CPU path (the reference's ``_block_reference``). A bf16 x runs the
    twin of its instance (module docstring), summing in ``acc``, with the
    roundings ``unrounded`` left out (controls)."""
    if x.dtype == _BF16:
        return _tower_block_plain_bf16(x, z, w_cat, w_cc_t, b_cat, spec,
                                       ds_prev, acc, unrounded)
    c = spec.channels
    cwi, swi = _stage(spec, "w_inv", x.device, x.dtype)
    ha, hb = _stage(spec, "h_inv", x.device, x.dtype)
    z = z.to(x.dtype)
    zre, zim = z[:, 0], z[:, 1]                       # (D, C, KH, KW)
    yre = torch.einsum("dcxj,jw->dcxw", zre, cwi) \
        - torch.einsum("dcxj,jw->dcxw", zim, swi)
    yim = torch.einsum("dcxj,jw->dcxw", zre, swi) \
        + torch.einsum("dcxj,jw->dcxw", zim, cwi)
    y1 = torch.einsum("dcxw,xh->dhwc", yre, ha) \
        + torch.einsum("dcxw,xh->dhwc", yim, hb)
    pq = torch.einsum("dhwc,oc->dhwo", x, w_cat.to(x.dtype))
    ds = pq[..., 2 * c:]
    pq = pq[..., :2 * c] + b_cat.to(x.dtype)
    t = torch.selu(y1 + pq[..., :c])
    o = torch.selu(torch.einsum("dhwc,oc->dhwo", t, w_cc_t.to(x.dtype))
                   + pq[..., c:])
    f = entry_forward_hw(o, spec)
    if not spec.n_ds:
        return o, f
    return o, f, ds_prev.to(ds.dtype) + ds


def _check_operands(spec: TowerSpec, x, w_cat, w_cc_t, b_cat, ds_prev,
                    **spectrum):
    """Shapes and dtypes of a block's operands; ``spectrum`` names the
    block's spectrum operand as (tensor, expected shape). x, w_cat and
    w_cc_t take one instance's dtypes (``instance``); the rest is fp32
    (float64 on the CPU). Returns name -> (tensor, shape) of every operand
    given."""
    d, h, w = spec.sizes
    c, n_ds = spec.channels, spec.n_ds
    want = {"x": (x, (d, h, w, c)), **spectrum,
            "w_cat": (w_cat, (2 * c + n_ds, c)), "w_cc_t": (w_cc_t, (c, c)),
            "b_cat": (b_cat, (2 * c,))}
    if n_ds:
        if ds_prev is None:
            raise ValueError(f"spec has n_ds={n_ds}: ds_prev is required")
        want["ds_prev"] = (ds_prev, (d, h, w, n_ds))
    elif ds_prev is not None:
        raise ValueError("ds_prev given for a spec with n_ds=0")
    instance(x, w_cat)
    if (w_cc_t.dtype == _BF16) != (w_cat.dtype == _BF16):
        raise TypeError(f"w_cc_t is {w_cc_t.dtype}, w_cat {w_cat.dtype}")
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if (name not in ("x", "w_cat", "w_cc_t")
                and t.dtype not in (torch.float32, torch.float64)):
            raise TypeError(f"{name} must be float32 (or float64 on the "
                            f"CPU, with x), got {t.dtype}")
    return want


def kernel_smem_bytes(spec: TowerSpec, inst: str = "float32") -> int:
    """Shared memory of one block of the three tower kernels' instance
    ``inst``; raises where it exceeds a block's 227 KB. 'float32': the FMA
    body's (``csrc/tower_block.cuh`` smem_floats: the y tile, one chunk of
    voxels, the chunk's (A, B) and Mh rows, the weights with room for
    MAX_DS_ROWS deep-supervision rows, and the tile's W-stage columns).
    'bfloat16' and 'mixed': the tensor-core body's
    (``csrc/tower_block_mma.cuh`` mma_smem_bytes: the weights' and the
    tile's W stages' fragments, the y tile, reused by the F tile, and the
    tile's out for all H rows)."""
    c, kh, kw = spec.channels, spec.kh, spec.kw
    if inst == "float32":
        smem = 4 * (2 * kh * _TILE_W * c + _TILE_H * _TILE_W * c
                    + 2 * kh * _TILE_H + _TILE_H * 2 * kh
                    + (2 * c + MAX_DS_ROWS) * c + c * c + 2 * c
                    + 4 * kw * _TILE_W)
    else:
        smem = mma_geom(spec, MMA_PARTS[inst]).smem
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(f"C={c}, KH={kh}, KW={kw}, H={spec.sizes[1]} need "
                         f"{smem} bytes of shared memory per block "
                         f"({inst})")
    return smem


@functools.lru_cache(maxsize=None)  # a spec that fails raises every call
def check_kernel_spec(spec: TowerSpec, kernel: str,
                      inst: str = "float32") -> None:
    """Raise where the tower kernels' body for instance ``inst`` has no
    instance for ``spec``: C outside ``SUPPORTED_CHANNELS``, KH above
    ``MAX_KH`` (the FMA body's forward H accumulators and the tensor-core
    body's inverse H fragments live in registers), KW above ``MMA_MAX_KW``
    in the tensor-core body (its z loads), or a block's shared memory
    above 227 KB."""
    if spec.channels not in SUPPORTED_CHANNELS:
        raise ValueError(f"{kernel} kernel has no instance for "
                         f"C={spec.channels} (supported: "
                         f"{SUPPORTED_CHANNELS})")
    if spec.kh > MAX_KH:
        raise ValueError(f"{kernel}: KH={spec.kh} > {MAX_KH}")
    if inst != "float32" and spec.kw > MMA_MAX_KW:
        raise ValueError(f"{kernel} ({inst}): KW={spec.kw} > {MMA_MAX_KW}")
    kernel_smem_bytes(spec, inst)


def occupancy(spec: TowerSpec, inst: str = "float32"):
    """(blocks per SM, registers per thread) of the kernel's instance
    ``inst`` at ``spec``'s channels, H, modes and ds rows, as the CUDA
    runtime reports them."""
    return _build.occupancy("m3seg_tower_block_occupancy", spec.channels,
                            spec.sizes[1], spec.kh, spec.kw, spec.n_ds,
                            INSTANCES[inst][0])


def check_cuda_operands(x, named, inst: str) -> None:
    """Raise unless the CUDA operands ``named`` ((name, tensor or None)
    pairs) are what instance ``inst`` takes: the volumes x, out, tmp and
    the channel-mix weights w_cat, w_cc_t, wcat_stack, wcc_stack in the
    instance's dtypes, everything else fp32; contiguous, on x's device."""
    vol = torch.float32 if inst == "float32" else _BF16
    mix = _BF16 if inst == "bfloat16" else torch.float32
    for name, t in named:
        if t is None:
            continue
        dt = (vol if name in ("x", "out", "tmp") else
              mix if name.startswith(("w_cat", "w_cc", "wcat", "wcc"))
              else torch.float32)
        _build.check_cuda_input(name, t, x.device, t.dim(), dt)


def _tower_block_forward(x, z, w_cat, w_cc_t, b_cat, spec: TowerSpec,
                         ds_prev):
    """The kernel on CUDA tensors, ``tower_block_plain`` on CPU ones (the
    operands' shapes and dtypes already checked)."""
    if x.device.type == "cpu":
        return tower_block_plain(x, z, w_cat, w_cc_t, b_cat, spec, ds_prev)
    d, h, w = spec.sizes
    c, kh, kw, n_ds = spec.channels, spec.kh, spec.kw, spec.n_ds
    inst = instance(x, w_cat)
    check_cuda_operands(x, (("x", x), ("z", z), ("w_cat", w_cat),
                            ("w_cc_t", w_cc_t), ("b_cat", b_cat),
                            ("ds_prev", ds_prev)), inst)
    check_kernel_spec(spec, "tower_block", inst)
    if n_ds > MAX_DS_ROWS:
        raise ValueError(f"n_ds={n_ds} > {MAX_DS_ROWS}")
    out = torch.empty_like(x)
    # f in the weights' dtype: bf16 in 'bfloat16', fp32 otherwise
    f = torch.empty((d, 2, c, kh, kw), dtype=w_cat.dtype, device=x.device)
    ds = (torch.empty((d, h, w, n_ds), dtype=torch.float32, device=x.device)
          if n_ds else None)
    if inst == "float32":
        n_tiles = -(-w // _TILE_W)
        mats, wcat, wcc = _kernel_mats(spec, x.device), w_cat, w_cc_t
    else:  # the tensor-core body's packed matrices, alive until the launch
        n_tiles = mma_geom(spec).n_tiles
        mats = mma_mats(spec, x.device, MMA_PARTS[inst])
        wcat, wcc = mma_weights(w_cat, w_cc_t)
    # per (plane, W-tile) partial spectra, summed in tile order by the
    # kernel's second pass (deterministic, no atomics)
    partial = torch.empty((d, n_tiles, 2, c, kh, kw), dtype=torch.float32,
                          device=x.device)
    mode, suffix = INSTANCES[inst]
    _build.launch("tower_block" + suffix, "m3seg_tower_block", x.device,
                  x.data_ptr(), z.data_ptr(), wcat.data_ptr(),
                  wcc.data_ptr(), b_cat.data_ptr(), mats.data_ptr(),
                  ds_prev.data_ptr() if n_ds else None, out.data_ptr(),
                  f.data_ptr(), ds.data_ptr() if n_ds else None,
                  partial.data_ptr(), d, h, w, c, kh, kw, n_ds, mode)
    return (out, f, ds) if n_ds else (out, f)


class _TowerBlock(torch.autograd.Function):
    """The block's forward (the kernel, or its plain twin on the CPU); the
    backward is the reference's ``_fused_bwd``: a replay of
    ``tower_block_plain`` under autograd. ds_prev is only added to the ds
    output, so its gradient is the ds cotangent and the replay runs at
    ds_prev = 0."""

    @staticmethod
    def forward(ctx, x, z, w_cat, w_cc_t, b_cat, ds_prev, spec):
        ctx.spec = spec
        ctx.set_materialize_grads(False)  # f after the last block: None
        ctx.save_for_backward(x, z, w_cat, w_cc_t, b_cat)
        return _tower_block_forward(x, z, w_cat, w_cc_t, b_cat, spec,
                                    ds_prev)

    @staticmethod
    def backward(ctx, *grads):
        spec = ctx.spec
        zero = ctx.saved_tensors[0].new_zeros(()) if spec.n_ds else None
        got = _build.replay_grads(
            lambda *a: tower_block_plain(*a, spec, zero), ctx.saved_tensors,
            ctx.needs_input_grad[:5], grads)
        g_ds = grads[2] if spec.n_ds and ctx.needs_input_grad[5] else None
        return (*got, g_ds, None)


def fused_tower_block(x, z, w_cat, w_cc_t, b_cat, spec: TowerSpec,
                      ds_prev: Optional[torch.Tensor] = None):
    """One fused tower block: (x, z) -> (out, f[, ds]).

    Args:
        x: (D, H, W, C) block input, channels-last per plane; fp32, or
            bf16 ('bfloat16' and 'mixed').
        z: (D, 2, C, KH, KW) fp32 depth-inverse pre-images of the updated
            spectrum (``d_stage_inverse``, ``block_spectrum_update``).
        w_cat: (2C + n_ds, C) rows [W_conv ; W_cc_x ; W_ds], each (out, in);
            fp32, or bf16 with a bf16 x ('bfloat16').
        w_cc_t: (C, C) conv_concat matrix of the activated branch, in
            w_cat's dtype.
        b_cat: (2C,) fp32 [conv-branch bias or zeros ; conv_concat bias].
        spec: ``make_tower_spec``'s description.
        ds_prev: (D, H, W, n_ds) fp32 running deep-supervision sum,
            required iff ``spec.n_ds``.

    Returns:
        out (D, H, W, C) in x's dtype; f (D, 2, C, KH, KW), the forward
        H/W partial spectra of out, in w_cat's dtype; and, when
        ``spec.n_ds``, ds = ds_prev + the bias-free deep-supervision
        projection of x, fp32. A CPU tensor runs ``tower_block_plain``; a
        CUDA tensor launches the kernel's instance (``instance``;
        contiguous, C in ``SUPPORTED_CHANNELS``) or raises.
        Differentiable: the backward replays ``tower_block_plain``.
    """
    d = spec.sizes[0]
    ops = _check_operands(spec, x, w_cat, w_cc_t, b_cat, ds_prev,
                          z=(z, (d, 2, spec.channels, spec.kh, spec.kw)))
    if _build.needs_grad(*(t for t, _ in ops.values())):
        return _TowerBlock.apply(x, z, w_cat, w_cc_t, b_cat, ds_prev, spec)
    return _tower_block_forward(x, z, w_cat, w_cc_t, b_cat, spec, ds_prev)
