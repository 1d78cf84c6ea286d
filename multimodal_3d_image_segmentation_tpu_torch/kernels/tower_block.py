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
reference's ``_block_reference``).

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
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import device as _device  # noqa: F401  (fp32 policy)
from ..ops.spectral import _dft_mats_np, _rfft_mats_np
from . import _build

__all__ = ["TowerSpec", "make_tower_spec", "fused_tower_block",
           "tower_block_plain", "entry_forward_hw", "d_stage_forward",
           "d_stage_inverse", "spectrum_mix", "block_spectrum_update",
           "spectrum_rows", "kernel_smem_bytes", "occupancy",
           "SUPPORTED_CHANNELS", "MAX_DS_ROWS", "MAX_KH"]

# template instances in the .cu: the configs' width 24, and 8 for tests
SUPPORTED_CHANNELS = (8, 24)
MAX_DS_ROWS = 8           # per-thread register bound of the ds rows
MAX_KH = 32               # csrc/tower_block.cuh kMaxKH: F's registers
_TILE_W, _TILE_H = 8, 32  # csrc/tower_block.cuh kTW, kTH
_MAX_SMEM_BYTES = 227 * 1024


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
    """Device copy of one stage matrix (or pair), uploaded once."""
    m = _spec_mats(spec)[key]
    np_dt = np.float64 if dtype == torch.float64 else np.float32

    def put(a):
        return torch.from_numpy(np.asarray(a, np_dt)).to(device)
    return tuple(put(a) for a in m) if isinstance(m, tuple) else put(m)


@functools.lru_cache(maxsize=None)
def _kernel_mats(spec: TowerSpec, device: torch.device) -> torch.Tensor:
    """The kernel's fp32 stage matrices in one buffer, in the order the
    .cu reads them: mhf (H, 2KH) = [cos | sin]; cwi, swi (KW, W); ha, hb
    (KH, H); cw, sw (W, KW)."""
    m = _spec_mats(spec)
    parts = [np.concatenate(m["h_fwd"], axis=1), *m["w_inv"], *m["h_inv"],
             *m["w_fwd"]]
    flat = np.concatenate([np.asarray(p, np.float32).ravel() for p in parts])
    return torch.from_numpy(flat).to(device)


def entry_forward_hw(x: torch.Tensor, spec: TowerSpec) -> torch.Tensor:
    """Forward H/W stages of a whole volume: (D, H, W, C) -> per-plane
    partial spectra (D, 2, C, KH, KW)."""
    ch, sh = _stage(spec, "h_fwd", x.device, x.dtype)
    cw, sw = _stage(spec, "w_fwd", x.device, x.dtype)
    fre = torch.einsum("dhwc,hk->dcwk", x, ch)
    fim = torch.einsum("dhwc,hk->dcwk", x, sh)
    gre = torch.einsum("dcwk,wj->dckj", fre, cw) \
        - torch.einsum("dcwk,wj->dckj", fim, sw)
    gim = torch.einsum("dcwk,wj->dckj", fre, sw) \
        + torch.einsum("dcwk,wj->dckj", fim, cw)
    return torch.stack([gre, gim], dim=1)


def d_stage_forward(f: torch.Tensor, spec: TowerSpec) -> torch.Tensor:
    """(D, 2, C, KH, KW) per-plane partial spectra -> the packed spectrum
    (KS, C, KH, KW) (Fourier: [re; im], the reference's (2, KD, ...)
    merged on the first axis)."""
    m = _stage(spec, "d_fwd", f.device, f.dtype)
    return torch.einsum("dqcxy,dqk->kcxy", f, m)


def d_stage_inverse(s: torch.Tensor, spec: TowerSpec) -> torch.Tensor:
    """Packed spectrum (KS, C, KH, KW) -> per-plane complex pre-images
    (D, 2, C, KH, KW)."""
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


def tower_block_plain(x, z, w_cat, w_cc_t, b_cat, spec: TowerSpec,
                      ds_prev: Optional[torch.Tensor] = None):
    """The block in torch ops over all planes at once: the kernel's oracle
    and CPU path (the reference's ``_block_reference``)."""
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
    block's spectrum operand as (tensor, expected shape). Returns name ->
    (tensor, shape) of every operand given."""
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
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{name} must be float32 (or float64 on the "
                            f"CPU), got {t.dtype}")
    return want


def kernel_smem_bytes(spec: TowerSpec) -> int:
    """Shared memory of one block of the kernels (``csrc/tower_block.cuh``
    smem_floats: the y tile, one chunk of voxels, the chunk's (A, B) and Mh
    rows, the weights with room for MAX_DS_ROWS deep-supervision rows, and
    the tile's W-stage columns); raises where it exceeds a block's
    227 KB."""
    c, kh, kw = spec.channels, spec.kh, spec.kw
    smem = 4 * (2 * kh * _TILE_W * c + _TILE_H * _TILE_W * c
                + 2 * kh * _TILE_H + _TILE_H * 2 * kh
                + (2 * c + MAX_DS_ROWS) * c + c * c + 2 * c
                + 4 * kw * _TILE_W)
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(f"C={c}, KH={kh}, KW={kw} need {smem} bytes of "
                         "shared memory per block")
    return smem


def check_kernel_spec(spec: TowerSpec, kernel: str) -> None:
    """Raise where the tower kernels' body has no instance for ``spec``:
    C outside ``SUPPORTED_CHANNELS``, KH above ``MAX_KH`` (the forward H
    accumulators live in registers) or a block's shared memory above
    227 KB."""
    if spec.channels not in SUPPORTED_CHANNELS:
        raise ValueError(f"{kernel} kernel has no instance for "
                         f"C={spec.channels} (supported: "
                         f"{SUPPORTED_CHANNELS})")
    if spec.kh > MAX_KH:
        raise ValueError(f"{kernel}: KH={spec.kh} > {MAX_KH}")
    kernel_smem_bytes(spec)


def occupancy(spec: TowerSpec):
    """(blocks per SM, registers per thread) of the kernel at ``spec``'s
    channels, modes and ds rows, as the CUDA runtime reports them."""
    return _build.occupancy("m3seg_tower_block_occupancy", spec.channels,
                            spec.kh, spec.kw, spec.n_ds)


def fused_tower_block(x, z, w_cat, w_cc_t, b_cat, spec: TowerSpec,
                      ds_prev: Optional[torch.Tensor] = None):
    """One fused tower block: (x, z) -> (out, f[, ds]).

    Args:
        x: (D, H, W, C) block input, channels-last per plane.
        z: (D, 2, C, KH, KW) depth-inverse pre-images of the updated
            spectrum (``d_stage_inverse``, ``block_spectrum_update``).
        w_cat: (2C + n_ds, C) rows [W_conv ; W_cc_x ; W_ds], each (out, in).
        w_cc_t: (C, C) conv_concat matrix of the activated branch.
        b_cat: (2C,) [conv-branch bias or zeros ; conv_concat bias].
        spec: ``make_tower_spec``'s description.
        ds_prev: (D, H, W, n_ds) fp32 running deep-supervision sum,
            required iff ``spec.n_ds``.

    Returns:
        out (D, H, W, C); f (D, 2, C, KH, KW), the forward H/W partial
        spectra of out; and, when ``spec.n_ds``, ds = ds_prev + the
        bias-free deep-supervision projection of x. A CPU tensor runs
        ``tower_block_plain``; a CUDA tensor launches the kernel (fp32,
        contiguous, C in ``SUPPORTED_CHANNELS``) or raises. Forward only.
    """
    d, h, w = spec.sizes
    c, kh, kw, n_ds = spec.channels, spec.kh, spec.kw, spec.n_ds
    ops = _check_operands(spec, x, w_cat, w_cc_t, b_cat, ds_prev,
                          z=(z, (d, 2, c, kh, kw)))
    if x.device.type == "cpu":
        return tower_block_plain(x, z, w_cat, w_cc_t, b_cat, spec, ds_prev)
    for name, (t, shape) in ops.items():
        _build.check_cuda_input(name, t, x.device, len(shape))
    _build.check_forward_only(*(t for t, _ in ops.values()))
    check_kernel_spec(spec, "tower_block")
    if n_ds > MAX_DS_ROWS:
        raise ValueError(f"n_ds={n_ds} > {MAX_DS_ROWS}")
    n_tiles = -(-w // _TILE_W)
    out = torch.empty_like(x)
    f = torch.empty((d, 2, c, kh, kw), dtype=torch.float32, device=x.device)
    ds = (torch.empty((d, h, w, n_ds), dtype=torch.float32, device=x.device)
          if n_ds else None)
    # per (plane, W-tile) partial spectra, summed in tile order by the
    # kernel's second pass (deterministic, no atomics)
    partial = torch.empty((d, n_tiles, 2, c, kh, kw), dtype=torch.float32,
                          device=x.device)
    mats = _kernel_mats(spec, x.device)
    _build.launch("tower_block", "m3seg_tower_block", x.device,
                  x.data_ptr(), z.data_ptr(), w_cat.data_ptr(),
                  w_cc_t.data_ptr(), b_cat.data_ptr(), mats.data_ptr(),
                  ds_prev.data_ptr() if n_ds else None, out.data_ptr(),
                  f.data_ptr(), ds.data_ptr() if n_ds else None,
                  partial.data_ptr(), d, h, w, c, kh, kw, n_ds)
    return (out, f, ds) if n_ds else (out, f)
