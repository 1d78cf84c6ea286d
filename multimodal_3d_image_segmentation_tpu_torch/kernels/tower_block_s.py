"""Fused tower block with the depth stages inside the kernel, the port of
``multimodal_3d_image_segmentation_tpu/kernels/tower_block_s.py``.

Between blocks the tower carries one small resident packed spectrum
(KS, C, KH, KW) fp32 (Hartley: KS = KD, real; Fourier: KS = 2 * KD,
[re; im]) instead of per-plane spectra. One block, per depth plane d::

    z[d]  = sum_s mi[d, :, s] * sy[s]           inverse depth stage
    out[d], f[d] (, ds[d]) = the tower_block body on (x[d], z[d])
    s_f   = sum_d sum_q mf[d, q, :] * f[d, q]   forward depth stage

``fused_tower_block_s`` launches the CUDA kernel (``csrc/tower_block_s.cu``)
on CUDA tensors: z and f never cross device memory. ``tower_block_s_plain``
is the same block in torch ops (the reference's ``_block_reference_s``: the
depth-inverse einsum, ``tower_block_plain``, ``d_stage_forward``). Between
kernels the operator mixes the resident spectrum (``spectrum_mix_s``); the
tower's entry is ``entry_spectrum_s``.

The specs and matrices are ``kernels/tower_block.py``'s: the port has no
lane padding, so ``make_tower_spec_s`` is ``make_tower_spec``, and the
depth matrices mi = ``d_inv`` and mf = ``d_fwd`` are (D, 2, KS), one row
per plane. The TPU kernel's probe of a Mosaic miscompile (``_hw_probe_ok``)
has no counterpart here: ``chip_smoke.py`` holds the kernel against the
plain version on the card.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from . import _build
from .tower_block import (MAX_DS_ROWS, _TILE_W, TowerSpec,
                          _check_operands, _kernel_mats, _spec_mats, _stage,
                          check_kernel_spec, d_stage_forward,
                          entry_forward_hw, make_tower_spec, spectrum_mix,
                          spectrum_rows, tower_block_plain)

__all__ = ["make_tower_spec_s", "fused_tower_block_s", "tower_block_s_plain",
           "spectrum_mix_s", "entry_spectrum_s", "occupancy",
           "MAX_SPECTRUM_ROWS"]

MAX_SPECTRUM_ROWS = 64  # csrc/tower_spectrum.cuh kMaxKS
_DEPTH_ROWS = 4         # csrc/tower_spectrum.cuh kDepthRows

make_tower_spec_s = make_tower_spec
# the resident spectrum has d_stage_forward's (KS, C, KH, KW) layout
spectrum_mix_s = spectrum_mix


def entry_spectrum_s(x: torch.Tensor, spec: TowerSpec) -> torch.Tensor:
    """Tower entry: the forward H/W and depth stages of the volume (D, H, W,
    C) straight to the resident spectrum (KS, C, KH, KW)."""
    return d_stage_forward(entry_forward_hw(x, spec), spec)


def tower_block_s_plain(x, sy, w_cat, w_cc_t, b_cat, spec: TowerSpec,
                        ds_prev: Optional[torch.Tensor] = None):
    """The block in torch ops: the kernel's oracle and CPU path."""
    mi = _stage(spec, "d_inv", x.device, x.dtype)
    z = torch.einsum("dqk,kcxy->dqcxy", mi, sy.to(x.dtype))
    res = tower_block_plain(x, z, w_cat, w_cc_t, b_cat, spec, ds_prev)
    return (res[0], d_stage_forward(res[1], spec)) + tuple(res[2:])


def _pack_depth_rows(mf: np.ndarray) -> np.ndarray:
    """mf (D, 2, KS) as the depth pass reads it: (ceil(KS / 4), D, 2, 4),
    four spectrum rows of a plane and component as one float4, the rows
    past KS zero."""
    d, _, ks = mf.shape
    n = -(-ks // _DEPTH_ROWS)
    padded = np.zeros((d, 2, n * _DEPTH_ROWS), np.float32)
    padded[:, :, :ks] = mf
    return padded.reshape(d, 2, n, _DEPTH_ROWS).transpose(2, 0, 1, 3)


@functools.lru_cache(maxsize=None)
def _kernel_mats_s(spec: TowerSpec, device: torch.device) -> torch.Tensor:
    """tower_block's stage-matrix buffer followed by mi (D, 2, KS) and mf
    packed by ``_pack_depth_rows``, fp32."""
    m = _spec_mats(spec)
    depth = np.concatenate([
        np.asarray(m["d_inv"], np.float32).ravel(),
        _pack_depth_rows(np.asarray(m["d_fwd"], np.float32)).ravel()])
    return torch.cat([_kernel_mats(spec, device),
                      torch.from_numpy(depth).to(device)])


def occupancy(spec: TowerSpec):
    """(blocks per SM, registers per thread) of the kernel at ``spec``'s
    channels, modes and ds rows, as the CUDA runtime reports them."""
    return _build.occupancy("m3seg_tower_block_s_occupancy", spec.channels,
                            spec.kh, spec.kw, spec.n_ds)


def fused_tower_block_s(x, sy, w_cat, w_cc_t, b_cat, spec: TowerSpec,
                        ds_prev: Optional[torch.Tensor] = None):
    """One fused tower block on the resident spectrum: (x, sy) -> (out,
    s_f[, ds]).

    Args:
        x: (D, H, W, C) block input, channels-last per plane.
        sy: (KS, C, KH, KW) fp32 resident spectrum after the block's
            operator (``spectrum_mix_s`` of the previous s_f, or of
            ``entry_spectrum_s`` for the first block).
        w_cat, w_cc_t, b_cat, spec, ds_prev: as ``fused_tower_block``.

    Returns:
        out (D, H, W, C); s_f (KS, C, KH, KW), the packed spectrum of out;
        and, when ``spec.n_ds``, ds = ds_prev + the bias-free deep-
        supervision projection of x. A CPU tensor runs
        ``tower_block_s_plain``; a CUDA tensor launches the kernel (fp32,
        contiguous, C in ``SUPPORTED_CHANNELS``) or raises. Forward only.
    """
    ks = spectrum_rows(spec)
    d, h, w = spec.sizes
    c, kh, kw, n_ds = spec.channels, spec.kh, spec.kw, spec.n_ds
    ops = _check_operands(spec, x, w_cat, w_cc_t, b_cat, ds_prev,
                          sy=(sy, (ks, c, kh, kw)))
    if x.device.type == "cpu":
        return tower_block_s_plain(x, sy, w_cat, w_cc_t, b_cat, spec,
                                   ds_prev)
    for name, (t, shape) in ops.items():
        _build.check_cuda_input(name, t, x.device, len(shape))
    _build.check_forward_only(*(t for t, _ in ops.values()))
    check_kernel_spec(spec, "tower_block_s")
    if n_ds > MAX_DS_ROWS:
        raise ValueError(f"n_ds={n_ds} > {MAX_DS_ROWS}")
    if ks > MAX_SPECTRUM_ROWS:
        raise ValueError(f"KS={ks} spectrum rows > {MAX_SPECTRUM_ROWS}")
    out = torch.empty_like(x)
    s_f = torch.empty((ks, c, kh, kw), dtype=torch.float32, device=x.device)
    ds = (torch.empty((d, h, w, n_ds), dtype=torch.float32, device=x.device)
          if n_ds else None)
    # per (plane, W-tile) partial spectra, then each plane's z, which the
    # tile sum overwrites with f: the passes after the body fold them into
    # s_f through the depth forward stage in a fixed order
    partial = torch.empty(d * (-(-w // _TILE_W) + 1) * 2 * c * kh * kw,
                          dtype=torch.float32, device=x.device)
    mats = _kernel_mats_s(spec, x.device)
    _build.launch("tower_block_s", "m3seg_tower_block_s", x.device,
                  x.data_ptr(), sy.data_ptr(), w_cat.data_ptr(),
                  w_cc_t.data_ptr(), b_cat.data_ptr(), mats.data_ptr(),
                  ds_prev.data_ptr() if n_ds else None, out.data_ptr(),
                  s_f.data_ptr(), ds.data_ptr() if n_ds else None,
                  partial.data_ptr(), d, h, w, c, kh, kw, n_ds, ks)
    return (out, s_f, ds) if n_ds else (out, s_f)
