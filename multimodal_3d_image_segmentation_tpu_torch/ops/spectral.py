"""Pruned ("packed-corner") Hartley transforms as matrix chains, the port of
the HNOSeg-XS subset of ``multimodal_3d_image_segmentation_tpu/ops/spectral.py``.

For each transformed axis, one contraction with a (n, 2m) cas/DFT matrix
yields exactly the packed corner layout ``[0..m-1, n-m..n-1]`` the upstream
model produces by FFT + crop + concat; the inverse is the transposed chain,
so the zero blocks are never materialized. Conventions (upstream
``nets/dht.py``): forward DHT with 1/N norm, inverse unnormalized,
DHT(x) = Re(FFT(x)) - Im(FFT(x)).

Matrices are built in float64 on the host (``_dft_mats_np``), rounded to
the tensor's dtype once (fp32; float64 for a reference model), and cached
on the device per (n, m, kind, device, dtype), so the serving loop uploads
them once. The contractions are plain ``torch.einsum`` (cuBLAS
on the GPU, exact fp32 under ``device.py``'s policy), in the reference's
axis order.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import device as _device  # noqa: F401  (fp32 policy)

__all__ = ["normalize_modes", "clip_modes", "spatial_axes", "dht_crop",
           "dht_pad_inverse"]


def spatial_axes(ndim: int) -> Tuple[int, ...]:
    """Spatial axes for channels-last layout (B, *spatial, C)."""
    return tuple(range(1, ndim - 1))


def normalize_modes(num_modes, n_spatial: int) -> Tuple[int, ...]:
    """Broadcast a scalar mode count to all spatial dims."""
    if np.isscalar(num_modes):
        return (int(num_modes),) * n_spatial
    if len(num_modes) != n_spatial:
        raise ValueError(f"num_modes {num_modes} for {n_spatial} axes")
    return tuple(int(m) for m in num_modes)


def clip_modes(modes: Sequence[int], sizes: Sequence[int]) -> Tuple[int, ...]:
    """Clip modes to half the spatial size."""
    return tuple(min(int(m), int(s) // 2) for m, s in zip(modes, sizes))


def _kept_freqs(n: int, m: int) -> np.ndarray:
    """Kept frequencies in packed-corner order: [0..m-1] then [n-m..n-1]."""
    assert n >= 2 * m
    return np.concatenate([np.arange(m), np.arange(n - m, n)])


@functools.lru_cache(maxsize=None)
def _dft_mats_np(n: int, m: int, forward: bool
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) float64 matrices of the pruned DFT along one axis, with
    the e^{-i theta} sign: forward (n, 2m) scaled by 1/n, inverse (2m, n)
    unscaled."""
    ks = _kept_freqs(n, m)
    theta = 2.0 * np.pi * np.outer(np.arange(n), ks) / n  # (n, K)
    if forward:
        return np.cos(theta) / n, np.sin(-theta) / n
    return np.cos(theta).T, np.sin(-theta).T


def _stage_matrix(c: np.ndarray, s: np.ndarray, kind: str,
                  dtype=np.float32) -> np.ndarray:
    """Stage matrix from (C, S) = (cos, sin-with-sign) parts.

    first:  M[a, k, q]    = (C, S)
    mid:    M[a, q, k, p] : q=0 -> (C, S); q=1 -> (-S, C)
    fold:   M[a, q, k]    : q=0 -> C - S ; q=1 -> -(C + S)
    single: M[a, k]       = C - S
    """
    if kind == "first":
        m = np.stack([c, s], axis=-1)
    elif kind == "mid":
        m = np.stack([np.stack([c, s], -1), np.stack([-s, c], -1)], axis=1)
    elif kind == "fold":
        m = np.stack([c - s, -(c + s)], axis=1)
    elif kind == "single":
        m = c - s
    else:
        raise ValueError(kind)
    return np.asarray(m, dtype)


@functools.lru_cache(maxsize=None)
def _stage_tensor(n: int, m: int, forward: bool, kind: str,
                  device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """Device copy of one stage matrix, uploaded once per
    (n, m, direction, kind, device, dtype). fp32 matrices are the float64
    ones rounded once; a float64 model (a reference for checks) gets the
    float64 matrices."""
    c, s = _dft_mats_np(n, m, forward)
    mat = _stage_matrix(c, s, kind, np.float64 if dtype == torch.float64
                        else np.float32)
    return torch.from_numpy(mat).to(device)


def _axis_order(pairs):
    """Forward pairs carry (n, 2m), inverse pairs (2m, n); sorting both
    descending on n_in/n_out contracts the largest reduction first and
    expands the largest axis last, keeping intermediates small."""
    return sorted(pairs, key=lambda t: t[1] / max(t[2], 1), reverse=True)


def _kinds(n_stages: int):
    if n_stages == 1:
        return ["single"]
    return ["first"] + ["mid"] * (n_stages - 2) + ["fold"]


_LETTERS = "abcdefghijklmnop"


def _cas_chain(x: torch.Tensor, stages) -> torch.Tensor:
    """Run a pruned separable transform on a real tensor, carrying the
    complex pair as one extra axis of size 2 (inserted at position 1) so
    every stage is one einsum. ``stages``: ordered (orig_axis, kind,
    matrix), axes in the comp-free layout; kinds as in ``_stage_matrix``
    ('fold' removes the comp axis with Re - Im folded into the matrix)."""
    if not all(st[0] >= 1 for st in stages):
        raise ValueError("transform axes must be >= 1 (axis 0 is the batch)")
    has_comp = False
    for orig_axis, kind, mat in stages:
        ax = orig_axis + (1 if has_comp else 0)
        subs = _LETTERS[:x.ndim]
        a = subs[ax]
        if kind == "first":
            out = subs[0] + "Q" + subs[1:].replace(a, "K")
            eq = f"{subs},{a}KQ->{out}"
            has_comp = True
        elif kind == "single":
            eq = f"{subs},{a}K->{subs.replace(a, 'K')}"
        else:
            q = subs[1]  # comp axis label
            if kind == "mid":
                out = subs.replace(a, "K").replace(q, "P")
                eq = f"{subs},{a}{q}KP->{out}"
            else:  # fold
                out = subs.replace(a, "K").replace(q, "")
                eq = f"{subs},{a}{q}K->{out}"
                has_comp = False
        x = torch.einsum(eq, x, mat)
    return x


def dht_crop(x: torch.Tensor, modes: Sequence[int]) -> torch.Tensor:
    """Forward DHT (1/N norm) of a channels-last (B, *spatial, C) tensor,
    evaluated only at the packed corner modes (``modes`` already clipped).
    Returns the real packed spectrum (B, *2*modes, C)."""
    axes = spatial_axes(x.ndim)
    mdict = dict(zip(axes, modes))
    pairs = [(ax, x.shape[ax], 2 * m) for ax, m in zip(axes, modes)]
    order = _axis_order(pairs)
    stages = []
    for (ax, n, _), kind in zip(order, _kinds(len(order))):
        stages.append((ax, kind, _stage_tensor(int(n), int(mdict[ax]), True,
                                               kind, x.device, x.dtype)))
    return _cas_chain(x, stages)


def dht_pad_inverse(y: torch.Tensor, sizes: Sequence[int]) -> torch.Tensor:
    """Inverse DHT (no norm) from a packed corner spectrum (B, *2m, C) to
    the full grid ``sizes``; modes are inferred as (packed size)//2."""
    axes = spatial_axes(y.ndim)
    modes = {ax: y.shape[ax] // 2 for ax in axes}
    ndict = dict(zip(axes, sizes))
    for ax, n in zip(axes, sizes):
        if n < 2 * modes[ax]:
            raise ValueError(f"target size {n} < 2*modes {2 * modes[ax]} "
                             f"on axis {ax}")
    pairs = [(ax, 2 * modes[ax], n) for ax, n in zip(axes, sizes)]
    order = _axis_order(pairs)
    stages = []
    for (ax, _, _), kind in zip(order, _kinds(len(order))):
        stages.append((ax, kind, _stage_tensor(int(ndict[ax]), modes[ax],
                                               False, kind, y.device,
                                               y.dtype)))
    return _cas_chain(y, stages)
