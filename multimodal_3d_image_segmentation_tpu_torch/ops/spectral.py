"""Pruned ("packed-corner") Hartley and real-Fourier transforms as matrix
chains, the port of ``multimodal_3d_image_segmentation_tpu/ops/spectral.py``
(``dht_crop`` / ``dht_pad_inverse``, ``rfft_crop`` / ``rfft_pad_inverse``).

For each transformed axis, one contraction with a (n, 2m) cas/DFT matrix
yields exactly the packed corner layout ``[0..m-1, n-m..n-1]`` the upstream
model produces by FFT + crop + concat; the inverse is the transposed chain,
so the zero blocks are never materialized. Conventions (upstream
``nets/dht.py``): forward DHT with 1/N norm, inverse unnormalized,
DHT(x) = Re(FFT(x)) - Im(FFT(x)). The real FFT keeps only the non-negative
modes [0..m-1] of the last axis (the rfft half spectrum); its inverse folds
the Hermitian doubling weights (1, 2, 2, ...) into the last stage.

Matrices are built in float64 on the host (``_dft_mats_np``), rounded to
the contraction's dtype once (fp32; bf16; float64 for a reference model),
and cached on the device per (n, m, kind, device, dtype), so the serving
loop uploads them once. The contractions are plain ``torch.einsum`` (cuBLAS
on the GPU, exact fp32 under ``device.py``'s policy, fp32 accumulation for
bf16), in the reference's axis order.

``compute_dtype`` (the reference's ``[model] compute_dtype``, with
``set_bf16_exact`` folded in as the value 'mixed') is an explicit argument
here, not a process-wide flag: ``compute_dtypes`` maps it to the
activation dtype and the island dtype, the dtype at which weight and
transform-matrix contractions run (the reference's ``_isl``). 'float32':
both the parameters' dtype; 'bfloat16': both bf16; 'mixed': bf16
activations, fp32 islands (bf16 operands widened into the contraction).
The transforms take the island dtype as ``island``: their output stays in
it, as the reference's einsum promotes to the wider operand.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import device as _device  # noqa: F401  (fp32 policy)

__all__ = ["normalize_modes", "clip_modes", "spatial_axes", "dht_crop",
           "dht_pad_inverse", "rfft_crop", "rfft_pad_inverse",
           "COMPUTE_DTYPES", "compute_dtypes"]

COMPUTE_DTYPES = ("float32", "bfloat16", "mixed")


def compute_dtypes(compute_dtype: str,
                   param_dtype: torch.dtype = torch.float32
                   ) -> Tuple[torch.dtype, torch.dtype]:
    """(activation dtype, island dtype) of a ``compute_dtype`` for a model
    whose parameters are ``param_dtype`` (fp32; float64 for a reference)."""
    if compute_dtype == "float32":
        return param_dtype, param_dtype
    if compute_dtype == "bfloat16":
        return torch.bfloat16, torch.bfloat16
    if compute_dtype == "mixed":
        return torch.bfloat16, torch.float32
    raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got "
                     f"{compute_dtype!r}")


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
def _dft_mats_np(n: int, m: int, forward: bool, sign: int = -1
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) float64 matrices of the pruned DFT along one axis, with
    the e^{sign i theta} sign: forward (n, 2m) scaled by 1/n, inverse
    (2m, n) unscaled."""
    ks = _kept_freqs(n, m)
    theta = 2.0 * np.pi * np.outer(np.arange(n), ks) / n  # (n, K)
    if forward:
        return np.cos(theta) / n, np.sin(sign * theta) / n
    return np.cos(theta).T, np.sin(sign * theta).T


@functools.lru_cache(maxsize=None)
def _rfft_mats_np(n: int, m: int, forward: bool
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) float64 matrices of the rfft half-spectrum axis, modes
    [0..m-1]: forward (n, m) with e^{-i theta} and 1/n; inverse (m, n) with
    e^{+i theta} times the Hermitian doubling weights (1, 2, 2, ...)."""
    ks = np.arange(m)
    if forward:
        theta = 2.0 * np.pi * np.outer(np.arange(n), ks) / n
        return np.cos(theta) / n, np.sin(-theta) / n
    wk = np.where(ks == 0, 1.0, 2.0)[:, None]
    theta = 2.0 * np.pi * np.outer(ks, np.arange(n)) / n
    return wk * np.cos(theta), wk * np.sin(theta)


def _stage_matrix(c: np.ndarray, s: np.ndarray, kind: str,
                  dtype=np.float32, final_weights=None) -> np.ndarray:
    """Stage matrix from (C, S) = (cos, sin-with-sign) parts.

    first:  M[a, k, q]    = (C, S)
    mid:    M[a, q, k, p] : q=0 -> (C, S); q=1 -> (-S, C)
    fold:   M[a, q, k]    : q=0 -> C - S ; q=1 -> -(C + S)
    single: M[a, k]       = C - S
    fold with final_weights (w0, w1): q=0 -> w0; q=1 -> w1 (the Hermitian
    rfft completion Re(Z e^{+i theta}) = re C - im S).
    """
    if kind == "fold" and final_weights is not None:
        return np.asarray(np.stack(final_weights, axis=1), dtype)
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
                  device: torch.device, dtype: torch.dtype, sign: int = -1,
                  half: bool = False) -> torch.Tensor:
    """Device copy of one stage matrix, uploaded once per (n, m, direction,
    kind, device, dtype, sign, half), outside inference mode. fp32 and
    bf16 matrices are the float64 ones rounded to fp32 and then to
    ``dtype``; a float64 model (a reference for checks) gets the float64
    matrices. ``half`` is the rfft half-spectrum axis, whose inverse is the
    'fold' with the Hermitian weights."""
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    if half:
        c, s = _rfft_mats_np(n, m, forward)
        mat = _stage_matrix(c, s, kind, np_dt,
                            final_weights=(c, -s) if kind == "fold" else None)
    else:
        c, s = _dft_mats_np(n, m, forward, sign)
        mat = _stage_matrix(c, s, kind, np_dt)
    # a normal tensor even when serving builds it first: a later autograd
    # graph saves it for backward
    with torch.inference_mode(False):
        return torch.from_numpy(mat).to(device, dtype)


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
    ('fold' removes the comp axis with Re - Im folded into the matrix).
    A chain that starts complex ('mid' or 'fold') takes x with the comp
    axis already at position 1 (the rfft inverse)."""
    if not all(st[0] >= 1 for st in stages):
        raise ValueError("transform axes must be >= 1 (axis 0 is the batch)")
    has_comp = bool(stages) and stages[0][1] in ("mid", "fold")
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


def dht_crop(x: torch.Tensor, modes: Sequence[int],
             island: Optional[torch.dtype] = None) -> torch.Tensor:
    """Forward DHT (1/N norm) of a channels-last (B, *spatial, C) tensor,
    evaluated only at the packed corner modes (``modes`` already clipped).
    Returns the real packed spectrum (B, *2*modes, C) in the island dtype
    ``island`` (default: x's)."""
    x = x if island is None else x.to(island)
    axes = spatial_axes(x.ndim)
    mdict = dict(zip(axes, modes))
    pairs = [(ax, x.shape[ax], 2 * m) for ax, m in zip(axes, modes)]
    order = _axis_order(pairs)
    stages = []
    for (ax, n, _), kind in zip(order, _kinds(len(order))):
        stages.append((ax, kind, _stage_tensor(int(n), int(mdict[ax]), True,
                                               kind, x.device, x.dtype)))
    return _cas_chain(x, stages)


def dht_pad_inverse(y: torch.Tensor, sizes: Sequence[int],
                    island: Optional[torch.dtype] = None) -> torch.Tensor:
    """Inverse DHT (no norm) from a packed corner spectrum (B, *2m, C) to
    the full grid ``sizes``, in the island dtype ``island`` (default: y's);
    modes are inferred as (packed size)//2."""
    y = y if island is None else y.to(island)
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


def rfft_crop(x: torch.Tensor, modes: Sequence[int],
              island: Optional[torch.dtype] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward real FFT (1/N norm) of a channels-last (B, *spatial, C)
    tensor at the kept modes: packed corners [0..m-1, n-m..n-1] on every
    spatial axis but the last, [0..m-1] (the rfft half spectrum) on the
    last. Returns the (real, imag) pair of the cropped spectrum, in the
    island dtype ``island`` (default: x's)."""
    x = x if island is None else x.to(island)
    axes = spatial_axes(x.ndim)
    last = axes[-1]
    pairs = [(ax, x.shape[ax], m if ax == last else 2 * m, m)
             for ax, m in zip(axes, modes)]
    order = _axis_order(pairs)
    stages = []
    for i, (ax, n, _, m) in enumerate(order):
        kind = "first" if i == 0 else "mid"
        stages.append((ax, kind, _stage_tensor(int(n), int(m), True, kind,
                                               x.device, x.dtype,
                                               half=ax == last)))
    out = _cas_chain(x, stages)  # comp axis at position 1
    return out[:, 0], out[:, 1]


def rfft_pad_inverse(re: torch.Tensor, im: torch.Tensor,
                     sizes: Sequence[int],
                     island: Optional[torch.dtype] = None) -> torch.Tensor:
    """Inverse real FFT (unnormalized) from the kept modes to the full grid
    ``sizes``, as zero-padding the modes into the rfftn half spectrum and
    irfftn would: e^{+i theta} 'mid' stages on the other axes, largest
    expansion last, then the Hermitian last axis as a 'fold'; in the island
    dtype ``island`` (default: re's)."""
    if island is not None:
        re, im = re.to(island), im.to(island)
    axes = spatial_axes(re.ndim)
    last = axes[-1]
    pairs = []
    for ax, n in zip(axes[:-1], sizes[:-1]):
        m = re.shape[ax] // 2
        if n < 2 * m:
            raise ValueError(f"target size {n} < 2*modes {2 * m} on axis "
                             f"{ax}")
        pairs.append((ax, 2 * m, n, m))
    n, m = int(sizes[-1]), re.shape[last]
    if n < 2 * m:
        raise ValueError(f"target size {n} < 2*modes {2 * m} on axis {last}")
    stages = [(ax, "mid", _stage_tensor(int(n_), int(m_), False, "mid",
                                        re.device, re.dtype, sign=1))
              for ax, _, n_, m_ in _axis_order(pairs)]
    stages.append((last, "fold", _stage_tensor(n, m, False, "fold",
                                               re.device, re.dtype,
                                               half=True)))
    return _cas_chain(torch.stack([re, im], dim=1), stages)
