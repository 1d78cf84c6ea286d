"""Linear resampling with exact half-pixel semantics, the port of
``multimodal_3d_image_segmentation_tpu/ops/resize.py``.

Linear interpolation is separable with two taps per output sample; each
axis is one contraction against the dense (n_in, n_out) two-tap matrix
(align_corners=False: src = (dst + 0.5) * in/out - 0.5, clamped). The tap
tables are computed in float64 on the host; the fused tail kernel
(``kernels/tail_resize.py``) reads the same tables, so both agree on which
taps an output sample uses.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import device as _device  # noqa: F401  (fp32 policy)

__all__ = ["resize_linear", "resize_linear_transpose", "resize_nearest"]


@functools.lru_cache(maxsize=None)
def _linear_taps_np(n_in: int, n_out: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(lo_idx, hi_idx, hi_weight) per output sample, half-pixel centers."""
    dst = np.arange(n_out)
    src = (dst + 0.5) * (n_in / n_out) - 0.5
    src = np.clip(src, 0.0, n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    w_hi = (src - lo).astype(np.float32)
    return lo, hi, w_hi


@functools.lru_cache(maxsize=None)
def _linear_matrix_np(n_in: int, n_out: int) -> np.ndarray:
    """Dense (n_in, n_out) two-tap interpolation matrix (fp32)."""
    lo, hi, w_hi = _linear_taps_np(n_in, n_out)
    m = np.zeros((n_in, n_out), np.float32)
    cols = np.arange(n_out)
    np.add.at(m, (lo, cols), 1.0 - w_hi)
    np.add.at(m, (hi, cols), w_hi)
    return m


@functools.lru_cache(maxsize=None)
def _linear_matrix(n_in: int, n_out: int, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    """Device copy of ``_linear_matrix_np``, made outside inference mode
    so that an autograd graph may save it after serving built it."""
    with torch.inference_mode(False):
        return torch.from_numpy(_linear_matrix_np(n_in, n_out)).to(device,
                                                                  dtype)


def _axis_matmul(x: torch.Tensor, n_out: int, ax: int,
                 transpose: bool = False) -> torch.Tensor:
    """Contract axis ``ax`` of ``x`` with the (n_in, n_out) interpolation
    matrix (with ``transpose``, axis ``ax`` of size n_out with its
    transpose, back to n_in = ``n_out``), output axis in place,
    accumulating in at least fp32."""
    dt = torch.promote_types(x.dtype, torch.float32)
    if transpose:
        mat = _linear_matrix(n_out, x.shape[ax], x.device, dt)
        dims = ([ax], [1])
    else:
        mat = _linear_matrix(x.shape[ax], n_out, x.device, dt)
        dims = ([ax], [0])
    y = torch.tensordot(x.to(dt), mat, dims=dims)  # ax moved last
    return torch.movedim(y, -1, ax).to(x.dtype)


def resize_linear(x: torch.Tensor, sizes: Sequence[int],
                  channel_first: bool = False) -> torch.Tensor:
    """Bi/tri-linear resize of the spatial axes of (B, *spatial, C), or of
    (B, C, *spatial) with ``channel_first=True``."""
    axes = range(2, x.ndim) if channel_first else range(1, x.ndim - 1)
    for ax, n_out in zip(axes, sizes):
        n_in = x.shape[ax]
        n_out = int(n_out)
        if n_in == n_out:
            continue
        x = _axis_matmul(x, n_out, ax)
    return x


def resize_linear_transpose(g: torch.Tensor, in_sizes: Sequence[int],
                            channel_first: bool = False) -> torch.Tensor:
    """The adjoint of ``resize_linear``: take ``g``, a gradient on the
    resized grid, back to the grid of ``in_sizes`` through the transposed
    interpolation matrices, axis by axis in the same order, skipping axes
    whose size does not change."""
    axes = range(2, g.ndim) if channel_first else range(1, g.ndim - 1)
    for ax, n_in in zip(axes, in_sizes):
        n_in = int(n_in)
        if g.shape[ax] == n_in:
            continue
        g = _axis_matmul(g, n_in, ax, transpose=True)
    return g


def resize_nearest(x: torch.Tensor, sizes: Sequence[int],
                   channel_first: bool = False) -> torch.Tensor:
    """Nearest-neighbour resize (floor indexing, PyTorch 'nearest') of
    the spatial axes of (B, *spatial, C), or of (B, C, *spatial) with
    ``channel_first=True``."""
    axes = range(2, x.ndim) if channel_first else range(1, x.ndim - 1)
    for ax, n_out in zip(axes, sizes):
        n_in = x.shape[ax]
        n_out = int(n_out)
        if n_in == n_out:
            continue
        idx = np.minimum(np.floor(np.arange(n_out) * (n_in / n_out)),
                         n_in - 1).astype(np.int64)
        x = torch.index_select(x, ax, torch.from_numpy(idx).to(x.device))
    return x
