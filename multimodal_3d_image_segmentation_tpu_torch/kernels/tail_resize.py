"""Fused trilinear upsample + softmax output tail, the port of
``multimodal_3d_image_segmentation_tpu/kernels/tail_resize.py``.

Every model family ends with conv_out at the small internal grid, a
trilinear resize (align_corners=False) to the image size, a center
pad/crop that is a no-op at that size, and a softmax over channels. The
CUDA kernel (``csrc/tail_resize.cu``) does the resize and the softmax in
one pass, reading the float64-derived tap tables of
``ops/resize.py::_linear_taps_np``; ``tail_plain`` is ``resize_linear``
(interpolation matrices) + ``torch.softmax``.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import device as _device  # noqa: F401  (fp32 policy)
from ..ops.resize import _linear_taps_np, resize_linear
from . import _build

__all__ = ["fused_tail_softmax", "tail_plain", "tail_supported"]

_MAX_CHANNELS = 8  # per-thread register bound in the kernel


def tail_supported(shape: Sequence[int], sizes: Sequence[int]) -> bool:
    """Routing predicate of the fused tail: batch 1, 1 <= C <= 8, 3D, no
    empty axis. (The Pallas kernel's VMEM budget has no counterpart: the
    CUDA kernel keeps one voxel per thread.)"""
    if len(shape) != 5 or len(sizes) != 3:
        return False
    b, c = shape[:2]
    return (b == 1 and 1 <= c <= _MAX_CHANNELS
            and min(*shape[2:], *(int(s) for s in sizes)) >= 1)


def tail_plain(x_cf: torch.Tensor, sizes: Sequence[int]) -> torch.Tensor:
    """Resize + softmax as plain tensor ops: the kernel's oracle and CPU
    path."""
    return torch.softmax(resize_linear(x_cf, sizes, channel_first=True),
                         dim=1)


@functools.lru_cache(maxsize=None)
def _tap_tables(in_sizes: Tuple[int, ...], out_sizes: Tuple[int, ...],
                device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """int32 [lo_d, hi_d, lo_h, hi_h, lo_w, hi_w] and fp32 [w_d, w_h, w_w]
    on the device, uploaded once per shape."""
    idx, wts = [], []
    for n_in, n_out in zip(in_sizes, out_sizes):
        lo, hi, w_hi = _linear_taps_np(n_in, n_out)
        idx += [lo, hi]
        wts.append(w_hi)
    taps = torch.from_numpy(np.concatenate(idx).astype(np.int32))
    w = torch.from_numpy(np.concatenate(wts).astype(np.float32))
    return taps.to(device), w.to(device)


def fused_tail_softmax(x_cf: torch.Tensor, sizes: Sequence[int]
                       ) -> torch.Tensor:
    """(1, C, d, h, w) channel-first logits -> trilinear resize to
    ``sizes`` + softmax over C, (1, C, *sizes) fp32.

    A CPU tensor runs ``tail_plain``; a CUDA tensor launches the kernel
    (fp32, contiguous, ``tail_supported``) or raises. Forward only.
    """
    sizes = tuple(int(s) for s in sizes)
    if not tail_supported(tuple(x_cf.shape), sizes):
        raise ValueError(f"fused tail does not take {tuple(x_cf.shape)} -> "
                         f"{sizes} (batch 1, 1 <= C <= {_MAX_CHANNELS}, 3D)")
    if x_cf.device.type == "cpu":
        return tail_plain(x_cf, sizes)
    _build.check_cuda_input("x_cf", x_cf, x_cf.device, 5)
    _build.check_forward_only(x_cf)
    _, c, d, h, w = x_cf.shape
    taps, wts = _tap_tables((d, h, w), sizes, x_cf.device)
    out = torch.empty((1, c) + sizes, dtype=torch.float32,
                      device=x_cf.device)
    _build.launch("tail_resize", "m3seg_tail_resize_softmax", x_cf.device,
                  x_cf.data_ptr(), out.data_ptr(), taps.data_ptr(),
                  wts.data_ptr(), c, d, h, w, *sizes)
    return out
