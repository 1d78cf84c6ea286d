"""Center spatial pad/crop, the port of
``multimodal_3d_image_segmentation_tpu/ops/padcrop.py``: per spatial axis,
pad or crop to the target size with floor(d/2) on the low side and
ceil(d/2) on the high side."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["spatial_padcrop", "get_spatial_padcrop"]


def get_spatial_padcrop(shape: Sequence[int], target_shape: Sequence[int]
                        ) -> Tuple[list, list]:
    """Per-axis (pad_lo, pad_hi) and (crop_lo, crop_hi) amounts."""
    padding, cropping = [], []
    for s, t in zip(shape, target_shape):
        d = t - s
        if d >= 0:
            padding.append((d // 2, d - d // 2))
            cropping.append((0, 0))
        else:
            d = -d
            padding.append((0, 0))
            cropping.append((d // 2, d - d // 2))
    return padding, cropping


def spatial_padcrop(x: torch.Tensor, target_shape: Sequence[int],
                    channel_first: bool = False) -> torch.Tensor:
    """Pad and/or crop the spatial axes of a (B, *spatial, C) tensor (or
    (B, C, *spatial) with ``channel_first=True``)."""
    spatial = tuple(x.shape[2:] if channel_first else x.shape[1:-1])
    if len(spatial) != len(target_shape):
        raise ValueError(f"{len(spatial)} spatial axes, target "
                         f"{tuple(target_shape)}")
    if spatial == tuple(int(t) for t in target_shape):
        return x

    padding, cropping = get_spatial_padcrop(spatial, target_shape)
    first = 2 if channel_first else 1
    if any(p != (0, 0) for p in padding):
        # F.pad lists (lo, hi) from the LAST axis backwards
        pads = [] if channel_first else [0, 0]
        for lo, hi in reversed(padding):
            pads += [lo, hi]
        x = F.pad(x, pads)
    if any(c != (0, 0) for c in cropping):
        idx = [slice(None)] * x.ndim
        for i, (lo, hi) in enumerate(cropping):
            ax = first + i
            idx[ax] = slice(lo, x.shape[ax] - hi)
        x = x[tuple(idx)]
    return x
