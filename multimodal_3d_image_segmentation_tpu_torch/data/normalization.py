"""Per-modality z-score normalization (host side, numpy), the port of
``multimodal_3d_image_segmentation_tpu/data/normalization.py``.

Statistics are taken in float64 over the voxels that are not ``mask_val``
(population std, 1 for a constant modality), then applied in float32;
masked voxels become 0, the mean after normalization.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["normalize_data", "normalize_modalities"]


def normalize_data(data, mask_val=None, clip_val: Optional[Tuple] = None
                   ) -> np.ndarray:
    """Normalize a single modality."""
    data = np.asarray(data, dtype=np.float32)
    if clip_val is not None:
        data = np.clip(data, *clip_val)
    mask = (data == mask_val) if mask_val is not None else None
    sel = data[~mask] if mask is not None else data.ravel()
    if sel.size == 0:
        return np.zeros_like(data)
    mean = sel.mean(dtype=np.float64)
    std = sel.std(dtype=np.float64)
    std = std if std > 0 else 1.0
    out = (data - np.float32(mean)) / np.float32(std)
    if mask is not None:
        out[mask] = 0.0
    return out.astype(np.float32, copy=False)


def normalize_modalities(data, mask_val=None, clip_val=None) -> np.ndarray:
    """Normalize each channel of a channel-first multimodal array
    independently."""
    return np.stack([normalize_data(d, mask_val=mask_val, clip_val=clip_val)
                     for d in data])
