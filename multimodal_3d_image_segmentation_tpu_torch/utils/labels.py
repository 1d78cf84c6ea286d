"""One-hot labels and label remapping, the port of
``multimodal_3d_image_segmentation_tpu/utils/labels.py``."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["to_categorical", "remap_labels"]


def to_categorical(y: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, 1, *spatial) integer labels -> (B, num_classes, *spatial)
    one-hot float32, channel-first (upstream ``experiments/utils.py:74-97``).
    A label outside [0, num_classes) gets an all-zero column, as in the
    reference."""
    if y.shape[1] != 1:
        raise ValueError(f"one label per voxel expected, got {y.shape[1]}")
    y = y[:, 0].long()
    classes = torch.arange(num_classes, device=y.device)
    onehot = (y.unsqueeze(1) == classes.view(1, -1, *([1] * (y.dim() - 1))))
    return onehot.to(torch.float32)


def remap_labels(label, mapping: Optional[Dict[int, int]]):
    """Remap integer labels via a {old: new} dict; every lookup reads the
    original labels, so chained pairs (1->2, 2->3) do not compose."""
    if mapping is None:
        return label
    if isinstance(label, np.ndarray):
        out = label.copy()
        for k, v in mapping.items():
            out[label == k] = v
        return out
    if isinstance(label, torch.Tensor):
        out = label.clone()
        for k, v in mapping.items():
            out[label == k] = v
        return out
    raise TypeError(f"labels must be a numpy array or a tensor, got "
                    f"{type(label).__name__}")
