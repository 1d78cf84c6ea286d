"""Label remapping for numpy arrays and torch tensors, the port of
``multimodal_3d_image_segmentation_tpu/utils/labels.py::remap_labels``."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["remap_labels"]


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
