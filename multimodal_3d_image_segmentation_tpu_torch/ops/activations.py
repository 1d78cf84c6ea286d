"""Activation registry (name -> torch function), the port of
``multimodal_3d_image_segmentation_tpu/ops/activations.py``."""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F

__all__ = ["get_activation", "is_selu"]

_REGISTRY = {
    "selu": F.selu,
    "elu": F.elu,
    "relu": F.relu,
    "relu6": F.relu6,
    "gelu": F.gelu,
    "silu": F.silu,
    "swish": F.silu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "leaky_relu": F.leaky_relu,
    "softplus": F.softplus,
    "softmax": lambda x: torch.softmax(x, dim=1),
    "identity": lambda x: x,
    "linear": lambda x: x,
}


def get_activation(act: Optional[Union[str, Callable]]) -> Optional[Callable]:
    if act is None or callable(act):
        return act
    if act not in _REGISTRY:
        raise ValueError(f"Unknown activation {act!r}")
    return _REGISTRY[act]


def is_selu(act) -> bool:
    """True when the activation is SELU (SNN init, no normalization)."""
    return act == "selu" or act is F.selu or act is torch.selu
