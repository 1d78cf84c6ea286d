"""Hartley-domain spectral convolution, the port of the HNOSeg-XS subset of
``multimodal_3d_image_segmentation_tpu/ops/operators.py::HartleyOperator``:
shared weights on an input that is already a packed spectrum
(``use_transform=False``), i.e. one (out, in) channel mix applied to every
kept frequency."""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from .. import device as _device  # noqa: F401  (fp32 policy)
from .. import not_ported
from . import initializers as inits

__all__ = ["HartleyOperator"]


class HartleyOperator(nn.Module):
    """``y = einsum('...i,oi->...o', x, weight)`` on a channels-last packed
    spectrum, with the upstream parameter name ``weight`` (O, I)."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_modes: Optional[Union[int, Sequence[int]]] = None,
                 use_bias: bool = False, weights_type: str = "shared",
                 use_transform: bool = True, snn_init: bool = False, *,
                 generator: torch.Generator):
        super().__init__()
        if weights_type not in ("individual", "shared"):
            raise ValueError(
                "weights_type must be one of {'individual', 'shared'}")
        if weights_type == "individual":
            not_ported("HartleyOperator weights_type='individual'", 10)
        if use_transform:
            not_ported("HartleyOperator use_transform=True", 10)
        if use_bias:
            not_ported("HartleyOperator frequency-domain bias", 10)
        init = (inits.kaiming_normal_linear(in_channels) if snn_init
                else inits.kaiming_uniform_a5(in_channels))
        self.weight = nn.Parameter(init((out_channels, in_channels),
                                        generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight)
