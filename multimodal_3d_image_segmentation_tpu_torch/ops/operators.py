"""Frequency-domain neural operator layers, the port of the shared-weight
subset of ``multimodal_3d_image_segmentation_tpu/ops/operators.py``
(``HartleyOperator``, ``FourierOperator``).

Shared weights are one (out, in) channel mix applied to every kept
frequency. With ``use_transform=True`` the operator takes a channels-last
(B, *spatial, C) volume: the pruned transform to the kept modes (clipped to
half the grid), the mix, SELU in the frequency domain for Hartley (upstream
``nets/hartley_operator.py:265-267``; selu(0) == 0 keeps the implicit zero
padding), and the pruned inverse. With ``use_transform=False`` the input is
already a packed spectrum (the HNOSeg-XS frequency-resident step), for
Fourier a (real, imag) pair. Fourier keeps its complex weight as the real
pair ``weight_real`` / ``weight_imag`` and the rfft half-spectrum layout of
the last axis.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from .. import device as _device  # noqa: F401  (fp32 policy)
from .. import not_ported
from . import initializers as inits
from .spectral import (clip_modes, dht_crop, dht_pad_inverse,
                       normalize_modes, rfft_crop, rfft_pad_inverse)

__all__ = ["HartleyOperator", "FourierOperator"]


def _weight(out_channels: int, in_channels: int, snn_init: bool,
            generator: torch.Generator) -> nn.Parameter:
    init = (inits.kaiming_normal_linear(in_channels) if snn_init
            else inits.kaiming_uniform_a5(in_channels))
    return nn.Parameter(init((out_channels, in_channels), generator))


class _SpectralOperator(nn.Module):
    """Options shared by both operators; what the port does not cover
    raises naming its ROADMAP item."""

    def __init__(self, name: str, num_modes, use_bias: bool,
                 weights_type: str, use_transform: bool):
        super().__init__()
        if weights_type not in ("individual", "shared"):
            raise ValueError(
                "weights_type must be one of {'individual', 'shared'}")
        if weights_type == "individual":
            not_ported(f"{name} weights_type='individual'", 18)
        if use_bias:
            not_ported(f"{name} frequency-domain bias", 18)
        if use_transform and num_modes is None:
            raise ValueError(f"{name} use_transform=True needs num_modes")
        self.num_modes = num_modes
        self.use_transform = use_transform

    def _modes(self, x: torch.Tensor):
        sizes = tuple(x.shape[1:-1])
        return sizes, clip_modes(normalize_modes(self.num_modes, len(sizes)),
                                 sizes)


class HartleyOperator(_SpectralOperator):
    """Hartley-domain spectral convolution with the upstream parameter name
    ``weight`` (O, I)."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_modes: Optional[Union[int, Sequence[int]]] = None,
                 use_bias: bool = False, weights_type: str = "shared",
                 use_transform: bool = True, snn_init: bool = False, *,
                 generator: torch.Generator):
        super().__init__("HartleyOperator", num_modes, use_bias,
                         weights_type, use_transform)
        self.weight = _weight(out_channels, in_channels, snn_init, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.use_transform:
            return F.linear(x, self.weight)
        sizes, modes = self._modes(x)
        y = torch.selu(F.linear(dht_crop(x, modes), self.weight))
        return dht_pad_inverse(y, sizes)


class FourierOperator(_SpectralOperator):
    """Fourier-domain spectral convolution (FNO-style) with the upstream
    parameter names ``weight_real`` / ``weight_imag`` (O, I)."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_modes: Optional[Union[int, Sequence[int]]] = None,
                 use_bias: bool = False, weights_type: str = "shared",
                 use_transform: bool = True, snn_init: bool = False, *,
                 generator: torch.Generator):
        super().__init__("FourierOperator", num_modes, use_bias,
                         weights_type, use_transform)
        self.weight_real = _weight(out_channels, in_channels, snn_init,
                                   generator)
        self.weight_imag = _weight(out_channels, in_channels, snn_init,
                                   generator)

    def _mix(self, re, im):
        """(wr + i wi)(re + i im), contracting the channels."""
        wr, wi = self.weight_real, self.weight_imag
        return (F.linear(re, wr) - F.linear(im, wi),
                F.linear(re, wi) + F.linear(im, wr))

    def forward(self, x):
        if not self.use_transform:
            return self._mix(*x)
        sizes, modes = self._modes(x)
        return rfft_pad_inverse(*self._mix(*rfft_crop(x, modes)), sizes)
