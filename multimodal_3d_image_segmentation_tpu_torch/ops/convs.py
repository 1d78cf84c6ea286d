"""Convolution building blocks (channels-last, reference state-dict names),
the port of ``multimodal_3d_image_segmentation_tpu/ops/convs.py``.

Shape arithmetic follows the upstream ``nets/nets_utils.py``: stride s with
kernel k pads k//2 per side (so k=2, s=2 maps n -> n//2 + 1). Weights keep
the upstream torch layout (O, I, *k), so ``state_dict()`` keys and shapes
are those of ``export_reference_state_dict``. Activations are channels-last
(B, *spatial, C): a 1x1 conv is one matrix product over the last axis.

Only the SELU / self-normalizing variants are ported; GroupNorm (non-SELU)
raises.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import device as _device  # noqa: F401  (fp32 policy)
from .. import not_ported
from . import initializers as inits
from .activations import get_activation, is_selu

__all__ = ["Conv", "ConvNormAct", "ConcatConvNormAct", "_SplitKernelConv1x1"]


def _tuple(v, nd: int):
    if np.isscalar(v):
        return (int(v),) * nd
    if len(v) != nd:
        raise ValueError(f"{v} for {nd} spatial axes")
    return tuple(int(t) for t in v)


def _weight_init(fan_in: int, snn_init: bool):
    return (inits.kaiming_normal_linear(fan_in) if snn_init
            else inits.kaiming_uniform_a5(fan_in))


def _bias_init(fan_in: int, snn_init: bool):
    return inits.snn_bias() if snn_init else inits.torch_conv_bias(fan_in)


class Conv(nn.Module):
    """Plain 3D convolution on channels-last tensors with torch-parity
    padding and init: a 1x1 stride-1 conv, or a strided conv with padding
    k//2 (``F.conv3d``; TF32 is off, see ``device.py``)."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Union[int, Sequence[int]] = 1,
                 strides: Union[int, Sequence[int]] = 1,
                 use_bias: bool = True, snn_init: bool = False, *,
                 generator: torch.Generator):
        super().__init__()
        self.kernel_size = _tuple(kernel_size, 3)
        self.strides = _tuple(strides, 3)
        pointwise = (all(k == 1 for k in self.kernel_size)
                     and all(s == 1 for s in self.strides))
        if not pointwise and all(s == 1 for s in self.strides):
            not_ported("stride-1 convolutions with k > 1 (V-Net-DS)", 8)
        fan_in = in_features * int(np.prod(self.kernel_size))
        self.weight = nn.Parameter(_weight_init(fan_in, snn_init)(
            (features, in_features) + self.kernel_size, generator))
        self.bias = (nn.Parameter(_bias_init(fan_in, snn_init)(
            (features,), generator)) if use_bias else None)
        self.pointwise = pointwise

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pointwise:
            w = self.weight.reshape(self.weight.shape[:2])
            return F.linear(x, w, self.bias)
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), self.weight, self.bias,
                     stride=self.strides,
                     padding=tuple(k // 2 for k in self.kernel_size))
        return y.permute(0, 2, 3, 4, 1)


class _SplitKernelConv1x1(nn.Module):
    """1x1 conv over a virtual concatenation of channels-last inputs
    (``in_features`` = sum C_i): one (O, sum C_i, 1, 1, 1) weight, computed
    as ``sum_i x_i @ W_i^T`` so the concatenated tensor is never
    materialized."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True, snn_init: bool = False, *,
                 generator: torch.Generator):
        super().__init__()
        fan_in = self.in_features = int(in_features)
        self.weight = nn.Parameter(_weight_init(fan_in, snn_init)(
            (features, fan_in, 1, 1, 1), generator))
        self.bias = (nn.Parameter(_bias_init(fan_in, snn_init)(
            (features,), generator)) if use_bias else None)

    def forward(self, inputs) -> torch.Tensor:
        if isinstance(inputs, torch.Tensor):
            inputs = (inputs,)
        cins = [x.shape[-1] for x in inputs]
        if sum(cins) != self.in_features:
            raise ValueError(f"input channels {cins} do not sum to "
                             f"{self.in_features}")
        w = self.weight.reshape(self.weight.shape[:2])
        y = None
        off = 0
        for x, c in zip(inputs, cins):
            part = F.linear(x, w[:, off:off + c])
            y = part if y is None else y + part
            off += c
        if self.bias is not None:
            y = y + self.bias
        return y


def _check_snn(activation, use_snn: bool) -> None:
    if use_snn and not is_selu(activation):
        raise RuntimeError(
            "Self-normalizing neural network (SNN) must be used with SELU.")
    if not use_snn:
        not_ported("GroupNorm (non-SNN) conv blocks", 5)


class ConvNormAct(nn.Module):
    """Convolution + SELU (the self-normalizing variant: no normalization)
    under the upstream names ``op.{weight,bias}``."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Union[int, Sequence[int]] = 1,
                 strides: Union[int, Sequence[int]] = 1,
                 use_bias: bool = True,
                 activation: Optional[str] = "selu", use_snn: bool = True,
                 *, generator: torch.Generator):
        super().__init__()
        _check_snn(activation, use_snn)
        self.op = Conv(in_features, features, kernel_size, strides,
                       use_bias=use_bias, snn_init=True, generator=generator)
        self.act = get_activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.op(x))


class ConcatConvNormAct(nn.Module):
    """``ConvNormAct(kernel=1)`` over a virtual concat of inputs, same
    state-dict names (``op.{weight,bias}``)."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True,
                 activation: Optional[str] = "selu", use_snn: bool = True,
                 *, generator: torch.Generator):
        super().__init__()
        _check_snn(activation, use_snn)
        self.op = _SplitKernelConv1x1(in_features, features,
                                      use_bias=use_bias, snn_init=True,
                                      generator=generator)
        self.act = get_activation(activation)

    def forward(self, inputs) -> torch.Tensor:
        return self.act(self.op(inputs))
