"""Convolution building blocks (channels-last, reference state-dict names),
the port of ``multimodal_3d_image_segmentation_tpu/ops/convs.py``.

Shape arithmetic follows the upstream ``nets/nets_utils.py``: stride s with
kernel k pads k//2 per side (so k=2, s=2 maps n -> n//2 + 1). Weights keep
the upstream torch layout (O, I, *k), so ``state_dict()`` keys and shapes
are those of ``export_reference_state_dict``. Activations are channels-last
(B, *spatial, C): a 1x1 conv is one matrix product over the last axis.

Both variants of the reference are ported: self-normalizing (SELU, no
normalization, SNN init) and GroupNorm(num_groups=1) + activation (torch's
default init), as V-Net-DS uses.

bf16 activations (``compute_dtype`` 'bfloat16' or 'mixed', see
``spectral.compute_dtypes``) follow the reference's ``ops/convs.py``: a
1x1 conv runs at the island dtype of its input (for a bf16 input the
mode's: bf16, or fp32 in 'mixed' with the bf16 operand widened into an
fp32 product; for a wider input its own dtype, as the reference's
``_isl``) and returns the input's dtype; any other conv, the transposed
one included, runs at the input's dtype; the bias is added in the
output's dtype. GroupNorm takes its moments in fp32 at least and returns
the dtype its input and affine promote to, as flax's ``nn.GroupNorm`` does:
a bf16 input with fp32 parameters comes out fp32.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import device as _device  # noqa: F401  (fp32 policy)
from . import initializers as inits
from .activations import get_activation, is_selu
from .resize import resize_nearest
from .spectral import compute_dtypes

__all__ = ["Conv", "ConvTranspose", "ConvNormAct", "ConvTransposeNormAct",
           "ConcatConvNormAct", "GroupNorm1", "_SplitKernelConv1x1"]


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


def _island(x: torch.Tensor, compute_dtype: str,
            param_dtype: torch.dtype) -> torch.dtype:
    """The dtype a 1x1 conv of ``x`` runs at (the reference's ``_isl``):
    for a bf16 ``x`` the island of ``compute_dtype``, else x's own."""
    if x.dtype == torch.bfloat16:
        return compute_dtypes(compute_dtype, param_dtype)[1]
    return x.dtype


class Conv(nn.Module):
    """Plain 3D convolution on channels-last tensors with torch-parity
    padding and init: a 1x1 stride-1 conv as a matrix product, else
    ``F.conv3d`` with SAME padding at stride 1 and padding k//2 at other
    strides (TF32 is off, see ``device.py``)."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Union[int, Sequence[int]] = 1,
                 strides: Union[int, Sequence[int]] = 1,
                 use_bias: bool = True, snn_init: bool = False,
                 compute_dtype: str = "float32", *,
                 generator: torch.Generator):
        super().__init__()
        compute_dtypes(compute_dtype)  # a known name
        self.compute_dtype = compute_dtype
        self.kernel_size = _tuple(kernel_size, 3)
        self.strides = _tuple(strides, 3)
        pointwise = (all(k == 1 for k in self.kernel_size)
                     and all(s == 1 for s in self.strides))
        fan_in = in_features * int(np.prod(self.kernel_size))
        self.weight = nn.Parameter(_weight_init(fan_in, snn_init)(
            (features, in_features) + self.kernel_size, generator))
        self.bias = (nn.Parameter(_bias_init(fan_in, snn_init)(
            (features,), generator)) if use_bias else None)
        self.pointwise = pointwise

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight, self.bias
        if self.pointwise:
            w = w.reshape(w.shape[:2])
            isl = _island(x, self.compute_dtype, w.dtype)
            if x.dtype == w.dtype == isl:
                return F.linear(x, w, b)
            y = F.linear(x.to(isl), w.to(isl)).to(x.dtype)
            return y if b is None else y + b.to(y.dtype)
        same = all(s == 1 for s in self.strides)
        sep = x.dtype != w.dtype  # bf16: weights at x's dtype, bias after
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.to(x.dtype),
                     None if sep else b, stride=self.strides,
                     padding="same" if same else
                     tuple(k // 2 for k in self.kernel_size))
        y = y.permute(0, 2, 3, 4, 1)
        return y + b.to(y.dtype) if sep and b is not None else y


class ConvTranspose(nn.Module):
    """Transposed 3D convolution with torch semantics (stride 2, padding
    k//2, output_padding 1: k=3 doubles each axis) on channels-last
    tensors. Weight in torch's transposed layout (I, O, *k), whose fan-in
    is O * prod(k)."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Union[int, Sequence[int]] = 2,
                 use_bias: bool = True, snn_init: bool = False, *,
                 generator: torch.Generator):
        super().__init__()
        self.kernel_size = _tuple(kernel_size, 3)
        fan_in = features * int(np.prod(self.kernel_size))
        self.weight = nn.Parameter(_weight_init(fan_in, snn_init)(
            (in_features, features) + self.kernel_size, generator))
        self.bias = (nn.Parameter(_bias_init(fan_in, snn_init)(
            (features,), generator)) if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight, self.bias
        sep = x.dtype != w.dtype  # bf16: weights at x's dtype, bias after
        y = F.conv_transpose3d(x.permute(0, 4, 1, 2, 3), w.to(x.dtype),
                               None if sep else b, stride=2,
                               padding=tuple(k // 2 for k in
                                             self.kernel_size),
                               output_padding=1)
        y = y.permute(0, 2, 3, 4, 1)
        return y + b.to(y.dtype) if sep and b is not None else y


class GroupNorm1(nn.Module):
    """GroupNorm with one group (eps 1e-5) over the spatial and channel
    axes of each sample of a channels-last tensor, with a per-channel
    affine (reference names ``weight``, ``bias``; init ones, zeros)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = tuple(range(1, x.dim()))
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        var, mean = torch.var_mean(x, dim=dims, unbiased=False, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight \
            + self.bias


class _SplitKernelConv1x1(nn.Module):
    """1x1 conv over a virtual concatenation of channels-last inputs
    (``in_features`` = sum C_i): one (O, sum C_i, 1, 1, 1) weight, computed
    as ``sum_i x_i @ W_i^T`` so the concatenated tensor is never
    materialized. ``upsample_to`` (call argument): parts may arrive at
    coarser sizes; each is nearest-upsampled to this spatial size after its
    projection (exact: the gather commutes with the per-voxel product).
    ``after_project`` (call argument): a function of (part index,
    projection) applied to each projection before its upsample (the
    depth-sharded V-Net-DS gathers a sharded leg's there)."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True, snn_init: bool = False,
                 compute_dtype: str = "float32", *,
                 generator: torch.Generator):
        super().__init__()
        compute_dtypes(compute_dtype)  # a known name
        self.compute_dtype = compute_dtype
        fan_in = self.in_features = int(in_features)
        self.weight = nn.Parameter(_weight_init(fan_in, snn_init)(
            (features, fan_in, 1, 1, 1), generator))
        self.bias = (nn.Parameter(_bias_init(fan_in, snn_init)(
            (features,), generator)) if use_bias else None)

    def forward(self, inputs, upsample_to: Optional[Sequence[int]] = None,
                after_project: Optional[Callable] = None) -> torch.Tensor:
        if isinstance(inputs, torch.Tensor):
            inputs = (inputs,)
        if upsample_to is not None:
            upsample_to = tuple(int(n) for n in upsample_to)
        cins = [x.shape[-1] for x in inputs]
        if sum(cins) != self.in_features:
            raise ValueError(f"input channels {cins} do not sum to "
                             f"{self.in_features}")
        w = self.weight.reshape(self.weight.shape[:2])
        y = None
        off = 0
        for k, (x, c) in enumerate(zip(inputs, cins)):
            # at the island dtype, each part back in the activation dtype
            isl = _island(x, self.compute_dtype, w.dtype)
            part = F.linear(x.to(isl), w[:, off:off + c].to(isl)).to(x.dtype)
            if after_project is not None:
                part = after_project(k, part)
            if (upsample_to is not None
                    and tuple(part.shape[1:-1]) != upsample_to):
                part = resize_nearest(part, upsample_to)
            y = part if y is None else y + part
            off += c
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


def _check_snn(activation, use_snn: bool) -> None:
    if use_snn and not is_selu(activation):
        raise RuntimeError(
            "Self-normalizing neural network (SNN) must be used with SELU.")


class _NormAct(nn.Module):
    """GroupNorm (unless self-normalizing) + activation after ``op``."""

    def _setup_norm_act(self, features: int, activation, use_snn: bool):
        self.normalization = None if use_snn else GroupNorm1(features)
        self.act = get_activation(activation)

    def _norm_act(self, y: torch.Tensor) -> torch.Tensor:
        if self.normalization is not None:
            y = self.normalization(y)
        return self.act(y) if self.act is not None else y


class ConvNormAct(_NormAct):
    """Convolution + GroupNorm(1) + activation, or + SELU alone in the
    self-normalizing variant, under the upstream names
    ``op.{weight,bias}`` and ``normalization.{weight,bias}``."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Union[int, Sequence[int]] = 1,
                 strides: Union[int, Sequence[int]] = 1,
                 use_bias: bool = True,
                 activation: Optional[str] = "selu", use_snn: bool = True,
                 compute_dtype: str = "float32",
                 *, generator: torch.Generator):
        super().__init__()
        _check_snn(activation, use_snn)
        self.op = Conv(in_features, features, kernel_size, strides,
                       use_bias=use_bias,
                       snn_init=use_snn and is_selu(activation),
                       compute_dtype=compute_dtype, generator=generator)
        self._setup_norm_act(features, activation, use_snn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._norm_act(self.op(x))


class ConvTransposeNormAct(_NormAct):
    """Transposed convolution + GroupNorm(1) + activation; normalization
    is skipped (and the init is SNN) for SELU."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Union[int, Sequence[int]] = 2,
                 use_bias: bool = True, activation: Optional[str] = "selu",
                 *, generator: torch.Generator):
        super().__init__()
        snn = is_selu(activation)
        self.op = ConvTranspose(in_features, features, kernel_size,
                                use_bias=use_bias, snn_init=snn,
                                generator=generator)
        self._setup_norm_act(features, activation, snn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._norm_act(self.op(x))


class ConcatConvNormAct(_NormAct):
    """``ConvNormAct(kernel=1)`` over a virtual concat of inputs, same
    state-dict names; ``upsample_to`` as in ``_SplitKernelConv1x1``."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True,
                 activation: Optional[str] = "selu", use_snn: bool = True,
                 compute_dtype: str = "float32",
                 *, generator: torch.Generator):
        super().__init__()
        _check_snn(activation, use_snn)
        self.op = _SplitKernelConv1x1(in_features, features,
                                      use_bias=use_bias,
                                      snn_init=use_snn and is_selu(activation),
                                      compute_dtype=compute_dtype,
                                      generator=generator)
        self._setup_norm_act(features, activation, use_snn)

    def forward(self, inputs, upsample_to: Optional[Sequence[int]] = None
                ) -> torch.Tensor:
        return self._norm_act(self.op(inputs, upsample_to))
