"""HNOSeg-XS, the port of the module path of
``multimodal_3d_image_segmentation_tpu/models/hnosegxs.py``.

Learnable 2x downsampling -> 1x1 conv -> a tower of HNO-XS blocks with
U-Net-style skips across blocks -> 1x1 conv_out -> trilinear upsample ->
softmax. Each HNO-XS block performs one forward Hartley transform cropped
to the kept modes, n_XS frequency-resident channel mixes with identity
skips and SELU on the packed spectrum, and one inverse transform.

Input and output are channel-first (B, C, *spatial); internals are
channels-last. ``use_kernels=True`` routes the three hand-written kernels
(conv_in, the frequency chain, the fused tail); on CPU tensors they run
their plain versions. The module tree's ``state_dict()`` keys are those of
``utils/torch_compat.py::export_reference_state_dict`` (the upstream
model's names), so reference weights load with ``strict=True``.

``compute_dtype`` is the reference's: 'float32' (the default, exact fp32),
'bfloat16' (bf16 activations and weights, fp32 sums) or 'mixed' (bf16
activation storage with fp32 islands for every weight and transform-matrix
contraction; the reference's 'bfloat16' under ``set_bf16_exact``). Serving
only: a forward that autograd would record raises (ROADMAP item 12).
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from .. import device as _device  # noqa: F401  (fp32 policy)
from .. import not_ported
from ..kernels.conv3 import _cached
from ..kernels.conv_in import conv_in_s2d
from ..kernels.freq_chain import fused_freq_chain
from ..kernels.tail_resize import fused_tail_softmax, tail_supported
from ..ops.activations import get_activation, is_selu
from ..ops.convs import ConcatConvNormAct, ConvNormAct, _SplitKernelConv1x1
from ..ops.operators import HartleyOperator
from ..ops.padcrop import spatial_padcrop
from ..ops.resize import resize_linear
from ..ops.spectral import clip_modes, compute_dtypes, dht_crop, \
    dht_pad_inverse, normalize_modes

__all__ = ["HNOSegXS", "HNOXSBlock"]


class _FreqResidentConv(nn.Module):
    """One frequency-domain 1x1 convolution with identity skip + SELU on
    the packed spectrum (upstream ``nets/hnosegxs.py:282-329``)."""

    def __init__(self, in_channels: int, out_channels: int, num_modes,
                 weights_type: str = "shared", activation="selu",
                 use_conv_branch: bool = False, snn_init: bool = False,
                 compute_dtype: str = "float32", *,
                 generator: torch.Generator):
        super().__init__()
        if use_conv_branch:
            not_ported("HNO-XS use_conv_branch", 5)
        if not is_selu(activation):
            not_ported("HNO-XS non-SELU activations (GroupNorm)", 5)
        # on a packed spectrum the operator mixes at the spectrum's dtype
        self.op = HartleyOperator(in_channels, out_channels, num_modes,
                                  use_bias=False, weights_type=weights_type,
                                  use_transform=False, snn_init=snn_init,
                                  compute_dtype=compute_dtype,
                                  generator=generator)
        self.act = get_activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.op(x) + x)


class HNOXSBlock(nn.Module):
    """HNO-XS block: transform-crop -> n_XS frequency-resident convolutions
    -> pad-inverse -> SELU -> block skip (concat + conv, or add)."""

    def __init__(self, num_convs: int, in_channels: int, out_channels: int,
                 num_modes, weights_type: str = "shared", activation="selu",
                 use_conv_branch: bool = False, use_block_concat: bool = True,
                 snn_init: bool = False, use_kernels: bool = False,
                 compute_dtype: str = "float32", *,
                 generator: torch.Generator):
        super().__init__()
        self.num_modes = num_modes
        self.use_kernels = use_kernels
        self.compute_dtype = compute_dtype
        snn = is_selu(activation)
        g = dict(compute_dtype=compute_dtype, generator=generator)
        self.mapping_conv = (
            ConcatConvNormAct(in_channels, out_channels, use_bias=True,
                              activation=activation, use_snn=snn, **g)
            if in_channels != out_channels else None)
        self.conv_blocks = nn.ModuleList(
            _FreqResidentConv(out_channels, out_channels, num_modes,
                              weights_type=weights_type,
                              activation=activation,
                              use_conv_branch=use_conv_branch,
                              snn_init=snn_init, **g)
            for _ in range(num_convs))
        self.act = get_activation(activation)
        self.conv_concat = (
            ConcatConvNormAct(2 * out_channels, out_channels, use_bias=True,
                              activation=activation, use_snn=snn, **g)
            if use_block_concat else None)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """``skip`` is the U-Net skip tensor, concatenated (virtually) with
        x before the mapping conv."""
        if self.mapping_conv is not None:
            x = self.mapping_conv((x,) if skip is None else (x, skip))
        elif skip is not None:
            raise ValueError("a skip input needs in_channels != out_channels")
        tmp = x
        sizes = tuple(x.shape[1:-1])
        modes = clip_modes(normalize_modes(self.num_modes, len(sizes)),
                           sizes)
        # TransformCrop: one forward DHT restricted to the kept modes, at
        # the island dtype ('mixed': the spectra stay fp32, so the chain
        # takes its fp32 instance; 'bfloat16': bf16 rows and weights)
        isl = compute_dtypes(self.compute_dtype, tmp.dtype)[1]
        y = dht_crop(x, modes, isl)
        if self.use_kernels:
            y = fused_freq_chain(y.contiguous(),
                                 [cb.op.weight.to(y.dtype)
                                  for cb in self.conv_blocks])
        else:
            for cb in self.conv_blocks:
                y = cb(y)
        # PadInverse: one inverse DHT back to the block grid, then back to
        # the activation dtype
        x = self.act(dht_pad_inverse(y, sizes, isl).to(tmp.dtype))
        # block skip AFTER the activation (upstream nets/hnosegxs.py:270-277)
        if self.conv_concat is not None:
            return self.conv_concat((x, tmp))
        return x + tmp


class HNOSegXS(nn.Module):
    """HNOSeg-XS (upstream ``nets/hnosegxs.py:20-182``): input (B, C,
    *spatial) channel-first, output probabilities (B, out_channels,
    *spatial).

    ``generator`` seeds the init (default: a generator seeded with 0);
    ``device`` places the parameters, which stay fp32 in every
    ``compute_dtype``. With 'float32' the model computes in its parameters'
    dtype: fp32, or float64 after ``.double()`` as a reference for checks
    (the CUDA kernels take fp32 and bf16 only, so such a model runs
    ``use_kernels=False``). 'bfloat16' and 'mixed' serve (module
    docstring); a forward that autograd would record raises. Options of
    the reference that the port does not cover yet raise
    ``NotImplementedError`` naming their ROADMAP item.
    """

    def __init__(self, in_channels: int, out_channels: int, filters: int,
                 num_transform_blocks: Union[int, Sequence[int]],
                 num_modes: Union[int, Sequence[int]],
                 weights_type: str = "shared", use_resize: bool = True,
                 use_deep_supervision: bool = False,
                 use_unet_skip: bool = True, use_block_concat: bool = True,
                 activation="selu", output_activation="softmax",
                 ndim: int = 5, channel_first_io: bool = True,
                 use_kernels: bool = False, use_flat: bool = False,
                 compute_dtype: str = "float32", use_remat: bool = False, *,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        if ndim != 5:
            not_ported("HNOSegXS ndim=4 (2D)", 11)
        compute_dtypes(compute_dtype)  # a known name
        if use_flat:
            not_ported("HNOSegXS use_flat (flat-layout tower)", 5)
        if use_remat:
            not_ported("HNOSegXS use_remat", 5)
        if use_deep_supervision:
            not_ported("HNOSegXS deep supervision", 5)
        if not is_selu(activation):
            not_ported("HNOSegXS non-SELU activations (GroupNorm)", 5)
        if generator is None:
            generator = torch.Generator().manual_seed(0)

        self.in_channels = in_channels
        self.out_channels = out_channels
        self.use_resize = use_resize
        self.use_unet_skip = use_unet_skip
        self.channel_first_io = channel_first_io
        self.output_activation = output_activation
        self.use_kernels = use_kernels
        self.compute_dtype = compute_dtype

        ntb = num_transform_blocks
        ntb = [int(ntb)] if np.isscalar(ntb) else [int(n) for n in ntb]
        self.num_blocks = len(ntb)
        g = dict(compute_dtype=compute_dtype, generator=generator)

        self.conv_in = (ConvNormAct(in_channels, filters, kernel_size=2,
                                    strides=2, activation=activation, **g)
                        if use_resize else None)
        self.conv1 = ConvNormAct(filters if use_resize else in_channels,
                                 filters, activation=activation, **g)
        layers = []
        cur_in = filters
        for i, num_convs in enumerate(ntb):
            # decoding: i == num_blocks // 2 (the median block) is excluded
            if use_unet_skip and i > self.num_blocks // 2:
                cur_in += filters
            layers.append(HNOXSBlock(
                num_convs, cur_in, filters, num_modes,
                weights_type=weights_type, activation=activation,
                use_block_concat=use_block_concat, snn_init=True,
                use_kernels=use_kernels, **g))
            cur_in = filters
        self.layers = nn.ModuleList(layers)
        self.conv_out = _SplitKernelConv1x1(filters, out_channels,
                                            use_bias=False, snn_init=True,
                                            **g)
        if device is not None:
            self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 5:
            raise ValueError(f"expected (B, C, D, H, W), got "
                             f"{tuple(x.shape)}")
        in_dtype = x.dtype
        # activations and islands: the parameters' dtype (fp32, float64
        # after .double()) in 'float32'; bf16 activations otherwise
        dtype, isl = compute_dtypes(self.compute_dtype,
                                    self.conv1.op.weight.dtype)
        if (dtype == torch.bfloat16 and torch.is_grad_enabled()
                and self.conv1.op.weight.requires_grad):
            not_ported(f"training with compute_dtype={self.compute_dtype!r} "
                       "(serve under torch.no_grad or inference_mode)", 12)
        if self.use_resize and self.channel_first_io and self.use_kernels:
            # the fused conv_in reads the channel-first input directly and
            # emits the channels-last half-resolution grid; its weights are
            # rounded to the island dtype and passed as fp32 (the bf16
            # instance sums in fp32)
            image_size = tuple(x.shape[2:])
            w, b = self.conv_in.op.weight, self.conv_in.op.bias
            # kept between forwards, so that the bf16 instance packs them
            # once per weight version
            w, b = _cached(self, f"conv_in_{isl}", [w, b], lambda: (
                w.to(isl).to(w.dtype), b.to(isl).to(b.dtype)))
            x = conv_in_s2d(x.to(dtype).contiguous(), w, b)
        else:
            if self.channel_first_io:
                x = x.permute(0, 2, 3, 4, 1)
            x = x.to(dtype)
            image_size = tuple(x.shape[1:-1])
            if self.use_resize:
                x = self.conv_in(x)
        x = self.conv1(x)

        encode = {}
        nb = self.num_blocks
        for i, block in enumerate(self.layers):
            skip = (encode[nb - 1 - i]
                    if self.use_unet_skip and i > nb // 2 else None)
            x = block(x, skip)
            if self.use_unet_skip and i < nb // 2:
                encode[i] = x

        # conv_out (linear, per voxel) commutes with the per-channel
        # resize: apply it at the block grid, then go channel-first while
        # the tensor is small
        x = self.conv_out(x).permute(0, 4, 1, 2, 3)
        if (self.use_kernels and self.use_resize
                and self.output_activation == "softmax"
                and tail_supported(tuple(x.shape), image_size)):
            # the probabilities in the caller's dtype where an instance
            # writes it, as the reference's out_dtype = in_dtype
            out = in_dtype if in_dtype == torch.bfloat16 else torch.float32
            x = fused_tail_softmax(x.contiguous(), image_size,
                                   out).to(in_dtype)
        else:
            if self.use_resize:
                x = resize_linear(x, image_size, channel_first=True)
            x = spatial_padcrop(x, image_size, channel_first=True)
            x = x.to(in_dtype)
            act = get_activation(self.output_activation)
            if act is not None:
                x = act(x)  # 'softmax' is over the channel axis
        if not self.channel_first_io:
            x = x.permute(0, 2, 3, 4, 1)
        return x
