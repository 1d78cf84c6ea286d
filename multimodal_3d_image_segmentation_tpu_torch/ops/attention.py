"""Hartley-domain multi-head attention (HartleyMHA, MICCAI 2023), the port
of ``multimodal_3d_image_segmentation_tpu/ops/attention.py``.

Self / cross attention on the packed corner spectrum of the Hartley
transform (upstream ``nets/hartley_mha.py``):

  * per-head spectral 1x1 projections on the kept modes;
  * optional patch *grouping* in frequency space: prod(patch) neighbouring
    frequency pixels fold into channels before attention, in the upstream
    (c, pd, ph, pw) channel packing order;
  * the attention activation is configurable and defaults to SELU, not
    softmax; scores are scaled by sqrt(channels) after grouping;
  * 1, 2 or 3 inputs give self / shared-kv / full cross attention.

The transforms are ``ops/spectral.py``'s pruned matmul chains; the QK and
AV contractions are plain ``torch.einsum`` (cuBLAS on the GPU), as the
reference leaves them to XLA. Layout: channels-last (B, *spatial, C).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from .. import device as _device  # noqa: F401  (fp32 policy)
from .. import not_ported
from . import initializers as inits
from .activations import get_activation
from .spectral import dht_crop, dht_pad_inverse, normalize_modes

__all__ = ["HartleyMultiHeadAttention"]


def _grouping(x: torch.Tensor, patch: Sequence[int]) -> torch.Tensor:
    """(B, *sp, Z, C) -> (B, *sp/patch, Z, C*prod(patch)); c slowest, then
    the patch indices in axis order (upstream ``grouping3d``)."""
    nd = len(patch)
    b = x.shape[0]
    sp = x.shape[1:1 + nd]
    z, c = x.shape[-2], x.shape[-1]
    nums, shape = [], [b]
    for s, p in zip(sp, patch):
        if s % p:
            raise ValueError(f"spatial size {s} not divisible by patch {p}")
        nums.append(s // p)
        shape += [s // p, p]
    x = x.reshape(shape + [z, c])
    # (b, n0, p0, n1, p1, ..., z, c) -> (b, n0, n1, ..., z, c, p0, p1, ...)
    perm = ([0] + [1 + 2 * i for i in range(nd)] + [1 + 2 * nd, 2 + 2 * nd]
            + [2 + 2 * i for i in range(nd)])
    return x.permute(perm).reshape([b] + nums + [z, c * int(np.prod(patch))])


def _ungrouping(x: torch.Tensor, num_channels: int,
                patch: Sequence[int]) -> torch.Tensor:
    """Inverse of ``_grouping``."""
    nd = len(patch)
    b = x.shape[0]
    nums = x.shape[1:1 + nd]
    z = x.shape[-2]
    x = x.reshape([b] + list(nums) + [z, num_channels] + list(patch))
    # (b, n0.., z, c, p0..) -> (b, n0, p0, n1, p1, .., z, c)
    perm = [0]
    for i in range(nd):
        perm += [1 + i, 3 + nd + i]
    perm += [1 + nd, 2 + nd]
    out_sp = [n * p for n, p in zip(nums, patch)]
    return x.permute(perm).reshape([b] + out_sp + [z, num_channels])


class HartleyMultiHeadAttention(nn.Module):
    """Multi-head attention in the Hartley frequency domain (upstream
    ``nets/hartley_mha.py:49-128``). ``num_modes`` must satisfy 2*m <=
    spatial size and be divisible by ``patch_size``. With
    ``use_transform=False`` the inputs already are packed spectra and so
    is the output (the fused tower's frequency-resident use).

    Parameters under the upstream names: ``weight_query``/``weight_key``
    (heads, key_dim, in), ``weight_value`` (heads, value_dim, in) and
    ``weight_out`` (value_dim, heads * value_dim).
    """

    def __init__(self, in_channels: int, key_dim: int, num_heads: int,
                 num_modes: Union[int, Sequence[int]],
                 patch_size: Optional[Union[int, Sequence[int]]] = None,
                 attention_activation="selu",
                 value_dim: Optional[int] = None,
                 key_in_channels: Optional[int] = None,
                 value_in_channels: Optional[int] = None,
                 use_bias: bool = False, use_transform: bool = True,
                 snn_init: bool = False, *, generator: torch.Generator):
        super().__init__()
        if use_bias:
            not_ported("HartleyMultiHeadAttention use_bias", 9)
        self.num_heads = num_heads
        self.num_modes = num_modes
        self.patch_size = patch_size
        self.attention_activation = attention_activation
        self.use_transform = use_transform
        self.value_dim = value_dim or key_dim
        key_in = key_in_channels or in_channels
        value_in = value_in_channels or key_in

        def init(fan_in):
            return (inits.kaiming_normal_linear(fan_in) if snn_init
                    else inits.kaiming_uniform_a5(fan_in))

        def proj(out_dim, in_dim):
            # torch's fan-in of a (heads, out, in) tensor is out * in (the
            # upstream kaiming_uniform_'s these 3-D tensors directly)
            return nn.Parameter(init(out_dim * in_dim)(
                (num_heads, out_dim, in_dim), generator))

        self.weight_query = proj(key_dim, in_channels)
        self.weight_key = proj(key_dim, key_in)
        self.weight_value = proj(self.value_dim, value_in)
        fan_out = self.value_dim * num_heads
        self.weight_out = nn.Parameter(init(fan_out)(
            (self.value_dim, fan_out), generator))

    def _activation(self):
        if self.attention_activation == "softmax":  # over the keys
            return lambda a: torch.softmax(a, dim=-1)
        return get_activation(self.attention_activation)

    def attend(self, query: torch.Tensor, key: torch.Tensor,
               value: torch.Tensor) -> torch.Tensor:
        """The frequency-resident part: projections, grouping, attention,
        ungrouping and the output projection on packed spectra."""
        nd = query.dim() - 2
        patch = (None if self.patch_size is None
                 else normalize_modes(self.patch_size, nd))

        def freq_conv(w, x):  # (B, *sp, I) -> (B, *sp, Z, O)
            return torch.einsum("...i,zoi->...zo", x, w.to(x.dtype))

        q = freq_conv(self.weight_query, query)
        k = freq_conv(self.weight_key, key)
        v = freq_conv(self.weight_value, value)
        if patch is not None:
            q, k, v = (_grouping(t, patch) for t in (q, k, v))
        sp_freq = q.shape[1:-2]

        def flat(t):
            return t.reshape(t.shape[0], -1, t.shape[-2], t.shape[-1])

        q, k, v = flat(q), flat(k), flat(v)
        att = torch.einsum("bqzc,bkzc->bzqk", q, k) / math.sqrt(k.shape[-1])
        act = self._activation()
        if act is not None:
            att = act(att)
        out = torch.einsum("bzqk,bkzc->bqzc", att, v)
        out = out.reshape((out.shape[0],) + tuple(sp_freq)
                          + (self.num_heads, out.shape[-1]))
        if patch is not None:
            out = _ungrouping(out, self.value_dim, patch)
        # merge the heads (z slowest) and project
        out = out.reshape(out.shape[:-2] + (-1,))
        return torch.einsum("...i,oi->...o", out,
                            self.weight_out.to(out.dtype))

    def forward(self, inputs) -> torch.Tensor:
        if isinstance(inputs, torch.Tensor):
            q_in = k_in = v_in = inputs
        elif len(inputs) == 2:
            q_in, k_in = inputs
            v_in = k_in
        elif len(inputs) == 3:
            q_in, k_in, v_in = inputs
        else:
            raise ValueError("Invalid inputs.")
        if not self.use_transform:
            return self.attend(q_in, k_in, v_in)
        sizes = tuple(q_in.shape[1:-1])
        modes = normalize_modes(self.num_modes, len(sizes))
        if any(s < 2 * m for s, m in zip(sizes, modes)):
            raise ValueError(f"spatial sizes {sizes} must be >= 2 * modes "
                             f"{modes}")
        query = dht_crop(q_in, modes)
        key = query if k_in is q_in else dht_crop(k_in, modes)
        value = key if v_in is k_in else dht_crop(v_in, modes)
        out = self.attend(query, key, value)
        return dht_pad_inverse(out, sizes).to(q_in.dtype)
