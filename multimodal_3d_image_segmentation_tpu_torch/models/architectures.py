"""V-Net-DS, the port of ``VNetDS`` in
``multimodal_3d_image_segmentation_tpu/models/architectures.py``.

V-Net with deep supervision (reference ``nets/architectures.py:26-253``):
an encoder of k=3 conv sections with parallel 1x1 residual convs and
stride-2 down convs, a decoder of transposed up convs whose output is
concatenated with the encoder's, and a deep-supervision right leg whose
legs are projected, nearest-upsampled and summed by a 1x1 ``conv_ds``.
Every conv is followed by GroupNorm(1) and the activation (SELU alone in
the self-normalizing variant).

Input and output are channel-first (B, C, *spatial); internals are
channels-last. Two execution paths share one module tree, whose
``state_dict()`` keys are those of
``utils/torch_compat.py::export_reference_state_dict``:

  * the module path (``use_kernels=False``), the counterpart of the
    reference's ``VNetDS.__call__``;
  * the kernel path (``use_kernels=True``), the counterpart of its
    ``_flat_forward``: conv_in through the ``conv_in`` kernel, every k=3
    conv through the ``conv3`` kernel, the output tail through the
    ``tail_resize`` kernel. It keeps the reference's fusions: each chain
    conv emits its GroupNorm moment sums; a non-final chain conv defers
    its GroupNorm + activation into the next conv's prologue; a section's
    1x1 residual rides its first chain conv as a tap; the decoder's first
    conv reads (up, skip) as a virtual concat. Batch 1, channel-first IO
    and k=3 only; CPU tensors run each kernel's plain version.

The kernel path also runs depth-sharded over the ranks of a process group
(``spatial_shard=(group, n, dim)``, fp32 serving), the counterpart of the
reference's ``_flat_forward`` under ``spatial_shard``
(``parallel/flat_sharded.py`` has the plan). The input and the weights
are replicated; image axis ``dim`` becomes depth (the volume and the conv
weights permuted along); conv_in runs on every rank, then each rank keeps
its slab of the levels that ``shard_schedule`` shards. There the chain
convs run conv3's halo mode on halo'd slabs (both inputs of the virtual
concat), with GroupNorm from all-reduced moments over the global voxel
count; a down conv into a sharded level is the halo mode at stride 2, one
into a replicated level gathers its input and runs replicated; an up conv
from a sharded level is the halo mode at dilation 2, one from a replicated
level into a sharded one runs replicated and keeps the slab. The
deep-supervision head projects each sharded leg on its slab and gathers
the ``out_channels`` result; the head and the tail run replicated, and
every rank returns the whole output.

V-Net-DS's ``compute_dtype`` is the reference's too. On the module path
each conv runs at its input's dtype (bf16 until the first GroupNorm, whose
output is fp32 as flax's is; the self-normalizing variant stays bf16) with
the 1x1 convs at the island dtype. On the kernel path the volumes stay bf16
between kernels, as the reference's ``_flat_forward`` keeps them: conv_in's
and the tail's bf16 instances, and conv3's 'bfloat16' instance (bf16
weights and biases) or 'mixed' one (fp32 weights and biases); the residual
taps' biases stay fp32, the GroupNorm moments are the kernels' fp32 sums
(the down convs' and the head's of their bf16 outputs), and each
GroupNorm's scale and shift are rounded to bf16 and applied in bf16.

HartleyMHASeg and NeuralOperatorSeg (FNOSeg / HNOSeg), the ports of
``HartleyMHASeg`` and ``NeuralOperatorSeg`` (reference
``nets/architectures.py:356-508``): conv_in -> conv1 -> a tower of
Hartley-MHA or neural-operator blocks -> the deep-supervision sum
(``conv_ds``) -> conv_out -> upsample -> softmax, on the shared tower
skeleton ``_TransSegBase``. Their kernel paths (``use_kernels=True``) are
the counterparts of ``_fused_mha_forward`` and ``_fused_tower_forward``:
conv_in through the ``conv_in`` kernel, every block through a fused tower
block kernel with the block's spectrum operator (the attention, or the
shared-weight mix) between kernels, the exit through ``tail_resize``. The
tower kernel is chosen by ``tower_kernel``: ``"block_s"`` carries the
resident packed spectrum between blocks and runs the depth stages inside
the kernel (``tower_block_s``); ``"block"`` exchanges per-plane spectra
with torch einsums between kernels (``tower_block``); NeuralOperatorSeg's
``"resident"`` runs the whole tower in one launch (``tower_resident``).

The towers' ``compute_dtype`` is the reference's: 'float32' (the default,
exact fp32), 'bfloat16' (bf16 activations and weights, fp32 sums) or
'mixed' (bf16 activation storage with fp32 islands for every weight and
transform-matrix contraction; the reference's 'bfloat16' under
``set_bf16_exact``). On the kernel path both take the tower kernels' bf16
instances ('bfloat16': bf16 weights; 'mixed': fp32 weights), conv_in's and
the tail's, with the spectra between kernels and the deep-supervision sum
in fp32, as the reference keeps them. Serving only, in every family: a
bf16 forward that autograd would record raises (ROADMAP item 12).
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from .. import device as _device  # noqa: F401  (fp32 policy)
from .. import not_ported
from ..kernels.conv3 import KERNEL_ACTS, _moments, conv3
from ..kernels.conv_in import conv_in_s2d
from ..kernels.tail_resize import fused_tail_softmax, tail_supported
from ..kernels.tower_block import (d_stage_forward, d_stage_inverse,
                                   entry_forward_hw, fused_tower_block,
                                   make_tower_spec)
from ..kernels.tower_block_s import (entry_spectrum_s, fused_tower_block_s,
                                     spectrum_mix_s)
from ..kernels.tower_resident import resident_tower
from ..ops.activations import get_activation, is_selu
from ..ops.attention import HartleyMultiHeadAttention
from ..ops.convs import (ConcatConvNormAct, Conv, ConvNormAct,
                         ConvTransposeNormAct, GroupNorm1,
                         _SplitKernelConv1x1)
from ..ops.operators import FourierOperator, HartleyOperator
from ..ops.padcrop import spatial_padcrop
from ..ops.resize import resize_linear
from ..ops.spectral import clip_modes, compute_dtypes, normalize_modes
from ..parallel.flat_sharded import ShardCtx, shard_schedule
from ..parallel.halo import conv3_sharded

__all__ = ["VNetDS", "HartleyMHASeg", "HartleyMHABlock", "NeuralOperatorSeg",
           "NeuralOperatorBlock"]

TOWER_KERNELS = ("block_s", "block", "resident")


def _apply_output_activation(x, output_activation, dim=-1):
    if output_activation == "softmax":
        return torch.softmax(x, dim=dim)
    act = get_activation(output_activation)
    return act(x) if act is not None else x


def _channel_first_tail(x, image_size, use_resize, in_dtype,
                        output_activation, use_kernels=False):
    """Output tail: channel-first while the tensor is small, upsample,
    pad/crop, activation over the channels. With ``use_kernels`` the
    resize + softmax run as the fused tail kernel where it applies, the
    probabilities in the caller's dtype where an instance writes it (bf16
    logits write bf16 ones for a bf16 caller, as the reference's
    ``out_dtype = in_dtype``)."""
    x = x.permute(0, 4, 1, 2, 3)
    if (use_kernels and use_resize and output_activation == "softmax"
            and tail_supported(tuple(x.shape), image_size)):
        out = in_dtype if in_dtype == torch.bfloat16 else torch.float32
        return fused_tail_softmax(x.contiguous(), image_size,
                                  out).to(in_dtype)
    if use_resize:
        x = resize_linear(x, image_size, channel_first=True)
    x = spatial_padcrop(x, image_size, channel_first=True)
    return _apply_output_activation(x.to(in_dtype), output_activation, dim=1)


def _gn_affine(stats, n_voxels, norm, eps=1e-5):
    """Per-channel (scale, shift) with ``GroupNorm(1)(y) == y * scale +
    shift``, from the (2, C) moment sums of y (reference
    ``_flat_gn_eff``: var = E[y^2] - E[y]^2 in the sums' dtype)."""
    n_valid = n_voxels * stats.shape[1]
    m = stats[0].sum() / n_valid
    var = stats[1].sum() / n_valid - m * m
    inv = torch.rsqrt(var + eps)
    scale = inv * norm.weight.to(stats.dtype)
    shift = norm.bias.to(stats.dtype) - m * scale
    return scale, shift


def _cached(owner: nn.Module, name: str, params, build):
    """``build()``, kept on ``owner`` under ``name`` between forwards and
    made again when a tensor of ``params`` changes storage or version, so
    the kernel path packs its weights once per weight version, not per
    call. Where autograd would track one of ``params``, or on inference
    tensors (no version counter), it is built anew on every call."""
    if any(p.is_inference() for p in params) or (
            torch.is_grad_enabled() and any(p.requires_grad for p in params)):
        return build()
    key = tuple((p.data_ptr(), p._version, p.device) for p in params)
    cache = owner.__dict__.setdefault("_m3seg_packed", {})
    hit = cache.get(name)
    if hit is None or hit[0] != key:
        # normal tensors, also under inference mode
        with torch.inference_mode(False), torch.no_grad():
            hit = cache[name] = (key, build())
    return hit[1]


class VNetDS(nn.Module):
    """V-Net-DS (reference ``nets/architectures.py:26-253``): input (B, C,
    *spatial) channel-first, output probabilities (B, out_channels,
    *spatial).

    ``num_blocks`` describes the encoding path (e.g. [1, 2, 3, 3, 3]); the
    decoding path mirrors it without the last entry. ``right_leg_indexes``
    selects the section outputs for deep supervision (default [0]).
    ``generator`` seeds the init (default: seeded with 0); ``device``
    places the parameters. With ``compute_dtype`` 'float32' the model
    computes in its parameters' dtype (fp32, or float64 after ``.double()``
    as a reference, which runs ``use_kernels=False`` on the card);
    'bfloat16' and 'mixed' serve in bf16 (module docstring). Options the
    port does not cover yet raise ``NotImplementedError`` naming their
    ROADMAP item.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 base_num_filters: int, num_blocks: Sequence[int],
                 use_resize: bool = True,
                 right_leg_indexes: Optional[Sequence[int]] = None,
                 kernel_size: int = 3, activation="elu",
                 use_snn: bool = False, output_activation="softmax",
                 use_residual: bool = True, ndim: int = 5,
                 channel_first_io: bool = True,
                 compute_dtype: str = "float32", use_kernels: bool = False,
                 spatial_shard=None, *,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        if ndim != 5:
            not_ported("VNetDS ndim=4 (2D)", 11)
        compute_dtypes(compute_dtype)  # a known name
        if spatial_shard is not None:
            if not use_kernels:
                not_ported("VNetDS spatial_shard on the module path (the "
                           "sharded forward is the kernel path's)", 15)
            if compute_dtype != "float32":
                not_ported(f"VNetDS spatial_shard with compute_dtype="
                           f"{compute_dtype!r}", 15)
            if any(int(n) < 1 for n in num_blocks):
                not_ported("VNetDS spatial_shard with a 0-block section", 15)
            group, n, dim = spatial_shard
            spatial_shard = (group, int(n), int(dim))
        self.spatial_shard = spatial_shard
        if use_kernels and (kernel_size != 3 or not channel_first_io):
            raise ValueError("VNetDS use_kernels takes kernel_size 3 and "
                             "channel-first IO only")
        rli = [0] if right_leg_indexes is None else list(right_leg_indexes)
        if 0 not in rli:
            raise ValueError("right_leg_indexes must hold 0 (the legs are "
                             "upsampled to section 0's size)")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.out_channels = out_channels
        self.num_blocks = [int(n) for n in num_blocks]
        self.use_resize = use_resize
        self.right_leg_indexes = rli
        self.activation = activation
        self.use_snn = use_snn
        self.output_activation = output_activation
        self.use_residual = use_residual
        self.channel_first_io = channel_first_io
        self.use_kernels = use_kernels
        self.compute_dtype = compute_dtype
        # (id(parameter), dtype) -> (version key, conv3 layout)
        self._up_weights = {}
        g = dict(generator=generator)
        na = dict(activation=activation, use_snn=use_snn,
                  compute_dtype=compute_dtype)
        k = kernel_size
        ns = len(self.num_blocks)

        self.conv_in = (ConvNormAct(in_channels, base_num_filters, 2, 2,
                                    **na, **g) if use_resize else None)
        cur = base_num_filters if use_resize else in_channels
        enc = []
        for i, nb in enumerate(self.num_blocks):
            f = base_num_filters * 2 ** i
            sec = [ConvNormAct(cur if j == 0 else f, f, k, **na, **g)
                   for j in range(nb)]
            if use_residual:
                sec.append(ConvNormAct(cur, f, 1, **na, **g))
            if i != ns - 1:
                sec.append(ConvNormAct(f, f, k, 2, **na, **g))
            enc.append(nn.ModuleList(sec))
            cur = f
        self.encode_layers = nn.ModuleList(enc)
        legs = [cur] if ns - 1 in rli else []
        dec = [None] * (ns - 1)
        for i in reversed(range(ns - 1)):
            f = base_num_filters * 2 ** i
            sec = [ConvTransposeNormAct(cur, f, k, activation=activation,
                                        **g)]
            sec += [ConvNormAct(2 * f if j == 0 else f, f, k, **na, **g)
                    for j in range(self.num_blocks[i])]
            if use_residual:
                sec.append(ConvNormAct(2 * f, f, 1, **na, **g))
            dec[i] = nn.ModuleList(sec)
            cur = f
            if i in rli:
                legs.append(f)
        self.decode_layers = nn.ModuleList(dec)
        self.conv_ds = (ConcatConvNormAct(sum(legs), out_channels, **na, **g)
                        if len(legs) > 1 else None)
        self.conv_out = _SplitKernelConv1x1(
            out_channels if self.conv_ds is not None else cur, out_channels,
            use_bias=False, snn_init=use_snn and is_selu(activation),
            compute_dtype=compute_dtype, **g)
        if device is not None:
            self.to(device)

    def _dtypes(self):
        """(activation dtype, island dtype) of ``compute_dtype`` for the
        parameters' dtype (fp32, or float64 after ``.double()``)."""
        return compute_dtypes(self.compute_dtype, self.conv_out.weight.dtype)

    def _section(self, side, i):
        """(chain convs, residual conv or None, last conv or None): the
        down conv of an encoder section, the up conv of a decoder one."""
        sec = (self.encode_layers if side == "encode"
               else self.decode_layers)[i]
        nb = self.num_blocks[i]
        first = 0 if side == "encode" else 1
        convs = list(sec[first:first + nb])
        res = sec[first + nb] if self.use_residual else None
        if side == "encode":
            extra = (sec[nb + int(self.use_residual)]
                     if i != len(self.num_blocks) - 1 else None)
        else:
            extra = sec[0]
        return convs, res, extra

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 5:
            raise ValueError(f"expected (B, C, D, H, W), got "
                             f"{tuple(x.shape)}")
        if (self._dtypes()[0] == torch.bfloat16 and torch.is_grad_enabled()
                and self.conv_out.weight.requires_grad):
            not_ported(f"training with compute_dtype={self.compute_dtype!r} "
                       "(serve under torch.no_grad or inference_mode)", 12)
        if (self.spatial_shard is not None and torch.is_grad_enabled()
                and self.conv_out.weight.requires_grad):
            not_ported("training V-Net-DS depth-sharded (serve under "
                       "torch.no_grad or inference_mode)", 15)
        if self.use_kernels:
            return self._kernel_forward(x)
        return self._module_forward(x)

    # ---- module path ----------------------------------------------------

    def _module_forward(self, x):
        if self.channel_first_io:
            x = x.permute(0, 2, 3, 4, 1)
        in_dtype = x.dtype
        x = x.to(self._dtypes()[0])
        image_size = tuple(x.shape[1:-1])
        if self.use_resize:
            x = self.conv_in(x)
        ns = len(self.num_blocks)
        encode, legs = {}, {}
        for i in range(ns):
            convs, res, down = self._section("encode", i)
            tmp = x
            for conv in convs:
                x = conv(x)
            if res is not None:
                x = x + res(tmp)
            if down is not None:
                encode[i] = x
                x = down(x)
            elif i in self.right_leg_indexes:
                legs[i] = x
        for i in reversed(range(ns - 1)):
            convs, res, up = self._section("decode", i)
            x = spatial_padcrop(up(x), encode[i].shape[1:-1])
            x = torch.cat([x, encode[i]], dim=-1)
            tmp = x
            for conv in convs:
                x = conv(x)
            if res is not None:
                x = x + res(tmp)
            if i in self.right_leg_indexes:
                legs[i] = x
        return self._head(x, legs, image_size, in_dtype)

    def _head(self, x, legs, image_size, in_dtype, lvl=None, shard=None):
        """Deep-supervision head (project, then nearest-upsample, to
        section 0's size; the kernel path's GroupNorm from the moments of
        its output, as the reference's ``_FlatDSHead``), conv_out and the
        output tail. Sharded (``lvl``: each level's ShardCtx or None), a
        leg's projection or conv_out's output is gathered where its level
        is sharded, and the rest runs replicated."""
        lvl = lvl or [None] * len(self.num_blocks)

        def gathered(i, t):
            return t if lvl[i] is None else lvl[i].gather_planes(t)
        if self.conv_ds is not None:
            size0 = tuple(legs[0].shape[1:-1])
            if lvl[0] is not None:
                size0 = (size0[0] * lvl[0].n,) + size0[1:]
            idx = list(legs)
            y = self.conv_ds.op(tuple(legs.values()), upsample_to=size0,
                                after_project=lambda k, t: gathered(idx[k],
                                                                    t))
            x = (self._finish(self.conv_ds, y, None) if self.use_kernels
                 else self.conv_ds._norm_act(y))
            x = self.conv_out(x)
        else:
            x = gathered(0, self.conv_out(legs[0]))
        x = _channel_first_tail(x, image_size, self.use_resize, in_dtype,
                                self.output_activation, self.use_kernels)
        if shard is not None:
            x = shard.permute(x, inverse=True)
        if not self.channel_first_io:
            x = x.permute(0, 2, 3, 4, 1)
        return x

    # ---- kernel path ----------------------------------------------------

    def _kernel_act(self):
        """The activation's name where the conv3 prologue can take it."""
        act = "none" if self.activation is None else self.activation
        return act if act in KERNEL_ACTS else None

    def _finish(self, module, y, stats, n_voxels=None, ctx=None):
        """Materialize ``module``'s GroupNorm (from the kernel-emitted
        moments over ``n_voxels``, by default y's; computed here when
        None) and activation on its raw conv output ``y``. With ``ctx`` y
        is a slab of a sharded volume: the default count and moments are
        the whole volume's."""
        if module.normalization is not None:
            if stats is None:
                stats = _moments(y)
                if ctx is not None:
                    stats = ctx.all_reduce(stats)
            if n_voxels is None:
                n_voxels = _voxels(y, ctx)
            scale, shift = _gn_affine(stats, n_voxels, module.normalization)
            y = y * scale.to(y.dtype) + shift.to(y.dtype)
        return module.act(y) if module.act is not None else y

    def _at_island(self, *params):
        """``params`` at the island dtype, kept between forwards
        (``_cached``): a weight is rounded once per version, not per
        call."""
        isl = self._dtypes()[1]
        return tuple(p if p.dtype == isl else _cached(
            self, f"island_{id(p)}_{isl}", [p], lambda p=p: p.to(isl))
            for p in params)

    def _deferred(self, module, y, stats, ctx=None):
        """(scale, shift, act) that the next conv's prologue applies: fp32
        vectors holding values of y's dtype (the reference's ``_flat_gn_eff``
        returns them in y's dtype; conv3 reads them as fp32); ``stats`` are
        the whole volume's when y is a slab (``ctx``)."""
        if module.normalization is None:  # self-normalizing: the activation
            ones = torch.ones(y.shape[-1], device=y.device,
                              dtype=torch.promote_types(y.dtype,
                                                        torch.float32))
            return ones, torch.zeros_like(ones), self._kernel_act()
        scale, shift = _gn_affine(stats, _voxels(y, ctx),
                                  module.normalization)
        if y.dtype != scale.dtype:  # one rounding of both
            scale, shift = torch.stack([scale, shift]).to(y.dtype).to(
                scale.dtype)
        return scale, shift, self._kernel_act()

    def _conv3(self, x, w, b, ctx, **kw):
        """conv3, or on a sharded level (``ctx``) its halo mode on this
        rank's slab with the moments all-reduced."""
        if ctx is None:
            return conv3(x, w, b, **kw)
        return conv3_sharded(x, w, b, group=ctx.group, **kw)

    def _chain(self, x0, convs, res, ctx=None, shard=None):
        """k=3 conv chain of one section; returns (output, residual output
        or None). ``x0`` is a tensor or an (up, skip) pair; ``ctx``: the
        level's ShardCtx where it is sharded; ``shard``: the forward's
        (for the weights' permutation)."""
        parts = x0 if isinstance(x0, tuple) else (x0,)
        stats_on = not self.use_snn
        if not convs:
            # a 0-block section: no chain conv for the tap to ride
            xc = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
            return xc, (self._finish(res, res.op(xc), None)
                        if res is not None else None)
        xc, pend, r_out = parts[0], None, None
        defer_ok = self._kernel_act() is not None
        for idx, conv in enumerate(convs):
            kw = dict(emit_stats=stats_on)
            if idx == 0 and len(parts) > 1:
                kw["x2"] = parts[1]
            if pend is not None:
                kw.update(prologue=pend[:2], prologue_act=pend[2])
            tap = idx == 0 and res is not None
            if tap:  # the tap's bias stays fp32, as the reference's
                w, isl = res.op.weight, self._dtypes()[1]
                wr = _cached(self, f"tap_{id(w)}_{isl}", [w],
                             lambda: w.reshape(w.shape[:2]).to(isl))
                kw["residual"] = (wr, res.op.bias)
            out = self._conv3(xc, *self._params(conv, shard), ctx, **kw)
            out = out if isinstance(out, tuple) else (out,)
            y = out[0]
            st = out[-2 if tap else -1] if stats_on else None
            if tap:
                r_out = self._finish(res, out[1],
                                     out[-1] if stats_on else None, ctx=ctx)
            if defer_ok and idx != len(convs) - 1:
                xc, pend = y, self._deferred(conv, y, st, ctx)
            else:
                xc, pend = self._finish(conv, y, st, ctx=ctx), None
        return xc, r_out

    def _params(self, module, shard, weight=None):
        """(weight, bias) of a conv as conv3 takes them: at the island
        dtype and, on a forward sharded along another image axis than
        depth, with the weight's spatial axes permuted along (kept between
        forwards, ``_cached``). ``weight``: the up conv's flipped one."""
        w, b = self._at_island(module.op.weight if weight is None
                               else weight, module.op.bias)
        if shard is None or shard.sperm == (0, 1, 2):
            return w, b
        return _cached(self, f"perm_{id(module)}_{w.dtype}_{shard.sperm}",
                       [w], lambda: shard.permute(w)), b

    def _up_weight(self, p, dtype):
        """The transposed conv's weight ``p`` as conv3 takes it, in
        ``dtype`` (the island's): torch's transposed conv is a conv over the
        2x-dilated input with the flipped kernel in conv layout. Kept
        between forwards and made again when ``p``'s storage or version
        changes, so the kernel path flips (and conv3 packs) each weight
        once per version and dtype, not per forward. Where autograd would
        track ``p``, the flip is made anew on every forward, so that
        conv3's Function passes its gradient back to ``p``; parameters made
        under inference mode carry no version counter and are flipped on
        every forward too."""
        if (torch.is_grad_enabled() and p.requires_grad) or p.is_inference():
            return p.flip(2, 3, 4).transpose(0, 1).to(dtype).contiguous()
        key = (p.data_ptr(), p._version, p.device, p.dtype)
        cached = self._up_weights.get((id(p), dtype))
        if cached is None or cached[0] != key:
            # a normal tensor, also under inference mode, so that conv3
            # can keep its packed copy
            with torch.inference_mode(False), torch.no_grad():
                w = p.detach().flip(2, 3, 4).transpose(0, 1).to(
                    dtype).contiguous()
            cached = self._up_weights[(id(p), dtype)] = (key, w)
        return cached[1]

    def _kernel_forward(self, x):
        if x.shape[0] != 1:
            raise ValueError(f"VNetDS's kernel path serves batch 1, got "
                             f"{x.shape[0]}")
        in_dtype = x.dtype
        dtype, isl = self._dtypes()
        shard = None
        if self.spatial_shard is not None:
            shard = ShardCtx(*self.spatial_shard)
            x = shard.permute(x)
        image_size = tuple(x.shape[2:])
        x = x.to(dtype).contiguous()
        if self.use_resize:
            w, b = self.conv_in.op.weight, self.conv_in.op.bias
            if dtype == torch.bfloat16:
                # the bf16 instance with fp32 weights holding the island's
                # values, then the GroupNorm or SELU on its bf16 output, as
                # the reference's flat entry
                w, b = _cached(self, f"conv_in_{isl}", [w, b], lambda: (
                    w.to(isl).to(w.dtype), b.to(isl).to(b.dtype)))
                x = self._finish(self.conv_in,
                                 conv_in_s2d(x, w, b, apply_selu=False), None)
            else:
                if shard is not None and shard.sperm != (0, 1, 2):
                    w = _cached(self, f"conv_in_perm_{shard.sperm}", [w],
                                lambda: shard.permute(w))
                snn = self.use_snn and is_selu(self.activation)
                y = conv_in_s2d(x, w, b, apply_selu=snn)
                x = y if snn else self._finish(self.conv_in, y, None)
        else:
            x = x.permute(0, 2, 3, 4, 1).contiguous()
        stats_on = not self.use_snn
        ns = len(self.num_blocks)
        lvl = [None] * ns
        if shard is not None:
            sched = shard_schedule(x.shape[1], ns, shard.n)
            if not sched[0]:
                not_ported(f"V-Net-DS depth-sharded over {shard.n} ranks "
                           f"with an entry depth of {x.shape[1]} planes "
                           f"(image axis {shard.dim}; see "
                           "flat_vnet_shardable)", 15)
            lvl = [shard if on else None for on in sched]
            x = shard.local_slab(x)
        encode, legs = {}, {}
        for i in range(ns):
            convs, res, down = self._section("encode", i)
            x, r = self._chain(x, convs, res, lvl[i], shard)
            if r is not None:
                x = x + r
            if down is not None:
                encode[i] = x
                ctx, nxt = lvl[i], lvl[i + 1]
                if ctx is not None and nxt is None:
                    # into a replicated level: gather, then run replicated
                    x, ctx = ctx.gather_planes(x), None
                # the reference's GroupNorm reads the decimated output: in
                # bf16 the stride-2 conv3 emits the moments of its rounded
                # values
                out = self._conv3(x, *self._params(down, shard), ctx,
                                  stride=2, emit_stats=stats_on)
                x = self._finish(down, *(out if stats_on else (out, None)),
                                 ctx=ctx)
            elif i in self.right_leg_indexes:
                legs[i] = x
        for i in reversed(range(ns - 1)):
            convs, res, up = self._section("decode", i)
            src, dst = lvl[i + 1], lvl[i]
            w = self._up_weight(up.op.weight, isl)
            stats_up = up.normalization is not None
            out = self._conv3(x, *self._params(up, shard, weight=w), src,
                              dilation=2, emit_stats=stats_up)
            y, st = out if stats_up else (out, None)
            # GroupNorm over the whole 2n output, applied after the crop to
            # the encoder's size (the whole volume's, where the up conv
            # runs replicated into a sharded level, which keeps its slab)
            n_full = _voxels(y, src)
            size = tuple(encode[i].shape[1:-1])
            if dst is not None and src is None:
                size = (size[0] * dst.n,) + size[1:]
            y = spatial_padcrop(y, size)
            x = self._finish(up, y, st, n_full, ctx=src).contiguous()
            if dst is not None and src is None:
                x = dst.local_slab(x)
            x, r = self._chain((x, encode[i]), convs, res, dst, shard)
            if r is not None:
                x = x + r
            if i in self.right_leg_indexes:
                legs[i] = x
        return self._head(x, legs, image_size, in_dtype, lvl, shard)


def _voxels(y, ctx=None):
    """The voxel count of ``y`` (1, D, H, W, C), of the whole volume where
    y is a slab of a sharded one (``ctx``)."""
    return y[0, ..., 0].numel() * (1 if ctx is None else ctx.n)


# ---- the spectral towers ------------------------------------------------


class _TransBlockMixin:
    """Shared tail of the tower blocks (reference
    ``nets/architectures.py:511-548``): add the two branches, GroupNorm(1)
    unless self-normalizing, the activation, then the block skip (concat +
    1x1 ``conv_concat``, or an add)."""

    def _setup_tail(self, in_channels: int, out_channels: int, activation,
                    use_block_skip: bool, use_block_concat: bool,
                    compute_dtype: str, generator: torch.Generator) -> None:
        snn = is_selu(activation)
        self.out_channels = out_channels
        self.use_block_skip = use_block_skip
        self.normalization = None if snn else GroupNorm1(out_channels)
        self.act = get_activation(activation)
        self.conv_concat = (
            ConcatConvNormAct(out_channels + in_channels, out_channels,
                              use_bias=True, activation=activation,
                              use_snn=snn, compute_dtype=compute_dtype,
                              generator=generator)
            if use_block_skip and use_block_concat else None)

    def _block_tail(self, x1, x2, tmp):
        x = x1 + x2
        if self.normalization is not None:
            x = self.normalization(x)
        if self.act is not None:
            x = self.act(x)
        if self.use_block_skip:
            if self.conv_concat is not None:
                return self.conv_concat((x, tmp))
            x = x + tmp
        return x

    def tower_weights(self, ds_rows: Optional[torch.Tensor] = None,
                      dtype: Optional[torch.dtype] = None):
        """(w_cat, w_cc_t, b_cat) of the fused tower block kernels: rows
        [W_conv ; the conv_concat columns of the block input (; ds_rows,
        the block input's deep-supervision rows)], the conv_concat columns
        of the activated branch, both in ``dtype`` (default the
        parameters'; bf16 for the 'bfloat16' instances), and [conv-branch
        bias or zeros ; conv_concat bias] in the parameters' dtype. Needs
        the concat skip."""
        c = self.out_channels
        w_conv = self.conv_branch.weight.reshape(c, -1)
        w_cc = self.conv_concat.op.weight.reshape(c, -1)
        dtype = dtype or w_cc.dtype
        b_conv = (self.conv_branch.bias if self.conv_branch.bias is not None
                  else torch.zeros_like(self.conv_concat.op.bias))
        rows = [w_conv, w_cc[:, c:]] + ([] if ds_rows is None
                                        else [ds_rows])
        return (torch.cat(rows).to(dtype).contiguous(),
                w_cc[:, :c].to(dtype).contiguous(),
                torch.cat([b_conv, self.conv_concat.op.bias]).contiguous())


class HartleyMHABlock(_TransBlockMixin, nn.Module):
    """Hartley-MHA block (reference ``nets/architectures.py:611-635``):
    the attention branch ``op`` and a parallel 1x1 ``conv_branch`` (the
    reference's ``use_conv_branch``, which no model turns off)."""

    def __init__(self, in_channels: int, out_channels: int, num_heads: int,
                 num_modes, patch_size=None, attention_activation="selu",
                 activation="selu", use_bias_conv_branch: bool = False,
                 use_block_skip: bool = True, use_block_concat: bool = True,
                 compute_dtype: str = "float32", *,
                 generator: torch.Generator):
        super().__init__()
        # the reference's SNN re-init skips the MHA projections
        # (``nets/nets_utils.py:108-117``): default init always
        self.op = HartleyMultiHeadAttention(
            in_channels, out_channels, num_heads, num_modes,
            patch_size=patch_size, attention_activation=attention_activation,
            snn_init=False, compute_dtype=compute_dtype, generator=generator)
        self.conv_branch = Conv(in_channels, out_channels, 1,
                                use_bias=use_bias_conv_branch,
                                snn_init=is_selu(activation),
                                compute_dtype=compute_dtype,
                                generator=generator)
        self._setup_tail(in_channels, out_channels, activation,
                         use_block_skip, use_block_concat, compute_dtype,
                         generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._block_tail(self.op(x), self.conv_branch(x), x)


class NeuralOperatorBlock(_TransBlockMixin, nn.Module):
    """FNO / HNO block (reference ``nets/architectures.py:551-608``): the
    spectral operator branch ``op`` (``FourierOperator`` or
    ``HartleyOperator`` on the volume) and a parallel 1x1 ``conv_branch``,
    then the shared tail."""

    def __init__(self, in_channels: int, out_channels: int, num_modes,
                 transform_type: str, weights_type: str = "shared",
                 activation="selu", use_bias_conv_branch: bool = False,
                 use_block_skip: bool = True, use_block_concat: bool = True,
                 compute_dtype: str = "float32", *,
                 generator: torch.Generator):
        super().__init__()
        if transform_type not in ("Fourier", "Hartley"):
            raise ValueError(f"transform_type must be 'Fourier' or "
                             f"'Hartley', got {transform_type!r}")
        snn = is_selu(activation)
        op_cls = (FourierOperator if transform_type == "Fourier"
                  else HartleyOperator)
        self.op = op_cls(in_channels, out_channels, num_modes,
                         weights_type=weights_type, snn_init=snn,
                         compute_dtype=compute_dtype, generator=generator)
        self.conv_branch = Conv(in_channels, out_channels, 1,
                                use_bias=use_bias_conv_branch, snn_init=snn,
                                compute_dtype=compute_dtype,
                                generator=generator)
        self._setup_tail(in_channels, out_channels, activation,
                         use_block_skip, use_block_concat, compute_dtype,
                         generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._block_tail(self.op(x), self.conv_branch(x), x)

    def op_weights(self):
        """The operator's shared weights as ``spectrum_mix_s`` takes them:
        (weight,) or (weight_real, weight_imag)."""
        if isinstance(self.op, FourierOperator):
            return self.op.weight_real, self.op.weight_imag
        return (self.op.weight,)


class _TransSegBase(nn.Module):
    """Shared tower skeleton (reference ``nets/architectures.py:282-353``):
    conv_in -> conv1 -> N blocks -> deep-supervision sum -> conv_out ->
    output tail, for HartleyMHASeg and NeuralOperatorSeg.

    Deep supervision folds each part (conv1's output and every block's)
    into a running out_channels-wide sum through its rows of ``conv_ds``,
    in the order of ``ConcatConvNormAct``'s split-kernel sum, so the
    (blocks + 1) parts are never held at once."""

    def _setup_tower(self, in_channels: int, out_channels: int, filters: int,
                     num_transform_blocks: int, use_resize: bool,
                     use_deep_supervision: bool, activation,
                     output_activation, channel_first_io: bool, make_block,
                     compute_dtype: str, generator: torch.Generator) -> None:
        snn = is_selu(activation)
        compute_dtypes(compute_dtype)  # a known name
        self.compute_dtype = compute_dtype
        g = dict(compute_dtype=compute_dtype, generator=generator)
        self.out_channels = out_channels
        self.filters = filters
        self.use_resize = use_resize
        self.activation = activation
        self.output_activation = output_activation
        self.channel_first_io = channel_first_io
        self.conv_in = (ConvNormAct(in_channels, filters, 2, 2,
                                    activation=activation, use_snn=snn, **g)
                        if use_resize else None)
        self.conv1 = ConvNormAct(filters if use_resize else in_channels,
                                 filters, activation=activation, use_snn=snn,
                                 **g)
        self.layers = nn.ModuleList(make_block(filters, **g)
                                    for _ in range(num_transform_blocks))
        self.conv_ds = (ConcatConvNormAct(
            filters * (num_transform_blocks + 1), out_channels,
            activation=activation, use_snn=snn, **g)
            if use_deep_supervision else None)
        self.conv_out = Conv(out_channels if use_deep_supervision
                             else filters, out_channels, 1, use_bias=False,
                             snn_init=snn, **g)

    def _dtypes(self):
        """(activation dtype, island dtype) of ``compute_dtype`` for the
        parameters' dtype (fp32, or float64 after ``.double()``)."""
        return compute_dtypes(self.compute_dtype, self.conv_out.weight.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 5:
            raise ValueError(f"expected (B, C, D, H, W), got "
                             f"{tuple(x.shape)}")
        if (self._dtypes()[0] == torch.bfloat16 and torch.is_grad_enabled()
                and self.conv_out.weight.requires_grad):
            not_ported(f"training with compute_dtype={self.compute_dtype!r} "
                       "(serve under torch.no_grad or inference_mode)", 12)
        if self.use_kernels:
            return self._kernel_forward(x)
        return self._module_tower(x)

    def _ds_rows(self, idx: int) -> torch.Tensor:
        """conv_ds's (out, filters) matrix of deep-supervision part idx."""
        w = self.conv_ds.op.weight.reshape(self.out_channels, -1)
        return w[:, idx * self.filters:(idx + 1) * self.filters]

    def _ds_fold(self, acc, part, idx):
        """The running deep-supervision sum plus part idx's projection,
        at the island dtype and stored in the part's dtype (the reference's
        module path)."""
        if self.conv_ds is None:
            return None
        isl = self._dtypes()[1]
        p = F.linear(part.to(isl), self._ds_rows(idx).to(isl)).to(part.dtype)
        return p if acc is None else acc + p

    def _module_tower(self, x: torch.Tensor) -> torch.Tensor:
        if self.channel_first_io:
            x = x.permute(0, 2, 3, 4, 1)
        in_dtype = x.dtype
        x = x.to(self._dtypes()[0])
        image_size = tuple(x.shape[1:-1])
        if self.conv_in is not None:
            x = self.conv_in(x)
        x = self.conv1(x)
        acc = self._ds_fold(None, x, 0)
        for i, block in enumerate(self.layers):
            x = block(x)
            acc = self._ds_fold(acc, x, i + 1)
        if acc is not None:
            x = self.conv_ds._norm_act(acc + self.conv_ds.op.bias.to(
                acc.dtype))
        return self._output(self.conv_out(x), image_size, in_dtype, False)

    def _output(self, x, image_size, in_dtype, use_kernels):
        x = _channel_first_tail(x, image_size, self.use_resize, in_dtype,
                                self.output_activation, use_kernels)
        return x if self.channel_first_io else x.permute(0, 2, 3, 4, 1)

    def _kernel_entry(self, x: torch.Tensor) -> torch.Tensor:
        """conv_in (the conv_in kernel, SELU fused) and conv1 on the
        channel-first batch-1 input -> the tower grid (D, H, W, filters),
        in the activation dtype. conv_in's weights are rounded to the island
        dtype and passed in their own (the bf16 instance sums in fp32)."""
        if x.shape[0] != 1:
            raise ValueError(f"the kernel path serves batch 1, got "
                             f"{x.shape[0]}")
        dtype, isl = self._dtypes()
        x = x.to(dtype).contiguous()
        if self.conv_in is not None:
            w, b = self.conv_in.op.weight, self.conv_in.op.bias
            x = conv_in_s2d(x, w.to(isl).to(w.dtype), b.to(isl).to(b.dtype))
        else:
            x = x.permute(0, 2, 3, 4, 1)
        return self.conv1(x)[0].contiguous()

    def _block_operands(self, i: int, block, n_ds: int):
        """Block i's (w_cat, w_cc_t, b_cat) for the tower kernels, with its
        deep-supervision rows, the channel-mix weights in the island dtype
        (bf16 selects the 'bfloat16' instances), packed once per weight
        version."""
        isl = self._dtypes()[1]
        params = list(block.conv_branch.parameters()) + list(
            block.conv_concat.parameters())
        if n_ds:
            params.append(self.conv_ds.op.weight)
        return _cached(block, f"tower_{isl}_{n_ds}", params,
                       lambda: block.tower_weights(
                           self._ds_rows(i) if n_ds else None, isl))

    def _kernel_tower(self, x, spec, mix):
        """Every block of the tower through the fused tower block kernel of
        ``self.tower_kernel``; ``mix(block, s)`` is the block's operator on
        a packed spectrum (KS, C, KH, KW). The volume x is in the
        activation dtype; the spectra between kernels and the running
        deep-supervision sum stay fp32 (float64 for a float64 model).
        Returns the tower's output and that sum (None without conv_ds)."""
        n_ds = spec.n_ds
        wide = self.conv_out.weight.dtype
        isl = self._dtypes()[1]
        ds = (torch.zeros(spec.sizes + (n_ds,), dtype=wide,
                          device=x.device) if n_ds else None)
        resident = self.tower_kernel == "block_s"
        # the resident spectrum (block_s) or the per-plane spectra (block),
        # the volume's transforms at the island dtype
        s = (entry_spectrum_s(x, spec, isl) if resident
             else entry_forward_hw(x, spec, isl))
        for i, block in enumerate(self.layers):
            w_cat, w_cc_t, b_cat = self._block_operands(i, block, n_ds)
            if resident:
                res = fused_tower_block_s(x, mix(block, s).contiguous(),
                                          w_cat, w_cc_t, b_cat, spec, ds)
            else:
                z = d_stage_inverse(mix(block, d_stage_forward(s, spec)),
                                    spec).contiguous()
                res = fused_tower_block(x, z, w_cat, w_cc_t, b_cat, spec,
                                        ds)
            x, s = res[0], res[1]
            ds = res[2] if n_ds else None
        return x, ds

    def _kernel_exit(self, x, ds, image_size, in_dtype):
        """The last block's deep-supervision part and conv_ds's bias + SELU
        in the sum's dtype, back to the activation dtype, conv_out, and the
        output tail (the tail_resize kernel)."""
        if ds is not None:
            ds = ds + F.linear(x.to(ds.dtype),
                               self._ds_rows(len(self.layers)))
            x = torch.selu(ds + self.conv_ds.op.bias).to(x.dtype)
        return self._output(self.conv_out(x)[None], image_size, in_dtype,
                            True)


class HartleyMHASeg(_TransSegBase):
    """HartleyMHASeg (reference ``nets/architectures.py:432-508``): input
    (B, C, *spatial) channel-first, output probabilities (B, out_channels,
    *spatial).

    ``use_kernels=True`` runs the counterpart of the reference's
    ``_fused_mha_forward``: batch 1, channel-first IO, SELU, the concat
    block skip; the tower grid must hold 2 * num_modes on every axis (the
    reference falls back to the module path there; this raises).
    ``tower_kernel`` picks its tower kernel: ``"block"`` (default; the
    attention reads the packed spectrum from the depth forward stage of
    the per-plane spectra) or ``"block_s"`` (the attention reads the
    resident spectrum). ``generator`` seeds the init (default: seeded with
    0); ``device`` places the parameters, which stay fp32 in every
    ``compute_dtype``. With 'float32' the model computes in its
    parameters' dtype (fp32, or float64 after ``.double()`` as a
    reference, which runs ``use_kernels=False`` on the card); 'bfloat16'
    and 'mixed' serve (module docstring).
    """

    def __init__(self, in_channels: int, out_channels: int, filters: int,
                 num_transform_blocks: int, num_heads: int,
                 num_modes: Union[int, Sequence[int]],
                 patch_size=None, attention_activation="selu",
                 use_resize: bool = True, use_deep_supervision: bool = True,
                 use_bias_conv_branch: bool = False,
                 use_block_skip: bool = True, use_block_concat: bool = True,
                 activation="selu", output_activation="softmax",
                 ndim: int = 5, channel_first_io: bool = True,
                 compute_dtype: str = "float32", use_kernels: bool = False,
                 tower_kernel: str = "block", *,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        if ndim != 5:
            not_ported("HartleyMHASeg ndim=4 (2D)", 11)
        if use_kernels and not (is_selu(activation) and use_block_skip
                                and use_block_concat and channel_first_io):
            raise ValueError("HartleyMHASeg use_kernels takes SELU, the "
                             "concat block skip and channel-first IO only")
        if tower_kernel == "resident":
            raise ValueError("tower_kernel='resident' serves NeuralOperatorSeg "
                             "only: HartleyMHASeg's operator is attention, "
                             "not a channel mix")
        if tower_kernel not in TOWER_KERNELS:
            raise ValueError(f"tower_kernel must be one of {TOWER_KERNELS}, "
                             f"got {tower_kernel!r}")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.num_modes = num_modes
        self.use_kernels = use_kernels
        self.tower_kernel = tower_kernel

        def make_block(c, compute_dtype, generator):
            return HartleyMHABlock(
                c, filters, num_heads, num_modes, patch_size=patch_size,
                attention_activation=attention_activation,
                activation=activation,
                use_bias_conv_branch=use_bias_conv_branch,
                use_block_skip=use_block_skip,
                use_block_concat=use_block_concat,
                compute_dtype=compute_dtype, generator=generator)

        self._setup_tower(in_channels, out_channels, filters,
                          num_transform_blocks, use_resize,
                          use_deep_supervision, activation,
                          output_activation, channel_first_io, make_block,
                          compute_dtype, generator)
        if device is not None:
            self.to(device)

    def _kernel_forward(self, x):
        in_dtype = x.dtype
        image_size = tuple(x.shape[2:])
        x = self._kernel_entry(x)
        n_ds = self.out_channels if self.conv_ds is not None else 0
        spec = make_tower_spec("Hartley", tuple(x.shape[:3]),
                               normalize_modes(self.num_modes, 3),
                               self.filters, n_ds=n_ds)

        def attend(block, s):
            # the attention on the packed spectrum (KD, C, KH, KW)
            s = s.permute(0, 2, 3, 1)[None]
            return block.op.attend(s, s, s)[0].permute(0, 3, 1, 2)

        x, ds = self._kernel_tower(x, spec, attend)
        return self._kernel_exit(x, ds, image_size, in_dtype)


class NeuralOperatorSeg(_TransSegBase):
    """FNO / FNOSeg / HNOSeg (reference ``nets/architectures.py:356-429``):
    input (B, C, *spatial) channel-first, output probabilities (B,
    out_channels, *spatial). ``transform_type`` 'Hartley' (HNOSeg) or
    'Fourier' (FNOSeg); shared operator weights (``weights_type=
    'individual'`` raises naming its ROADMAP item).

    ``use_kernels=True`` runs the counterpart of the reference's
    ``_fused_tower_forward`` with the modes clipped to half the tower grid,
    on ``tower_kernel`` ``"block"`` (default: per-plane spectra
    exchanged with einsums between kernels, the fastest of the three on an
    H100), ``"block_s"`` (the resident spectrum, the depth stages inside
    the kernel) or ``"resident"`` (the whole tower in one launch, the
    reference's unrouted ``resident_tower``; no deep supervision). It
    keeps the
    reference's gate (shared weights, SELU, the concat block skip, no
    conv-branch bias, batch 1, channel-first IO) and raises outside it,
    where the reference falls back to its module path. Deep supervision
    rides the kernel's ds rows. ``generator`` seeds the init (default:
    seeded with 0); ``device`` places the parameters, which stay fp32 in
    every ``compute_dtype``. With 'float32' the model computes in its
    parameters' dtype (fp32, or float64 after ``.double()`` as a
    reference, which runs ``use_kernels=False`` on the card); 'bfloat16'
    and 'mixed' serve on all three tower kernels (module docstring).
    """

    def __init__(self, in_channels: int, out_channels: int, filters: int,
                 num_transform_blocks: int,
                 num_modes: Union[int, Sequence[int]],
                 transform_type: str = "Hartley",
                 weights_type: str = "shared", use_resize: bool = True,
                 use_deep_supervision: bool = False,
                 use_bias_conv_branch: bool = False,
                 use_block_skip: bool = True, use_block_concat: bool = True,
                 activation="selu", output_activation="softmax",
                 ndim: int = 5, channel_first_io: bool = True,
                 compute_dtype: str = "float32", use_kernels: bool = False,
                 tower_kernel: str = "block", *,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        if ndim != 5:
            not_ported("NeuralOperatorSeg ndim=4 (2D)", 11)
        if weights_type == "individual":
            not_ported("NeuralOperatorSeg weights_type='individual'", 18)
        if use_kernels and not (
                weights_type == "shared" and is_selu(activation)
                and use_block_skip and use_block_concat
                and not use_bias_conv_branch and channel_first_io):
            raise ValueError("NeuralOperatorSeg use_kernels takes shared "
                             "weights, SELU, the concat block skip without "
                             "a conv-branch bias and channel-first IO only")
        if tower_kernel not in TOWER_KERNELS:
            raise ValueError(f"tower_kernel must be one of {TOWER_KERNELS}, "
                             f"got {tower_kernel!r}")
        if tower_kernel == "resident" and use_deep_supervision:
            raise ValueError("tower_kernel='resident' has no deep "
                             "supervision")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.num_modes = num_modes
        self.transform_type = transform_type
        self.use_kernels = use_kernels
        self.tower_kernel = tower_kernel

        def make_block(c, compute_dtype, generator):
            return NeuralOperatorBlock(
                c, filters, num_modes, transform_type,
                weights_type=weights_type, activation=activation,
                use_bias_conv_branch=use_bias_conv_branch,
                use_block_skip=use_block_skip,
                use_block_concat=use_block_concat,
                compute_dtype=compute_dtype, generator=generator)

        self._setup_tower(in_channels, out_channels, filters,
                          num_transform_blocks, use_resize,
                          use_deep_supervision, activation,
                          output_activation, channel_first_io, make_block,
                          compute_dtype, generator)
        if device is not None:
            self.to(device)

    def _kernel_forward(self, x):
        in_dtype = x.dtype
        image_size = tuple(x.shape[2:])
        x = self._kernel_entry(x)
        sizes = tuple(x.shape[:3])
        n_ds = self.out_channels if self.conv_ds is not None else 0
        spec = make_tower_spec(
            self.transform_type, sizes,
            clip_modes(normalize_modes(self.num_modes, 3), sizes),
            self.filters, n_ds=n_ds)
        if self.tower_kernel == "resident":
            x, ds = resident_tower(
                x, *self.resident_operands(self._dtypes()[1]), spec), None
        else:
            x, ds = self._kernel_tower(
                x, spec, lambda block, s: spectrum_mix_s(
                    s, block.op_weights(), spec))
        return self._kernel_exit(x, ds, image_size, in_dtype)

    def resident_operands(self, dtype: Optional[torch.dtype] = None):
        """(op_stack, wcat_stack, wcc_stack, b_stack) of ``resident_tower``:
        every block's ``op_weights()`` and ``tower_weights()``, stacked, the
        channel-mix stacks in ``dtype`` (default the parameters'; bf16 for
        the 'bfloat16' instance), packed once per weight version."""
        def build():
            ops = torch.stack([torch.stack(block.op_weights())
                               for block in self.layers])
            return (ops, *(torch.stack(t) for t in zip(
                *(block.tower_weights(dtype=dtype)
                  for block in self.layers))))
        return _cached(self, f"resident_{dtype}", list(self.layers.parameters()),
                       build)
