"""k=3 convolution with V-Net-DS's fused options, the port of
``multimodal_3d_image_segmentation_tpu/kernels/conv3d_flat.py::conv3_flat``.

Volumes are channels-last (1, D, H, W, C), the layout the port's conv_in
kernel emits: the contraction axis is contiguous and a 1x1 mix is a matrix
product over the last axis. The Pallas kernel's flat padded layout
``(Dp, C, pad128(Hp*Wp))`` exists for TPU lanes and is not carried over;
its semantics are: the padding is zero after the prologue, the residual
tap reads the pre-prologue input, and the moment sums cover the valid
output voxels only.

Options, each a flag of the one CUDA kernel (``csrc/conv3.cu``):

  * ``x2``: a second input read as channels ``c1..c1+c2`` (virtual concat);
  * ``prologue`` = (scale, shift) with ``prologue_act``: the input becomes
    ``act(x * scale + shift)`` per channel on load (a deferred GroupNorm);
  * ``residual`` = (wr (co, ci), br (co,)): also return
    ``r = x @ wr.T + br`` of the pre-prologue input (no prologue allowed);
  * ``emit_stats``: also return fp32 ``(2, co)`` [sum(y), sum(y**2)]
    (and the same for r);
  * ``stride=2``: the down conv, output ``(n - 1) // 2 + 1`` per axis;
  * ``dilation=2``: the transposed up conv (torch's stride 2, padding 1,
    output_padding 1), given as a conv over the input dilated by 2 with
    the flipped kernel in conv layout, output ``2n`` per axis;
  * ``halo=True`` with ``halo_keep`` = (keep_first, keep_last), each 0 or
    1: the depth-sharded conv (the reference's ``halo`` mode, used by
    ``parallel/halo.py``). x (and x2) hold d + 2 planes: the d planes of
    this shard and, first and last, one plane of each neighbouring shard.
    A halo plane goes through the prologue like any plane and is then
    multiplied by its keep flag: 0 at a global end of the volume, where it
    stands for the zero padding. H and W are zero-padded, depth is not.
    The output, the residual tap and the moment sums cover the d interior
    planes only; with ``stride=2`` the output has (d - 1) // 2 + 1 planes
    (only the first halo is read), with ``dilation=2`` 2d (only the last
    halo is read);
  * ``dilated_depth=n``: a stride-1 conv over the volume dilated along
    depth only (the reference's ``dilated_depth``): source plane j of x's
    first n planes at plane 2j of a 2n-plane grid, the odd planes zero
    (after the prologue), output 2n planes. Not with ``halo``, ``stride``,
    ``dilation`` or ``residual``.

``conv3_plain`` computes the same with ``F.conv3d`` /
``F.conv_transpose3d`` (cuDNN on the GPU, TF32 off) and torch ops: the
kernel's oracle and the CPU path. Under autograd ``conv3`` is a
``torch.autograd.Function`` whose backward is the reference's
``_conv3_bwd``: a replay of ``conv3_plain`` (cuDNN's backward on the GPU).

Instances (``instance``), chosen by the dtypes of the volume and the conv
weight, as the reference's precision classes (``_dot_f32``): 'float32'
(both fp32, its 'highest' and 'bf16x3', exact fp32 products; the FMA body,
``csrc/conv3.cu``); 'bfloat16' (x bf16, weight bf16: the reference's
'native', one bf16 pass with fp32 sums) and 'mixed' (x bf16, weight fp32:
the reference's 'mixed', the weight split into bf16 hi and lo parts,
``hi_lo``, two passes summed in fp32). Both bf16 instances run the
tensor-core body (``csrc/conv3_mma.cu``, plan ``conv3_mma_plan``) on the
weights ``mma_weight`` packs once per weight version. In both the input is
widened to fp32, the prologue runs in fp32 and its output, the product's
activation operand, is rounded to bf16; the products are summed in fp32
and the bias (bf16 values in 'bfloat16', or fp32) is added in fp32; y and
r are written as bf16, and the moment sums are fp32 sums of the fp32
values before that rounding; at stride 2 they are sums of the rounded
outputs, as the reference's down conv takes its GroupNorm moments from its
decimated bf16 volume. The residual tap's weight takes its own dtype's
passes. The biases, scale and shift may come in bf16 or fp32; the kernel
reads them widened to fp32. The plain twin of a bf16 instance
(``conv3_plain`` on a bf16 x) computes in fp32 from the bf16 values (an
fp32 weight exactly, where the kernel's hi + lo carries its first 16
significant bits) and rounds where the kernel rounds; ``acc=float64``
sums in float64 instead (the precision gate's twins64 path). The bf16
instances serve only: a forward that autograd would record raises
(ROADMAP item 12).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import device as _device  # noqa: F401  (fp32 policy)
from .. import not_ported
from . import _build
from ._common import instance

__all__ = ["conv3", "conv3_plain", "conv3_out_size", "conv3_plan",
           "conv3_mma_plan", "flat_call", "hi_lo", "mma_weight",
           "packed_weight", "instance", "INSTANCES", "KERNEL_ACTS",
           "MMA_PLAN_FIELDS", "PLAN_FIELDS"]

# prologue activation -> the kernel's code
KERNEL_ACTS = {None: 0, "none": 0, "elu": 1, "selu": 2, "relu": 3}
_PLAIN_ACTS = {"elu": F.elu, "selu": torch.selu, "relu": torch.relu}
_BF16 = torch.bfloat16
# instance -> (the reference's precision name, the suffix its launches count
# under)
INSTANCES = {"float32": ("highest", ""), "bfloat16": ("native", "_bf16"),
             "mixed": ("mixed", "_mixed")}
# the halo mode's launches count under a name of their own
HALO_KERNEL = "conv3_halo"


def _keep_flags(halo_keep) -> Tuple[int, int]:
    """``halo_keep`` (a pair of 0/1 numbers, or None for (1, 1)) as two
    ints."""
    if halo_keep is None:
        return 1, 1
    flags = tuple(float(k) for k in halo_keep)
    if len(flags) != 2 or any(k not in (0.0, 1.0) for k in flags):
        raise ValueError(f"halo_keep must be two flags of 0 or 1, got "
                         f"{halo_keep!r}")
    return int(flags[0]), int(flags[1])


def conv3_out_size(sizes: Sequence[int], stride: int = 1,
                   dilation: int = 1) -> Tuple[int, ...]:
    """Output (D, H, W) of a conv3 call on input ``sizes`` (a halo
    call's interior planes, a dilated depth's 2n)."""
    if dilation == 2:
        return tuple(2 * int(n) for n in sizes)
    if stride == 2:
        return tuple((int(n) - 1) // 2 + 1 for n in sizes)
    return tuple(int(n) for n in sizes)


def _moments(t: torch.Tensor) -> torch.Tensor:
    """(2, C) [sum, sum of squares] over every axis but the last."""
    t = t.reshape(-1, t.shape[-1]).to(torch.promote_types(t.dtype,
                                                          torch.float32))
    return torch.stack([t.sum(0), (t * t).sum(0)])


def _conv(xp, weight, bias, stride, dilation, halo=False):
    """The k=3 conv of a channels-last ``xp`` (channels-last out); with
    ``halo`` xp holds a halo plane at each end of its depth, which is not
    padded."""
    xcf = xp.permute(0, 4, 1, 2, 3)
    if dilation == 2:
        if halo:  # output 2j + 1 reads source j + 1: the last halo only
            xcf = xcf[:, :, 1:]
        y = F.conv_transpose3d(xcf, weight.flip(2, 3, 4).transpose(0, 1),
                               bias, stride=2, padding=1, output_padding=1)
        if halo:
            y = y[:, :, :2 * (xcf.shape[2] - 1)]
    else:
        y = F.conv3d(xcf, weight, bias, stride=stride,
                     padding=(0, 1, 1) if halo else 1)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def _dilate_depth(x, n):
    """x's first ``n`` planes at the even planes of a 2n-plane volume,
    the odd planes zero (the reference's ``_dilate_d_flat``)."""
    src = x[:, :n]
    return torch.stack([src, torch.zeros_like(src)], dim=2).reshape(
        (x.shape[0], 2 * n) + tuple(x.shape[2:]))


def _depth_mode(xp, halo, keep, dilated_depth):
    """The prologue's output ``xp`` as the conv reads it: the halo planes
    times their keep flags, or the depth-dilated volume."""
    if halo:
        dmask = torch.ones(xp.shape[1], dtype=xp.dtype, device=xp.device)
        dmask[0], dmask[-1] = keep
        return xp * dmask[:, None, None, None]
    if dilated_depth is not None:
        return _dilate_depth(xp, dilated_depth)
    return xp


def _prologue(xin, prologue, prologue_act):
    xp = xin * prologue[0] + prologue[1]
    act = _PLAIN_ACTS.get(prologue_act)
    return act(xp) if act is not None else xp


def _interior(xin, halo):
    """The residual tap's input: the interior planes of a halo call."""
    return xin[:, 1:-1] if halo else xin


def _conv3_plain_bf16(x, weight, bias, x2, prologue, prologue_act, residual,
                      emit_stats, stride, dilation, acc, unrounded, halo,
                      keep, dilated_depth):
    """The 'bfloat16' or 'mixed' instance (by the weight's dtype) in torch
    ops: sums in ``acc`` from the operands' values, the prologue output
    rounded to bf16 unless "prologue" is in ``unrounded`` (a control); y
    and r bf16, the moments fp32 (at stride 2 of the rounded outputs)."""
    xin = (x if x2 is None else torch.cat([x, x2], dim=-1)).to(acc)
    xp = xin
    if prologue is not None:
        xp = _prologue(xin, tuple(t.to(acc) for t in prologue), prologue_act)
        if "prologue" not in unrounded:
            xp = xp.to(_BF16).to(acc)
    xp = _depth_mode(xp, halo, keep, dilated_depth)
    outs = [_conv(xp, weight.to(acc), bias.to(acc), stride, dilation, halo)]
    if residual is not None:
        outs.append(F.linear(_interior(xin, halo), residual[0].to(acc),
                             residual[1].to(acc)))
    rounded = [t.to(_BF16) for t in outs]
    if emit_stats:
        outs = rounded + [_moments(r.to(acc) if stride == 2 else t).float()
                          for t, r in zip(outs, rounded)]
    else:
        outs = rounded
    return outs[0] if len(outs) == 1 else tuple(outs)


def conv3_plain(x, weight, bias, *, x2=None, prologue=None,
                prologue_act=None, residual=None, emit_stats=False,
                stride=1, dilation=1, halo=False, halo_keep=None,
                dilated_depth=None, acc: torch.dtype = torch.float32,
                unrounded=frozenset()):
    """The conv and its options as plain tensor ops (``conv3``'s
    arguments and returns). A bf16 x runs the twin of its instance (module
    docstring), summing in ``acc``; ``unrounded={"prologue"}`` leaves the
    rounding of the prologue's output out (a control)."""
    keep = _keep_flags(halo_keep) if halo else None
    if x.dtype == _BF16:
        return _conv3_plain_bf16(x, weight, bias, x2, prologue, prologue_act,
                                 residual, emit_stats, stride, dilation, acc,
                                 frozenset(unrounded), halo, keep,
                                 dilated_depth)
    xin = x if x2 is None else torch.cat([x, x2], dim=-1)
    xp = xin
    if prologue is not None:
        xp = _prologue(xin, prologue, prologue_act)
    xp = _depth_mode(xp, halo, keep, dilated_depth)
    outs = [_conv(xp, weight, bias, stride, dilation, halo)]
    if residual is not None:
        outs.append(F.linear(_interior(xin, halo), residual[0], residual[1]))
    if emit_stats:
        outs += [_moments(t) for t in outs[:]]
    return outs[0] if len(outs) == 1 else tuple(outs)


def _check_args(x, weight, bias, x2, prologue, prologue_act, residual,
                stride, dilation, precision, dilated_depth, halo, halo_keep):
    inst = instance(x, weight)
    if inst == "float32":
        if precision in ("native", "mixed"):
            # one bf16 pass on fp32 volumes (the reference's
            # transform_precision 'default' class)
            not_ported(f"conv3 precision={precision!r} on fp32 volumes", 12)
        if precision not in (None, "highest", "bf16x3"):
            raise ValueError(f"unknown conv3 precision {precision!r}")
    elif precision not in (None, "bf16x3", INSTANCES[inst][0]):
        # the reference maps its default 'bf16x3' on a bf16 volume to the
        # weights' class, as the dtypes do here
        raise ValueError(f"conv3 precision={precision!r} does not fit a "
                         f"bf16 volume with a {weight.dtype} weight "
                         f"(the {inst!r} instance: "
                         f"{INSTANCES[inst][0]!r})")
    if x2 is not None and x2.dtype != x.dtype:
        raise TypeError(f"x2 is {x2.dtype}, x {x.dtype}")
    if x.dim() != 5 or x.shape[0] != 1:
        raise ValueError(f"x must be (1, D, H, W, C), got {tuple(x.shape)}")
    ci = x.shape[-1]
    if x2 is not None:
        if x2.dim() != 5 or x2.shape[:4] != x.shape[:4]:
            raise ValueError(f"x2 {tuple(x2.shape)} does not match x "
                             f"{tuple(x.shape)}")
        ci += x2.shape[-1]
    co = weight.shape[0]
    if tuple(weight.shape) != (co, ci, 3, 3, 3) or tuple(bias.shape) != (co,):
        raise ValueError(f"weight {tuple(weight.shape)} / bias "
                         f"{tuple(bias.shape)} do not fit ci={ci}")
    if prologue is not None and (
            tuple(prologue[0].shape) != (ci,)
            or tuple(prologue[1].shape) != (ci,)):
        raise ValueError(f"prologue scale/shift must be ({ci},)")
    if prologue_act not in KERNEL_ACTS:
        raise ValueError(f"unsupported prologue activation {prologue_act!r}")
    if (stride, dilation) not in ((1, 1), (2, 1), (1, 2)):
        raise ValueError(f"stride={stride}, dilation={dilation}: one of "
                         "stride 2 or dilation 2, or neither")
    if residual is not None:
        if prologue is not None or stride != 1 or dilation != 1:
            # the tap reads the pre-prologue centre voxel of a stride-1 conv
            raise ValueError("conv3(residual=...) requires prologue=None, "
                             "stride 1 and dilation 1")
        if (tuple(residual[0].shape) != (co, ci)
                or tuple(residual[1].shape) != (co,)):
            raise ValueError(f"residual weight must be ({co}, {ci}) and its "
                             f"bias ({co},)")
    if halo:
        if dilated_depth is not None:
            # the reference's conv3_flat refuses it too: a transposed conv
            # exchanges its source planes before the dilation
            raise ValueError("conv3(halo=True) does not compose with "
                             "dilated_depth")
        if x.shape[1] < 3:
            raise ValueError(f"a halo call needs one interior plane and "
                             f"two halo planes, got depth {x.shape[1]}")
        _keep_flags(halo_keep)
    elif halo_keep is not None:
        raise ValueError("halo_keep is given without halo=True")
    if dilated_depth is not None:
        if stride != 1 or dilation != 1 or residual is not None:
            raise ValueError("conv3(dilated_depth=...) takes stride 1, "
                             "dilation 1 and no residual")
        if not 1 <= int(dilated_depth) <= x.shape[1]:
            raise ValueError(f"dilated_depth={dilated_depth} outside 1.."
                             f"{x.shape[1]} (x's planes)")


# fields of the FMA body's launch plan (``csrc/conv3.cu``, ``PlanField``)
PLAN_FIELDS = ("rw", "bd", "bh", "nrw", "cot", "ck", "split", "n_part",
               "threads", "smem", "pw", "pl", "blocks", "conflict")
# the tensor-core body's (``csrc/conv3_mma.cu``): M tiles a warp, brick
# depth, height and width, warps along N (24 channels each), chunk, split;
# then as above (the split and the partials' rows at the same places)
MMA_PLAN_FIELDS = ("tm", "bd", "bh", "bw", "wn", "ck", "split", "n_part",
                   "threads", "smem", "pw", "pl", "blocks", "conflict",
                   "chunks")
P_SPLIT, P_NPART = PLAN_FIELDS.index("split"), PLAN_FIELDS.index("n_part")
assert (MMA_PLAN_FIELDS.index("split"), MMA_PLAN_FIELDS.index("n_part")) \
    == (P_SPLIT, P_NPART)
_PLANS = {}


def _plan(entry, fields, shape, choice):
    """``entry``'s launch plan for the int arguments ``shape``, cached."""
    key = (entry, tuple(shape),
           None if choice is None else tuple(int(c) for c in choice))
    plan = _PLANS.get(key)
    if plan is None:
        plan = (ctypes.c_int * len(fields))()
        if choice is not None:
            plan[:len(choice)] = list(key[2])
        rc = getattr(_build.library().cdll, entry)(
            *(int(n) for n in key[1]), plan)
        if rc != 0:
            raise ValueError(f"conv3: no launch plan for {key[1]}, "
                             f"choice={choice} ({entry})")
        _PLANS[key] = plan
    return plan


def conv3_plan(sizes: Sequence[int], ci: int, co: int, mode: int,
               choice: Optional[Sequence[int]] = None):
    """The FMA body's launch plan (the 'float32' instance) for a ``sizes``
    = (D, H, W) input with ``ci`` channels, ``co`` outputs and ``mode`` (0
    stride 1, 1 stride 2, 2 dilation 2): a ctypes int array of
    ``PLAN_FIELDS``. The planner chooses it once per shape (cached);
    ``choice`` gives the first seven fields instead (W run, brick depth and
    height, runs along W, channel tile, chunk, split), as a sweep does.
    Raises where no plan fits."""
    return _plan("m3seg_conv3_plan", PLAN_FIELDS,
                 (*sizes, ci, co, mode), choice)


def conv3_mma_plan(sizes: Sequence[int], ci: int, co: int, mode: int,
                   choice: Optional[Sequence[int]] = None, passes: int = 1,
                   residual: bool = False):
    """The tensor-core body's launch plan (the 'bfloat16' and 'mixed'
    instances), as ``conv3_plan``: a ctypes int array of
    ``MMA_PLAN_FIELDS``; ``choice`` gives M tiles a warp (2 or 4), brick
    depth, height and width (a multiple of 8), warps along N, chunk (a
    multiple of 16 up to 96, or all of ci up to 96) and split (the K
    ranges, each of ceil(chunks / split) chunks, on blocks of their own;
    with 4 M tiles a warp a range holds at most 96 channels);
    ``passes``: the weight's, 1 ('bfloat16') or 2 ('mixed': hi and lo), by
    which the planner sizes its blocks; ``residual``: the call takes the
    residual tap, which reads a block's one chunk."""
    return _plan("m3seg_conv3_mma_plan", MMA_PLAN_FIELDS,
                 (*sizes, ci, co, mode, passes, int(bool(residual))), choice)


def _kept(t: torch.Tensor, name: str, make) -> torch.Tensor:
    """``make(t)``, kept on ``t`` under ``name`` and made again only when
    t's storage, version or dtype changes, so a model's parameters are
    converted once per weight version, not per call. Inference tensors
    carry no version counter: they are converted on every call."""
    if t.is_inference():
        return make(t)
    key = (t.data_ptr(), t._version, t.device, t.dtype)
    cached = getattr(t, name, None)
    if cached is None or cached[0] != key:
        with torch.no_grad():
            cached = (key, make(t.detach()))
        setattr(t, name, cached)
    return cached[1]


def _cached(owner, name: str, params, build):
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


def packed_weight(weight: torch.Tensor) -> torch.Tensor:
    """(co, ci, 3, 3, 3) -> the FMA body's (27 * ci, co) fp32 layout, row
    ((kz*3+ky)*3+kx)*ci + c, kept per weight version (``_kept``)."""
    co, ci = weight.shape[:2]
    return _kept(weight, "_m3seg_conv3_packed",
                 lambda w: w.permute(2, 3, 4, 1, 0).reshape(27 * ci, co).to(
                     torch.float32).contiguous())


def _widened(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A bf16 vector or matrix as the fp32 the kernel reads, kept per
    version (``_kept``); an fp32 one (or None) as it is."""
    if t is None or t.dtype == torch.float32:
        return t
    return _kept(t, "_m3seg_conv3_fp32", lambda v: v.float())


def hi_lo(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 -> (bf16 hi, bf16 lo), the reference's mantissa split
    (``kernels/_common.py::hi_lo``): hi + lo carries w's first 16
    significant bits. A bf16 w gives lo = 0."""
    hi = w.to(_BF16)
    return hi, (w.float() - hi.float()).to(_BF16)


def _fragments(b: torch.Tensor) -> torch.Tensor:
    """(taps, K, N) bf16 B matrices -> mma.sync's B fragments, K padded to
    16 and N to 24 (a warp's three n8 tiles) with zeros: (taps, K/16, N/8,
    8, 4, 2, 2), element [tap, ks, nt, g, t, half, j] = b[tap, 16 ks + 8
    half + 2 t + j, 8 nt + g], so lane 4g + t of a warp loads its two
    registers of n8 tile nt, k16 step ks as 8 contiguous bytes."""
    taps, k, n = b.shape
    kp, np_ = -(-k // 16) * 16, -(-n // 24) * 24
    b = F.pad(b, (0, np_ - n, 0, kp - k))
    f = b.reshape(taps, kp // 16, 2, 4, 2, np_ // 8, 8)
    return f.permute(0, 1, 5, 6, 3, 2, 4).contiguous()


def _passes(b: torch.Tensor) -> torch.Tensor:
    """(taps, K, N) -> the passes' fragments stacked: a bf16 b its values
    (one pass), an fp32 b its hi and lo parts (two)."""
    parts = (b,) if b.dtype == _BF16 else hi_lo(b.float())
    return torch.stack([_fragments(p) for p in parts])


def mma_weight(weight: torch.Tensor) -> torch.Tensor:
    """(co, ci, 3, 3, 3) -> the tensor-core body's packed weight: (passes,
    27, ceil(ci/16), 3 ceil(co/24), 8, 4, 2, 2) bf16 (``_fragments`` of each
    tap's (ci, co) matrix, tap (kz*3+ky)*3+kx); one pass of a bf16
    weight's values, two of an fp32 weight's hi and lo parts; kept per
    weight version and dtype (``_kept``)."""
    co, ci = weight.shape[:2]
    return _kept(weight, "_m3seg_conv3_mma", lambda w: _passes(
        w.permute(2, 3, 4, 1, 0).reshape(27, ci, co)))


def mma_res_weight(wr: torch.Tensor) -> torch.Tensor:
    """The residual tap's (co, ci) weight packed as ``mma_weight``'s one
    tap: (passes, 1, ceil(ci/16), 3 ceil(co/24), 8, 4, 2, 2)."""
    return _kept(wr, "_m3seg_conv3_mma_res", lambda w: _passes(
        w.t().unsqueeze(0)))


def _conv3_plain_flat(x, x2, weight, bias, scale, shift, res_weight,
                      res_bias, prologue_act, emit_stats, stride, dilation,
                      halo_keep, dilated_depth):
    """``conv3_plain`` over ``_Conv3``'s flat argument list
    (``halo_keep`` None: no halo)."""
    return conv3_plain(
        x, weight, bias, x2=x2,
        prologue=None if scale is None else (scale, shift),
        prologue_act=prologue_act,
        residual=None if res_weight is None else (res_weight, res_bias),
        emit_stats=emit_stats, stride=stride, dilation=dilation,
        halo=halo_keep is not None, halo_keep=halo_keep,
        dilated_depth=dilated_depth)


def flat_call(x, weight, bias, *, x2=None, prologue=None, residual=None,
              **opts):
    """A conv3 call as its tensors in ``_Conv3``'s flat order (x, x2,
    weight, bias, scale, shift, res_weight, res_bias; the absent ones left
    out) and ``bind(fn)``: a function of those tensors that calls ``fn``
    (``conv3`` or ``conv3_plain``) with the call's options."""
    scale, shift = prologue if prologue is not None else (None, None)
    res_weight, res_bias = residual if residual is not None else (None, None)
    flat = (x, x2, weight, bias, scale, shift, res_weight, res_bias)
    present = [i for i, t in enumerate(flat) if t is not None]

    def bind(fn):
        def call(*tensors):
            full = [None] * len(flat)
            for i, t in zip(present, tensors):
                full[i] = t
            x_, x2_, w_, b_, sc, sh, rw, rb = full
            return fn(x_, w_, b_, x2=x2_,
                      prologue=None if sc is None else (sc, sh),
                      residual=None if rw is None else (rw, rb), **opts)
        return call
    return [flat[i] for i in present], bind


_MODES = {(1, 1): 0, (2, 1): 1, (1, 2): 2}  # (stride, dilation) -> mode


def _ptr(t):
    return None if t is None else t.data_ptr()


def _conv3_forward(x, x2, weight, bias, scale, shift, res_weight, res_bias,
                   prologue_act, emit_stats, stride, dilation, halo_keep,
                   dilated_depth):
    """The kernel on CUDA tensors, ``conv3_plain`` on CPU ones (the
    arguments already checked), over ``_Conv3``'s flat argument list;
    ``halo_keep`` is the halo mode's (keep_first, keep_last) or None. The
    'float32' instance launches the FMA body, the bf16 instances the
    tensor-core body; both C entries finish the moments (a fixed-order
    float64 sum of the per-block partials)."""
    if x.device.type == "cpu":
        return _conv3_plain_flat(x, x2, weight, bias, scale, shift,
                                 res_weight, res_bias, prologue_act,
                                 emit_stats, stride, dilation, halo_keep,
                                 dilated_depth)
    dev = x.device
    inst = instance(x, weight)
    bf16 = inst != "float32"
    f32 = torch.float32
    for name, t, nd in (("x", x, 5), ("weight", weight, 5), ("bias", bias, 1),
                        ("x2", x2, 5), ("scale", scale, 1),
                        ("shift", shift, 1), ("res_weight", res_weight, 2),
                        ("res_bias", res_bias, 1)):
        if t is not None:
            # a bf16 instance takes its volumes bf16 and the rest bf16 or
            # fp32
            _build.check_cuda_input(name, t, dev, nd, (
                _BF16 if name in ("x", "x2") or t.dtype == _BF16 else f32)
                if bf16 else f32)
    c1, c2 = x.shape[-1], 0 if x2 is None else x2.shape[-1]
    ci, co = c1 + c2, weight.shape[0]
    if c1 % 4 or c2 % 4 or co % 4:
        raise ValueError(f"conv3 kernel needs channel counts that are "
                         f"multiples of 4 (c1={c1}, c2={c2}, co={co})")
    if x.numel() == 0:
        raise ValueError("empty input")
    x_ptr, x2_ptr = x.data_ptr(), _ptr(x2)
    if x_ptr % 16 or (x2_ptr or 0) % 16:
        raise ValueError("conv3 kernel needs 16-byte aligned inputs")

    _, d, h, w = x.shape[:4]
    halo = halo_keep is not None
    if halo:  # the kernel's depth is the interior's
        d -= 2
    dsrc = 0 if dilated_depth is None else int(dilated_depth)
    if dsrc:  # the iteration grid is the dilated one
        d = 2 * dsrc
    out_sz = conv3_out_size((d, h, w), stride, dilation)
    y = torch.empty((1,) + out_sz + (co,), dtype=x.dtype, device=dev)
    r = None if res_weight is None else torch.empty_like(y)
    mode = _MODES[(stride, dilation)]
    act = KERNEL_ACTS[prologue_act]
    # the kernel's forms of the weight-side tensors, packed and widened once
    # per weight version (``_kept``; an inference tensor's anew each call),
    # held here until the launch: the outputs allocated below may otherwise
    # take the memory of a form made for this call
    if bf16:
        wp = mma_weight(weight)
        rp = None if r is None else mma_res_weight(res_weight)
        held = (wp, rp) + tuple(map(_widened, (bias, scale, shift,
                                               res_bias)))
        plan = conv3_mma_plan((d, h, w), ci, co, mode, passes=wp.shape[0],
                              residual=r is not None)
        entry, head = "m3seg_conv3_bf16", (
            wp.data_ptr(), wp.shape[0], held[2].data_ptr(), _ptr(held[3]),
            _ptr(held[4]), act, _ptr(rp), 0 if rp is None else rp.shape[0],
            _ptr(held[5]))
    else:
        held = (packed_weight(weight),)
        plan = conv3_plan((d, h, w), ci, co, mode)
        entry, head = "m3seg_conv3", (
            held[0].data_ptr(), bias.data_ptr(), _ptr(scale), _ptr(shift),
            act, _ptr(res_weight), _ptr(res_bias))
    n_out = 1 if r is None else 2
    moms = []
    part = rpart = ws = scratch = None
    if emit_stats:  # the partials live until the launch is issued
        n_part = plan[P_NPART] * 2 * co
        scratch = torch.empty(n_out * n_part, dtype=f32, device=dev)
        part = scratch.data_ptr()
        rpart = None if r is None else part + 4 * n_part
        moms = [torch.empty((2, co), dtype=f32, device=dev)
                for _ in range(n_out)]
    if plan[P_SPLIT] > 1:  # K ranges split over blocks: partial sums
        ws = torch.empty((plan[P_SPLIT] * n_out,) + y.shape[1:], dtype=f32,
                         device=dev)
    name = (HALO_KERNEL if halo else "conv3") + INSTANCES[inst][1]
    _build.launch(name, entry, dev, x_ptr, x2_ptr, *head, y.data_ptr(),
                  _ptr(r), part, rpart, *(_ptr(m) for m in moms),
                  *((None,) * (2 - len(moms))), _ptr(ws), d, h, w, c1, c2,
                  co, mode, plan, halo_keep[0] | 2 * halo_keep[1] if halo
                  else -1, dsrc)
    del held, scratch  # launched: the stream orders any reuse of them
    outs = [y] if r is None else [y, r]
    outs += moms
    return outs[0] if len(outs) == 1 else tuple(outs)


class _Conv3(torch.autograd.Function):
    """conv3's forward (the kernel, or its plain twin on the CPU) over the
    flat argument list (x, x2, weight, bias, scale, shift, res_weight,
    res_bias; None where absent); the backward is the reference's
    ``_conv3_bwd``: a replay of ``conv3_plain`` under autograd. The moment
    sums are differentiable outputs: V-Net-DS's GroupNorm is built from
    them."""

    @staticmethod
    def forward(ctx, x, x2, weight, bias, scale, shift, res_weight, res_bias,
                prologue_act, emit_stats, stride, dilation, halo_keep,
                dilated_depth):
        ctx.opts = (prologue_act, emit_stats, stride, dilation, halo_keep,
                    dilated_depth)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, x2, weight, bias, scale, shift, res_weight,
                              res_bias)
        return _conv3_forward(x, x2, weight, bias, scale, shift, res_weight,
                              res_bias, *ctx.opts)

    @staticmethod
    def backward(ctx, *grads):
        got = _build.replay_grads(
            lambda *a: _conv3_plain_flat(*a, *ctx.opts), ctx.saved_tensors,
            ctx.needs_input_grad[:8], grads)
        return (*got, None, None, None, None, None, None)


def conv3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
          x2: Optional[torch.Tensor] = None,
          prologue: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
          prologue_act: Optional[str] = None,
          residual: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
          emit_stats: bool = False, stride: int = 1, dilation: int = 1,
          precision: Optional[str] = None,
          dilated_depth: Optional[int] = None, halo: bool = False,
          halo_keep=None):
    """k=3 conv + bias of a channels-last volume (options and instances in
    the module docstring).

    Args:
        x: (1, D, H, W, c1) fp32 or bf16; x2: optional (1, D, H, W, c2) in
            x's dtype.
        weight: (co, c1 + c2, 3, 3, 3) in torch's conv layout; bias (co,).
            With a bf16 x, a bf16 weight selects 'bfloat16' and an fp32 one
            'mixed'.
        precision: the reference's name of the instance, checked against
            the dtypes: 'highest' or 'bf16x3' (fp32 volumes; both run exact
            fp32), 'native' ('bfloat16') or 'mixed'; None (default) or
            'bf16x3' take the dtypes' instance.
        halo, halo_keep: the depth-sharded mode (module docstring); its
            launches count under ``conv3_halo`` (and the instance's
            suffix).
        dilated_depth: the depth-dilated mode (module docstring).

    Returns:
        y (1, Do, Ho, Wo, co) in x's dtype; with ``residual`` also r (1,
        Do, Ho, Wo, co); with ``emit_stats`` also the fp32 (2, co) moments
        of y (and of r), in the order of the reference's ``conv3_flat``. A
        CPU tensor runs ``conv3_plain``; a CUDA tensor launches the
        kernel's instance (contiguous, channel counts multiples of 4) or
        raises. Differentiable in every tensor argument in fp32, the
        moments included: the backward replays ``conv3_plain``. A bf16
        pass on fp32 volumes and a bf16 instance that autograd would
        record raise ``NotImplementedError`` naming their ROADMAP item.
    """
    scale, shift = prologue if prologue is not None else (None, None)
    res_weight, res_bias = residual if residual is not None else (None, None)
    _check_args(x, weight, bias, x2, prologue, prologue_act, residual,
                stride, dilation, precision, dilated_depth, halo, halo_keep)
    args = (x, x2, weight, bias, scale, shift, res_weight, res_bias,
            prologue_act, bool(emit_stats), stride, dilation,
            _keep_flags(halo_keep) if halo else None,
            None if dilated_depth is None else int(dilated_depth))
    if _build.needs_grad(*(t for t in args[:8] if t is not None)):
        if x.dtype == _BF16:
            not_ported(f"training conv3's {instance(x, weight)!r} instance "
                       "(serve under torch.no_grad or inference_mode)", 12)
        return _Conv3.apply(*args)
    return _conv3_forward(*args)
