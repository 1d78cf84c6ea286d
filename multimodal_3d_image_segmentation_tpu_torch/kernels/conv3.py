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
(both fp32, its 'highest' and 'bf16x3', exact fp32 products); 'bfloat16'
(x bf16, weight bf16: the reference's 'native', bf16 operands and fp32
sums) and 'mixed' (x bf16, weight fp32: a bf16 activation times an fp32
weight island, which the reference splits hi/lo for its MXU). In both bf16
instances the input is widened to fp32, the prologue runs in fp32 and its
output, the product's activation operand, is rounded to bf16; the products
are summed in fp32 and the bias (bf16 values in 'bfloat16', or fp32) is
added in fp32; y and r are written as bf16, and the moment sums are fp32
sums of the fp32 values before that rounding; at stride 2 they are sums of
the rounded outputs, as the reference's down conv takes its GroupNorm
moments from its decimated bf16 volume. The weights, biases, scale and shift may come in bf16 or
fp32; the kernel reads them widened to fp32. The plain twin of a bf16
instance (``conv3_plain`` on a bf16 x) computes in fp32 from the bf16
values and rounds where the kernel rounds; ``acc=float64`` sums in float64
instead (the precision gate's twins64 path). The bf16 instances serve only:
a forward that autograd would record raises (ROADMAP item 12).
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
           "flat_call", "packed_weight", "instance", "INSTANCES",
           "KERNEL_ACTS", "PLAN_FIELDS"]

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


# fields of the kernel's launch plan (``csrc/conv3.cu``, ``PlanField``)
PLAN_FIELDS = ("rw", "bd", "bh", "nrw", "cot", "ck", "split", "n_part",
               "threads", "smem", "pw", "pl", "blocks", "conflict")
P_SPLIT, P_NPART = PLAN_FIELDS.index("split"), PLAN_FIELDS.index("n_part")
_PLANS = {}


def conv3_plan(sizes: Sequence[int], ci: int, co: int, mode: int,
               choice: Optional[Sequence[int]] = None):
    """The kernel's launch plan for a ``sizes`` = (D, H, W) input with
    ``ci`` channels, ``co`` outputs and ``mode`` (0 stride 1, 1 stride 2,
    2 dilation 2): a ctypes int array of ``PLAN_FIELDS``. The planner
    chooses it once per shape (cached); ``choice`` gives the first seven
    fields instead (W run, brick depth and height, runs along W, channel
    tile, chunk, split), as a sweep does. Raises where no plan fits."""
    key = (tuple(int(n) for n in sizes), int(ci), int(co), int(mode),
           None if choice is None else tuple(int(c) for c in choice))
    plan = _PLANS.get(key)
    if plan is None:
        plan = (ctypes.c_int * len(PLAN_FIELDS))()
        if choice is not None:
            plan[:len(choice)] = list(key[4])
        rc = _build.library().cdll.m3seg_conv3_plan(*key[0], ci, co, mode,
                                                    plan)
        if rc != 0:
            raise ValueError(f"conv3: no launch plan for {key[0]}, ci={ci}, "
                             f"co={co}, mode={mode}, choice={choice}")
        _PLANS[key] = plan
    return plan


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


def packed_weight(weight: torch.Tensor) -> torch.Tensor:
    """(co, ci, 3, 3, 3) -> the kernel's (27 * ci, co) fp32 layout, row
    ((kz*3+ky)*3+kx)*ci + c (a bf16 weight widened: its values exactly),
    kept per weight version and dtype (``_kept``)."""
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


def _conv3_forward(x, x2, weight, bias, scale, shift, res_weight, res_bias,
                   prologue_act, emit_stats, stride, dilation, halo_keep,
                   dilated_depth):
    """The kernel on CUDA tensors, ``conv3_plain`` on CPU ones (the
    arguments already checked), over ``_Conv3``'s flat argument list;
    ``halo_keep`` is the halo mode's (keep_first, keep_last) or None."""
    if x.device.type == "cpu":
        return _conv3_plain_flat(x, x2, weight, bias, scale, shift,
                                 res_weight, res_bias, prologue_act,
                                 emit_stats, stride, dilation, halo_keep,
                                 dilated_depth)
    dev = x.device
    inst = instance(x, weight)
    bf16 = inst != "float32"
    tensors = {"x": (x, 5), "weight": (weight, 5), "bias": (bias, 1)}
    if x2 is not None:
        tensors["x2"] = (x2, 5)
    if scale is not None:
        tensors.update(scale=(scale, 1), shift=(shift, 1))
    if res_weight is not None:
        tensors.update(res_weight=(res_weight, 2), res_bias=(res_bias, 1))
    for name, (t, nd) in tensors.items():
        # a bf16 instance takes its volumes bf16 and the rest bf16 or fp32
        dtype = (_BF16 if name in ("x", "x2") or t.dtype == _BF16
                 else torch.float32) if bf16 else torch.float32
        _build.check_cuda_input(name, t, dev, nd, dtype)
    if bf16:  # the kernel reads the weight-side vectors as fp32
        bias, scale, shift, res_weight, res_bias = map(
            _widened, (bias, scale, shift, res_weight, res_bias))
    c1, c2 = x.shape[-1], 0 if x2 is None else x2.shape[-1]
    ci, co = c1 + c2, weight.shape[0]
    if c1 % 4 or c2 % 4 or co % 4:
        raise ValueError(f"conv3 kernel needs channel counts that are "
                         f"multiples of 4 (c1={c1}, c2={c2}, co={co})")
    if x.numel() == 0:
        raise ValueError("empty input")
    if any(t.data_ptr() % 16 for t in (x, x2) if t is not None):
        raise ValueError("conv3 kernel needs 16-byte aligned inputs")

    d, h, w = x.shape[1:4]
    halo = halo_keep is not None
    if halo:  # the kernel's depth is the interior's
        d -= 2
    dsrc = 0 if dilated_depth is None else int(dilated_depth)
    if dsrc:  # the iteration grid is the dilated one
        d = 2 * dsrc
    out_sz = conv3_out_size((d, h, w), stride, dilation)
    y = torch.empty((1,) + out_sz + (co,), dtype=x.dtype, device=dev)
    r = torch.empty_like(y) if res_weight is not None else None
    w_packed = packed_weight(weight)
    mode = {(1, 1): 0, (2, 1): 1, (1, 2): 2}[(stride, dilation)]
    plan = conv3_plan((d, h, w), ci, co, mode)
    part = rpart = ws = None
    if emit_stats:
        part = torch.empty((plan[P_NPART], 2, co), dtype=torch.float32,
                           device=dev)
        if res_weight is not None:
            rpart = torch.empty_like(part)
    if plan[P_SPLIT] > 1:  # the chunks split over blocks: partial sums
        n_ws = plan[P_SPLIT] * (2 if res_weight is not None else 1)
        ws = torch.empty((n_ws,) + y.shape[1:], dtype=torch.float32,
                         device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = (x.data_ptr(), ptr(x2), w_packed.data_ptr(), bias.data_ptr(),
            ptr(scale), ptr(shift), KERNEL_ACTS[prologue_act],
            ptr(res_weight), ptr(res_bias), y.data_ptr(), ptr(r), ptr(part),
            ptr(rpart), ptr(ws), d, h, w, c1, c2, co, mode, plan,
            halo_keep[0] | 2 * halo_keep[1] if halo else -1, dsrc)
    name = (HALO_KERNEL if halo else "conv3") + INSTANCES[inst][1]
    _build.launch(name, "m3seg_conv3_bf16" if bf16 else "m3seg_conv3", dev,
                  *args)
    outs = [y] + ([r] if r is not None else [])
    if emit_stats:
        # the per-block partials, summed in float64 in a fixed order
        outs += [p.sum(0, dtype=torch.float64).float()
                 for p in (part, rpart) if p is not None]
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
    _check_args(x, weight, bias, x2, prologue, prologue_act, residual,
                stride, dilation, precision, dilated_depth, halo, halo_keep)
    scale, shift = prologue if prologue is not None else (None, None)
    res_weight, res_bias = residual if residual is not None else (None, None)
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
