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
    the flipped kernel in conv layout, output ``2n`` per axis.

``conv3_plain`` computes the same with ``F.conv3d`` /
``F.conv_transpose3d`` (cuDNN on the GPU, TF32 off) and torch ops: the
kernel's oracle and the CPU path.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import device as _device  # noqa: F401  (fp32 policy)
from .. import not_ported
from . import _build

__all__ = ["conv3", "conv3_plain", "conv3_out_size", "conv3_plan",
           "packed_weight", "KERNEL_ACTS", "PLAN_FIELDS"]

# prologue activation -> the kernel's code
KERNEL_ACTS = {None: 0, "none": 0, "elu": 1, "selu": 2, "relu": 3}
_PLAIN_ACTS = {"elu": F.elu, "selu": torch.selu, "relu": torch.relu}


def conv3_out_size(sizes: Sequence[int], stride: int = 1,
                   dilation: int = 1) -> Tuple[int, ...]:
    """Output (D, H, W) of a conv3 call on input ``sizes``."""
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


def conv3_plain(x, weight, bias, *, x2=None, prologue=None,
                prologue_act=None, residual=None, emit_stats=False,
                stride=1, dilation=1):
    """The conv and its options as plain tensor ops (``conv3``'s
    arguments and returns)."""
    xin = x if x2 is None else torch.cat([x, x2], dim=-1)
    xp = xin
    if prologue is not None:
        xp = xin * prologue[0] + prologue[1]
        act = _PLAIN_ACTS.get(prologue_act)
        if act is not None:
            xp = act(xp)
    xcf = xp.permute(0, 4, 1, 2, 3)
    if dilation == 2:
        y = F.conv_transpose3d(xcf, weight.flip(2, 3, 4).transpose(0, 1),
                               bias, stride=2, padding=1, output_padding=1)
    else:
        y = F.conv3d(xcf, weight, bias, stride=stride, padding=1)
    outs = [y.permute(0, 2, 3, 4, 1).contiguous()]
    if residual is not None:
        outs.append(F.linear(xin, residual[0], residual[1]))
    if emit_stats:
        outs += [_moments(t) for t in outs[:]]
    return outs[0] if len(outs) == 1 else tuple(outs)


def _check_args(x, weight, bias, x2, prologue, prologue_act, residual,
                stride, dilation, precision, dilated_depth, halo):
    if dilated_depth is not None:
        not_ported("conv3 dilated_depth (depth-only dilation)", 17)
    if halo:
        not_ported("conv3 halo (depth-sharded volumes)", 15)
    if precision not in ("highest", "bf16x3"):
        not_ported(f"conv3 precision={precision!r}", 12)
    if x.dtype in (torch.bfloat16, torch.float16):
        not_ported(f"conv3 on {x.dtype} volumes", 12)
    if x.dim() != 5 or x.shape[0] != 1:
        raise ValueError(f"x must be (1, D, H, W, C), got {tuple(x.shape)}")
    c1 = x.shape[-1]
    c2 = 0
    if x2 is not None:
        if x2.dim() != 5 or x2.shape[:4] != x.shape[:4]:
            raise ValueError(f"x2 {tuple(x2.shape)} does not match x "
                             f"{tuple(x.shape)}")
        c2 = x2.shape[-1]
    ci = c1 + c2
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
    return c1, c2, ci, co


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


def packed_weight(weight: torch.Tensor) -> torch.Tensor:
    """(co, ci, 3, 3, 3) -> the kernel's (27 * ci, co) layout, row
    ((kz*3+ky)*3+kx)*ci + c. The packed copy is kept on the weight tensor
    and made again only when the weight's storage or version changes, so a
    model's parameters are packed once per weight version, not per call.
    Inference tensors carry no version counter: they are packed on every
    call."""
    co, ci = weight.shape[:2]
    if weight.is_inference():
        return weight.permute(2, 3, 4, 1, 0).reshape(27 * ci, co).contiguous()
    key = (weight.data_ptr(), weight._version, weight.device)
    cached = getattr(weight, "_m3seg_conv3_packed", None)
    if cached is None or cached[0] != key:
        with torch.no_grad():
            packed = weight.detach().permute(2, 3, 4, 1, 0).reshape(
                27 * ci, co).contiguous()
        cached = (key, packed)
        weight._m3seg_conv3_packed = cached
    return cached[1]


def conv3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
          x2: Optional[torch.Tensor] = None,
          prologue: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
          prologue_act: Optional[str] = None,
          residual: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
          emit_stats: bool = False, stride: int = 1, dilation: int = 1,
          precision: str = "highest", dilated_depth: Optional[int] = None,
          halo: bool = False):
    """k=3 conv + bias of a channels-last volume (options in the module
    docstring).

    Args:
        x: (1, D, H, W, c1); x2: optional (1, D, H, W, c2).
        weight: (co, c1 + c2, 3, 3, 3) in torch's conv layout; bias (co,).
        precision: 'highest' or 'bf16x3' (the reference's fp32 modes) both
            run exact fp32.

    Returns:
        y (1, Do, Ho, Wo, co); with ``residual`` also r (1, Do, Ho, Wo,
        co); with ``emit_stats`` also the (2, co) moments of y (and of r),
        in the order of the reference's ``conv3_flat``. A CPU tensor runs
        ``conv3_plain``; a CUDA tensor launches the kernel (fp32,
        contiguous, channel counts multiples of 4) or raises. Forward only.
        The reference's ``dilated_depth``, ``halo`` and bf16 modes raise
        ``NotImplementedError`` naming their ROADMAP item.
    """
    c1, c2, ci, co = _check_args(x, weight, bias, x2, prologue,
                                 prologue_act, residual, stride, dilation,
                                 precision, dilated_depth, halo)
    kw = dict(x2=x2, prologue=prologue, prologue_act=prologue_act,
              residual=residual, emit_stats=emit_stats, stride=stride,
              dilation=dilation)
    if x.device.type == "cpu":
        return conv3_plain(x, weight, bias, **kw)
    dev = x.device
    tensors = {"x": (x, 5), "weight": (weight, 5), "bias": (bias, 1)}
    if x2 is not None:
        tensors["x2"] = (x2, 5)
    if prologue is not None:
        tensors.update(scale=(prologue[0], 1), shift=(prologue[1], 1))
    if residual is not None:
        tensors.update(res_weight=(residual[0], 2), res_bias=(residual[1], 1))
    for name, (t, nd) in tensors.items():
        _build.check_cuda_input(name, t, dev, nd)
    _build.check_forward_only(*(t for t, _ in tensors.values()))
    if c1 % 4 or c2 % 4 or co % 4:
        raise ValueError(f"conv3 kernel needs channel counts that are "
                         f"multiples of 4 (c1={c1}, c2={c2}, co={co})")
    if x.numel() == 0:
        raise ValueError("empty input")
    if any(t.data_ptr() % 16 for t in (x, x2) if t is not None):
        raise ValueError("conv3 kernel needs 16-byte aligned inputs")

    d, h, w = x.shape[1:4]
    out_sz = conv3_out_size((d, h, w), stride, dilation)
    y = torch.empty((1,) + out_sz + (co,), dtype=torch.float32, device=dev)
    r = torch.empty_like(y) if residual is not None else None
    w_packed = packed_weight(weight)
    mode = {(1, 1): 0, (2, 1): 1, (1, 2): 2}[(stride, dilation)]
    plan = conv3_plan((d, h, w), ci, co, mode)
    part = rpart = ws = None
    if emit_stats:
        part = torch.empty((plan[P_NPART], 2, co), dtype=torch.float32,
                           device=dev)
        if residual is not None:
            rpart = torch.empty_like(part)
    if plan[P_SPLIT] > 1:  # the chunks split over blocks: partial sums
        n_ws = plan[P_SPLIT] * (2 if residual is not None else 1)
        ws = torch.empty((n_ws,) + y.shape[1:], dtype=torch.float32,
                         device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    pro = prologue if prologue is not None else (None, None)
    res = residual if residual is not None else (None, None)
    _build.launch("conv3", "m3seg_conv3", dev, x.data_ptr(), ptr(x2),
                  w_packed.data_ptr(), bias.data_ptr(), ptr(pro[0]),
                  ptr(pro[1]), KERNEL_ACTS[prologue_act], ptr(res[0]),
                  ptr(res[1]),
                  y.data_ptr(), ptr(r), ptr(part), ptr(rpart), ptr(ws), d, h,
                  w, c1, c2, co, mode, plan)
    outs = [y] + ([r] if r is not None else [])
    if emit_stats:
        # the per-block partials, summed in float64 in a fixed order
        outs += [p.sum(0, dtype=torch.float64).float()
                 for p in (part, rpart) if p is not None]
    return outs[0] if len(outs) == 1 else tuple(outs)
