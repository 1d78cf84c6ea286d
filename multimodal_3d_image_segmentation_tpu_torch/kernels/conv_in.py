"""Fused input-downsampling convolution (k=2, s=2, pad=1) + bias (+ SELU),
the port of ``multimodal_3d_image_segmentation_tpu/kernels/conv_in.py``.

The learnable 2x input resize reads the channel-first input and emits the
channels-last half-resolution grid in one pass. One CUDA kernel per input
type covers both Pallas variants (even and odd D/H): the fp32 instance
(``csrc/conv_in.cu``, a block per band of output rows staged in shared
memory, fmaf products) reads the weight in its torch layout;
``conv_in_plain`` is ``F.conv3d`` (cuDNN on the GPU, TF32 off) + SELU,
the reference's ``_reference_xla``.

A bf16 input (``compute_dtype`` 'bfloat16' or 'mixed') takes the bf16
instance (``csrc/conv_in_mma.cu``: persistent blocks, the raw bf16 spans
copied a band ahead, the products on the bf16 tensor cores): fp32
weights (in 'bfloat16' the caller passes them rounded through bf16, as
the reference's ``_isl`` does), packed once per weight version into
fragment order as one bf16 part a weight where they are bf16 values and
three (``parts3``, exact) where not (``mma_weight``); exact products,
fp32 sums, a bf16 output, as the Pallas kernel raises its operands per
tap and writes the input's dtype. Its plain twin is ``conv_in_plain`` in
fp32 on the widened input, rounded to bf16 at the end.

The backward pass is the reference's (``_conv_in_bwd``): a replay of
``conv_in_plain`` under autograd, which gives the gradients of x, weight
and bias (cuDNN's backward on the GPU, TF32 off).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import device as _device  # noqa: F401  (fp32 policy)
from . import _build
from .conv3 import _kept
from .tower_block import _b_fragments, parts3

__all__ = ["conv_in_s2d", "conv_in_plain", "SUPPORTED_FEATURES",
           "mma_weight", "phase_us", "PHASES"]

# template instances in the .cu: the configs' width 24, and 8 for tests
SUPPORTED_FEATURES = (8, 24)
_MAX_SMEM_BYTES = 48 * 1024


def conv_in_plain(x_cf: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor, apply_selu: bool = True
                  ) -> torch.Tensor:
    """The conv as plain tensor ops: the kernel's oracle and CPU path. It
    computes in the weight's type, at least fp32, and returns the input's
    type (a bf16 input is widened, and the output rounded once)."""
    dt = torch.promote_types(weight.dtype, torch.float32)
    y = F.conv3d(x_cf.to(dt), weight.to(dt), bias.to(dt), stride=2,
                 padding=1)
    if apply_selu:
        y = torch.selu(y)
    return y.permute(0, 2, 3, 4, 1).contiguous().to(x_cf.dtype)


def _mma_pack(weight: torch.Tensor) -> torch.Tensor:
    """(F, C, 2, 2, 2) -> the tensor-core instance's B fragments of the
    (K, F) matrix, K = 8 C in the order (c, kz, ky, kx) padded to 16:
    (ceil(C/2), F/8, NP, 8, 4, 2, 2) bf16, [k step][n tile][part][lane]
    with lane 4g + t's 4 values 8 contiguous bytes (``_b_fragments``); NP
    = 1 where every weight is a bf16 value, else 3 (``parts3``: hi, mid,
    lo, whose sum is the fp32 weight)."""
    f, c = weight.shape[:2]
    k = weight.float().permute(1, 2, 3, 4, 0).reshape(8 * c, f)
    parts = parts3(k)
    if not (bool(parts[1].any()) or bool(parts[2].any())):
        parts = parts[:1]
    return torch.stack([_b_fragments(p) for p in parts], dim=2)


def mma_weight(weight: torch.Tensor) -> torch.Tensor:
    """The bf16 instance's packed weight (``_mma_pack``), kept per weight
    version (``conv3._kept``); its dim 2 is the number of parts."""
    return _kept(weight, "_m3seg_conv_in_mma", _mma_pack)


# the bf16 instance's phases a band, in the order its phase clock sums them
PHASES = ("wait", "products", "stores")


def phase_us():
    """The bf16 instance's phase clock of its last launch (thread 0 of
    each persistent block reads the card's globaltimer around each band's
    phases): ({phase: mean us a band} over the blocks' bands, the launch's
    span in us from the first block's start to the last block's end, the
    mean us a block was resident, the grid). Waits for the device;
    launches nothing."""
    return _build.phase_clock("m3seg_conv_in_phase_ns", PHASES)


def _conv_in_forward(x_cf, weight, bias, apply_selu):
    """The kernel on a CUDA tensor, ``conv_in_plain`` on a CPU one."""
    if x_cf.device.type == "cpu":
        return conv_in_plain(x_cf, weight, bias, apply_selu)
    bf16 = x_cf.dtype == torch.bfloat16
    _build.check_cuda_input("x_cf", x_cf, x_cf.device, 5,
                            torch.bfloat16 if bf16 else torch.float32)
    _build.check_cuda_input("weight", weight, x_cf.device, 5)
    _build.check_cuda_input("bias", bias, x_cf.device, 1)
    b, c, d, h, w = x_cf.shape
    f = weight.shape[0]
    if f not in SUPPORTED_FEATURES:
        raise ValueError(f"conv_in kernel has no instance for F={f} "
                         f"(supported: {SUPPORTED_FEATURES})")
    # the fp32 instance keeps its weights in shared memory as fp32
    if not bf16 and 4 * (8 * c * f + f) > _MAX_SMEM_BYTES:
        raise ValueError(f"C={c}, F={f} weights exceed the kernel's shared "
                         "memory")
    if x_cf.numel() == 0:
        raise ValueError("empty input")
    out = torch.empty((b, d // 2 + 1, h // 2 + 1, w // 2 + 1, f),
                      dtype=x_cf.dtype, device=x_cf.device)
    if bf16:
        # the packed weight stays referenced here until after the launch
        packed = mma_weight(weight)
        _build.launch("conv_in_bf16", "m3seg_conv_in_bf16", x_cf.device,
                      x_cf.data_ptr(), packed.data_ptr(), packed.shape[2],
                      bias.data_ptr(), out.data_ptr(), b, c, d, h, w, f,
                      int(bool(apply_selu)))
        return out
    # the kernel reads the weight in its torch layout (F, C, kz, ky, kx)
    _build.launch("conv_in", "m3seg_conv_in", x_cf.device,
                  x_cf.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                  out.data_ptr(), b, c, d, h, w, f, int(bool(apply_selu)))
    return out


class _ConvIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_cf, weight, bias, apply_selu):
        ctx.apply_selu = apply_selu
        ctx.save_for_backward(x_cf, weight, bias)
        return _conv_in_forward(x_cf, weight, bias, apply_selu)

    @staticmethod
    def backward(ctx, g):
        grads = _build.replay_grads(
            lambda *a: conv_in_plain(*a, ctx.apply_selu), ctx.saved_tensors,
            ctx.needs_input_grad[:3], (g,))
        return (*grads, None)


def conv_in_s2d(x_cf: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor, apply_selu: bool = True
                ) -> torch.Tensor:
    """k=2/s=2/pad=1 conv + bias (+ SELU unless ``apply_selu`` is False,
    as V-Net-DS applies GroupNorm + ELU outside).

    Args:
        x_cf: channel-first input (B, C, D, H, W).
        weight: (F, C, 2, 2, 2) conv weight (torch layout).
        bias: (F,).

    Returns:
        Channels-last (B, D//2+1, H//2+1, W//2+1, F) in x's type. A CPU
        tensor runs ``conv_in_plain``; a CUDA tensor launches the kernel
        (x fp32 or bf16, weight and bias fp32, contiguous, F in
        ``SUPPORTED_FEATURES``; one output row and its input rows (two
        stages of them in the bf16 instance) must fit a block's 227 KB of
        shared memory, about (16 C + 2 F) W bytes, W <= 2,000 at C = 4, F
        = 24) or raises.
        Differentiable: the backward replays ``conv_in_plain``.
    """
    if x_cf.dim() != 5:
        raise ValueError(f"x_cf must be (B, C, D, H, W), got "
                         f"{tuple(x_cf.shape)}")
    b, c, d, h, w = x_cf.shape
    f = weight.shape[0]
    if tuple(weight.shape) != (f, c, 2, 2, 2) or tuple(bias.shape) != (f,):
        raise ValueError(f"weight {tuple(weight.shape)} / bias "
                         f"{tuple(bias.shape)} do not fit C={c}")
    if _build.needs_grad(x_cf, weight, bias):
        return _ConvIn.apply(x_cf, weight, bias, bool(apply_selu))
    return _conv_in_forward(x_cf, weight, bias, bool(apply_selu))
