"""Fused trilinear upsample + softmax output tail, the port of
``multimodal_3d_image_segmentation_tpu/kernels/tail_resize.py``.

Every model family ends with conv_out at the small internal grid, a
trilinear resize (align_corners=False) to the image size, a center
pad/crop that is a no-op at that size, and a softmax over channels. The
CUDA kernel (``csrc/tail_resize.cu``: for fp32 logits a block per band
of output rows; for bf16 logits persistent blocks over (plane, band)
tiles, the next tile's logits copied while the current one's
probabilities are computed and stored) does the resize and the softmax in
one pass, reading the float64-derived tap tables of
``ops/resize.py::_linear_taps_np``; ``tail_plain`` is ``resize_linear``
(interpolation matrices) + ``torch.softmax``.

bf16 logits (``compute_dtype`` 'bfloat16' and 'mixed') take the
bf16-input instance, which widens each logit as it reads it and writes the
probabilities as fp32 or, with ``out_dtype=torch.bfloat16``, rounded once to
bf16, as the Pallas kernel keeps its softmax fp32 and casts to
``out_dtype``. ``tail_plain`` computes the same from the widened logits.

The backward pass is the reference's closed form (``_tail_bwd``) from the
saved fp32 probabilities y: ``gz = y * (g - sum_c y g)``, then the
transposed interpolation matrices take gz back to the input grid, axis by
axis (``ops/resize.py::resize_linear_transpose``).
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import device as _device  # noqa: F401  (fp32 policy)
from ..ops.resize import (_linear_taps_np, resize_linear,
                          resize_linear_transpose)
from . import _build

__all__ = ["fused_tail_softmax", "tail_plain", "tail_smem_bytes",
           "tail_supported", "phase_us", "PHASES"]

_MAX_CHANNELS = 8  # per-thread register bound in the kernel
_SMEM_BYTES = 232448  # shared memory a block may use on an H100
_MIN_BAND_ROWS = 4    # csrc/tail_resize.cu band: the fewest output rows a block
_STAGED_VOXELS = 1024  # csrc/tail_resize.cu band: 8 warps x 128 voxels
# csrc/tail_resize.cu, the bf16-logit instance: warps a block, bytes a warp
# stages a channel
_WARPS, _STAGE_BYTES = 8, 512


def _up16(n: int) -> int:
    return (n + 15) // 16 * 16


def tail_smem_bytes(c: int, rows: int, h: int, w: int, out_h: int,
                    out_w: int, in_bytes: int = 4) -> int:
    """Shared memory of a block of ``rows`` output rows, in bytes: the
    layouts of csrc/tail_resize.cu. fp32 logits (``in_bytes`` 4,
    ``band::tail_smem_floats``): the band's input rows along D or the
    staged probabilities, the W and H taps, the rows along H. bf16 logits
    (2, ``tail_smem``): the W taps; the stage: the D and H taps and the 2C
    spans of input rows, each its covering 16-byte words; the band's rows
    along H, C padded to 1, 2, 4 or 8; the staging room: each warp's
    probabilities or the rows along D. The CUDA tests hold both to the C
    side's ``m3seg_tail_smem_bytes``."""
    if in_bytes == 4:
        in_rows = min(h, (rows - 1) * h // out_h + 3)
        floats = (max(c * in_rows * w, c * _STAGED_VOXELS) + 3 * out_w
                  + 3 * rows + c * rows * w)
        return 4 * floats
    in_rows = min(h, ((rows - 1) * h + out_h - 1) // out_h + 2)
    stage = 16 + _up16(12 * rows) + 2 * c * _up16(14 + in_rows * w * 2)
    cp = c if c <= 2 else 4 if c <= 4 else 8
    staging = _up16(max(_WARPS * c * _STAGE_BYTES, 4 * c * in_rows * w))
    return _up16(8 * out_w) + stage + _up16(rows * w * cp * 4) + staging


def tail_supported(shape: Sequence[int], sizes: Sequence[int]) -> bool:
    """Routing predicate of the fused tail: batch 1, 1 <= C <= 8, 3D, no
    empty axis, and a block of the fp32-logit instance's fewest rows within
    the card's shared memory (``tail_smem_bytes``: input widths to about
    860 at C 8 and 1,650 at C 4 when the size is kept; the Pallas kernel's
    VMEM budget in its place); the bf16-logit instance's block of one row
    is never larger (``tests/test_torch_tail_plan.py``)."""
    if len(shape) != 5 or len(sizes) != 3:
        return False
    b, c = shape[:2]
    if not (b == 1 and 1 <= c <= _MAX_CHANNELS
            and min(*shape[2:], *(int(s) for s in sizes)) >= 1):
        return False
    return tail_smem_bytes(c, _MIN_BAND_ROWS, shape[3], shape[4],
                           int(sizes[1]), int(sizes[2])) <= _SMEM_BYTES


# the phases a tile, in the order the kernel's phase clock sums them
PHASES = ("wait", "D and H lerps", "W lerp, softmax, stores")


def phase_us():
    """The bf16-logit kernel's phase clock of its last launch (thread 0
    of each persistent block reads the card's globaltimer around each
    tile's phases): ({phase: mean us a tile} over the blocks' tiles, the
    launch's
    span in us from the first block's start to the last block's end,
    the mean us a block was resident, the grid). Waits for the device;
    launches nothing."""
    return _build.phase_clock("m3seg_tail_phase_ns", PHASES)


def tail_plain(x_cf: torch.Tensor, sizes: Sequence[int],
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Resize + softmax as plain tensor ops: the kernel's oracle and CPU
    path. bf16 logits are widened to fp32 first; the probabilities are
    returned as ``out_dtype`` (default: the logits' type, fp32 for bf16
    logits)."""
    if x_cf.dtype == torch.bfloat16:
        x_cf = x_cf.float()
    y = torch.softmax(resize_linear(x_cf, sizes, channel_first=True), dim=1)
    return y if out_dtype is None else y.to(out_dtype)


@functools.lru_cache(maxsize=None)
def _tap_tables(in_sizes: Tuple[int, ...], out_sizes: Tuple[int, ...],
                device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """int32 [lo_d, hi_d, lo_h, hi_h, lo_w, hi_w] and fp32 [w_d, w_h, w_w]
    on the device, uploaded once per shape."""
    idx, wts = [], []
    for n_in, n_out in zip(in_sizes, out_sizes):
        lo, hi, w_hi = _linear_taps_np(n_in, n_out)
        idx += [lo, hi]
        wts.append(w_hi)
    with torch.inference_mode(False):  # see ops/spectral.py::_stage_tensor
        taps = torch.from_numpy(np.concatenate(idx).astype(np.int32))
        w = torch.from_numpy(np.concatenate(wts).astype(np.float32))
        return taps.to(device), w.to(device)


def _tail_forward(x_cf: torch.Tensor, sizes: Tuple[int, ...],
                  out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """The kernel on a CUDA tensor, ``tail_plain`` on a CPU one."""
    if x_cf.device.type == "cpu":
        return tail_plain(x_cf, sizes, out_dtype)
    bf16 = x_cf.dtype == torch.bfloat16
    _build.check_cuda_input("x_cf", x_cf, x_cf.device, 5,
                            torch.bfloat16 if bf16 else torch.float32)
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    if out_dtype not in ((torch.float32, torch.bfloat16) if bf16
                         else (torch.float32,)):
        raise TypeError(f"fused tail has no instance for {x_cf.dtype} "
                        f"logits to {out_dtype} probabilities")
    _, c, d, h, w = x_cf.shape
    taps, wts = _tap_tables((d, h, w), sizes, x_cf.device)
    out = torch.empty((1, c) + sizes, dtype=out_dtype, device=x_cf.device)
    if bf16:
        _build.launch("tail_resize_bf16", "m3seg_tail_resize_softmax_bf16",
                      x_cf.device, x_cf.data_ptr(), out.data_ptr(),
                      int(out_dtype == torch.bfloat16), taps.data_ptr(),
                      wts.data_ptr(), c, d, h, w, *sizes)
    else:
        _build.launch("tail_resize", "m3seg_tail_resize_softmax",
                      x_cf.device, x_cf.data_ptr(), out.data_ptr(),
                      taps.data_ptr(), wts.data_ptr(), c, d, h, w, *sizes)
    return out


class _TailSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_cf, sizes, out_dtype):
        y = _tail_forward(x_cf, sizes, out_dtype)
        ctx.in_sizes = tuple(x_cf.shape[2:])
        ctx.in_dtype = x_cf.dtype
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors  # fp32 (or float64) probabilities
        # y (g - sum_c y g) in one launch, as autograd's softmax backward
        gz = torch._softmax_backward_data(g.to(y.dtype), y, 1, y.dtype)
        gz = resize_linear_transpose(gz, ctx.in_sizes, channel_first=True)
        return gz.to(ctx.in_dtype), None, None


def fused_tail_softmax(x_cf: torch.Tensor, sizes: Sequence[int],
                       out_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """(1, C, d, h, w) channel-first logits -> trilinear resize to
    ``sizes`` + softmax over C, (1, C, *sizes) in ``out_dtype`` (default
    fp32).

    A CPU tensor runs ``tail_plain``; a CUDA tensor launches the kernel
    (fp32 logits to fp32, or bf16 logits to fp32 or bf16; contiguous,
    ``tail_supported``) or raises. Differentiable: the backward is the
    closed form of the module docstring.
    """
    sizes = tuple(int(s) for s in sizes)
    if not tail_supported(tuple(x_cf.shape), sizes):
        raise ValueError(f"fused tail does not take {tuple(x_cf.shape)} -> "
                         f"{sizes} (batch 1, 1 <= C <= {_MAX_CHANNELS}, 3D, "
                         f"and a block of {_MIN_BAND_ROWS} output rows within "
                         f"{_SMEM_BYTES} bytes of shared memory)")
    if _build.needs_grad(x_cf):
        return _TailSoftmax.apply(x_cf, sizes, out_dtype)
    return _tail_forward(x_cf, sizes, out_dtype)
