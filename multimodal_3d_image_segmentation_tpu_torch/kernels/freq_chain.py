"""Fused frequency-resident convolution chain of HNOSeg-XS, the port of
``multimodal_3d_image_segmentation_tpu/kernels/freq_chain.py``.

The HNO-XS block applies n channel-mixing convolutions with identity skips
and SELU on the packed corner spectrum (upstream ``nets/hnosegxs.py``)::

    x <- selu(x @ W_k^T + x),  k = 1..n

Every frequency point is independent (the weights are shared across
modes), so the spectrum is a set of rows of C channels. The CUDA kernel
(``csrc/freq_chain.cu``) spreads each row over two lanes of a warp and
keeps it in shared memory through the whole chain, reading the weights in
their torch layout; ``freq_chain_plain`` is the same chain in PyTorch.

bf16 rows (``compute_dtype`` 'bfloat16') take the bf16 instance with bf16
weights, as the reference casts the weights to the rows' dtype: each stage
sums in fp32 on the exact bf16 values, applies the SELU in fp32 and rounds
its output to bf16 before the next stage, as the Pallas kernel does.
``freq_chain_plain`` computes the same on bf16 rows.

The backward pass is the reference's closed form (``_fused_rows_bwd``):
replay the chain in plain ops keeping each stage's input x_k and
pre-activation p_k, then from the last stage to the first
``dp = dx * selu'(p_k)``, ``dW_k = dpᵀ x_k``, ``dx = dp W_k + dp``.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from .. import device as _device  # noqa: F401  (fp32 policy)
from ._common import SELU_ALPHA, SELU_SCALE
from . import _build

__all__ = ["fused_freq_chain", "freq_chain_plain", "SUPPORTED_CHANNELS",
           "MAX_CHAIN"]

# template instances in the .cu: the configs' width 24, and 8 for tests
SUPPORTED_CHANNELS = (8, 24)
MAX_CHAIN = 8  # weight pointers the kernel takes (kMaxChain in the .cu)
_MAX_WEIGHT_BYTES = 48 * 1024  # dynamic shared memory without opt-in


def freq_chain_plain(x: torch.Tensor, weights: Sequence[torch.Tensor]
                     ) -> torch.Tensor:
    """The chain as plain tensor ops: the kernel's oracle and CPU path. On
    bf16 rows each stage runs in fp32 and rounds its output to bf16."""
    if x.dtype == torch.bfloat16:
        for w in weights:
            xf = x.float()
            x = torch.selu(F.linear(xf, w.float()) + xf).to(torch.bfloat16)
        return x
    for w in weights:
        x = torch.selu(F.linear(x, w) + x)
    return x


def _chain_backward(x2d: torch.Tensor, weights: Sequence[torch.Tensor],
                    g: torch.Tensor):
    """(dx, [dW_k]) of the chain on rows ``x2d`` (N, C) for the output
    gradient ``g`` (N, C): the closed form of the reference's
    ``_fused_rows_bwd``, in as few launches as it allows (the step is
    bound by the host's time per op): x Wᵀ + x and dp W + dp as one
    ``addmm`` each, ``dx * selu'(p)`` as one ``elu_backward`` (selu'(p) =
    scale for p > 0, else scale alpha e^p, as the reference writes it)."""
    xs, pres = [x2d], []
    for k, w in enumerate(weights):
        pres.append(torch.addmm(xs[k], xs[k], w.t()))
        if k + 1 < len(weights):
            xs.append(torch.selu(pres[k]))
    dx, dws = g, [None] * len(weights)
    for k in range(len(weights) - 1, -1, -1):
        dpre = torch.ops.aten.elu_backward(dx, SELU_ALPHA, SELU_SCALE, 1.0,
                                           False, pres[k])
        dws[k] = dpre.t() @ xs[k]          # (out, in), as the weight
        dx = torch.addmm(dpre, dpre, weights[k])
    return dx, dws


def _chain_forward(x: torch.Tensor, weights: Sequence[torch.Tensor]
                   ) -> torch.Tensor:
    """The kernel on a CUDA tensor, ``freq_chain_plain`` on a CPU one."""
    if x.device.type == "cpu":
        return freq_chain_plain(x, weights)
    c = x.shape[-1]
    dt = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    for i, w in enumerate(weights):
        _build.check_cuda_input(f"weights[{i}]", w, x.device, 2, dt)
    _build.check_cuda_input("x", x, x.device, x.dim(), dt)
    if c not in SUPPORTED_CHANNELS:
        raise ValueError(f"freq_chain kernel has no instance for C={c} "
                         f"(supported: {SUPPORTED_CHANNELS})")
    if 4 * len(weights) * c * c > _MAX_WEIGHT_BYTES:  # fp32 in both
        raise ValueError(f"{len(weights)} weights of {c}x{c} exceed the "
                         "kernel's shared memory")
    if len(weights) > MAX_CHAIN:
        raise ValueError(f"freq_chain kernel takes at most {MAX_CHAIN} "
                         f"weights, got {len(weights)}")
    n_rows = x.numel() // c
    out = torch.empty_like(x)
    if n_rows == 0:
        return out
    # the kernel reads each W_k (out, in) in place: one pointer per weight
    ptrs = (ctypes.c_void_p * len(weights))(*(w.data_ptr() for w in weights))
    kernel = "freq_chain_bf16" if dt == torch.bfloat16 else "freq_chain"
    _build.launch(kernel, f"m3seg_{kernel}", x.device, x.data_ptr(), ptrs,
                  out.data_ptr(), n_rows, c, len(weights))
    return out


class _FreqChain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *weights):
        ctx.save_for_backward(x, *weights)
        return _chain_forward(x, weights)

    @staticmethod
    def backward(ctx, g):
        x, *weights = ctx.saved_tensors
        c = x.shape[-1]
        dx, dws = _chain_backward(x.reshape(-1, c), weights,
                                  g.reshape(-1, c))
        return (dx.reshape(x.shape),
                *(dw if need else None
                  for dw, need in zip(dws, ctx.needs_input_grad[1:])))


def fused_freq_chain(x: torch.Tensor, weights: Sequence[torch.Tensor]
                     ) -> torch.Tensor:
    """Apply the chain to a channels-last packed spectrum (B, *modes, C).

    ``weights`` are (out, in) matrices with out == in == C. A CPU tensor
    runs ``freq_chain_plain``; a CUDA tensor launches the kernel (rows and
    weights all fp32 or all bf16, contiguous, C in ``SUPPORTED_CHANNELS``,
    at most ``MAX_CHAIN`` weights) or raises. Differentiable: the backward
    is the closed form of the module docstring, in plain ops on either
    device.
    """
    c = x.shape[-1]
    for w in weights:
        if tuple(w.shape) != (c, c):
            raise ValueError("fused chain requires square shared weights "
                             f"({c}, {c}), got {tuple(w.shape)}")
    if not weights:  # a 0-conv chain is the identity
        return x
    if _build.needs_grad(x, *weights):
        return _FreqChain.apply(x, *weights)
    return _chain_forward(x, weights)
