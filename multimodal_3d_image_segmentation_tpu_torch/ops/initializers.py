"""Parameter initializers matching the reference's distributions, the port
of ``multimodal_3d_image_segmentation_tpu/ops/initializers.py``.

Each factory takes an explicit fan_in and returns ``init(shape, generator)``;
the generator is required so that every random init is seeded by the
caller. Values are drawn on the CPU (the generator's device) and moved by
the caller with the module.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

__all__ = ["kaiming_uniform_a5", "kaiming_normal_linear", "torch_conv_bias",
           "snn_bias"]


def _uniform(shape: Sequence[int], lo: float, hi: float,
             generator: torch.Generator) -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32)
    return lo + (hi - lo) * u


def kaiming_uniform_a5(fan_in: int):
    """U(-b, b) with b = 1/sqrt(fan_in) (kaiming_uniform with a=sqrt(5))."""
    bound = 1.0 / math.sqrt(fan_in)

    def init(shape, generator: torch.Generator) -> torch.Tensor:
        return _uniform(shape, -bound, bound, generator)

    return init


def kaiming_normal_linear(fan_in: int):
    """N(0, 1/fan_in) (kaiming_normal with linear nonlinearity, gain 1)."""
    std = 1.0 / math.sqrt(fan_in)

    def init(shape, generator: torch.Generator) -> torch.Tensor:
        return std * torch.randn(tuple(shape), generator=generator,
                                 dtype=torch.float32)

    return init


def torch_conv_bias(fan_in: int):
    """PyTorch conv bias default: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    return kaiming_uniform_a5(fan_in)


def snn_bias():
    """U(-0.001, 0.001) bias for self-normalizing networks."""

    def init(shape, generator: torch.Generator) -> torch.Tensor:
        return _uniform(shape, -0.001, 0.001, generator)

    return init
