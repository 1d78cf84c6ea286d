"""Serving step, the port of
``multimodal_3d_image_segmentation_tpu/runtime/steps.py::make_predict_step``."""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["make_predict_step"]


def make_predict_step(model: torch.nn.Module
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Forward + argmax to uint8 labels on the device (upstream
    ``experiments/train_test.py:395-410``), so only the small label volume
    crosses back to the host. Runs under ``torch.inference_mode``: the
    CUDA kernels are forward-only."""

    def step(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return torch.argmax(model(x), dim=1).to(torch.uint8)

    return step
