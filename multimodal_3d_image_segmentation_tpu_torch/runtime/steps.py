"""Train, eval and predict steps, the port of
``multimodal_3d_image_segmentation_tpu/runtime/steps.py``.

Label remap and one-hot happen on the device inside the step, so the host
ships only the raw integer labels. The train and eval steps return the
loss as a device scalar: the loop reads it back once an epoch, not once a
step.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..utils.labels import remap_labels, to_categorical

__all__ = ["make_train_step", "make_eval_step", "make_predict_step"]


def make_train_step(model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer,
                    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler],
                    loss_fn: Callable, num_labels: int,
                    label_mapping: Optional[Dict[int, int]] = None
                    ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """(x, y) -> loss: remap and one-hot the labels, forward, loss,
    backward, one optimizer step, then one scheduler step (per batch)."""

    def step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        y1h = to_categorical(remap_labels(y, label_mapping), num_labels)
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model(x), y1h)
        loss.backward()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return loss.detach()

    return step


def make_eval_step(model: torch.nn.Module, loss_fn: Callable,
                   num_labels: int,
                   label_mapping: Optional[Dict[int, int]] = None
                   ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """(x, y) -> loss under ``torch.no_grad()``: not inference mode, whose
    tensors an autograd graph of a later train step could not save."""

    def step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            y1h = to_categorical(remap_labels(y, label_mapping), num_labels)
            return loss_fn(model(x), y1h)

    return step


def make_predict_step(model: torch.nn.Module
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Forward + argmax to uint8 labels on the device (upstream
    ``experiments/train_test.py:395-410``), so only the small label volume
    crosses back to the host. Runs under ``torch.inference_mode``."""

    def step(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return torch.argmax(model(x), dim=1).to(torch.uint8)

    return step
