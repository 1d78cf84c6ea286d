"""Optimizers and learning-rate schedules, the port of
``multimodal_3d_image_segmentation_tpu/runtime/optim.py``.

As in the upstream ``experiments/run.py:89-103``: the optimizer is looked
up by name in ``torch.optim`` and takes the ``[optimizer]`` keys as its
keyword arguments, and the scheduler is stepped per batch, with
CosineAnnealingWarmRestarts' ``T_0`` defaulting to (train batches ×
epochs), a single cosine ramp over the run, unless ``restart_epochs`` or
``T_0`` is given.

The schedule is the reference's closed form, evaluated in float32 as the
JAX package evaluates it, and driven through a per-batch ``LambdaLR``:
the optimizer's step k (from 0) uses lr(k), as optax evaluates the
schedule at the update count before the update.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

__all__ = ["build_optimizer", "build_schedule", "lr_schedule",
           "cosine_annealing_warm_restarts"]

_OPTIMIZERS = {"Adamax": torch.optim.Adamax, "Adam": torch.optim.Adam,
               "AdamW": torch.optim.AdamW, "SGD": torch.optim.SGD,
               "RMSprop": torch.optim.RMSprop}
_F32 = np.float32


def cosine_annealing_warm_restarts(base_lr: float, t_0: int,
                                   eta_min: float = 0.0, t_mult: int = 1
                                   ) -> Callable[[int], float]:
    """torch's CosineAnnealingWarmRestarts as a function of the step:
    lr(t) = eta_min + (base - eta_min) (1 + cos(pi t_cur / T_i)) / 2 with
    restarts every T_i = T_0 t_mult^i steps."""
    if t_0 <= 0:
        raise ValueError(f"T_0 must be positive, got {t_0}")

    def schedule(step: int) -> float:
        if t_mult == 1:
            t_cur, t_i = _F32(step % t_0), _F32(t_0)
        else:  # the cycle found in integers, not by a float log
            start, t_i = 0, t_0
            while step >= start + t_i:
                start, t_i = start + t_i, t_i * t_mult
            t_cur, t_i = _F32(step - start), _F32(t_i)
        cos = np.cos(_F32(np.pi) * t_cur / t_i)
        return float(_F32(eta_min) + _F32(base_lr - eta_min)
                     * (_F32(1.0) + cos) / _F32(2.0))

    return schedule


def lr_schedule(scheduler_args: Optional[Dict[str, Any]], base_lr: float,
                steps_per_epoch: int, num_epochs: int
                ) -> Callable[[int], float]:
    """``[scheduler]`` section -> lr as a function of the step (batch)."""
    if not scheduler_args:
        return lambda step: base_lr
    args = dict(scheduler_args)
    name = args.pop("scheduler_name")
    if name == "CosineAnnealingWarmRestarts":
        if "restart_epochs" in args:
            t_0 = steps_per_epoch * args.pop("restart_epochs")
            args.pop("T_0", None)
        else:
            t_0 = args.pop("T_0", steps_per_epoch * num_epochs)
        fn = cosine_annealing_warm_restarts(
            base_lr, t_0, eta_min=args.pop("eta_min", 0.0),
            t_mult=args.pop("T_mult", 1))
    elif name == "CosineAnnealingLR":
        t_max = args.pop("T_max")
        alpha = _F32(args.pop("eta_min", 0.0) / max(base_lr, 1e-30))

        def fn(step):  # optax.cosine_decay_schedule
            cosine = _F32(0.5) * (_F32(1.0) + np.cos(
                _F32(np.pi) * _F32(min(step, t_max)) / _F32(t_max)))
            return float(_F32(base_lr) * ((_F32(1.0) - alpha) * cosine
                                          + alpha))
    elif name == "StepLR":
        size = args.pop("step_size") * steps_per_epoch
        gamma = _F32(args.pop("gamma", 0.1))

        def fn(step):  # optax.exponential_decay, staircase
            return float(_F32(base_lr) * gamma ** _F32(step // size))
    else:
        raise ValueError(f"Unknown scheduler {name!r}")
    if args:
        raise ValueError(f"Unsupported [scheduler] keys for {name!r}: "
                         f"{sorted(args)}")
    return fn


def build_schedule(optimizer: torch.optim.Optimizer,
                   scheduler_args: Optional[Dict[str, Any]], base_lr: float,
                   steps_per_epoch: int, num_epochs: int
                   ) -> torch.optim.lr_scheduler.LambdaLR:
    """A per-batch ``LambdaLR`` on ``optimizer`` (built with lr
    ``base_lr``) that sets lr(k) before the optimizer's step k: call its
    ``step()`` after each optimizer step."""
    fn = lr_schedule(scheduler_args, base_lr, steps_per_epoch, num_epochs)
    if base_lr == 0:
        return torch.optim.lr_scheduler.LambdaLR(optimizer, lambda k: 0.0)
    return torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda k: fn(k) / base_lr)


def build_optimizer(optimizer_args: Dict[str, Any], params
                    ) -> torch.optim.Optimizer:
    """``[optimizer]`` section -> ``torch.optim.<optimizer_name>`` with the
    other keys as its keyword arguments (lr defaults to 1e-3; AdamW's
    decay to torch's 1e-2). Adamax, Adam (``amsgrad`` too), AdamW, SGD and
    RMSprop are accepted; a key the optimizer does not take raises.

    Where torch and optax differ, the port follows torch, the upstream
    reference: Adamax adds eps inside its max (optax outside, a 1e-8
    difference on the denominator), and Adam's ``amsgrad`` keeps the
    largest raw second moment (optax the largest bias-corrected one)."""
    args = dict(optimizer_args)
    name = args.pop("optimizer_name")
    if name not in _OPTIMIZERS:
        raise ValueError(f"Unknown optimizer {name!r} (supported: "
                         f"{sorted(_OPTIMIZERS)})")
    cls = _OPTIMIZERS[name]
    args.setdefault("lr", 1e-3)
    accepted = set(inspect.signature(cls.__init__).parameters) - {
        "self", "params"}
    unknown = sorted(set(args) - accepted)
    if unknown:
        raise ValueError(f"Unsupported [optimizer] keys for {name!r}: "
                         f"{unknown}")
    if "betas" in args:
        args["betas"] = tuple(args["betas"])
    return cls(params, **args)
