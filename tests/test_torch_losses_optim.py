"""The port's losses, one-hot labels, schedules and optimizers against the
JAX package's, on the CPU.

Tolerances: losses 1e-6 (fp32 sums over a small volume); the schedule
1e-6 relative (both evaluate the closed form in float32, the port in
numpy, the JAX package in XLA); parameters after 50 steps of the same
gradient sequence 1e-6 of their largest magnitude, at least 1 (torch's
Adamax adds eps inside its max, optax outside: a 1e-8 difference on a
denominator of about 1; AdamW decays before its update, optax with it:
fp32 rounding of a few ulp on parameters of magnitude 3).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from multimodal_3d_image_segmentation_tpu import losses as jlosses
from multimodal_3d_image_segmentation_tpu.runtime import optim as joptim
from multimodal_3d_image_segmentation_tpu.utils.labels import \
    to_categorical as j_to_categorical
from multimodal_3d_image_segmentation_tpu_torch import losses
from multimodal_3d_image_segmentation_tpu_torch.runtime import optim
from multimodal_3d_image_segmentation_tpu_torch.utils.labels import \
    to_categorical

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6


def _pair(shape=(2, 4, 9, 8, 7), seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal(shape).astype(np.float32)
    y_pred = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    labels = rng.integers(0, shape[1], (shape[0], 1) + shape[2:])
    return y_pred.astype(np.float32), labels.astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 4, 9, 8, 7), (1, 3, 10, 6)])
def test_to_categorical_matches_jax(shape):
    _, labels = _pair(shape)
    got = to_categorical(torch.from_numpy(labels), shape[1])
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_to_categorical(jnp.asarray(labels),
                                                 shape[1])))


@pytest.mark.parametrize("name,kwargs", [
    ("PCCLoss", {}), ("DiceLoss", {}), ("ExpDiceLoss", {}),
    ("ExpDiceLoss", {"exp": 0.5}), ("CrossEntropyLoss", {}),
    ("cross_entropy", {"weight": [0.1, 1.0, 2.0, 0.5]}),
])
def test_losses_match_jax(name, kwargs):
    y_pred, labels = _pair()
    y_true = np.asarray(j_to_categorical(jnp.asarray(labels), 4))
    want = float(jlosses.get_loss(name, **dict(kwargs))(
        jnp.asarray(y_pred), jnp.asarray(y_true)))
    y_true = np.array(y_true)  # writable, for torch
    got = float(losses.get_loss(name, **dict(kwargs))(
        torch.from_numpy(y_pred), torch.from_numpy(y_true)))
    assert abs(got - want) <= 1e-6, (got, want)


def test_loss_coefficients_match_jax():
    y_pred, labels = _pair(seed=1)
    y_true = np.array(j_to_categorical(jnp.asarray(labels), 4))
    for fn in ("corrcoef", "dice_coef"):
        np.testing.assert_allclose(
            getattr(losses, fn)(torch.from_numpy(y_pred),
                                torch.from_numpy(y_true)).numpy(),
            np.asarray(getattr(jlosses, fn)(jnp.asarray(y_pred),
                                            jnp.asarray(y_true))),
            atol=1e-6)


def test_unknown_losses_and_arguments_raise():
    with pytest.raises(ValueError, match="Unknown loss"):
        losses.get_loss("HingeLoss")
    with pytest.raises(ValueError, match="cross-entropy args"):
        losses.get_loss("CrossEntropyLoss", reduction="sum")


SCHEDULES = [
    ({"scheduler_name": "CosineAnnealingWarmRestarts", "eta_min": 1e-3},
     5e-3, 4, 6),                       # the configs': T_0 = 24 steps
    ({"scheduler_name": "CosineAnnealingWarmRestarts", "eta_min": 1e-4,
      "restart_epochs": 2}, 1e-2, 5, 9),
    ({"scheduler_name": "CosineAnnealingWarmRestarts", "T_0": 7}, 1e-3, 3,
     4),
    ({"scheduler_name": "CosineAnnealingLR", "T_max": 20, "eta_min": 1e-4},
     2e-3, 3, 5),
    ({"scheduler_name": "StepLR", "step_size": 2, "gamma": 0.5}, 1e-3, 3,
     5),
    (None, 3e-3, 3, 5),
]


@pytest.mark.parametrize("args,base_lr,spe,epochs", SCHEDULES)
def test_schedule_matches_jax(args, base_lr, spe, epochs):
    """Three times T_0 (or the run) of steps, read from the optimizer as
    the port's per-batch LambdaLR sets it before each step."""
    want_fn = joptim.build_schedule(args, base_lr, spe, epochs)
    n = 3 * spe * epochs
    p = torch.nn.Parameter(torch.zeros(()))
    opt = torch.optim.SGD([p], lr=base_lr)
    sched = optim.build_schedule(opt, args, base_lr, spe, epochs)
    for k in range(n):
        got = opt.param_groups[0]["lr"]
        want = float(want_fn(k)) if callable(want_fn) else want_fn
        assert got == pytest.approx(want, rel=1e-6, abs=0), k
        opt.step()
        sched.step()


def test_schedule_restarts_with_t_mult():
    fn = optim.lr_schedule({"scheduler_name": "CosineAnnealingWarmRestarts",
                            "T_0": 3, "T_mult": 2}, 1.0, 1, 1)
    # cycles of 3, 6, 12 steps: the lr is back at its base at 0, 3 and 9
    assert [fn(k) for k in (0, 3, 9)] == [1.0, 1.0, 1.0]
    assert fn(2) < fn(1) < 1.0 and fn(8) < fn(4)


@pytest.mark.parametrize("name,extra", [
    ("Adamax", {}), ("Adam", {}), ("Adam", {"weight_decay": 1e-2}),
    ("AdamW", {}), ("SGD", {"momentum": 0.9, "nesterov": True}),
])
def test_optimizer_matches_optax(name, extra):
    """50 steps fed one seeded gradient sequence, under the configs'
    cosine schedule, against the JAX package's optax chain."""
    cfg = {"optimizer_name": name, "lr": 5e-3, **extra}
    sched_args = {"scheduler_name": "CosineAnnealingWarmRestarts",
                  "eta_min": 1e-3}
    rng = np.random.default_rng(3)
    p0 = rng.standard_normal((6, 5)).astype(np.float32)
    grads = rng.standard_normal((50, 6, 5)).astype(np.float32)

    tx = joptim.build_optimizer(
        cfg, joptim.build_schedule(sched_args, 5e-3, 10, 5))
    pj = jnp.asarray(p0)
    state = tx.init(pj)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, updates)

    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = optim.build_optimizer(cfg, [p])
    sched = optim.build_schedule(opt, sched_args, 5e-3, 10, 5)
    for g in grads:
        p.grad = torch.from_numpy(g)
        opt.step()
        sched.step()
    want = np.asarray(pj)
    np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                               atol=1e-6 * max(1.0, np.abs(want).max()))


def test_optimizer_keys():
    p = [torch.nn.Parameter(torch.zeros(2))]
    opt = optim.build_optimizer({"optimizer_name": "AdamW"}, p)
    assert opt.defaults["weight_decay"] == 1e-2 and opt.defaults["lr"] == 1e-3
    opt = optim.build_optimizer({"optimizer_name": "Adam", "amsgrad": True,
                                 "betas": [0.8, 0.9]}, p)
    assert opt.defaults["amsgrad"] and opt.defaults["betas"] == (0.8, 0.9)
    with pytest.raises(ValueError, match="Unsupported"):
        optim.build_optimizer({"optimizer_name": "Adamax", "amsgrad": True},
                              p)
    with pytest.raises(ValueError, match="Unsupported"):
        optim.build_optimizer({"optimizer_name": "SGD", "momentun": 0.9}, p)
    with pytest.raises(ValueError, match="Unknown optimizer"):
        optim.build_optimizer({"optimizer_name": "LBFGS"}, p)
    with pytest.raises(ValueError, match="Unknown scheduler"):
        optim.lr_schedule({"scheduler_name": "OneCycleLR"}, 1e-3, 1, 1)
