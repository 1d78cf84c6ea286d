"""The port's training path on the CPU: one step of each family
(HNOSeg-XS, V-Net-DS, HartleyMHASeg, HNOSeg and FNOSeg on their three
tower kernels) against the JAX package, and serving then training in one
process. (The kernel Functions' backward passes are held to ``jax.vjp`` in
``tests/test_torch_backward.py`` and ``tests/test_torch_backward_item19.py``.)

On a CPU tensor each kernel wrapper runs its plain forward, and its
``torch.autograd.Function`` runs the same backward as on the card. The
JAX side runs at 'highest' (pinned, as ``tests/test_runtime.py`` leaves
'high' behind).

Tolerance: one model step's loss and gradients within 1e-4 of each
tensor's largest magnitude, at least 1 (eight blocks of DFT chains at
random init, as ``tests/test_torch_hnosegxs.py`` holds the forward to
1e-4).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from multimodal_3d_image_segmentation_tpu import losses as jlosses
from multimodal_3d_image_segmentation_tpu import models as jmodels
from multimodal_3d_image_segmentation_tpu.ops import spectral as jspectral
from multimodal_3d_image_segmentation_tpu.utils.labels import \
    to_categorical as j_to_categorical
from multimodal_3d_image_segmentation_tpu_torch import kernels
from multimodal_3d_image_segmentation_tpu_torch.kernels import \
    tower_block as tb
from multimodal_3d_image_segmentation_tpu_torch.losses import PCCLoss
from multimodal_3d_image_segmentation_tpu_torch.models import (
    HartleyMHASeg, HNOSegXS, NeuralOperatorSeg, VNetDS)
from multimodal_3d_image_segmentation_tpu_torch.ops import resize, spectral
from multimodal_3d_image_segmentation_tpu_torch.runtime.steps import (
    make_eval_step, make_predict_step, make_train_step)
from multimodal_3d_image_segmentation_tpu_torch.utils.jax_compat import \
    state_dict_from_jax
from multimodal_3d_image_segmentation_tpu_torch.utils.labels import \
    to_categorical

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

STEP_RTOL = 1e-4
# filters 8 and one conv a block: blocks 5-7 take the U-Net skip, so they
# run their mapping conv
SMALL = dict(in_channels=2, out_channels=4, filters=8,
             num_transform_blocks=[1] * 8, num_modes=(3, 4, 4))
SMALL_SHAPE = (1, 2, 16, 16, 12)


@pytest.fixture
def highest(monkeypatch):
    monkeypatch.setattr(jspectral, "PRECISION", jax.lax.Precision.HIGHEST)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want, rtol):
    want = np.asarray(want)
    atol = rtol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=atol)


# ------------------------------------------------------ one model step

def _jax_small(kw=SMALL, seed=0):
    jm = jmodels.HNOSegXS(**kw)
    x = _rand(SMALL_SHAPE, 11)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    y = np.random.default_rng(12).integers(0, 4, (1, 1) + SMALL_SHAPE[2:])
    return jm, params, x, y.astype(np.float32)


def _port_small(params, use_kernels):
    tm = HNOSegXS(**SMALL, use_kernels=use_kernels)
    tm.load_state_dict(state_dict_from_jax(jax.device_get(params)),
                       strict=True)
    return tm


@pytest.fixture(scope="module")
def jax_step():
    """The JAX module path's loss and gradients on the small model (traced
    once for both port paths)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jspectral, "PRECISION", jax.lax.Precision.HIGHEST)
        jm, params, x, y = _jax_small()
        y1h = j_to_categorical(jnp.asarray(y), 4)
        loss, grads = jax.value_and_grad(
            lambda p: jlosses.pcc_loss(jm.apply({"params": p},
                                                jnp.asarray(x)), y1h))(params)
        return (params, x, y, np.asarray(loss),
                state_dict_from_jax(jax.device_get(grads)))


@pytest.mark.parametrize("use_kernels", [True, False])
def test_model_step_loss_and_gradients_match_jax(use_kernels, jax_step):
    params, x, y, loss_j, want = jax_step
    tm = _port_small(params, use_kernels)
    loss = PCCLoss()(tm(torch.from_numpy(x)),
                     to_categorical(torch.from_numpy(y), 4))
    loss.backward()
    _close(loss.detach().numpy(), loss_j, STEP_RTOL)
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for k, v in want.items():
        _close(got[k].grad.numpy(), v.numpy(), STEP_RTOL)


# one PCC-loss step of each other family, small widths: the JAX module
# path (family -> JAX class, port class, arguments, input shape)
FAMILY_MODELS = {
    # every conv3 mode: the residual tap, stride 2, dilation 2, (up, skip)
    "VNetDS": (jmodels.VNetDS, VNetDS, dict(
        in_channels=2, out_channels=4, base_num_filters=4,
        num_blocks=[1, 1], right_leg_indexes=[0, 1]), (1, 2, 12, 12, 10)),
    "HartleyMHASeg": (jmodels.HartleyMHASeg, HartleyMHASeg, dict(
        in_channels=2, out_channels=4, filters=4, num_transform_blocks=2,
        num_heads=2, num_modes=(2, 2, 2), patch_size=2), (1, 2, 12, 12, 10)),
    **{f"{t[0]}NOSeg{ds}": (jmodels.NeuralOperatorSeg, NeuralOperatorSeg,
                            dict(in_channels=2, out_channels=4, filters=4,
                                 num_transform_blocks=2, num_modes=(2, 2, 2),
                                 transform_type=t,
                                 use_deep_supervision=bool(ds)),
                            (1, 2, 12, 11, 9))
       for t in ("Hartley", "Fourier") for ds in ("", "-ds")},
}
# case -> (family, the port's path)
FAMILY_STEPS = {
    "VNetDS-kernels": ("VNetDS", dict(use_kernels=True)),
    "VNetDS-plain": ("VNetDS", dict()),
    "HartleyMHASeg-ds-kernels": ("HartleyMHASeg", dict(use_kernels=True)),
    **{f"{f}-{k}": (f, dict(use_kernels=True, tower_kernel=k))
       for f in ("HNOSeg", "FNOSeg") for k in ("block", "block_s",
                                               "resident")},
    "HNOSeg-ds-block": ("HNOSeg-ds", dict(use_kernels=True)),
    "FNOSeg-ds-block_s": ("FNOSeg-ds", dict(use_kernels=True,
                                            tower_kernel="block_s")),
}


@pytest.fixture(scope="module")
def family_steps():
    """family -> the JAX module path's loss and gradients (traced once per
    family, for all of the port's paths)."""
    cache = {}

    def get(family):
        if family not in cache:
            jcls, _, kw, shape = FAMILY_MODELS[family]
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jspectral, "PRECISION", jax.lax.Precision.HIGHEST)
                jm = jcls(**kw)
                x = _rand(shape, 21)
                y = np.random.default_rng(22).integers(
                    0, 4, (1, 1) + shape[2:]).astype(np.float32)
                params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                          jnp.asarray(x))["params"]
                y1h = j_to_categorical(jnp.asarray(y), 4)
                loss, grads = jax.jit(jax.value_and_grad(
                    lambda p: jlosses.pcc_loss(
                        jm.apply({"params": p}, jnp.asarray(x)), y1h)))(
                    params)
                conv = (dict(num_blocks=kw["num_blocks"])
                        if family == "VNetDS" else {})
                cache[family] = (
                    state_dict_from_jax(jax.device_get(params), **conv), x,
                    y, np.asarray(loss),
                    state_dict_from_jax(jax.device_get(grads), **conv))
        return cache[family]
    return get


@pytest.mark.parametrize("case", sorted(FAMILY_STEPS))
def test_family_step_loss_and_gradients_match_jax(case, family_steps):
    """One PCC-loss step of the port's model (its kernel path runs each
    kernel Function's plain forward and its backward on the CPU) against
    ``jax.value_and_grad`` of the JAX module path at 'highest'."""
    family, path = FAMILY_STEPS[case]
    weights, x, y, loss_j, want = family_steps(family)
    _, cls, kw, _ = FAMILY_MODELS[family]
    tm = cls(**kw, **path)
    tm.load_state_dict(weights, strict=True)
    before = dict(kernels.LAUNCHES)
    loss = PCCLoss()(tm(torch.from_numpy(x)),
                     to_categorical(torch.from_numpy(y), 4))
    loss.backward()
    assert kernels.LAUNCHES == before  # CPU tensors: no launch
    _close(loss.detach().numpy(), loss_j, STEP_RTOL)
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].grad is not None, k
        _close(got[k].grad.numpy(), v.numpy(), STEP_RTOL)


def test_sgd_steps_match_optax(highest):
    """Three SGD steps with momentum through the port's train step against
    optax on the JAX module path: the parameters within 1e-4 of each
    tensor's largest magnitude. (Under Adamax a near-zero gradient's sign
    decides a full lr-sized step, so its multi-step parameters are not
    compared.)"""
    jm, params, x, y = _jax_small()
    tx = optax.sgd(0.05, momentum=0.9)
    state = tx.init(params)
    y1h = j_to_categorical(jnp.asarray(y), 4)
    grad_fn = jax.grad(lambda p: jlosses.pcc_loss(
        jm.apply({"params": p}, jnp.asarray(x)), y1h))
    tm = _port_small(params, True)
    opt = torch.optim.SGD(tm.parameters(), lr=0.05, momentum=0.9)
    step = make_train_step(tm, opt, None, PCCLoss(), 4)
    for _ in range(3):
        updates, state = tx.update(grad_fn(params), state, params)
        params = optax.apply_updates(params, updates)
        step(torch.from_numpy(x), torch.from_numpy(y))
    want = state_dict_from_jax(jax.device_get(params))
    got = tm.state_dict()
    for k, v in want.items():
        _close(got[k].numpy(), v.numpy(), STEP_RTOL)


def test_eval_step_is_the_loss_without_a_graph():
    tm = HNOSegXS(**SMALL)
    x = torch.from_numpy(_rand(SMALL_SHAPE, 13))
    y = torch.from_numpy(np.random.default_rng(14).integers(
        0, 4, (1, 1) + SMALL_SHAPE[2:]).astype(np.float32))
    loss = make_eval_step(tm, PCCLoss(), 4, {3: 2})(x, y)
    assert not loss.requires_grad and not loss.is_inference()
    with torch.no_grad():
        want = PCCLoss()(tm(x), to_categorical(torch.where(y == 3, 2, y), 4))
    assert float(loss) == pytest.approx(float(want), rel=1e-6)


# ------------------------------------------- serving, then training

def _clear_device_caches():
    """The matrices are cached per process: clear them, so that serving
    below builds them first, as it does in a fresh process."""
    for fn in (spectral._stage_tensor, resize._linear_matrix, tb._stage):
        fn.cache_clear()


FAMILIES = {
    "HNOSegXS-kernels": lambda: HNOSegXS(**SMALL, use_kernels=True),
    "HNOSegXS-plain": lambda: HNOSegXS(**SMALL),
    "VNetDS-plain": lambda: VNetDS(2, 4, 4, [1, 1],
                                   right_leg_indexes=[0, 1]),
    "VNetDS-kernels": lambda: VNetDS(2, 4, 4, [1, 1],
                                     right_leg_indexes=[0, 1],
                                     use_kernels=True),
    "HartleyMHASeg-kernels": lambda: HartleyMHASeg(
        2, 4, 4, 2, 2, (2, 2, 2), patch_size=2, use_kernels=True),
    "HNOSeg-block": lambda: NeuralOperatorSeg(
        2, 4, 4, 2, (2, 2, 2), "Hartley", use_kernels=True),
    "HNOSeg-resident": lambda: NeuralOperatorSeg(
        2, 4, 4, 2, (2, 2, 2), "Hartley", use_kernels=True,
        tower_kernel="resident"),
    "FNOSeg-block_s": lambda: NeuralOperatorSeg(
        2, 4, 4, 2, (2, 2, 2), "Fourier", use_kernels=True,
        tower_kernel="block_s"),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_serving_then_training_in_one_process(family):
    """Serving (under inference mode) builds the cached DFT, interpolation
    and stage matrices first; a train step afterwards saves them for its
    backward pass. Before they were built outside inference mode, this
    step raised "Inference tensors cannot be saved for backward"."""
    _clear_device_caches()
    model = FAMILIES[family]()
    x = torch.from_numpy(_rand(SMALL_SHAPE, 15))
    y = torch.from_numpy(np.random.default_rng(16).integers(
        0, 4, (1, 1) + SMALL_SHAPE[2:]).astype(np.float32))
    labels = make_predict_step(model)(x)
    assert labels.shape == (1,) + SMALL_SHAPE[2:]
    before = [p.detach().clone() for p in model.parameters()]
    opt = torch.optim.Adamax(model.parameters(), lr=1e-3)
    loss = make_train_step(model, opt, None, PCCLoss(), 4)(x, y)
    assert np.isfinite(float(loss))
    assert any(not torch.equal(a, p) for a, p in
               zip(before, model.parameters()))
