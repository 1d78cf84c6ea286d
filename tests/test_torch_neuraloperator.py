"""The port's NeuralOperatorSeg (FNOSeg / HNOSeg: ``ops/spectral.py``'s real
FFT, ``ops/operators.py``, ``models/architectures.py``) against the JAX
package's, on the CPU.

Weights pass from JAX to torch through ``utils/jax_compat.py``; inputs are
made with numpy from a seed; the JAX side runs with ``ops/spectral.
PRECISION`` pinned to HIGHEST by ``monkeypatch`` (restored after each
test). Tolerances: 1e-5 for the transforms, the operators and the block
(fp32 on both sides, other summation orders); 3e-5 on the whole model's
probabilities (the bar of the HartleyMHASeg and V-Net-DS parity tests),
for the module path and for the kernel path (its plain versions on the
CPU, all three tower kernels) against the JAX module path.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_3d_image_segmentation_tpu.models import \
    architectures as jarch
from multimodal_3d_image_segmentation_tpu.ops import operators as jops
from multimodal_3d_image_segmentation_tpu.ops import spectral as jspectral
from multimodal_3d_image_segmentation_tpu.utils.torch_compat import \
    export_reference_state_dict
from multimodal_3d_image_segmentation_tpu_torch import kernels
from multimodal_3d_image_segmentation_tpu_torch.models import (
    HartleyMHASeg, NeuralOperatorBlock, NeuralOperatorSeg)
from multimodal_3d_image_segmentation_tpu_torch.ops import (operators,
                                                            spectral)
from multimodal_3d_image_segmentation_tpu_torch.runtime import config
from multimodal_3d_image_segmentation_tpu_torch.runtime.run import \
    _build_model
from multimodal_3d_image_segmentation_tpu_torch.utils.jax_compat import \
    state_dict_from_jax

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

REPO = Path(__file__).resolve().parent.parent
PROB_ATOL = 3e-5
SMALL = dict(in_channels=2, out_channels=3, filters=4, num_transform_blocks=2,
             num_modes=(2, 2, 2))
X_SHAPE = (1, 2, 12, 11, 9)
TRANSFORMS = ["Hartley", "Fourier"]


@pytest.fixture(autouse=True)
def _highest(monkeypatch):
    monkeypatch.setattr(jspectral, "PRECISION", jax.lax.Precision.HIGHEST)


def _x(shape=X_SHAPE, seed=41):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _gen():
    return torch.Generator().manual_seed(0)


def _load(module, params):
    module.load_state_dict(state_dict_from_jax(jax.device_get(params)),
                           strict=True)
    return module


def _run(module, x):
    with torch.no_grad():
        return module(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("shape,modes", [((1, 12, 11, 9, 3), (2, 3, 2)),
                                         ((2, 9, 8, 7, 2), (3, 2, 3)),
                                         ((1, 10, 13, 4, 3), (4, 5, 2))])
def test_rfft_crop_and_pad_inverse_match_jax(shape, modes):
    x = _x(shape, 1)
    jre, jim = jspectral.rfft_crop(jnp.asarray(x), modes)
    re, im = spectral.rfft_crop(torch.from_numpy(x), modes)
    assert re.shape == jre.shape == (shape[0], 2 * modes[0], 2 * modes[1],
                                     modes[2], shape[-1])
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), atol=1e-5, rtol=0)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim), atol=1e-5, rtol=0)
    want = jspectral.rfft_pad_inverse(jre, jim, shape[1:4])
    got = spectral.rfft_pad_inverse(re, im, shape[1:4])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_rfft_crop_is_numpys_rfftn_at_the_kept_modes():
    x = _x((1, 10, 9, 8, 2), 2)
    re, im = spectral.rfft_crop(torch.from_numpy(x).double(), (2, 3, 3))
    full = np.fft.rfftn(x.astype(np.float64), axes=(1, 2, 3), norm="forward")
    idx = (np.r_[0:2, 8:10], np.r_[0:3, 6:9], np.r_[0:3])
    want = full[:, idx[0]][:, :, idx[1]][:, :, :, idx[2]]
    np.testing.assert_allclose(re.numpy(), want.real, atol=1e-12)
    np.testing.assert_allclose(im.numpy(), want.imag, atol=1e-12)


@pytest.mark.parametrize("op,use_transform", [
    ("Hartley", True), ("Fourier", True), ("Fourier", False)])
def test_operators_match_jax(op, use_transform):
    jcls = jops.HartleyOperator if op == "Hartley" else jops.FourierOperator
    tcls = (operators.HartleyOperator if op == "Hartley"
            else operators.FourierOperator)
    x = _x((1, 9, 8, 7, 4), 3)
    if use_transform:
        jin, tin = jnp.asarray(x), torch.from_numpy(x)
    else:
        y = _x((1, 4, 4, 2, 4), 4)
        jin = (jnp.asarray(x[:, :4, :4, :2]), jnp.asarray(y))
        tin = (torch.from_numpy(x[:, :4, :4, :2].copy()), torch.from_numpy(y))
    kw = dict(use_transform=use_transform, snn_init=True)
    jm = jcls(4, 5, (2, 3, 2), **kw)
    params = jm.init(jax.random.PRNGKey(1), jin)["params"]
    want = jm.apply({"params": params}, jin)
    tm = tcls(4, 5, (2, 3, 2), **kw, generator=_gen())
    tm.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in params.items()}, strict=True)
    with torch.no_grad():
        got = tm(tin)
    for g, w in zip(*((got, want) if isinstance(got, tuple)
                      else ((got,), (want,)))):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("transform", TRANSFORMS)
@pytest.mark.parametrize("opts", [
    dict(), dict(activation="elu"),
    dict(use_block_concat=False, use_bias_conv_branch=True)],
    ids=["selu", "elu-groupnorm", "add-skip-bias"])
def test_block_matches_jax(transform, opts):
    x = _x((1, 8, 9, 7, 4), 6)
    jm = jarch.NeuralOperatorBlock(4, 4, (2, 3, 2), transform, **opts)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = _load(NeuralOperatorBlock(4, 4, (2, 3, 2), transform, **opts,
                                   generator=_gen()), params)
    np.testing.assert_allclose(_run(tm, x), want, atol=1e-5, rtol=0)


def _jax_model(transform, kw, x):
    jm = jarch.NeuralOperatorSeg(**SMALL, transform_type=transform, **kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros_like(x))["params"]
    return jm, params


MODEL_CASES = [dict(), dict(use_resize=False),
               dict(use_deep_supervision=True), dict(activation="elu")]
MODEL_IDS = ["default", "no-resize", "ds", "elu-groupnorm"]


@pytest.mark.parametrize("transform", TRANSFORMS)
@pytest.mark.parametrize("kw", MODEL_CASES, ids=MODEL_IDS)
def test_module_path_matches_jax_module_path(transform, kw):
    x = _x()
    jm, params = _jax_model(transform, kw, jnp.asarray(x))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = _load(NeuralOperatorSeg(**SMALL, transform_type=transform, **kw,
                                 generator=_gen()), params)
    got = _run(tm, x)
    assert got.shape == want.shape == X_SHAPE[:1] + (3,) + X_SHAPE[2:]
    np.testing.assert_allclose(got, want, atol=PROB_ATOL, rtol=0)


@pytest.mark.parametrize("transform", TRANSFORMS)
@pytest.mark.parametrize("tower_kernel", ["block_s", "block"])
@pytest.mark.parametrize("kw", [dict(), dict(use_resize=False),
                                dict(use_deep_supervision=True)],
                         ids=["default", "no-resize", "ds"])
def test_kernel_path_matches_jax_module_path(transform, tower_kernel, kw):
    """The kernel path (plain versions on the CPU, no launch) against the
    JAX module path, the reference's serving path at fp32."""
    x = _x()
    jm, params = _jax_model(transform, kw, jnp.asarray(x))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = _load(NeuralOperatorSeg(**SMALL, transform_type=transform, **kw,
                                 use_kernels=True, tower_kernel=tower_kernel,
                                 generator=_gen()), params)
    before = dict(kernels.LAUNCHES)
    got = _run(tm, x)
    assert kernels.LAUNCHES == before
    np.testing.assert_allclose(got, want, atol=PROB_ATOL, rtol=0)


@pytest.mark.parametrize("transform", TRANSFORMS)
@pytest.mark.parametrize("kw", [dict(), dict(use_resize=False)],
                         ids=["default", "no-resize"])
def test_resident_kernel_path_matches_jax_and_module_path(transform, kw):
    """tower_kernel='resident' (the whole tower in one resident_tower call,
    its plain version on the CPU) against the JAX module path with the
    exported weights and against the port's own module path."""
    x = _x()
    jm, params = _jax_model(transform, kw, jnp.asarray(x))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    fast = _load(NeuralOperatorSeg(**SMALL, transform_type=transform, **kw,
                                   use_kernels=True, tower_kernel="resident",
                                   generator=_gen()), params)
    plain = _load(NeuralOperatorSeg(**SMALL, transform_type=transform, **kw,
                                    generator=_gen()), params)
    before = dict(kernels.LAUNCHES)
    got = _run(fast, x)
    assert kernels.LAUNCHES == before
    np.testing.assert_allclose(got, want, atol=PROB_ATOL, rtol=0)
    np.testing.assert_allclose(got, _run(plain, x), atol=PROB_ATOL, rtol=0)


def test_resident_operands_stack_every_block():
    m = NeuralOperatorSeg(**SMALL, transform_type="Fourier", use_kernels=True,
                          tower_kernel="resident")
    ops, wcat, wcc, b = m.resident_operands()
    n, c = SMALL["num_transform_blocks"], SMALL["filters"]
    assert (ops.shape, wcat.shape, wcc.shape, b.shape) == (
        (n, 2, c, c), (n, 2 * c, c), (n, c, c), (n, 2 * c))
    for i, block in enumerate(m.layers):
        torch.testing.assert_close(ops[i, 1], block.op.weight_imag)
        for got, want in zip((wcat[i], wcc[i], b[i]), block.tower_weights()):
            torch.testing.assert_close(got, want)


def test_hartleymha_refuses_the_resident_tower():
    with pytest.raises(ValueError, match="NeuralOperatorSeg only"):
        HartleyMHASeg(2, 3, 4, 2, 2, (2, 2, 2), use_kernels=True,
                      tower_kernel="resident")


@pytest.mark.parametrize("transform", TRANSFORMS)
def test_kernel_path_clips_the_modes_like_the_module_path(transform):
    """A grid below 2 * num_modes: both paths clip the modes to half the
    grid (odd sizes, the Fourier KW then odd)."""
    kw = dict(SMALL, num_modes=(4, 5, 6), transform_type=transform)
    x = torch.from_numpy(_x((1, 2, 13, 11, 9), 8))
    plain = NeuralOperatorSeg(**kw, generator=_gen())
    fast = NeuralOperatorSeg(**kw, use_kernels=True)
    fast.load_state_dict(plain.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(fast(x), plain(x), rtol=0, atol=PROB_ATOL)


def test_float64_model_is_a_reference_for_the_fp32_kernel_path():
    x = torch.from_numpy(_x())
    m = NeuralOperatorSeg(**SMALL, transform_type="Fourier",
                          use_kernels=True)
    ref = NeuralOperatorSeg(**SMALL, transform_type="Fourier").double()
    ref.load_state_dict(m.state_dict())
    with torch.no_grad():
        got, want = m(x), ref(x.double())
    assert want.dtype == torch.float64 and got.dtype == torch.float32
    assert float((got.double() - want).abs().max()) < 1e-5


@pytest.mark.parametrize("transform", TRANSFORMS)
@pytest.mark.parametrize("kw", [dict(), dict(use_deep_supervision=True,
                                             activation="elu")],
                         ids=["selu", "ds-elu-groupnorm"])
def test_state_dict_keys_equal_the_reference_export(transform, kw):
    jm, params = _jax_model(transform, kw, jnp.asarray(_x()))
    ref = export_reference_state_dict(jm, params)
    got = state_dict_from_jax(jax.device_get(params))
    own = NeuralOperatorSeg(**SMALL, transform_type=transform,
                            **kw).state_dict()
    assert set(got) == set(ref) == set(own)
    for k, v in ref.items():
        if k.endswith("normalization.bias"):  # see ROADMAP §3: (1, C, 1..)
            v = v.reshape(-1)
        np.testing.assert_array_equal(got[k].numpy(), v)
        assert tuple(own[k].shape) == v.shape, k


@pytest.mark.parametrize("transform,n_params", [("Hartley", 57360),
                                                ("Fourier", 71184)])
def test_config_width_parameter_count(transform, n_params):
    m = NeuralOperatorSeg(4, 4, 24, 24, (10, 14, 14),
                          transform_type=transform, use_kernels=True)
    assert sum(p.numel() for p in m.parameters()) == n_params


class _Sizes:
    def get_num_x_modalities(self):
        return 4


@pytest.mark.parametrize("name,transform,n_params", [
    ("config_hnoseg.ini", "Hartley", 57360),
    ("config_fnoseg.ini", "Fourier", 71184)])
def test_build_model_from_the_config(name, transform, n_params):
    cfg = config.get_config(str(REPO / "configs" / name))
    model = _build_model(cfg, _Sizes(), lambda: (240, 240, 155))
    assert isinstance(model, NeuralOperatorSeg) and model.use_kernels
    assert model.transform_type == transform
    assert model.tower_kernel == "block"
    assert sum(p.numel() for p in model.parameters()) == n_params


@pytest.mark.parametrize("name", ["config_hnoseg.ini", "config_fnoseg.ini"])
def test_build_model_passes_the_tower_kernel_through(name):
    cfg = config.get_config(str(REPO / "configs" / name))
    cfg["model"]["tower_kernel"] = "resident"
    model = _build_model(cfg, _Sizes(), lambda: (240, 240, 155))
    assert model.tower_kernel == "resident" and model.use_kernels
    cfg["model"]["tower_kernel"] = "whole"
    with pytest.raises(ValueError, match="tower_kernel must be one of"):
        _build_model(cfg, _Sizes(), lambda: (240, 240, 155))


def test_kernel_path_refuses_batch_2():
    m = NeuralOperatorSeg(**SMALL, use_kernels=True)
    with pytest.raises(ValueError, match="batch 1"):
        with torch.no_grad():
            m(torch.zeros((2,) + X_SHAPE[1:]))


@pytest.mark.parametrize("opts,exc", [
    (dict(weights_type="individual"), NotImplementedError),
    (dict(ndim=4), NotImplementedError),
    (dict(compute_dtype="bfloat16"), NotImplementedError),
    (dict(use_kernels=True, activation="elu"), ValueError),
    (dict(use_kernels=True, use_block_concat=False), ValueError),
    (dict(use_kernels=True, use_bias_conv_branch=True), ValueError),
    (dict(use_kernels=True, channel_first_io=False), ValueError),
    (dict(tower_kernel="block_v3"), ValueError),
    (dict(transform_type="Cosine"), ValueError),
    (dict(tower_kernel="resident", use_deep_supervision=True), ValueError),
], ids=["individual", "2d", "bf16", "elu", "add-skip", "branch-bias",
        "channels-last", "tower-kernel", "transform", "resident-ds"])
def test_unported_options_raise(opts, exc):
    with pytest.raises(exc, match="ROADMAP" if exc is NotImplementedError
                       else None):
        NeuralOperatorSeg(**{**SMALL, **opts})


@pytest.mark.parametrize("cls", [operators.HartleyOperator,
                                 operators.FourierOperator])
def test_operator_bias_and_individual_weights_name_their_item(cls):
    for kw in (dict(use_bias=True), dict(weights_type="individual")):
        with pytest.raises(NotImplementedError, match="item 18"):
            cls(4, 4, (2, 2, 2), **kw, generator=_gen())
    with pytest.raises(ValueError, match="weights_type"):
        cls(4, 4, (2, 2, 2), weights_type="tied", generator=_gen())


@pytest.mark.parametrize("patch", [None, 2])
def test_hartleymha_block_s_kernel_path_matches_module_path(patch):
    """HartleyMHASeg's kernel path on tower_block_s (plain versions on the
    CPU; the attention reads the resident spectrum) against its module
    path and the JAX module path, with the deep-supervision rows."""
    kw = dict(in_channels=2, out_channels=3, filters=4,
              num_transform_blocks=2, num_heads=2, num_modes=(2, 2, 2),
              patch_size=patch)
    x = _x((1, 2, 12, 12, 10), 31)
    jm = jarch.HartleyMHASeg(**kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros_like(x))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    plain = _load(HartleyMHASeg(**kw, generator=_gen()), params)
    fast = _load(HartleyMHASeg(**kw, use_kernels=True, tower_kernel="block_s",
                               generator=_gen()), params)
    got = _run(fast, x)
    np.testing.assert_allclose(got, _run(plain, x), atol=PROB_ATOL, rtol=0)
    np.testing.assert_allclose(got, want, atol=PROB_ATOL, rtol=0)
