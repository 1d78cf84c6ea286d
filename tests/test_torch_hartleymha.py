"""The port's HartleyMHASeg (``ops/attention.py``, ``models/architectures.py``)
against the JAX package's, on the CPU.

Weights pass from JAX to torch through ``utils/jax_compat.py``; inputs are
made with numpy from a seed; the JAX side runs with ``ops/spectral.
PRECISION`` pinned to HIGHEST by ``monkeypatch``. Tolerances: 1e-5 for the
attention module and the block (fp32 on both sides, other summation
orders); 3e-5 on the whole model's probabilities (the bar of the V-Net-DS
parity tests); 2e-4 absolute and 1e-3 relative between the port's kernel
path and the JAX fused path, whose Pallas kernel computes packed bf16x3
products (the bar of ``tests/test_tower_kernel.py``).
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_3d_image_segmentation_tpu.models import \
    architectures as jarch
from multimodal_3d_image_segmentation_tpu.ops import attention as jattn
from multimodal_3d_image_segmentation_tpu.ops import spectral as jspectral
from multimodal_3d_image_segmentation_tpu.utils.torch_compat import \
    export_reference_state_dict
from multimodal_3d_image_segmentation_tpu_torch import kernels
from multimodal_3d_image_segmentation_tpu_torch.models import (
    HartleyMHABlock, HartleyMHASeg)
from multimodal_3d_image_segmentation_tpu_torch.ops import attention
from multimodal_3d_image_segmentation_tpu_torch.runtime import config
from multimodal_3d_image_segmentation_tpu_torch.runtime.run import \
    _build_model
from multimodal_3d_image_segmentation_tpu_torch.utils.jax_compat import \
    state_dict_from_jax

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

REPO = Path(__file__).resolve().parent.parent
PROB_ATOL = 3e-5
CONFIG_WIDTH = dict(in_channels=4, out_channels=4, filters=24,
                    num_transform_blocks=16, num_heads=4,
                    num_modes=(8, 12, 12), patch_size=2)
SMALL = dict(in_channels=2, out_channels=3, filters=4,
             num_transform_blocks=2, num_heads=2, num_modes=(2, 2, 2))
X_SHAPE = (1, 2, 12, 12, 10)


@pytest.fixture(autouse=True)
def _highest(monkeypatch):
    monkeypatch.setattr(jspectral, "PRECISION", jax.lax.Precision.HIGHEST)


def _x(shape=X_SHAPE, seed=31):
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


@pytest.mark.parametrize("patch", [None, 2])
def test_grouping_matches_jax_and_inverts(patch):
    p = (2, 2, 2) if patch else (1, 1, 1)
    x = _x((2, 4, 6, 8, 3, 5), 1)
    got = attention._grouping(torch.from_numpy(x), p)
    want = np.asarray(jattn._grouping(jnp.asarray(x), p))
    np.testing.assert_array_equal(got.numpy(), want)
    back = attention._ungrouping(got, 5, p)
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("use_transform", [True, False])
@pytest.mark.parametrize("patch", [None, 2])
def test_attention_matches_jax(patch, use_transform):
    shape = (1, 8, 9, 6, 4) if use_transform else (1, 4, 4, 4, 4)
    x = _x(shape, 3)
    kw = dict(patch_size=patch, use_transform=use_transform)
    jm = jattn.HartleyMultiHeadAttention(4, 6, 2, (2, 2, 2), **kw)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = _load(attention.HartleyMultiHeadAttention(4, 6, 2, (2, 2, 2), **kw,
                                                   generator=_gen()), params)
    got = _run(tm, x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_attention_cross_inputs_match_jax():
    q, kv = _x((1, 8, 6, 6, 4), 4), _x((1, 8, 6, 6, 4), 5)
    jm = jattn.HartleyMultiHeadAttention(4, 4, 2, (2, 2, 2), patch_size=2)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(q))["params"]
    want = np.asarray(jm.apply({"params": params},
                               (jnp.asarray(q), jnp.asarray(kv))))
    tm = _load(attention.HartleyMultiHeadAttention(
        4, 4, 2, (2, 2, 2), patch_size=2, generator=_gen()), params)
    with torch.no_grad():
        got = tm((torch.from_numpy(q), torch.from_numpy(kv))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("cin,opts", [
    (4, dict(patch_size=2)),
    (6, dict(patch_size=None)),
    (4, dict(patch_size=2, activation="elu")),
    (4, dict(patch_size=2, use_block_concat=False,
             use_bias_conv_branch=True)),
    (4, dict(patch_size=2, attention_activation="softmax")),
], ids=["selu", "fan-in-6", "elu-groupnorm", "add-skip-bias", "softmax"])
def test_block_matches_jax(cin, opts):
    x = _x((1, 8, 8, 6, cin), 6)
    jm = jarch.HartleyMHABlock(cin, 4, 2, (2, 2, 2), **opts)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = _load(HartleyMHABlock(cin, 4, 2, (2, 2, 2), **opts,
                               generator=_gen()), params)
    np.testing.assert_allclose(_run(tm, x), want, atol=1e-5, rtol=0)


MODEL_CASES = [dict(patch_size=2), dict(patch_size=None),
               dict(patch_size=2, use_deep_supervision=False),
               dict(patch_size=2, activation="elu"),
               dict(patch_size=2, use_resize=False)]
MODEL_IDS = ["patch2", "nopatch", "no-ds", "elu-groupnorm", "no-resize"]


def _jax_model(kw, x, **extra):
    jm = jarch.HartleyMHASeg(**SMALL, **kw, **extra)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros_like(x))["params"]
    return jm, params


@pytest.mark.parametrize("kw", MODEL_CASES, ids=MODEL_IDS)
def test_module_path_matches_jax_module_path(kw):
    x = _x()
    jm, params = _jax_model(kw, jnp.asarray(x))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = _load(HartleyMHASeg(**SMALL, **kw, generator=_gen()), params)
    got = _run(tm, x)
    assert got.shape == want.shape == X_SHAPE[:1] + (3,) + X_SHAPE[2:]
    np.testing.assert_allclose(got, want, atol=PROB_ATOL, rtol=0)


@pytest.mark.parametrize("kw", [dict(patch_size=2),
                                dict(patch_size=2,
                                     use_deep_supervision=False)],
                         ids=["patch2", "no-ds"])
def test_kernel_path_matches_jax_fused_path(monkeypatch, kw):
    """The port's kernel path (plain versions on the CPU) against the JAX
    fused path (its TPU gate bypassed; Pallas kernels in interpret
    mode)."""
    monkeypatch.setattr(jarch.HartleyMHASeg, "_use_fused_tower",
                        lambda self, x: self.use_pallas and x.shape[0] == 1)
    x = _x()
    jm, params = _jax_model(kw, jnp.asarray(x), use_pallas=True)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = _load(HartleyMHASeg(**SMALL, **kw, use_kernels=True,
                             generator=_gen()), params)
    before = dict(kernels.LAUNCHES)
    got = _run(tm, x)
    assert kernels.LAUNCHES == before  # CPU tensors: no kernel launched
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("kw,shape", [
    (dict(patch_size=2), (1, 2, 13, 11, 9)),
    (dict(patch_size=None, use_deep_supervision=False), (1, 2, 12, 10, 9)),
    (dict(patch_size=2, use_resize=False), (1, 2, 7, 9, 6)),
    (dict(patch_size=2, use_bias_conv_branch=True), (1, 2, 12, 12, 10)),
], ids=["odd", "nopatch-no-ds", "no-resize", "branch-bias"])
def test_kernel_path_matches_module_path(kw, shape):
    x = torch.from_numpy(_x(shape, 8))
    plain = HartleyMHASeg(**SMALL, **kw, generator=_gen())
    fast = HartleyMHASeg(**SMALL, **kw, use_kernels=True)
    fast.load_state_dict(plain.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(fast(x), plain(x), rtol=0, atol=PROB_ATOL)


def test_float64_model_is_a_reference_for_the_fp32_kernel_path():
    x = torch.from_numpy(_x())
    m = HartleyMHASeg(**SMALL, patch_size=2, use_kernels=True)
    ref = HartleyMHASeg(**SMALL, patch_size=2).double()
    ref.load_state_dict(m.state_dict())
    with torch.no_grad():
        got, want = m(x), ref(x.double())
    assert want.dtype == torch.float64 and got.dtype == torch.float32
    assert float((got.double() - want).abs().max()) < 1e-5


@pytest.mark.parametrize("kw", [dict(patch_size=2),
                                dict(patch_size=None, activation="elu")],
                         ids=["selu", "elu-groupnorm"])
def test_state_dict_keys_equal_the_reference_export(kw):
    x = jnp.asarray(_x())
    jm, params = _jax_model(kw, x)
    ref = export_reference_state_dict(jm, params)
    got = state_dict_from_jax(jax.device_get(params))
    own = HartleyMHASeg(**SMALL, **kw).state_dict()
    assert set(got) == set(ref) == set(own)
    for k, v in ref.items():
        if k.endswith("normalization.bias"):  # see ROADMAP §3: (1, C, 1..)
            v = v.reshape(-1)
        np.testing.assert_array_equal(got[k].numpy(), v)
        assert tuple(own[k].shape) == v.shape, k


def test_config_width_parameter_count():
    m = HartleyMHASeg(**CONFIG_WIDTH, use_kernels=True)
    assert sum(p.numel() for p in m.parameters()) == 178532


def test_kernel_path_refuses_a_grid_below_twice_the_modes():
    m = HartleyMHASeg(**{**SMALL, "num_modes": (3, 2, 2)}, use_kernels=True)
    with pytest.raises(ValueError, match="smaller than 2 \\* modes"):
        with torch.no_grad():
            m(torch.zeros(1, 2, 8, 12, 12))  # grid (5, 7, 7)


def test_kernel_path_refuses_batch_2():
    m = HartleyMHASeg(**SMALL, use_kernels=True)
    with pytest.raises(ValueError, match="batch 1"):
        with torch.no_grad():
            m(torch.zeros((2,) + X_SHAPE[1:]))


@pytest.mark.parametrize("opts,exc", [
    (dict(ndim=4), NotImplementedError),
    (dict(compute_dtype="float16"), ValueError),
    (dict(use_kernels=True, activation="elu"), ValueError),
    (dict(use_kernels=True, use_block_concat=False), ValueError),
    (dict(use_kernels=True, channel_first_io=False), ValueError),
])
def test_unported_options_raise(opts, exc):
    with pytest.raises(exc, match="ROADMAP" if exc is NotImplementedError
                       else None):
        HartleyMHASeg(**{**SMALL, **opts})


def test_attention_bias_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 9"):
        attention.HartleyMultiHeadAttention(4, 4, 2, 2, use_bias=True,
                                            generator=_gen())


class _Sizes:
    def get_num_x_modalities(self):
        return 4


def test_build_model_from_the_hartleymha_config():
    cfg = config.get_config(str(REPO / "configs" / "config_hartleymha.ini"))
    model = _build_model(cfg, _Sizes(), lambda: (240, 240, 155))
    assert isinstance(model, HartleyMHASeg) and model.use_kernels
    assert model.layers[0].op.num_heads == 4
    assert model.layers[0].op.patch_size == 2
    assert sum(p.numel() for p in model.parameters()) == 178532
