"""The port's HNOSeg-XS against the JAX package's, on the CPU.

Weights pass from JAX to torch through ``utils/jax_compat.py``; inputs are
made with numpy from a seed. Tolerance: 1e-4 on probabilities. Both sides
are fp32, but eight blocks of DFT matrix chains and random-init weights
grow activations well above O(1), so summation-order differences reach
the softmax at the 1e-5 class.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_3d_image_segmentation_tpu import models as jmodels
from multimodal_3d_image_segmentation_tpu.utils.torch_compat import \
    export_reference_state_dict
from multimodal_3d_image_segmentation_tpu_torch.models import HNOSegXS
from multimodal_3d_image_segmentation_tpu_torch.utils.jax_compat import \
    state_dict_from_jax

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

FLAGSHIP = dict(in_channels=4, out_channels=4, filters=24,
                num_transform_blocks=[3] * 8, num_modes=(10, 14, 14))
SMALL = dict(in_channels=2, out_channels=3, filters=8,
             num_transform_blocks=[2, 2, 2], num_modes=(3, 4, 4))
PROB_ATOL = 1e-4


def _x(shape=(1, 2, 16, 16, 12), seed=2):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax_pair(kw, x, **jkw):
    jm = jmodels.HNOSegXS(**kw, **jkw)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    return jm, params


def _port(kw, params, **tkw):
    tm = HNOSegXS(**kw, **tkw)
    tm.load_state_dict(state_dict_from_jax(jax.device_get(params)),
                       strict=True)
    return tm


def _run(tm, x):
    with torch.no_grad():
        return tm(torch.from_numpy(x)).numpy()


@pytest.fixture(scope="module")
def flagship_params():
    jm, params = _jax_pair(FLAGSHIP, _x((1, 4, 16, 16, 12)))
    return jm, params


def test_flagship_parameter_count():
    tm = HNOSegXS(**FLAGSHIP, use_kernels=True)
    assert sum(p.numel() for p in tm.parameters()) == 28248


def test_state_dict_from_jax_equals_reference_export(flagship_params):
    jm, params = flagship_params
    ref = export_reference_state_dict(jm, params)
    got = state_dict_from_jax(jax.device_get(params))
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert tuple(got[k].shape) == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), v)
    # the port's own module tree carries exactly these names and shapes
    tm = HNOSegXS(**FLAGSHIP)
    own = tm.state_dict()
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: v.shape for k, v in ref.items()}
    tm.load_state_dict(got, strict=True)
    assert own["conv_in.op.weight"].shape == (24, 4, 2, 2, 2)
    assert own["conv_out.weight"].shape == (4, 24, 1, 1, 1)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_small_model_matches_jax_module_path(use_kernels):
    x = _x()
    jm, params = _jax_pair(SMALL, x)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    got = _run(_port(SMALL, params, use_kernels=use_kernels), x)
    assert got.shape == want.shape == (1, 3, 16, 16, 12)
    np.testing.assert_allclose(got, want, atol=PROB_ATOL)


def test_small_model_matches_jax_pallas_path():
    """JAX use_pallas=True runs fused_freq_chain interpreted on the CPU."""
    x = _x(seed=3)
    jm, params = _jax_pair(SMALL, x, use_pallas=True)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    got = _run(_port(SMALL, params, use_kernels=True), x)
    np.testing.assert_allclose(got, want, atol=PROB_ATOL)


@pytest.mark.parametrize("opts,shape", [
    (dict(use_block_concat=False), (1, 2, 16, 16, 12)),
    (dict(use_unet_skip=False), (1, 2, 16, 16, 12)),
    (dict(use_resize=False), (1, 2, 12, 10, 8)),
    (dict(channel_first_io=False), (1, 16, 16, 12, 2)),
    (dict(num_transform_blocks=2, output_activation="sigmoid"),
     (1, 2, 15, 13, 11)),                                   # odd sizes
])
def test_options_match_jax(opts, shape):
    kw = {**SMALL, **opts}
    x = _x(shape, seed=4)
    jm, params = _jax_pair(kw, x)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    got = _run(_port(kw, params, use_kernels=True), x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=PROB_ATOL)


def test_kernel_path_equals_plain_path_on_cpu():
    """On the CPU the kernel path runs the plain versions: the two paths
    agree to fp32 rounding."""
    x = _x(seed=5)
    plain = HNOSegXS(**SMALL)
    fast = HNOSegXS(**SMALL, use_kernels=True)
    fast.load_state_dict(plain.state_dict())
    np.testing.assert_allclose(_run(fast, x), _run(plain, x), atol=1e-5)


def test_float64_model_is_a_reference_for_the_fp32_model():
    """``.double()`` runs the same model in float64 (matrices included);
    the fp32 model stays within its stated tolerance of it."""
    x = _x(seed=6)
    m32 = HNOSegXS(**SMALL, use_kernels=True)
    m64 = HNOSegXS(**SMALL).double()
    m64.load_state_dict(m32.state_dict())
    with torch.no_grad():
        y64 = m64(torch.from_numpy(x).double())
    assert y64.dtype == torch.float64
    np.testing.assert_allclose(_run(m32, x), y64.numpy(), atol=PROB_ATOL)


def test_generator_seeds_the_init():
    a = HNOSegXS(**SMALL, generator=torch.Generator().manual_seed(7))
    b = HNOSegXS(**SMALL, generator=torch.Generator().manual_seed(7))
    c = HNOSegXS(**SMALL, generator=torch.Generator().manual_seed(8))
    for (k, va), vb, vc in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0)
        assert not torch.equal(va, vc), k


@pytest.mark.parametrize("opts", [
    dict(use_flat=True),
    dict(use_remat=True),
    dict(ndim=4),
    dict(weights_type="individual"),
    dict(activation="relu"),
    dict(use_deep_supervision=True),
])
def test_unported_options_raise(opts):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        HNOSegXS(**{**SMALL, **opts})


@pytest.mark.parametrize("mode", ["bfloat16", "mixed"])
def test_training_in_a_bf16_mode_raises(mode):
    """Serving only: a forward autograd would record raises, naming item
    12; the same model serves under no_grad."""
    m = HNOSegXS(**SMALL, compute_dtype=mode, use_kernels=True)
    x = torch.from_numpy(_x())
    with pytest.raises(NotImplementedError, match="item 12"):
        m(x)
    with torch.no_grad():
        assert torch.isfinite(m(x)).all()
