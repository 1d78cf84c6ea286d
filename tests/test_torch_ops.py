"""The port's ops against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and fed to both. Tolerances: both
sides compute in fp32 (the JAX einsums at HIGHEST precision, exact fp32 on
the CPU), so they differ only by summation order: 1e-5 absolute on O(1)
values.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_3d_image_segmentation_tpu.ops import convs as jconvs
from multimodal_3d_image_segmentation_tpu.ops import padcrop as jpadcrop
from multimodal_3d_image_segmentation_tpu.ops import resize as jresize
from multimodal_3d_image_segmentation_tpu.ops import spectral as jspectral
from multimodal_3d_image_segmentation_tpu_torch.ops import (convs, initializers,
                                                            operators,
                                                            padcrop, resize,
                                                            spectral)
from multimodal_3d_image_segmentation_tpu_torch.utils.jax_compat import \
    state_dict_from_jax

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

ATOL = 1e-5


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("shape,modes", [
    ((1, 16, 16, 12, 3), (3, 4, 4)),
    ((1, 15, 13, 11, 2), (4, 3, 5)),   # odd sizes
    ((2, 9, 10, 7, 4), (4, 5, 3)),     # n == 2m on H, batch 2
])
def test_dht_crop_matches_jax(shape, modes):
    x = _rand(shape, 0)
    modes = jspectral.clip_modes(modes, shape[1:-1])
    want = np.asarray(jspectral.dht_crop(jnp.asarray(x), modes))
    got = spectral.dht_crop(torch.from_numpy(x), modes).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("shape,modes", [
    ((1, 16, 16, 12, 3), (3, 4, 4)),
    ((1, 15, 13, 11, 2), (4, 3, 5)),
])
def test_dht_crop_matches_fft_oracle(shape, modes):
    """Packed corners of DHT(x) = Re(FFT(x)) - Im(FFT(x)), 1/N norm."""
    x = _rand(shape, 1).astype(np.float64)
    f = np.fft.fftn(x, axes=(1, 2, 3)) / np.prod(shape[1:4])
    full = f.real - f.imag
    for ax, (n, m) in enumerate(zip(shape[1:4], modes), start=1):
        idx = np.concatenate([np.arange(m), np.arange(n - m, n)])
        full = np.take(full, idx, axis=ax)
    got = spectral.dht_crop(torch.from_numpy(x.astype(np.float32)),
                            modes).numpy()
    np.testing.assert_allclose(got, full, atol=ATOL)


@pytest.mark.parametrize("packed,sizes", [
    ((1, 6, 8, 8, 3), (16, 16, 12)),
    ((1, 8, 6, 10, 2), (15, 13, 11)),  # odd target sizes
])
def test_dht_pad_inverse_matches_jax(packed, sizes):
    y = _rand(packed, 2)
    want = np.asarray(jspectral.dht_pad_inverse(jnp.asarray(y), sizes))
    got = spectral.dht_pad_inverse(torch.from_numpy(y), sizes).numpy()
    assert got.shape == want.shape
    # unnormalized inverse: values grow to O(sqrt(#modes))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


def test_dht_pad_inverse_inverts_crop_on_band_limited_input():
    """crop then pad-inverse is the identity on a volume whose spectrum
    lies inside the kept corners."""
    sizes, modes = (12, 10, 8), (3, 2, 4)
    y = _rand((1,) + tuple(2 * m for m in modes) + (2,), 3)
    x = spectral.dht_pad_inverse(torch.from_numpy(y), sizes)
    back = spectral.dht_crop(x, modes).numpy()
    np.testing.assert_allclose(back, y, atol=ATOL)


@pytest.mark.parametrize("shape,sizes,channel_first", [
    ((1, 3, 6, 5, 4), (12, 10, 8), True),     # exact 2x
    ((1, 2, 7, 9, 11), (31, 25, 19), True),   # odd upsample, all axes
    ((1, 16, 6, 6, 2), (9, 11, 6), False),    # D down, identity W
])
def test_resize_linear_matches_jax(shape, sizes, channel_first):
    x = _rand(shape, 4)
    want = np.asarray(jresize.resize_linear(jnp.asarray(x), sizes,
                                            channel_first=channel_first))
    got = resize.resize_linear(torch.from_numpy(x), sizes,
                               channel_first=channel_first).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("shape,target,channel_first", [
    ((1, 2, 6, 7, 8), (8, 5, 8), True),    # pad D, crop H, keep W
    ((1, 9, 4, 5, 3), (6, 7, 5), False),   # crop D, pad H and W
])
def test_spatial_padcrop_matches_jax(shape, target, channel_first):
    x = _rand(shape, 5)
    want = np.asarray(jpadcrop.spatial_padcrop(jnp.asarray(x), target,
                                               channel_first=channel_first))
    got = padcrop.spatial_padcrop(torch.from_numpy(x), target,
                                  channel_first=channel_first).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,k,s", [
    ((1, 8, 6, 5, 3), 1, 1),
    ((1, 8, 6, 6, 4), 2, 2),   # even spatial sizes
    ((2, 7, 5, 9, 3), 2, 2),   # odd spatial sizes, batch 2
    ((1, 7, 6, 5, 4), 3, 1),   # k=3 SAME (V-Net-DS)
    ((1, 7, 6, 5, 4), 3, 2),   # k=3 stride 2, padding 1 (V-Net's down)
])
def test_conv_matches_jax(shape, k, s):
    x = _rand(shape, 6)
    jm = jconvs.Conv(5, kernel_size=k, strides=s, snn_init=True)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = convs.Conv(shape[-1], 5, k, s, snn_init=True, generator=_gen())
    tm.load_state_dict(state_dict_from_jax(jax.device_get(params)),
                       strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("parts", [(4,), (4, 3)])
def test_concat_conv_norm_act_matches_jax(parts):
    xs = [_rand((1, 5, 6, 4, c), 7 + i) for i, c in enumerate(parts)]
    jm = jconvs.ConcatConvNormAct(6)
    jin = tuple(jnp.asarray(x) for x in xs)
    params = jm.init(jax.random.PRNGKey(1), jin)["params"]
    want = np.asarray(jm.apply({"params": params}, jin))
    tm = convs.ConcatConvNormAct(sum(parts), 6, generator=_gen())
    tm.load_state_dict(state_dict_from_jax(jax.device_get(params)),
                       strict=True)
    with torch.no_grad():
        got = tm(tuple(torch.from_numpy(x) for x in xs)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_conv_norm_act_matches_jax():
    x = _rand((1, 6, 4, 5, 3), 9)
    jm = jconvs.ConvNormAct(4, kernel_size=2, strides=2)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = convs.ConvNormAct(3, 4, kernel_size=2, strides=2, generator=_gen())
    tm.load_state_dict(state_dict_from_jax(jax.device_get(params)),
                       strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("k,s,act", [(3, 1, "elu"), (3, 2, "relu"),
                                     (2, 2, None)])
def test_group_norm_conv_norm_act_matches_jax(k, s, act):
    """The GroupNorm(1) variant (V-Net-DS): torch init, norm, activation."""
    x = _rand((1, 7, 6, 5, 3), 19)
    jm = jconvs.ConvNormAct(4, kernel_size=k, strides=s, activation=act,
                            use_snn=False)
    params = jm.init(jax.random.PRNGKey(4), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(  # a non-trivial GroupNorm affine
        lambda v: v + 0.1 * _rand(v.shape, 20), params)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = convs.ConvNormAct(3, 4, kernel_size=k, strides=s, activation=act,
                           use_snn=False, generator=_gen())
    sd = state_dict_from_jax(jax.device_get(params))
    assert set(sd) == {"op.weight", "op.bias", "normalization.weight",
                       "normalization.bias"}
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("act,shape", [("elu", (1, 4, 3, 5, 3)),
                                       ("selu", (2, 3, 4, 2, 5))])
def test_conv_transpose_norm_act_matches_jax(act, shape):
    """k=3 transposed conv doubles each axis; the weight is (I, O, *k)."""
    x = _rand(shape, 21)
    jm = jconvs.ConvTransposeNormAct(4, kernel_size=3, activation=act)
    params = jm.init(jax.random.PRNGKey(5), jnp.asarray(x))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = convs.ConvTransposeNormAct(shape[-1], 4, kernel_size=3,
                                    activation=act, generator=_gen())
    sd = state_dict_from_jax({"decode_0_up": jax.device_get(params)},
                             num_blocks=[1])
    tm.load_state_dict({k.replace("decode_layers.0.0.", ""): v
                        for k, v in sd.items()}, strict=True)
    assert tuple(tm.op.weight.shape) == (shape[-1], 4, 3, 3, 3)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (shape[0],) + tuple(2 * n for n in shape[1:4]) + (4,)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_concat_conv_upsample_to_matches_jax():
    """Deep-supervision head: legs projected, then nearest-upsampled."""
    sizes = ((6, 5, 4), (3, 3, 2), (2, 2, 1))
    xs = [_rand((1,) + sz + (c,), 22 + i)
          for i, (sz, c) in enumerate(zip(sizes, (4, 6, 8)))]
    jm = jconvs.ConcatConvNormAct(3, activation="elu", use_snn=False,
                                  upsample_to=sizes[0])
    jin = tuple(jnp.asarray(x) for x in xs)
    params = jm.init(jax.random.PRNGKey(6), jin)["params"]
    want = np.asarray(jm.apply({"params": params}, jin))
    tm = convs.ConcatConvNormAct(18, 3, activation="elu", use_snn=False,
                                 generator=_gen())
    tm.load_state_dict(state_dict_from_jax(jax.device_get(params)),
                       strict=True)
    with torch.no_grad():
        got = tm(tuple(torch.from_numpy(x) for x in xs),
                 upsample_to=sizes[0]).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("shape,sizes,channel_first", [
    ((1, 3, 5, 2, 4), (7, 10, 3), False),
    ((2, 3, 4, 4, 2), (8, 9, 4), True),
])
def test_resize_nearest_matches_jax(shape, sizes, channel_first):
    x = _rand(shape, 25)
    want = np.asarray(jresize.resize_nearest(jnp.asarray(x), sizes,
                                             channel_first=channel_first))
    got = resize.resize_nearest(torch.from_numpy(x), sizes,
                                channel_first=channel_first).numpy()
    np.testing.assert_array_equal(got, want)


def test_initializer_distributions():
    g = _gen(3)
    w = initializers.kaiming_normal_linear(64)((256, 64), g)
    assert abs(float(w.std()) - 1 / 8) < 0.01
    u = initializers.kaiming_uniform_a5(16)((4096,), g)
    assert float(u.abs().max()) <= 0.25 and float(u.abs().max()) > 0.24
    b = initializers.snn_bias()((4096,), g)
    assert float(b.abs().max()) <= 1e-3
    # the generator alone decides the values
    a1 = initializers.kaiming_normal_linear(8)((5,), _gen(11))
    a2 = initializers.kaiming_normal_linear(8)((5,), _gen(11))
    torch.testing.assert_close(a1, a2, rtol=0, atol=0)


def test_unported_op_options_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        operators.HartleyOperator(4, 4, (2, 2, 2),
                                  weights_type="individual",
                                  use_transform=False, generator=_gen())
    with pytest.raises(RuntimeError, match="SELU"):
        convs.ConvNormAct(4, 4, activation="relu", generator=_gen())
