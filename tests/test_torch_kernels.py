"""The port's kernel modules on the CPU against the JAX package's kernels.

On a CPU tensor each wrapper runs its kernel's plain version; here that is
held against the JAX functions, the Pallas kernels run in interpret mode as
the JAX package's own tests run them. The CUDA kernels themselves are
checked against the plain versions on a card (``test_torch_kernels_cuda``).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_3d_image_segmentation_tpu.kernels import conv_in as jconv_in
from multimodal_3d_image_segmentation_tpu.kernels import \
    tail_resize as jtail
from multimodal_3d_image_segmentation_tpu.kernels.freq_chain import \
    fused_freq_chain as j_fused_freq_chain
from multimodal_3d_image_segmentation_tpu.ops.resize import \
    resize_linear as j_resize_linear
from multimodal_3d_image_segmentation_tpu_torch import kernels
from multimodal_3d_image_segmentation_tpu_torch.kernels.tail_resize import \
    _tap_tables
from multimodal_3d_image_segmentation_tpu_torch.ops.resize import \
    _linear_taps_np

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("shape,n", [
    ((1, 6, 8, 4, 24), 3),   # the flagship channel count
    ((1, 5, 7, 3, 16), 1),   # row count not a multiple of the Pallas tile
    ((2, 4, 4, 2, 8), 2),
])
def test_freq_chain_matches_jax_kernel(shape, n):
    """atol 1e-5: both fp32, as tests/test_kernels.py holds the Pallas
    kernel to the einsum chain."""
    c = shape[-1]
    x = _rand(shape, 0)
    ws = [_rand((c, c), 1 + k, 0.2) for k in range(n)]
    want = np.asarray(j_fused_freq_chain(
        jnp.asarray(x), [jnp.asarray(w) for w in ws], interpret=True))
    got = kernels.fused_freq_chain(_t(x), [_t(w) for w in ws]).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_freq_chain_empty_is_identity():
    x = _t(_rand((1, 4, 4, 2, 8), 2))
    assert kernels.fused_freq_chain(x, []) is x


def _jax_kernel_layout(w_torch):
    """(F, C, kz, ky, kx) -> flax DHWIO (kz, ky, kx, C, F)."""
    return np.ascontiguousarray(w_torch.transpose(2, 3, 4, 1, 0))


@pytest.mark.parametrize("shape", [
    (1, 2, 8, 6, 5),    # even D/H: the raw Pallas path, odd W
    (1, 3, 7, 6, 5),    # odd D: the padded Pallas path
    (1, 2, 8, 5, 6),    # odd H
    (1, 4, 6, 4, 7),
])
def test_conv_in_matches_jax_kernel(shape):
    """atol 1e-5: both fp32 (the interpreted kernel's W selection at
    HIGHEST), differing in summation order only."""
    c, f = shape[1], 8
    x = _rand(shape, 3)
    w = _rand((f, c, 2, 2, 2), 4, 1 / np.sqrt(8 * c))
    b = _rand((f,), 5, 0.1)
    kern, bias = jnp.asarray(_jax_kernel_layout(w)), jnp.asarray(b)
    got = kernels.conv_in_s2d(_t(x), _t(w), _t(b)).numpy()
    want_k = np.asarray(jconv_in.conv_in_s2d(jnp.asarray(x), kern, bias,
                                             interpret=True))
    want_x = np.asarray(jconv_in._reference_xla(jnp.asarray(x), kern, bias))
    d, h, wd = shape[2:]
    assert got.shape == (1, d // 2 + 1, h // 2 + 1, wd // 2 + 1, f)
    np.testing.assert_allclose(got, want_k, atol=1e-5)
    np.testing.assert_allclose(got, want_x, atol=1e-5)


def test_conv_in_without_selu_matches_jax():
    x = _rand((1, 2, 6, 6, 5), 6)
    w = _rand((8, 2, 2, 2, 2), 7, 0.25)
    b = _rand((8,), 8, 0.1)
    got = kernels.conv_in_s2d(_t(x), _t(w), _t(b), apply_selu=False).numpy()
    want = np.asarray(jconv_in._reference_xla(
        jnp.asarray(x), jnp.asarray(_jax_kernel_layout(w)), jnp.asarray(b),
        apply_selu=False))
    np.testing.assert_allclose(got, want, atol=1e-5)


TAIL_CASES = [
    ((1, 4, 12, 10, 8), (31, 25, 19)),    # odd upsample, all axes
    ((1, 2, 7, 9, 11), (14, 18, 22)),     # exact 2x
    ((1, 3, 6, 8, 8), (6, 8, 8)),         # identity resize
    ((1, 2, 16, 6, 6), (9, 11, 13)),      # D downsample + HW upsample
]


@pytest.mark.parametrize("shape,sizes", TAIL_CASES)
def test_tail_matches_jax_module_tail(shape, sizes):
    """atol 1e-5: the JAX module tail (resize_linear at HIGHEST + softmax)
    is fp32 like the port's plain version."""
    x = _rand(shape, 9)
    want = np.asarray(jax.nn.softmax(
        j_resize_linear(jnp.asarray(x), sizes, channel_first=True), axis=1))
    got = kernels.fused_tail_softmax(_t(x), sizes).numpy()
    assert got.shape == (1, shape[1]) + sizes
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("shape,sizes", TAIL_CASES[:2])
def test_tail_matches_jax_fused_kernel(shape, sizes):
    """atol 2e-4: the TPU kernel's H/W dots are bf16x3
    (tests/test_tail_resize.py holds it to the module tail at that class)."""
    x = _rand(shape, 10)
    want = np.asarray(jtail.fused_tail_softmax(jnp.asarray(x), sizes,
                                               jnp.float32, True))
    got = kernels.fused_tail_softmax(_t(x), sizes).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_tail_supported_predicate():
    ok = kernels.tail_supported
    assert ok((1, 4, 121, 121, 78), (240, 240, 155))
    assert ok((1, 8, 2, 2, 2), (3, 3, 3))
    assert not ok((2, 4, 8, 8, 8), (16, 16, 16))     # batch 2
    assert not ok((1, 9, 8, 8, 8), (16, 16, 16))     # C > 8
    assert not ok((1, 4, 8, 8), (16, 16))            # 2D
    assert not ok((1, 4, 8, 8, 8), (16, 0, 16))      # empty axis
    with pytest.raises(ValueError):
        kernels.fused_tail_softmax(torch.zeros(2, 4, 3, 3, 3), (6, 6, 6))


def test_tail_supported_bounds_the_kernels_shared_memory():
    """A block holds the W taps and, at its fewest rows, C x 4 rows of the
    input width twice (along D, then H) or C x 1,024 staged probabilities:
    the serving shape fits by far, an input row of 2,000 at C 8 does not."""
    ok = kernels.tail_supported
    assert ok((1, 4, 121, 121, 78), (240, 240, 155))
    assert ok((1, 8, 4, 4, 800), (4, 4, 800))
    assert not ok((1, 8, 4, 4, 2000), (4, 4, 2000))
    assert ok((1, 1, 4, 4, 2000), (4, 4, 2000))
    with pytest.raises(ValueError, match="shared memory"):
        kernels.fused_tail_softmax(torch.zeros(1, 8, 4, 4, 2000),
                                   (4, 4, 2000))


def test_tail_tap_tables_layout():
    """The tables the kernel reads are _linear_taps_np's, concatenated."""
    taps, wts = _tap_tables((5, 7, 3), (9, 14, 3), torch.device("cpu"))
    idx, ws = [], []
    for n_in, n_out in ((5, 9), (7, 14), (3, 3)):
        lo, hi, w = _linear_taps_np(n_in, n_out)
        idx += [lo, hi]
        ws.append(w)
    assert taps.dtype == torch.int32 and wts.dtype == torch.float32
    np.testing.assert_array_equal(taps.numpy(), np.concatenate(idx))
    np.testing.assert_array_equal(wts.numpy(), np.concatenate(ws))


def test_cpu_wrappers_run_plain_versions_without_counting():
    """On CPU tensors the wrappers run the plain versions and count no
    launch (a count moves only where a kernel is launched)."""
    before = dict(kernels.LAUNCHES)
    x = _t(_rand((1, 2, 6, 6, 5), 11))
    w = _t(_rand((8, 2, 2, 2, 2), 12, 0.25))
    b = _t(_rand((8,), 13, 0.1))
    torch.testing.assert_close(kernels.conv_in_s2d(x, w, b),
                               kernels.conv_in_plain(x, w, b),
                               rtol=0, atol=0)
    s = _t(_rand((1, 4, 4, 2, 8), 14))
    ws = [_t(_rand((8, 8), 15, 0.2))]
    torch.testing.assert_close(kernels.fused_freq_chain(s, ws),
                               kernels.freq_chain_plain(s, ws),
                               rtol=0, atol=0)
    lg = _t(_rand((1, 3, 4, 5, 6), 16))
    torch.testing.assert_close(kernels.fused_tail_softmax(lg, (8, 9, 7)),
                               kernels.tail_plain(lg, (8, 9, 7)),
                               rtol=0, atol=0)
    assert kernels.LAUNCHES == before


def test_selu_constants_are_torch_selus():
    """The kernels' SELU (csrc/common.cuh) uses the constants of
    kernels/_common.py, and those are torch.selu's."""
    from multimodal_3d_image_segmentation_tpu_torch.kernels import _common
    cuh = (Path(kernels.__file__).parent.parent / "csrc" /
           "common.cuh").read_text()
    for name, val in (("kSeluScale", _common.SELU_SCALE),
                      ("kSeluAlpha", _common.SELU_ALPHA)):
        m = re.search(name + r" = ([0-9.]+)f;", cuh)
        assert m and float(m.group(1)) == val
    x = _t(_rand((4096,), 17, 4.0)).double()
    want = _common.SELU_SCALE * torch.where(
        x > 0, x, _common.SELU_ALPHA * torch.expm1(x))
    torch.testing.assert_close(torch.selu(x), want, rtol=1e-12, atol=0)


def test_wrappers_reject_mismatched_shapes():
    with pytest.raises(ValueError):
        kernels.fused_freq_chain(torch.zeros(1, 4, 4, 2, 8),
                                 [torch.zeros(8, 6)])
    with pytest.raises(ValueError):
        kernels.conv_in_s2d(torch.zeros(1, 2, 6, 6, 5),
                            torch.zeros(8, 3, 2, 2, 2), torch.zeros(8))
    with pytest.raises(ValueError):
        kernels.conv_in_s2d(torch.zeros(2, 6, 6, 5),
                            torch.zeros(8, 2, 2, 2, 2), torch.zeros(8))
