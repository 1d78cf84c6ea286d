"""The port's conv3 (plain version, as CPU tensors run it) against the JAX
package's ``conv3_flat`` on the CPU.

Inputs are made with numpy from a seed. The JAX side runs the Pallas
kernel in interpret mode at precision 'highest' through
``to_flat``/``from_flat``, and its XLA oracle ``_conv3_xla_reference``.
Tolerances: both sides compute in fp32 and differ only in summation order,
so 1e-5 absolute on O(1) outputs, and 1e-5 relative on the moment sums.
The CUDA kernel itself is held to the plain version on a card
(``tests/test_torch_kernels_cuda.py``).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from multimodal_3d_image_segmentation_tpu.kernels.conv3d_flat import (
    _conv3_xla_reference, conv3_flat, flat_geom, from_flat, to_flat)
from multimodal_3d_image_segmentation_tpu.ops import convs as jconvs
from multimodal_3d_image_segmentation_tpu_torch import kernels
from multimodal_3d_image_segmentation_tpu_torch.kernels.conv3 import \
    conv3_out_size

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

ATOL = 1e-5


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _flat(x):
    """(1, D, H, W, C) numpy -> the reference's flat layout."""
    g = flat_geom(x.shape[1:4])
    return to_flat(jnp.asarray(x[0].transpose(3, 0, 1, 2)), g), g


def _unflat(yf, g):
    return np.asarray(from_flat(yf, g)).transpose(1, 2, 3, 0)[None]


def _dhwio(w):
    return jnp.asarray(w.transpose(2, 3, 4, 1, 0))


def _case(sizes, c1, co, seed, c2=0):
    x = _rand((1,) + sizes + (c1,), seed)
    x2 = _rand((1,) + sizes + (c2,), seed + 1) if c2 else None
    w = _rand((co, c1 + c2, 3, 3, 3), seed + 2, 1 / np.sqrt(27 * (c1 + c2)))
    b = _rand((co,), seed + 3, 0.1)
    return x, x2, w, b


SIZES = [(5, 6, 7), (4, 6, 8)]  # odd and even D/H/W


@pytest.mark.parametrize("sizes", SIZES)
@pytest.mark.parametrize("c2", [0, 4])
def test_plain_matches_jax_kernel_and_oracle(sizes, c2):
    """The bare conv, and the virtual concat (x, x2)."""
    x, x2, w, b = _case(sizes, 8, 12, 0, c2)
    xf, g = _flat(x)
    xin = xf if x2 is None else (xf, _flat(x2)[0])
    want = _unflat(conv3_flat(xin, _dhwio(w), jnp.asarray(b), g,
                              precision="highest", interpret=True), g)
    oracle = _unflat(_conv3_xla_reference(
        xf, _dhwio(w), jnp.asarray(b), None, g, None,
        x2=None if x2 is None else _flat(x2)[0]), g)
    got = kernels.conv3(_t(x), _t(w), _t(b),
                        x2=None if x2 is None else _t(x2)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, oracle, atol=ATOL)


@pytest.mark.parametrize("act", ["elu", "selu", "relu", "none"])
@pytest.mark.parametrize("sizes", SIZES)
def test_prologue_matches_jax(act, sizes):
    """The deferred GroupNorm + activation; the padding stays zero after
    it (ELU(shift) is not 0)."""
    x, _, w, b = _case(sizes, 8, 8, 10)
    scale = _rand((8,), 14, 0.5) + 1.0
    shift = _rand((8,), 15, 0.5)
    xf, g = _flat(x)
    pro = (jnp.asarray(scale), jnp.asarray(shift))
    want = _unflat(conv3_flat(xf, _dhwio(w), jnp.asarray(b), g, prologue=pro,
                              prologue_act=act, precision="highest",
                              interpret=True), g)
    oracle = _unflat(_conv3_xla_reference(xf, _dhwio(w), jnp.asarray(b), pro,
                                          g, act), g)
    got = kernels.conv3(_t(x), _t(w), _t(b), prologue=(_t(scale), _t(shift)),
                        prologue_act=act).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, oracle, atol=ATOL)


@pytest.mark.parametrize("c2", [0, 8])
@pytest.mark.parametrize("sizes", SIZES)
def test_residual_and_stats_match_jax(c2, sizes):
    """The 1x1 residual tap of the pre-prologue input and the moment sums
    of both outputs (a decoder's first conv reads (up, skip))."""
    x, x2, w, b = _case(sizes, 8, 8, 20, c2)
    ci = 8 + c2
    wr = _rand((8, ci), 24, 1 / np.sqrt(ci))
    br = _rand((8,), 25, 0.1)
    xf, g = _flat(x)
    xin = xf if x2 is None else (xf, _flat(x2)[0])
    y, r, st, rst = conv3_flat(xin, _dhwio(w), jnp.asarray(b), g,
                               emit_stats=True,
                               residual=(jnp.asarray(wr), jnp.asarray(br)),
                               precision="highest", interpret=True)
    got = kernels.conv3(_t(x), _t(w), _t(b),
                        x2=None if x2 is None else _t(x2),
                        residual=(_t(wr), _t(br)), emit_stats=True)
    assert len(got) == 4
    np.testing.assert_allclose(got[0].numpy(), _unflat(y, g), atol=ATOL)
    np.testing.assert_allclose(got[1].numpy(), _unflat(r, g), atol=ATOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(st), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(rst), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("sizes", SIZES + [(7, 5, 6)])
def test_stride2_is_the_decimated_stride1_conv(sizes):
    """The down conv: the reference convolves at stride 1 and keeps the
    even positions; the port's stride 2 gives the same voxels, sizes
    (n - 1) // 2 + 1, and their moments."""
    x, _, w, b = _case(sizes, 8, 8, 30)
    xf, g = _flat(x)
    full = _unflat(conv3_flat(xf, _dhwio(w), jnp.asarray(b), g,
                              precision="highest", interpret=True), g)
    want = full[:, ::2, ::2, ::2]
    y, st = kernels.conv3(_t(x), _t(w), _t(b), stride=2, emit_stats=True)
    assert y.shape[1:4] == conv3_out_size(sizes, stride=2) == want.shape[1:4]
    np.testing.assert_allclose(y.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(
        st.numpy(), np.stack([want.sum((0, 1, 2, 3)),
                              (want.astype(np.float64) ** 2).sum((0, 1, 2, 3))]),
        rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("sizes", [(3, 4, 5), (4, 4, 2)])
def test_dilation2_is_the_transposed_conv(sizes):
    """The up conv: a conv over the 2x-dilated input with the flipped
    kernel in conv layout equals torch's transposed conv (stride 2,
    padding 1, output_padding 1) and the JAX package's ConvTranspose."""
    x = _rand((1,) + sizes + (8,), 40)
    wt = _rand((8, 4, 3, 3, 3), 41, 0.2)  # transposed layout (I, O, *k)
    b = _rand((4,), 42, 0.1)
    w_conv = _t(wt).flip(2, 3, 4).transpose(0, 1)
    y, st = kernels.conv3(_t(x), w_conv, _t(b), dilation=2,
                          emit_stats=True)
    assert y.shape[1:4] == tuple(2 * n for n in sizes)
    want = F.conv_transpose3d(_t(x).permute(0, 4, 1, 2, 3), _t(wt), _t(b),
                              stride=2, padding=1, output_padding=1)
    np.testing.assert_allclose(y.numpy(),
                               want.permute(0, 2, 3, 4, 1).numpy(), atol=ATOL)
    jm = jconvs.ConvTranspose(4, kernel_size=3)
    params = {"kernel": jnp.asarray(wt.transpose(2, 3, 4, 0, 1)),
              "bias": jnp.asarray(b)}
    jy = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(y.numpy(), jy, atol=ATOL)
    yy = y.numpy().astype(np.float64)
    np.testing.assert_allclose(
        st.numpy(), np.stack([yy.sum((0, 1, 2, 3)), (yy ** 2).sum((0, 1, 2, 3))]),
        rtol=1e-5, atol=1e-4)


def test_cpu_wrapper_runs_the_plain_version_without_counting():
    before = dict(kernels.LAUNCHES)
    x, x2, w, b = _case((4, 5, 3), 4, 8, 50, 4)
    got = kernels.conv3(_t(x), _t(w), _t(b), x2=_t(x2), emit_stats=True)
    want = kernels.conv3_plain(_t(x), _t(w), _t(b), x2=_t(x2),
                               emit_stats=True)
    for a, c in zip(got, want):
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("mode", ["dilated_depth", "halo"])
def test_wrapper_takes_the_reference_depth_modes(mode):
    """The reference's two depth modes, which the wrapper refused until
    they were ported (ROADMAP items 17 and 15), against the Pallas kernel
    at the refusal test's shapes; ``tests/test_torch_conv3_halo.py`` holds
    their options."""
    x, _, w, b = _case((4, 4, 4), 8, 8, 60)
    xf, g = _flat(x)
    if mode == "dilated_depth":
        g_out = flat_geom(6, 4, 4)
        want = _unflat(conv3_flat(xf, _dhwio(w), jnp.asarray(b), g_out,
                                  dilated_depth=3, precision="highest",
                                  interpret=True), g_out)
        got = kernels.conv3(_t(x), _t(w), _t(b), dilated_depth=3)
    else:  # planes 0 and 3 are the halos; the interior is planes 1-2
        g_in = flat_geom(2, 4, 4)
        want = _unflat(conv3_flat(xf[1:-1], _dhwio(w), jnp.asarray(b), g_in,
                                  halo=True, precision="highest",
                                  interpret=True), g_in)
        got = kernels.conv3(_t(x), _t(w), _t(b), halo=True)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("kwargs,exc,match", [
    (dict(precision="native"), NotImplementedError, "item 12"),
    (dict(precision="mixed"), NotImplementedError, "item 12"),
    (dict(stride=2, dilation=2), ValueError, "stride"),
    (dict(stride=3), ValueError, "stride"),
    (dict(prologue_act="gelu"), ValueError, "activation"),
    (dict(residual="with prologue"), ValueError, "prologue=None"),
    (dict(residual="with stride 2"), ValueError, "stride 1"),
])
def test_wrapper_refuses_what_it_does_not_take(kwargs, exc, match):
    x, _, w, b = _case((4, 4, 4), 8, 8, 60)
    ones, zeros = torch.ones(8), torch.zeros(8)
    res = (torch.zeros(8, 8), zeros)
    if kwargs.get("residual") == "with prologue":
        kwargs = dict(residual=res, prologue=(ones, zeros))
    elif kwargs.get("residual") == "with stride 2":
        kwargs = dict(residual=res, stride=2)
    with pytest.raises(exc, match=match):
        kernels.conv3(_t(x), _t(w), _t(b), **kwargs)


def test_wrapper_refuses_mismatched_shapes_and_bf16():
    x, _, w, b = _case((4, 4, 4), 8, 8, 70)
    # bf16 volumes take the 'bfloat16' and 'mixed' instances; float16 none
    with pytest.raises(TypeError, match="float16"):
        kernels.conv3(_t(x).half(), _t(w), _t(b))
    with pytest.raises(ValueError, match="1, D, H, W"):
        kernels.conv3(_t(np.concatenate([x, x])), _t(w), _t(b))  # batch 2
    with pytest.raises(ValueError, match="do not fit"):
        kernels.conv3(_t(x), _t(w[:, :4]), _t(b))
    with pytest.raises(ValueError, match="does not match"):
        kernels.conv3(_t(x), _t(w), _t(b), x2=_t(x[:, :3]))
    with pytest.raises(ValueError, match="prologue"):
        kernels.conv3(_t(x), _t(w), _t(b),
                      prologue=(torch.ones(4), torch.zeros(4)))


def test_packed_weight_is_kept_per_weight_version():
    """conv3's packed weights (27 * ci, co) are made once per weight
    version: the same tensor while the weight is unchanged, made again
    after an in-place update or a new storage; inference tensors (no
    version counter) are packed on every call."""
    from multimodal_3d_image_segmentation_tpu_torch.kernels.conv3 import \
        packed_weight
    w = torch.nn.Parameter(torch.from_numpy(np.random.default_rng(3)
                           .standard_normal((8, 4, 3, 3, 3))
                           .astype(np.float32)))
    want = w.detach().permute(2, 3, 4, 1, 0).reshape(27 * 4, 8)
    first = packed_weight(w)
    assert torch.equal(first, want) and packed_weight(w) is first
    with torch.no_grad():
        w.mul_(2.0)
    second = packed_weight(w)
    assert second is not first and torch.equal(second, 2.0 * want)
    w.data = w.data.clone()
    assert packed_weight(w) is not second
    with torch.inference_mode():
        wi = w.detach().clone()
        assert wi.is_inference()
        a, b = packed_weight(wi), packed_weight(wi)
    assert a is not b and torch.equal(a, b)


def test_vnetds_keeps_its_flipped_up_weights():
    """The kernel path flips each up conv's weight once per weight version
    and gives the same output as a fresh model after an update."""
    from multimodal_3d_image_segmentation_tpu_torch.models import VNetDS
    m = VNetDS(2, 3, 4, [1, 1], right_leg_indexes=[0, 1], use_kernels=True)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 2, 12, 10, 8)).astype(np.float32))
    with torch.inference_mode():
        a = m(x)
        kept = {k: v[1] for k, v in m._up_weights.items()}
        assert len(kept) == 1 and torch.equal(m(x), a)
        assert all(m._up_weights[k][1] is v for k, v in kept.items())
    with torch.no_grad():
        for p in m.parameters():
            p.mul_(1.1)
    fresh = VNetDS(2, 3, 4, [1, 1], right_leg_indexes=[0, 1],
                   use_kernels=True)
    fresh.load_state_dict(m.state_dict())
    with torch.inference_mode():
        assert torch.equal(m(x), fresh(x))
    assert all(m._up_weights[k][1] is not v for k, v in kept.items())
