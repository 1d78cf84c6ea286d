"""conv3's depth modes, the halo mode of depth-sharded volumes and the
depth-dilated mode, against the JAX package's ``conv3_flat`` on the CPU.

The port's plain version (what CPU tensors run, and the oracle of the CUDA
kernel on the card) against the Pallas kernel in interpret mode at
precision 'highest', through the layout helpers of
``tests/test_torch_conv3.py``. A halo call's x holds the slab's d planes
and one neighbouring plane at each end; the keep flags say which of those
are data (0 at a global end of the volume, where a prologue would
otherwise turn the zero padding into act(shift)). Stride 2 is held to the
JAX halo conv decimated, as the JAX package's sharded down conv computes
it; dilation 2 to JAX's source-grid transposed conv (the interleaved
source and the doubled-channel kernel of ``_FlatConvTransposeNormAct``).
Tolerances, the JAX tests' own: 1e-5 absolute on outputs, 1e-5 relative on
moment sums. Inputs are made with numpy from a seed.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodal_3d_image_segmentation_tpu.kernels.conv3d_flat import (
    conv3_flat, flat_geom, from_flat, to_flat)
from multimodal_3d_image_segmentation_tpu.models.architectures import \
    _lane_select
from multimodal_3d_image_segmentation_tpu_torch import kernels

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

ATOL = 1e-5
MOMENTS_RTOL = 1e-5
KEEPS = [(0, 1), (1, 1), (1, 0)]


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _flat(x):
    """(1, D, H, W, C) numpy -> the reference's flat layout."""
    g = flat_geom(x.shape[1:4])
    return to_flat(jnp.asarray(x[0].transpose(3, 0, 1, 2)), g), g


def _unflat(yf, g):
    return np.asarray(from_flat(yf, g)).transpose(1, 2, 3, 0)[None]


def _halo_flat(x):
    """A halo'd (1, d + 2, H, W, C) slab -> the JAX halo call's flat
    (d + 2, C, Npl) tensor (its border planes the halos) and the geometry
    of its d interior planes."""
    xf, _ = _flat(x)
    return xf[1:-1], flat_geom(x.shape[1] - 2, *x.shape[2:4])


def _dhwio(w):
    return jnp.asarray(w.transpose(2, 3, 4, 1, 0))


def _jax_halo(x, w, b, keep, x2=None, **kw):
    """JAX conv3_flat in halo mode: outputs unflattened, moments as they
    are."""
    xf, g = _halo_flat(x)
    xin = xf if x2 is None else (xf, _halo_flat(x2)[0])
    out = conv3_flat(xin, _dhwio(w), jnp.asarray(b), g, halo=True,
                     halo_keep=jnp.asarray(keep, jnp.float32),
                     precision="highest", interpret=True, **kw)
    out = out if isinstance(out, tuple) else (out,)
    n_vol = 2 if kw.get("residual") is not None else 1
    return ([_unflat(t, g) for t in out[:n_vol]]
            + [np.asarray(t) for t in out[n_vol:]])


def _held(got, want, n_vol):
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for a, e in zip(got[:n_vol], want[:n_vol]):
        assert a.shape == e.shape
        np.testing.assert_allclose(a.numpy(), e, atol=ATOL)
    for a, e in zip(got[n_vol:], want[n_vol:]):
        np.testing.assert_allclose(a.numpy(), e, rtol=MOMENTS_RTOL, atol=0)


def _pro(c, seed):
    return (_rand((c,), seed, 0.3) + 1.0, _rand((c,), seed + 1, 0.5))


@pytest.mark.parametrize("keep", KEEPS)
def test_halo_matches_jax(keep):
    """A first, middle and last slab: ELU prologue (nonzero shift) and the
    moment sums of the interior."""
    x = _rand((1, 6, 5, 7, 8), 0)
    w, b = _rand((8, 8, 3, 3, 3), 1, 0.1), _rand((8,), 2, 0.1)
    sc, sh = _pro(8, 3)
    want = _jax_halo(x, w, b, keep, prologue=(jnp.asarray(sc),
                                              jnp.asarray(sh)),
                     prologue_act="elu", emit_stats=True)
    got = kernels.conv3(_t(x), _t(w), _t(b), prologue=(_t(sc), _t(sh)),
                        prologue_act="elu", emit_stats=True, halo=True,
                        halo_keep=keep)
    assert got[0].shape == (1, 4, 5, 7, 8)
    _held(got, want, 1)


def test_halo_concat_and_selu_prologue_match_jax():
    """The decoder's virtual concat (both inputs halo'd) under a SELU
    prologue."""
    x, x2 = _rand((1, 5, 6, 4, 4), 10), _rand((1, 5, 6, 4, 8), 11)
    w, b = _rand((4, 12, 3, 3, 3), 12, 0.1), _rand((4,), 13, 0.1)
    sc, sh = _pro(12, 14)
    want = _jax_halo(x, w, b, (1, 1), x2=x2,
                     prologue=(jnp.asarray(sc), jnp.asarray(sh)),
                     prologue_act="selu", emit_stats=True)
    got = kernels.conv3(_t(x), _t(w), _t(b), x2=_t(x2),
                        prologue=(_t(sc), _t(sh)), prologue_act="selu",
                        emit_stats=True, halo=True, halo_keep=(1, 1))
    _held(got, want, 1)


def test_halo_residual_matches_jax():
    """The residual tap and its moments stay interior-only."""
    x, x2 = _rand((1, 6, 5, 6, 4), 20), _rand((1, 6, 5, 6, 4), 21)
    w, b = _rand((8, 8, 3, 3, 3), 22, 0.1), _rand((8,), 23, 0.1)
    wr, br = _rand((8, 8), 24, 0.3), _rand((8,), 25, 0.1)
    want = _jax_halo(x, w, b, (0, 1), x2=x2,
                     residual=(jnp.asarray(wr), jnp.asarray(br)),
                     emit_stats=True)
    got = kernels.conv3(_t(x), _t(w), _t(b), x2=_t(x2),
                        residual=(_t(wr), _t(br)), emit_stats=True,
                        halo=True, halo_keep=(0, 1))
    _held(got, want, 2)


def test_halo_stride2_is_the_decimated_jax_halo_conv():
    """The sharded down conv: the JAX halo conv at stride 1, decimated (an
    even slab: the local parity is the global one), and the moments of the
    decimated volume."""
    x = _rand((1, 8, 7, 6, 8), 30)
    w, b = _rand((8, 8, 3, 3, 3), 31, 0.1), _rand((8,), 32, 0.1)
    sc, sh = _pro(8, 33)
    full = _jax_halo(x, w, b, (1, 0), prologue=(jnp.asarray(sc),
                                                jnp.asarray(sh)),
                     prologue_act="elu")[0]
    want = full[:, ::2, ::2, ::2]
    got = kernels.conv3(_t(x), _t(w), _t(b), prologue=(_t(sc), _t(sh)),
                        prologue_act="elu", stride=2, emit_stats=True,
                        halo=True, halo_keep=(1, 0))
    w64 = want.astype(np.float64)
    _held(got, [want, np.stack([w64.sum((0, 1, 2, 3)),
                                (w64 ** 2).sum((0, 1, 2, 3))])], 1)


@pytest.mark.parametrize("keep", [(1, 1), (1, 0)])
def test_halo_dilation2_matches_jax_source_grid_conv(keep):
    """The sharded up conv: JAX's transposed conv on the source grid (the
    (H, W)-interleaved halo'd source, a stride-1 halo conv with the
    flipped kernel's taps packed into 2 co channels, the output planes
    2j and 2j + 1 reassembled), against the port's dilation 2 in halo
    mode; only the next halo is read."""
    d, h, w_, ci, co = 3, 4, 5, 8, 4
    x = _rand((1, d + 2, h, w_, ci), 40)
    wt = _rand((ci, co, 3, 3, 3), 41, 0.2)  # torch's transposed layout
    b = _rand((co,), 42, 0.1)
    xf, g = _halo_flat(x)
    g2 = flat_geom(2 * d, 2 * h, 2 * w_)
    up = _lane_select(xf, g, g2, "interleave2")
    flipped = jnp.flip(jnp.asarray(wt.transpose(2, 3, 4, 0, 1)),
                       axis=(0, 1, 2))
    k2x = jnp.zeros((3, 3, 3, ci, 2 * co), jnp.float32)
    k2x = k2x.at[1, :, :, :, :co].set(flipped[1])
    k2x = k2x.at[1, :, :, :, co:].set(flipped[0])
    k2x = k2x.at[2, :, :, :, co:].set(flipped[2])
    y2, st = conv3_flat(up, k2x, jnp.concatenate([jnp.asarray(b)] * 2),
                        flat_geom(d, 2 * h, 2 * w_), halo=True,
                        halo_keep=jnp.asarray(keep, jnp.float32),
                        emit_stats=True, precision="highest", interpret=True)
    planes = y2[1:d + 1].reshape(d, 2, co, g2.npl).reshape(2 * d, co, g2.npl)
    want = _unflat(jnp.pad(planes, ((1, 1), (0, 0), (0, 0))), g2)
    st = np.asarray(st)
    w_conv = _t(wt).flip(2, 3, 4).transpose(0, 1)
    got = kernels.conv3(_t(x), w_conv, _t(b), dilation=2, emit_stats=True,
                        halo=True, halo_keep=keep)
    assert got[0].shape == (1, 2 * d, 2 * h, 2 * w_, co)
    _held(got, [want, st[:, :co] + st[:, co:]], 1)


@pytest.mark.parametrize("with_prologue", [False, True])
def test_dilated_depth_matches_jax(with_prologue):
    """The depth-dilated conv: source plane j at plane 2j of a 2n-plane
    grid, the odd planes zero after the prologue (a nonzero shift would
    show a prologue applied to them); with the virtual concat."""
    n, h, w_ = 3, 5, 6
    x, x2 = _rand((1, n, h, w_, 4), 50), _rand((1, n, h, w_, 4), 51)
    w, b = _rand((4, 8, 3, 3, 3), 52, 0.1), _rand((4,), 53, 0.1)
    sc, sh = _pro(8, 54)
    kw, jkw = {}, {}
    if with_prologue:
        kw = dict(prologue=(_t(sc), _t(sh)), prologue_act="elu")
        jkw = dict(prologue=(jnp.asarray(sc), jnp.asarray(sh)),
                   prologue_act="elu")
    g_out = flat_geom(2 * n, h, w_)
    want = _unflat(conv3_flat((_flat(x)[0], _flat(x2)[0]), _dhwio(w),
                              jnp.asarray(b), g_out, dilated_depth=n,
                              precision="highest", interpret=True, **jkw),
                   g_out)
    got = kernels.conv3(_t(x), _t(w), _t(b), x2=_t(x2), dilated_depth=n,
                        **kw)
    assert got.shape == (1, 2 * n, h, w_, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_halo_slabs_are_slices_of_the_unsharded_conv():
    """Cut a volume into slabs with their halos (zeros at the ends, keep
    0 there): each slab's output is its share of the unsharded conv at
    stride 1, stride 2 (even slabs) and dilation 2, prologue and moments
    included."""
    x = _rand((1, 12, 5, 6, 8), 60)
    w, b = _rand((8, 8, 3, 3, 3), 61, 0.1), _rand((8,), 62, 0.1)
    sc, sh = _pro(8, 63)
    pro = dict(prologue=(_t(sc), _t(sh)), prologue_act="elu")
    xp = np.pad(x, ((0, 0), (1, 1), (0, 0), (0, 0), (0, 0)))
    n, d = 3, 4
    for opts, scale in ((dict(), 1), (dict(stride=2), 0.5),
                        (dict(dilation=2), 2)):
        whole = kernels.conv3(_t(x), _t(w), _t(b), emit_stats=True,
                              **pro, **opts)
        parts, moments = [], 0
        for r in range(n):
            y, st = kernels.conv3(_t(xp[:, r * d:(r + 1) * d + 2]), _t(w),
                                  _t(b), emit_stats=True, halo=True,
                                  halo_keep=(int(r > 0), int(r < n - 1)),
                                  **pro, **opts)
            assert y.shape[1] == int(d * scale)
            parts.append(y)
            moments = moments + st
        np.testing.assert_allclose(torch.cat(parts, 1).numpy(),
                                   whole[0].numpy(), atol=ATOL)
        np.testing.assert_allclose(moments.numpy(), whole[1].numpy(),
                                   rtol=MOMENTS_RTOL, atol=1e-4)


def test_depth_modes_refuse_what_they_do_not_take():
    x = _t(_rand((1, 5, 4, 4, 8), 70))
    w, b = _t(_rand((8, 8, 3, 3, 3), 71, 0.1)), _t(_rand((8,), 72))
    with pytest.raises(ValueError, match="dilated_depth"):
        kernels.conv3(x, w, b, halo=True, dilated_depth=2)
    with pytest.raises(ValueError, match="halo_keep"):
        kernels.conv3(x, w, b, halo=True, halo_keep=(0.5, 1))
    with pytest.raises(ValueError, match="halo_keep"):
        kernels.conv3(x, w, b, halo_keep=(1, 1))
    with pytest.raises(ValueError, match="two halo planes"):
        kernels.conv3(x[:, :2], w, b, halo=True)
    with pytest.raises(ValueError, match="dilated_depth"):
        kernels.conv3(x, w, b, dilated_depth=2, stride=2)
    with pytest.raises(ValueError, match="dilated_depth"):
        kernels.conv3(x, w, b, dilated_depth=6)
    # halo_keep as a (2,) tensor, as the JAX package passes it
    a = kernels.conv3(x, w, b, halo=True, halo_keep=torch.tensor([0., 1.]))
    c = kernels.conv3(x, w, b, halo=True, halo_keep=(0, 1))
    assert torch.equal(a, c)
