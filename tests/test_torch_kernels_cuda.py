"""The port's CUDA kernels against their plain PyTorch versions on a card.

Every test here needs a CUDA device and skips without one. The file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest`` skips the repository conftest, which configures JAX.)
Tolerances: 1e-5 absolute for conv_in and freq_chain (fp32 FMA order
against cuDNN / cuBLAS in full fp32), 1e-6 on the tail's probabilities.
conv3 sums up to 27 x 768 products in another order than cuDNN: 1e-4
times the output's largest magnitude (at least 1); a TF32 product would
miss by about 5e-4 of it. Its moment sums are held to float64 sums of its
own output, to 1e-5 of the sum of magnitudes. tower_block and
tower_block_s sum up to 56 fp32 products per output in another order than
cuBLAS: 1e-5 times each output's largest magnitude (at least 1); a TF32
operand would miss by about 5e-4 of it. tower_resident chains those blocks
and is held to the same bar against its plain version.
"""
import ctypes

import numpy as np
import pytest
import torch

from multimodal_3d_image_segmentation_tpu_torch import kernels
from multimodal_3d_image_segmentation_tpu_torch.kernels import _build
from multimodal_3d_image_segmentation_tpu_torch.kernels import tail_resize
from multimodal_3d_image_segmentation_tpu_torch.kernels import \
    tower_block as tb
from multimodal_3d_image_segmentation_tpu_torch.kernels import \
    tower_block_s as tbs
from multimodal_3d_image_segmentation_tpu_torch.kernels import \
    tower_resident as tr
from multimodal_3d_image_segmentation_tpu_torch.utils.tower_sweep import \
    BLOCK_SHAPES

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(shape, seed, dev, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(a.astype(np.float32)).to(dev)


def _launched(name, fn):
    before = kernels.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    return out


@pytest.mark.parametrize("shape", [
    (1, 4, 16, 14, 11),   # even D/H, odd W
    (1, 4, 15, 13, 12),   # odd D/H
    (2, 3, 9, 8, 7),      # batch 2
])
@pytest.mark.parametrize("f", [8, 24])
def test_conv_in_kernel_matches_plain(dev, shape, f):
    c = shape[1]
    x = _t(shape, 0, dev)
    w = _t((f, c, 2, 2, 2), 1, dev, 1 / np.sqrt(8 * c))
    b = _t((f,), 2, dev, 0.1)
    with torch.no_grad():
        got = _launched("conv_in", lambda: kernels.conv_in_s2d(x, w, b))
        want = kernels.conv_in_plain(x, w, b)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        raw = kernels.conv_in_s2d(x, w, b, apply_selu=False)
        torch.testing.assert_close(
            raw, kernels.conv_in_plain(x, w, b, apply_selu=False),
            rtol=0, atol=1e-5)


@pytest.mark.parametrize("c", [8, 24])
def test_freq_chain_kernel_matches_plain(dev, c):
    x = _t((1, 10, 14, 14, c), 3, dev)
    ws = [_t((c, c), 4 + k, dev, 1 / np.sqrt(c)) for k in range(3)]
    with torch.no_grad():
        got = _launched("freq_chain",
                        lambda: kernels.fused_freq_chain(x, ws))
        torch.testing.assert_close(got, kernels.freq_chain_plain(x, ws),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape,sizes", [
    ((1, 4, 12, 10, 8), (31, 25, 19)),
    ((1, 2, 7, 9, 11), (14, 18, 22)),
    ((1, 3, 6, 8, 8), (6, 8, 8)),
    ((1, 8, 16, 6, 6), (9, 11, 13)),
])
def test_tail_kernel_matches_plain(dev, shape, sizes):
    x = _t(shape, 5, dev, 3.0)
    with torch.no_grad():
        got = _launched("tail_resize",
                        lambda: kernels.fused_tail_softmax(x, sizes))
        torch.testing.assert_close(got, kernels.tail_plain(x, sizes),
                                   rtol=0, atol=1e-6)


# Planes whose size H x W is and is not a multiple of 4 (16-byte stores or
# one value at a time), several bands of 16 output rows, downsampling and
# identity sizes
TAIL_BAND_CASES = [
    ((6, 20, 9), (11, 40, 18)),   # H W = 720: 16-byte stores, 3 bands
    ((5, 9, 7), (9, 37, 15)),     # H W = 555: one value at a time
    ((10, 36, 30), (6, 20, 12)),  # downsampling, H W = 240
    ((12, 40, 22), (7, 19, 11)),  # downsampling, H W = 209
    ((6, 8, 8), (6, 8, 8)),       # identity, H W = 64
    ((5, 7, 9), (5, 7, 9)),       # identity, H W = 63
]


@pytest.mark.parametrize("sizes_in,sizes", TAIL_BAND_CASES)
@pytest.mark.parametrize("c", [1, 4, 8])
def test_tail_kernel_bands_match_plain(dev, sizes_in, sizes, c):
    x = _t((1, c) + sizes_in, 9, dev, 3.0)
    with torch.no_grad():
        got = _launched("tail_resize",
                        lambda: kernels.fused_tail_softmax(x, sizes))
        torch.testing.assert_close(got, kernels.tail_plain(x, sizes),
                                   rtol=0, atol=1e-6)
        assert torch.equal(kernels.fused_tail_softmax(x, sizes), got)


@pytest.mark.parametrize("shape,sizes", [
    ((1, 8, 3, 6, 200), (4, 9, 300)),  # 4-row bands, within 48 KB
    ((1, 8, 3, 6, 600), (4, 9, 700)),  # 4-row bands past 48 KB (opt-in)
])
def test_tail_kernel_wide_rows_match_plain(dev, shape, sizes):
    x = _t(shape, 10, dev, 3.0)
    with torch.no_grad():
        got = _launched("tail_resize",
                        lambda: kernels.fused_tail_softmax(x, sizes))
        torch.testing.assert_close(got, kernels.tail_plain(x, sizes),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("c", [1, 4, 8])
@pytest.mark.parametrize("rows", [4, 8, 16])
@pytest.mark.parametrize("sizes_in,sizes", [
    ((121, 121, 78), (240, 240, 155)),  # the serving shape
    ((3, 6, 600), (4, 9, 700)),
    ((12, 40, 22), (7, 19, 11)),       # downsampling
])
def test_tail_smem_bytes_follow_the_c_layout(dev, c, rows, sizes_in, sizes):
    """tail_smem_bytes, which tail_supported bounds, equals the shared
    memory that the C side gives a block of the tail kernel."""
    got = ctypes.c_int(0)
    _build.call("m3seg_tail_smem_bytes", c, rows, sizes_in[1], sizes_in[2],
                sizes[1], sizes[2], ctypes.byref(got))
    assert tail_resize.tail_smem_bytes(c, rows, sizes_in[1], sizes_in[2],
                                       sizes[1], sizes[2]) == got.value


@pytest.mark.parametrize("c", [4, 8])
def test_tail_kernel_takes_the_widest_rows_it_routes(dev, c):
    """The widest input row that tail_supported accepts launches and
    matches the plain version; one column more is refused for its shared
    memory."""
    w = next(w for w in range(1, 4096)
             if not kernels.tail_supported((1, c, 3, 6, w + 1), (4, 9, w + 1)))
    x = _t((1, c, 3, 6, w), 12, dev, 3.0)
    with torch.no_grad():
        got = _launched("tail_resize",
                        lambda: kernels.fused_tail_softmax(x, (4, 9, w)))
        torch.testing.assert_close(got, kernels.tail_plain(x, (4, 9, w)),
                                   rtol=0, atol=1e-6)
    wide = _t((1, c, 3, 6, w + 1), 12, dev, 3.0)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.fused_tail_softmax(wide, (4, 9, w + 1))


def test_kernels_refuse_what_they_do_not_take(dev):
    x = _t((1, 4, 8, 8, 8), 6, dev)
    w = _t((24, 4, 2, 2, 2), 7, dev)
    b = _t((24,), 8, dev)
    with pytest.raises(TypeError):
        kernels.conv_in_s2d(x.double(), w.double(), b.double())
    with pytest.raises(ValueError):
        kernels.conv_in_s2d(x.transpose(2, 3), w, b)  # not contiguous
    with pytest.raises(ValueError):
        kernels.conv_in_s2d(x, w.cpu(), b)             # wrong device
    with pytest.raises(ValueError):
        kernels.fused_freq_chain(_t((1, 4, 4, 4, 12), 9, dev),
                                 [_t((12, 12), 10, dev)])  # no C=12 instance
    with pytest.raises(ValueError):
        kernels.conv_in_s2d(x, _t((16, 4, 2, 2, 2), 11, dev),
                            _t((16,), 12, dev))        # no F=16 instance
    wg = w.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kernels.conv_in_s2d(x, wg, b)                  # forward only
    with torch.no_grad():
        kernels.conv_in_s2d(x, wg, b)


def _moments64(y):
    y = y.double().reshape(-1, y.shape[-1])
    return torch.stack([y.sum(0), (y * y).sum(0)]), torch.stack(
        [y.abs().sum(0), (y * y).sum(0)])


def _close(got, want):
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= tol


CONV3_OPTIONS = ["bare", "x2", "prologue_elu", "prologue_selu",
                 "residual_stats", "x2_residual_stats", "stride2",
                 "dilation2"]


@pytest.mark.parametrize("sizes,ci,co", [
    # small grids: the taps split over blocks (but in the dilated mode)
    *[(s, ci, co) for s in ((9, 8, 7), (8, 6, 10))
      for ci, co in ((24, 24), (48, 96), (384, 384), (8, 12))],
    ((48, 40, 30), 24, 24),   # enough blocks: one pass, no split
    ((31, 31, 20), 96, 96),
    # no axis a multiple of any brick
    ((13, 11, 9), 24, 24),
    ((7, 17, 21), 48, 24),
])
@pytest.mark.parametrize("option", CONV3_OPTIONS)
def test_conv3_kernel_matches_plain(dev, sizes, ci, co, option):
    x, w, b, kw = _conv3_case(dev, sizes, ci, co, option)
    _conv3_held(lambda: kernels.conv3(x, w, b, **kw),
                kernels.conv3_plain(x, w, b, **kw), kw)


def _conv3_case(dev, sizes, ci, co, option, c2=None):
    if c2 is None:
        c2 = ci if option.startswith("x2") else 0
    x = _t((1,) + sizes + (ci,), 20, dev)
    x2 = _t((1,) + sizes + (c2,), 21, dev) if c2 else None
    w = _t((co, ci + c2, 3, 3, 3), 22, dev, 1 / np.sqrt(27 * (ci + c2)))
    b = _t((co,), 23, dev, 0.1)
    kw = dict(x2=x2)
    if option.startswith("prologue"):
        kw.update(prologue=(_t((ci + c2,), 24, dev, 0.3) + 1,
                            _t((ci + c2,), 25, dev)),
                  prologue_act=option.split("_")[1], emit_stats=True)
    if option.endswith("residual_stats"):
        kw.update(residual=(_t((co, ci + c2), 26, dev,
                               1 / np.sqrt(ci + c2)), _t((co,), 27, dev)),
                  emit_stats=True)
    if option == "stride2":
        kw.update(stride=2, emit_stats=True)
    if option == "dilation2":
        kw.update(dilation=2, emit_stats=True)
    return x, w, b, kw


def _conv3_held(kern, want, kw):
    """One launch of ``kern`` against the plain outputs ``want``; returns
    the kernel's outputs."""
    with torch.no_grad():
        got = _launched("conv3", kern)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    n_out = 2 if kw.get("residual") is not None else 1
    for g, wt in zip(got[:n_out], want[:n_out]):
        _close(g, wt)
    for y, st in zip(got[:n_out], got[n_out:]):
        exact, scale = _moments64(y)
        assert float(((st.double() - exact).abs() - 1e-5 * scale).max()) <= 0
    return got


# forced plans (W run, brick depth, height, runs along W, channel tile,
# chunk, split): each W run, bricks that divide no axis, a 16-channel chunk
# that spans the x1/x2 boundary at channel 24, splits of the chunks
CONV3_PLANS = [(8, 2, 2, 1, 24, 16, 1), (5, 1, 4, 2, 24, 8, 2),
               (8, 4, 2, 2, 24, 4, 3), (5, 2, 1, 1, 8, 16, 1),
               (8, 1, 1, 1, 16, 4, 5)]


@pytest.mark.parametrize("choice", CONV3_PLANS)
@pytest.mark.parametrize("option", CONV3_OPTIONS)
def test_conv3_kernel_plans_match_plain(dev, choice, option):
    import importlib
    conv3_mod = importlib.import_module(
        "multimodal_3d_image_segmentation_tpu_torch.kernels.conv3")
    x, w, b, kw = _conv3_case(dev, (7, 9, 13), 24, 24, option)
    real = conv3_mod.conv3_plan

    def forced(sizes, ci, co, mode, _=None):
        return real(sizes, ci, co, mode, choice)

    conv3_mod.conv3_plan = forced
    try:
        _conv3_held(lambda: kernels.conv3(x, w, b, **kw),
                    kernels.conv3_plain(x, w, b, **kw), kw)
    finally:
        conv3_mod.conv3_plan = real


def test_conv3_vnetds_calls_match_plain(dev):
    """Every conv3 call of a V-Net-DS forward (base 24, blocks
    [1,2,3,3,3]: each (grid level, ci, co, mode, options) of the 29 calls
    at the serving width, on a 40x36x30 volume) against the plain version;
    a second call gives the same bits and leaves the inputs untouched."""
    from multimodal_3d_image_segmentation_tpu_torch.models import (
        VNetDS, architectures)
    model = VNetDS(4, 4, 24, [1, 2, 3, 3, 3],
                   right_leg_indexes=[0, 1, 2, 3, 4], use_kernels=True,
                   generator=torch.Generator().manual_seed(0)).to(dev)
    calls, real = [], architectures.conv3

    def recording(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    architectures.conv3 = recording
    try:
        with torch.no_grad():
            model(_t((1, 4, 40, 36, 30), 70, dev))
    finally:
        architectures.conv3 = real
    assert len(calls) == 29
    with torch.no_grad():
        for args, kw in calls:
            ins = [t for t in (args[0], kw.get("x2")) if t is not None]
            inputs = [t.clone() for t in ins]
            got = _conv3_held(lambda: kernels.conv3(*args, **kw),
                              kernels.conv3_plain(*args, **kw), kw)
            again = kernels.conv3(*args, **kw)
            again = again if isinstance(again, tuple) else (again,)
            assert all(torch.equal(a, g) for a, g in zip(again, got))
            assert all(torch.equal(a, b) for a, b in zip(inputs, ins))


def test_conv3_refuses_what_it_does_not_take(dev):
    x = _t((1, 6, 6, 6, 24), 30, dev)
    w = _t((24, 24, 3, 3, 3), 31, dev, 0.05)
    b = _t((24,), 32, dev)
    with pytest.raises(NotImplementedError, match="item 12"):
        kernels.conv3(x.bfloat16(), w, b)
    with pytest.raises(NotImplementedError, match="item 15"):
        kernels.conv3(x, w, b, halo=True)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.conv3(x.transpose(1, 2), w, b)
    with pytest.raises(ValueError, match="cpu"):
        kernels.conv3(x, w.cpu(), b)
    with pytest.raises(ValueError, match="multiples of 4"):
        kernels.conv3(x[..., :6].contiguous(), w[:, :6].contiguous(), b)
    with pytest.raises(TypeError):
        kernels.conv3(x.double(), w.double(), b.double())


def _tower_inputs(dev, sizes, modes, c, n_ds, seed=40, transform="Hartley",
                  resident=False):
    """A block's operands; the spectrum operand is z (tower_block) or,
    with ``resident``, the resident spectrum sy (tower_block_s)."""
    spec = tb.make_tower_spec(transform, sizes, modes, c, n_ds=n_ds)
    x = _t(sizes + (c,), seed, dev)
    ops = [_t((c, c), seed + 5 + i, dev, 1 / np.sqrt(c))
           for i in range(1 if transform == "Hartley" else 2)]
    with torch.no_grad():
        s = tb.spectrum_mix(tb.d_stage_forward(tb.entry_forward_hw(x, spec),
                                               spec), ops, spec)
        s = s if resident else tb.d_stage_inverse(s, spec)
    w_cat = _t((2 * c + n_ds, c), seed + 1, dev, 1 / np.sqrt(c))
    w_cc_t = _t((c, c), seed + 2, dev, 1 / np.sqrt(c))
    b_cat = _t((2 * c,), seed + 3, dev, 0.1)
    ds_prev = _t(sizes + (n_ds,), seed + 4, dev) if n_ds else None
    return (x, s.contiguous(), w_cat, w_cc_t, b_cat, spec, ds_prev)


def _held_to_plain(name, kern, plain, args):
    with torch.no_grad():
        got = _launched(name, lambda: kern(*args))
        want = plain(*args)
        again = kern(*args)
    assert len(got) == len(want) == (3 if args[-1] is not None else 2)
    for g, wt, a in zip(got, want, again):
        assert g.shape == wt.shape and g.dtype == torch.float32
        tol = 1e-5 * max(1.0, float(wt.abs().max()))
        assert float((g - wt).abs().max()) <= tol
        assert torch.equal(g, a)  # no atomics: the same from run to run


@pytest.mark.parametrize("sizes,modes", [
    ((7, 9, 6), (2, 3, 2)),       # one ragged W tile, one ragged H chunk
    ((9, 37, 21), (3, 5, 4)),     # ragged tiles and chunks, odd sizes
    ((6, 64, 16), (2, 4, 3)),     # whole tiles and chunks
    ((16, 33, 30), (8, 12, 12)),  # the config's modes
    # H 37 leaves the last 32-row chunk of both passes 5 rows, W 19 the
    # last 8-column tile 3 columns
    ((5, 37, 19), (2, 5, 4)),
])
@pytest.mark.parametrize("c", [8, 24])
@pytest.mark.parametrize("n_ds", [0, 3, 4])
def test_tower_block_kernel_matches_plain(dev, sizes, modes, c, n_ds):
    args = _tower_inputs(dev, sizes, modes, c, n_ds)
    with torch.no_grad():
        got = _launched("tower_block", lambda: kernels.fused_tower_block(*args))
        want = kernels.tower_block_plain(*args)
        again = kernels.fused_tower_block(*args)
    assert len(got) == len(want) == (3 if n_ds else 2)
    for g, wt, a in zip(got, want, again):
        assert g.shape == wt.shape and g.dtype == torch.float32
        tol = 1e-5 * max(1.0, float(wt.abs().max()))
        assert float((g - wt).abs().max()) <= tol
        assert torch.equal(g, a)  # no atomics: the same from run to run


@pytest.mark.parametrize("sizes,modes", [
    ((7, 9, 7), (2, 3, 3)),       # odd KW = 3: rows at odd offsets
    ((9, 37, 21), (3, 5, 4)),     # ragged tiles and chunks, odd sizes
    ((21, 33, 30), (10, 14, 14)),  # the config's modes, KW 14
    ((5, 37, 19), (2, 5, 5)),     # ragged last chunk and tile, odd KW 5
])
@pytest.mark.parametrize("c", [8, 24])
@pytest.mark.parametrize("n_ds", [0, 3, 4])
def test_tower_block_kernel_matches_plain_fourier(dev, sizes, modes, c,
                                                  n_ds):
    _held_to_plain("tower_block", kernels.fused_tower_block,
                   kernels.tower_block_plain,
                   _tower_inputs(dev, sizes, modes, c, n_ds,
                                 transform="Fourier"))


@pytest.mark.parametrize("transform,sizes,modes", [
    ("Hartley", (7, 9, 6), (2, 3, 2)),     # one ragged W tile and H chunk
    ("Hartley", (9, 37, 21), (3, 5, 4)),   # ragged tiles and chunks
    ("Hartley", (21, 33, 30), (10, 14, 14)),  # the configs' modes, KS 20
    ("Fourier", (7, 9, 7), (2, 3, 3)),     # odd KW = 3
    ("Fourier", (9, 37, 21), (3, 5, 5)),   # odd sizes, odd KW = 5
    ("Fourier", (21, 33, 30), (10, 14, 14)),  # KS 40, KW 14
])
@pytest.mark.parametrize("c", [8, 24])
@pytest.mark.parametrize("n_ds", [0, 4])
def test_tower_block_s_kernel_matches_plain(dev, transform, sizes, modes, c,
                                            n_ds):
    _held_to_plain("tower_block_s", kernels.fused_tower_block_s,
                   kernels.tower_block_s_plain,
                   _tower_inputs(dev, sizes, modes, c, n_ds, 41, transform,
                                 resident=True))


# The depth pass's 8 plane groups left short or empty, W tiles of 8 left
# ragged, spectrum rows not a multiple of the depth pass's 4 per thread. At
# these D each of the z pass's 64 plane groups holds one plane or none;
# test_tower_block_s_z_groups_match_plain takes groups of several planes.
@pytest.mark.parametrize("transform,sizes,modes", [
    ("Hartley", (21, 9, 19), (3, 3, 2)),  # D 21; KS 6
    ("Fourier", (37, 6, 13), (3, 2, 3)),  # D 37, odd KW 3, KS 12
    ("Hartley", (5, 11, 10), (2, 4, 3)),  # D 5: empty depth groups
    ("Fourier", (18, 9, 9), (4, 3, 4)),   # D 18: two empty depth groups
])
@pytest.mark.parametrize("c", [8, 24])
@pytest.mark.parametrize("n_ds", [0, 4])
def test_tower_block_s_passes_match_plain(dev, transform, sizes, modes, c,
                                          n_ds):
    _held_to_plain("tower_block_s", kernels.fused_tower_block_s,
                   kernels.tower_block_s_plain,
                   _tower_inputs(dev, sizes, modes, c, n_ds, 43, transform,
                                 resident=True))


def _z_group_planes(case):
    """A depth D for the z pass's plane groups, worked out from the C
    side's group count G, so that a change of G keeps the case:
    ``short`` 4 G - 1 (groups of 4, the last of 3), ``ragged`` 5 G - 3
    (groups of 5, a step of 4 then 1, the last group of 2), ``empty``
    2 G + 1 (groups of 3, the last third of the groups empty)."""
    g, dg = ctypes.c_int(0), ctypes.c_int(0)
    _build.call("m3seg_tower_spectrum_groups", ctypes.byref(g),
                ctypes.byref(dg))
    g = g.value
    return {"short": 4 * g - 1, "ragged": 5 * g - 3, "empty": 2 * g + 1}[case]


@pytest.mark.parametrize("transform,n_ds", [("Hartley", 0), ("Fourier", 4)])
@pytest.mark.parametrize("c", [8, 24])
@pytest.mark.parametrize("case", ["short", "ragged", "empty"])
def test_tower_block_s_z_groups_match_plain(dev, transform, n_ds, c, case):
    """z groups of several planes, stepped four at a time (z_group_element),
    on a small plane so that D can pass the group count several times."""
    d = _z_group_planes(case)
    _held_to_plain("tower_block_s", kernels.fused_tower_block_s,
                   kernels.tower_block_s_plain,
                   _tower_inputs(dev, (d, 9, 7), (3, 3, 2), c, n_ds, 44,
                                 transform, resident=True))


def test_tower_block_s_refuses_what_it_does_not_take(dev):
    x, sy, w_cat, w_cc_t, b_cat, spec, ds_prev = _tower_inputs(
        dev, (7, 9, 6), (2, 3, 2), 24, 4, resident=True)
    with pytest.raises(ValueError, match="sy has shape"):
        kernels.fused_tower_block_s(x, sy[:3].contiguous(), w_cat, w_cc_t,
                                    b_cat, spec, ds_prev)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.fused_tower_block_s(x, sy.transpose(2, 3).contiguous()
                                    .transpose(2, 3), w_cat, w_cc_t, b_cat,
                                    spec, ds_prev)
    with pytest.raises(ValueError, match="cpu"):
        kernels.fused_tower_block_s(x, sy.cpu(), w_cat, w_cc_t, b_cat, spec,
                                    ds_prev)
    with pytest.raises(TypeError, match="float32"):
        kernels.fused_tower_block_s(*(t.double() for t in (x, sy, w_cat,
                                                           w_cc_t, b_cat)),
                                    spec, ds_prev.double())
    x12, s12, w12, wc12, b12, spec12, _ = _tower_inputs(
        dev, (7, 9, 6), (2, 3, 2), 12, 0, resident=True)
    with pytest.raises(ValueError, match="no instance for C=12"):
        kernels.fused_tower_block_s(x12, s12, w12, wc12, b12, spec12)
    wg = w_cat.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kernels.fused_tower_block_s(x, sy, wg, w_cc_t, b_cat, spec, ds_prev)
    # 2 * KD = 66 spectrum rows: more than MAX_SPECTRUM_ROWS (64)
    xb, sb, wb, wcb, bb, specb, _ = _tower_inputs(
        dev, (66, 9, 6), (33, 3, 2), 8, 0, transform="Fourier",
        resident=True)
    with pytest.raises(ValueError, match="spectrum rows"):
        kernels.fused_tower_block_s(xb, sb, wb, wcb, bb, specb)


@pytest.mark.parametrize("modes", [(8, 12, 12), (10, 14, 14)])
def test_tower_kernels_keep_two_blocks_per_sm(dev, modes):
    """At the serving shapes' modes and C 24, each tower kernel leaves room
    for two blocks of 256 threads on an SM (128 registers a thread and
    under half the SM's shared memory)."""
    spec = tb.make_tower_spec("Hartley", (121, 121, 78), modes, 24)
    for occ in (tb.occupancy(spec), tbs.occupancy(spec), tr.occupancy(spec)):
        assert occ[0] >= 2 and occ[1] <= 128


@pytest.mark.parametrize("label,transform,modes,n_ds", BLOCK_SHAPES)
@pytest.mark.parametrize("c", [8, 24])
def test_kernel_smem_bytes_follow_the_c_layout(dev, label, transform, modes,
                                               n_ds, c):
    """kernel_smem_bytes, which the wrappers check before a launch, equals
    the shared memory that the C side gives each block of the tower
    kernels, at the shapes that serve tower_block."""
    spec = tb.make_tower_spec(transform, (121, 121, 78), modes, c, n_ds=n_ds)
    got = ctypes.c_int(0)
    _build.call("m3seg_tower_smem_bytes", spec.channels, spec.kh, spec.kw,
                ctypes.byref(got))
    assert tb.kernel_smem_bytes(spec) == got.value


def test_tower_block_occupancy_is_reported(dev):
    spec = tb.make_tower_spec("Hartley", (21, 33, 30), (10, 14, 14), 24)
    for blocks, regs in (tb.occupancy(spec), tbs.occupancy(spec)):
        assert blocks >= 1 and 0 < regs <= 128


def test_tower_block_refuses_what_it_does_not_take(dev):
    x, z, w_cat, w_cc_t, b_cat, spec, ds_prev = _tower_inputs(
        dev, (7, 9, 6), (2, 3, 2), 24, 4)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.fused_tower_block(x, z.transpose(3, 4).contiguous()
                                  .transpose(3, 4), w_cat, w_cc_t, b_cat,
                                  spec, ds_prev)
    with pytest.raises(ValueError, match="cpu"):
        kernels.fused_tower_block(x, z, w_cat.cpu(), w_cc_t, b_cat, spec,
                                  ds_prev)
    with pytest.raises(TypeError, match="float32"):
        kernels.fused_tower_block(*(t.double() for t in (x, z, w_cat,
                                                         w_cc_t, b_cat)),
                                  spec, ds_prev.double())
    x12, z12, w12, wc12, b12, spec12, _ = _tower_inputs(dev, (7, 9, 6),
                                                        (2, 3, 2), 12, 0)
    with pytest.raises(ValueError, match="no instance for C=12"):
        kernels.fused_tower_block(x12, z12, w12, wc12, b12, spec12)
    wg = w_cat.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kernels.fused_tower_block(x, z, wg, w_cc_t, b_cat, spec, ds_prev)


@pytest.mark.parametrize("patch", [None, 2])
def test_hartleymha_kernel_path_matches_plain_path(dev, patch):
    from multimodal_3d_image_segmentation_tpu_torch.models import \
        HartleyMHASeg
    kw = dict(in_channels=2, out_channels=3, filters=8,
              num_transform_blocks=2, num_heads=2, num_modes=(2, 3, 2),
              patch_size=patch)
    plain = HartleyMHASeg(**kw, device=dev)
    fast = HartleyMHASeg(**kw, use_kernels=True, device=dev)
    fast.load_state_dict(plain.state_dict())
    x = _t((1, 2, 15, 17, 13), 50, dev)
    before = dict(kernels.LAUNCHES)
    with torch.no_grad():
        got, want = fast(x), plain(x)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["tower_block"] == before["tower_block"] + 2
    assert kernels.LAUNCHES["conv_in"] == before["conv_in"] + 1
    assert kernels.LAUNCHES["tail_resize"] == before["tail_resize"] + 1
    torch.testing.assert_close(got, want, rtol=0, atol=3e-5)


@pytest.mark.parametrize("transform", ["Hartley", "Fourier"])
@pytest.mark.parametrize("tower_kernel,ds", [
    ("block_s", False), ("block_s", True), ("block", False), ("block", True),
    ("resident", False)])
def test_neuraloperatorseg_kernel_path_matches_plain_path(dev, transform,
                                                          tower_kernel, ds):
    from multimodal_3d_image_segmentation_tpu_torch.models import \
        NeuralOperatorSeg
    kw = dict(in_channels=2, out_channels=3, filters=8,
              num_transform_blocks=3, num_modes=(2, 3, 3),
              transform_type=transform, use_deep_supervision=ds)
    plain = NeuralOperatorSeg(**kw, device=dev)
    fast = NeuralOperatorSeg(**kw, use_kernels=True,
                             tower_kernel=tower_kernel, device=dev)
    fast.load_state_dict(plain.state_dict())
    x = _t((1, 2, 15, 17, 13), 51, dev)
    before = dict(kernels.LAUNCHES)
    with torch.no_grad():
        got, want = fast(x), plain(x)
    torch.cuda.synchronize()
    name, n = {"block_s": ("tower_block_s", 3), "block": ("tower_block", 3),
               "resident": ("tower_resident", 1)}[tower_kernel]
    assert kernels.LAUNCHES[name] == before[name] + n
    assert kernels.LAUNCHES["conv_in"] == before["conv_in"] + 1
    assert kernels.LAUNCHES["tail_resize"] == before["tail_resize"] + 1
    torch.testing.assert_close(got, want, rtol=0, atol=3e-5)


@pytest.mark.parametrize("patch", [None, 2])
def test_hartleymha_block_s_kernel_path_matches_plain_path(dev, patch):
    from multimodal_3d_image_segmentation_tpu_torch.models import \
        HartleyMHASeg
    kw = dict(in_channels=2, out_channels=3, filters=8,
              num_transform_blocks=2, num_heads=2, num_modes=(2, 3, 2),
              patch_size=patch)
    plain = HartleyMHASeg(**kw, device=dev)
    fast = HartleyMHASeg(**kw, use_kernels=True, tower_kernel="block_s",
                         device=dev)
    fast.load_state_dict(plain.state_dict())
    x = _t((1, 2, 15, 17, 13), 52, dev)
    before = kernels.LAUNCHES["tower_block_s"]
    with torch.no_grad():
        got, want = fast(x), plain(x)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["tower_block_s"] == before + 2
    torch.testing.assert_close(got, want, rtol=0, atol=3e-5)


def _resident_inputs(dev, transform, sizes, modes, c, nb, seed=60):
    """x and the stacked weights of nb blocks (op weights scaled as the
    SNN init, 1 / sqrt(C))."""
    spec = tb.make_tower_spec(transform, sizes, modes, c)
    pr = 1 if transform == "Hartley" else 2
    return (_t(sizes + (c,), seed, dev),
            _t((nb, pr, c, c), seed + 1, dev, 1 / np.sqrt(c)),
            _t((nb, 2 * c, c), seed + 2, dev, 1 / np.sqrt(c)),
            _t((nb, c, c), seed + 3, dev, 1 / np.sqrt(c)),
            _t((nb, 2 * c), seed + 4, dev, 0.1), spec)


@pytest.mark.parametrize("transform,sizes,modes", [
    ("Hartley", (7, 9, 6), (2, 3, 2)),     # one ragged W tile and H chunk
    ("Hartley", (9, 37, 21), (3, 5, 4)),   # ragged tiles and chunks
    ("Hartley", (21, 33, 30), (10, 14, 14)),  # the configs' modes, KS 20
    ("Fourier", (7, 9, 7), (2, 3, 3)),     # odd KW = 3
    ("Fourier", (9, 37, 21), (3, 5, 5)),   # odd sizes, odd KW = 5
    ("Fourier", (21, 33, 30), (10, 14, 14)),  # KS 40, KW 14
    # D 11: the depth pass's 8 plane groups do not divide it; ragged
    # chunks and tiles
    ("Hartley", (11, 37, 19), (3, 5, 4)),
    ("Fourier", (11, 37, 19), (3, 5, 5)),
])
@pytest.mark.parametrize("c", [8, 24])
@pytest.mark.parametrize("nb", [1, 3])
def test_tower_resident_kernel_matches_plain(dev, transform, sizes, modes, c,
                                             nb):
    args = _resident_inputs(dev, transform, sizes, modes, c, nb)
    x0 = args[0].clone()
    with torch.no_grad():
        got = _launched("tower_resident", lambda: kernels.resident_tower(*args))
        want = kernels.resident_tower_plain(*args)
        again = kernels.resident_tower(*args)
    assert got.shape == want.shape and got.dtype == torch.float32
    tol = 1e-5 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol
    assert torch.equal(got, again)  # no atomics: the same from run to run
    assert torch.equal(args[0], x0)  # the caller's x is not written


@pytest.mark.parametrize("transform,modes", [("Hartley", (2, 3, 2)),
                                             ("Fourier", (2, 3, 3))])
@pytest.mark.parametrize("d", [8, 21, 37, 78])
@pytest.mark.parametrize("nb", [2, 3])
def test_tower_resident_c8_over_blocks_matches_plain(dev, transform, modes,
                                                     d, nb):
    """C 8 over several blocks, so that every block after the first reads a
    z that the z phase formed from the kernel's own mix. Of the z phase's
    64 plane groups, D 8, 21 and 37 fill the first D with one plane each,
    and D 78 the first 39 with two; test_tower_resident_z_groups_match_plain
    takes groups of three to five planes."""
    args = _resident_inputs(dev, transform, (d, 9, 7), modes, 8, nb)
    with torch.no_grad():
        got = _launched("tower_resident", lambda: kernels.resident_tower(*args))
        want = kernels.resident_tower_plain(*args)
    tol = 1e-5 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("transform,modes", [("Hartley", (3, 3, 2)),
                                             ("Fourier", (3, 3, 3))])
@pytest.mark.parametrize("c", [8, 24])
@pytest.mark.parametrize("case", ["short", "ragged", "empty"])
def test_tower_resident_z_groups_match_plain(dev, transform, modes, c, case):
    """The z phase over groups of several planes (see _z_group_planes),
    over two blocks so that the second reads a z formed from the kernel's
    own mix."""
    args = _resident_inputs(dev, transform, (_z_group_planes(case), 9, 7),
                            modes, c, 2)
    with torch.no_grad():
        got = _launched("tower_resident", lambda: kernels.resident_tower(*args))
        want = kernels.resident_tower_plain(*args)
        again = kernels.resident_tower(*args)
    tol = 1e-5 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol
    assert torch.equal(got, again)


def test_tower_resident_matches_the_block_s_chain(dev):
    """The one launch equals tower_block_s launched block by block with the
    operator between them, to the fp32 rounding of the mix."""
    x, ops, wcat, wcc, b, spec = _resident_inputs(
        dev, "Fourier", (9, 37, 21), (3, 5, 5), 8, 3)
    with torch.no_grad():
        got = kernels.resident_tower(x, ops, wcat, wcc, b, spec)
        s = tbs.spectrum_mix_s(tbs.entry_spectrum_s(x, spec), ops[0], spec)
        for i in range(3):
            x, s_f = kernels.fused_tower_block_s(x, s.contiguous(), wcat[i],
                                                 wcc[i], b[i], spec)
            if i < 2:
                s = tbs.spectrum_mix_s(s_f, ops[i + 1], spec)
    assert float((got - x).abs().max()) <= 1e-5 * max(1.0,
                                                      float(x.abs().max()))


def test_tower_resident_refuses_what_it_does_not_take(dev):
    x, ops, wcat, wcc, b, spec = _resident_inputs(dev, "Fourier", (7, 9, 7),
                                                  (2, 3, 3), 24, 2)
    with pytest.raises(ValueError, match="op_stack has shape"):
        kernels.resident_tower(x, ops[:, :1].contiguous(), wcat, wcc, b, spec)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.resident_tower(x.transpose(1, 2).contiguous().transpose(1, 2),
                               ops, wcat, wcc, b, spec)
    with pytest.raises(ValueError, match="cpu"):
        kernels.resident_tower(x, ops, wcat.cpu(), wcc, b, spec)
    with pytest.raises(TypeError, match="float32"):
        kernels.resident_tower(*(t.double() for t in (x, ops, wcat, wcc, b)),
                               spec)
    with pytest.raises(ValueError, match="deep supervision"):
        kernels.resident_tower(x, ops, wcat, wcc, b, spec._replace(n_ds=4))
    wg = wcat.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kernels.resident_tower(x, ops, wg, wcc, b, spec)
    args12 = _resident_inputs(dev, "Hartley", (7, 9, 6), (2, 3, 2), 12, 1)
    with pytest.raises(ValueError, match="no instance for C=12"):
        kernels.resident_tower(*args12)
    # 2 * KD = 66 spectrum rows: more than MAX_SPECTRUM_ROWS (64)
    argsb = _resident_inputs(dev, "Fourier", (66, 9, 6), (33, 3, 2), 8, 1)
    with pytest.raises(ValueError, match="spectrum rows"):
        kernels.resident_tower(*argsb)


def test_tower_resident_grid_is_reported(dev):
    spec = tb.make_tower_spec("Hartley", (21, 33, 30), (10, 14, 14), 24)
    blocks, regs = tr.occupancy(spec)
    assert blocks >= 1 and 0 < regs <= 255
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    assert tr.resident_grid(spec) == blocks * n_sm


def test_tower_resident_phases_are_timed(dev):
    args = _resident_inputs(dev, "Hartley", (9, 37, 21), (3, 5, 4), 8, 3)
    tr.phase_ms(reset=True)
    with torch.no_grad():
        kernels.resident_tower(*args)
    got = tr.phase_ms(reset=True)
    assert len(got) == 5 and "z" in got  # the z phase, once per block
    assert set(got) == set(tr.PHASES) and all(v > 0 for v in got.values())
    assert all(v == 0 for v in tr.phase_ms().values())
