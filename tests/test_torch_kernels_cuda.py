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
and is held to the same bar against its plain version. The backward
passes of all seven kernels (their ``torch.autograd.Function``s) are held
to autograd through the plain twins: 1e-5 times each gradient's largest
magnitude (at least 1), fp32 sums over up to 148,840 voxels in another
order. One train step of each family on its kernel path is held to its
plain path: 1e-4 of each gradient's largest magnitude (at least 1), the
whole-model bar of the CPU tests.
"""
import ctypes

import numpy as np
import pytest
import torch

from multimodal_3d_image_segmentation_tpu_torch import kernels
from multimodal_3d_image_segmentation_tpu_torch.kernels import _build
from multimodal_3d_image_segmentation_tpu_torch.kernels import tail_resize
from multimodal_3d_image_segmentation_tpu_torch.kernels.conv3 import \
    flat_call
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


@pytest.mark.parametrize("shape", [
    (1, 4, 6, 8, 11),     # W odd
    (1, 4, 6, 8, 16),     # W a multiple of 4
    (1, 4, 4, 12, 155),   # the serving W: bands of 2 rows, H2 = 7
    (1, 4, 5, 13, 155),   # spans at every offset modulo 4 (below)
    (2, 4, 5, 9, 13),     # batch 2
    (1, 4, 7, 9, 13),     # odd D and H
    (1, 4, 3, 5, 300),    # a band of one row of 151 threads
    (1, 4, 2, 3, 600),    # rows wider than a block: two voxels a thread
    (1, 1, 3, 30, 3),     # one channel, 8-row bands of 2 voxels a row
])
@pytest.mark.parametrize("f", [8, 24])
@pytest.mark.parametrize("selu", [True, False])
def test_conv_in_kernel_bands_match_plain(dev, shape, f, selu):
    b_, c, d, h, w_ = shape
    if shape == (1, 4, 5, 13, 155):
        # the first band's spans start at every offset modulo 4 floats:
        # plane c * D of a volume of odd H * W
        assert {(ci * d * h * w_) % 4 for ci in range(c)} == {0, 1, 2, 3}
    x = _t(shape, 20, dev)
    w = _t((f, c, 2, 2, 2), 21, dev, 1 / np.sqrt(8 * c))
    b = _t((f,), 22, dev, 0.1)
    with torch.no_grad():
        got = _launched("conv_in",
                        lambda: kernels.conv_in_s2d(x, w, b, apply_selu=selu))
        torch.testing.assert_close(
            got, kernels.conv_in_plain(x, w, b, apply_selu=selu),
            rtol=0, atol=1e-5)


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("shape", [(1, 4, 5, 13, 155), (1, 1, 5, 7, 13)])
def test_conv_in_kernel_takes_an_unaligned_view(dev, shape, offset):
    # a contiguous view that starts `offset` floats into its storage, as
    # batch element 1 of a one-channel odd volume does: each span's 16-byte
    # alignment comes from its address
    x = _t((int(np.prod(shape)) + offset,), 42, dev)[offset:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4 * offset
    c = shape[1]
    w = _t((24, c, 2, 2, 2), 43, dev, 1 / np.sqrt(8 * c))
    b = _t((24,), 44, dev, 0.1)
    with torch.no_grad():
        got = _launched("conv_in", lambda: kernels.conv_in_s2d(x, w, b))
        torch.testing.assert_close(got, kernels.conv_in_plain(x, w, b),
                                   rtol=0, atol=1e-5)


def test_conv_in_refuses_rows_too_wide_for_a_block(dev):
    # one output row's input spans and outputs exceed 227 KB of shared
    # memory: the launch is refused and the wrapper raises
    x = _t((1, 4, 1, 1, 4001), 19, dev)
    w = _t((24, 4, 2, 2, 2), 24, dev)
    with pytest.raises(RuntimeError, match="m3seg_conv_in failed"):
        kernels.conv_in_s2d(x, w, _t((24,), 25, dev))


def test_conv_in_refuses_a_weight_view(dev):
    x = _t((1, 4, 6, 8, 11), 23, dev)
    w = _t((24, 4, 2, 2, 2), 24, dev)
    b = _t((24,), 25, dev)
    view = w.transpose(3, 4)  # (F, C, 2, 2, 2), not contiguous
    with pytest.raises(ValueError, match="weight must be contiguous"):
        kernels.conv_in_s2d(x, view, b)
    with torch.no_grad():  # the same values, contiguous, are taken
        got = _launched("conv_in", lambda: kernels.conv_in_s2d(
            x, view.contiguous(), b))
        torch.testing.assert_close(
            got, kernels.conv_in_plain(x, view, b), rtol=0, atol=1e-5)


@pytest.mark.parametrize("c", [8, 24])
def test_freq_chain_kernel_matches_plain(dev, c):
    x = _t((1, 10, 14, 14, c), 3, dev)
    ws = [_t((c, c), 4 + k, dev, 1 / np.sqrt(c)) for k in range(3)]
    with torch.no_grad():
        got = _launched("freq_chain",
                        lambda: kernels.fused_freq_chain(x, ws))
        torch.testing.assert_close(got, kernels.freq_chain_plain(x, ws),
                                   rtol=0, atol=1e-5)


# a block holds 128 rows at both widths
@pytest.mark.parametrize("rows", [1, 31, 33, 127, 129, 15685])
@pytest.mark.parametrize("c", [8, 24])
def test_freq_chain_kernel_ragged_rows_match_plain(dev, rows, c):
    x = _t((rows, c), 26, dev)
    ws = [_t((c, c), 27 + k, dev, 1 / np.sqrt(c)) for k in range(3)]
    with torch.no_grad():
        got = _launched("freq_chain",
                        lambda: kernels.fused_freq_chain(x, ws))
        torch.testing.assert_close(got, kernels.freq_chain_plain(x, ws),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", list(range(1, kernels.freq_chain.MAX_CHAIN
                                         + 1)))
@pytest.mark.parametrize("c", [8, 24])
def test_freq_chain_kernel_chain_lengths_match_plain(dev, n, c):
    """1e-5 of the output's largest magnitude (at least 1): the values grow
    by about 1.4 a step (to about 50 after 8), and the plain fp32 chain is
    itself 2e-5 from a float64 one after 8 steps."""
    x = _t((300, c), 30, dev)
    ws = [_t((c, c), 31 + k, dev, 1 / np.sqrt(c)) for k in range(n)]
    with torch.no_grad():
        got = _launched("freq_chain",
                        lambda: kernels.fused_freq_chain(x, ws))
        want = kernels.freq_chain_plain(x, ws)
        torch.testing.assert_close(
            got, want, rtol=0, atol=1e-5 * max(1.0, float(want.abs().max())))


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("c", [8, 24])
def test_freq_chain_kernel_takes_an_unaligned_view(dev, c, offset):
    # rows that start `offset` floats into their storage: read in 4-byte
    # loads where they are not 16-byte aligned
    rows = 131
    x = _t((rows * c + offset,), 45, dev)[offset:].view(rows, c)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4 * offset
    ws = [_t((c, c), 46 + k, dev, 1 / np.sqrt(c)) for k in range(3)]
    with torch.no_grad():
        got = _launched("freq_chain",
                        lambda: kernels.fused_freq_chain(x, ws))
        torch.testing.assert_close(got, kernels.freq_chain_plain(x, ws),
                                   rtol=0, atol=1e-5)


def test_freq_chain_refuses_a_longer_chain(dev):
    n = kernels.freq_chain.MAX_CHAIN + 1
    ws = [_t((24, 24), 40 + k, dev, 1 / np.sqrt(24)) for k in range(n)]
    with pytest.raises(ValueError, match="at most"):
        kernels.fused_freq_chain(_t((10, 24), 39, dev), ws)


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
    # differentiable: the kernel forward, the replayed backward
    y = _launched("conv_in", lambda: kernels.conv_in_s2d(x, wg, b))
    assert y.requires_grad
    y.sum().backward()
    assert wg.grad is not None and wg.grad.shape == w.shape
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


def _conv3_held(kern, want, kw, name="conv3"):
    """One launch of ``kern`` (counted under ``name``) against the plain
    outputs ``want``; returns the kernel's outputs."""
    with torch.no_grad():
        got = _launched(name, kern)
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


@pytest.mark.parametrize("keep", [(0, 1), (1, 1), (1, 0)])
@pytest.mark.parametrize("sizes,ci,co", [((9, 8, 7), 24, 24),
                                         ((8, 6, 10), 48, 96),
                                         ((42, 40, 30), 24, 24),
                                         ((13, 11, 9), 8, 12)])
@pytest.mark.parametrize("option", CONV3_OPTIONS)
def test_conv3_halo_matches_plain(dev, option, sizes, ci, co, keep):
    """The halo mode (the first and last of the depth's planes are a
    neighbouring shard's) at every option, stride 2 and dilation 2
    included, and each keep pair: a first, middle and last slab."""
    x, w, b, kw = _conv3_case(dev, sizes, ci, co, option)
    kw.update(halo=True, halo_keep=keep)
    _conv3_held(lambda: kernels.conv3(x, w, b, **kw),
                kernels.conv3_plain(x, w, b, **kw), kw, "conv3_halo")


@pytest.mark.parametrize("option", ["bare", "x2", "prologue_elu"])
@pytest.mark.parametrize("sizes", [(5, 8, 7), (10, 9, 13)])
def test_conv3_dilated_depth_matches_plain(dev, option, sizes):
    """The depth-dilated mode: the volume's planes at the even planes of a
    grid twice as deep (the prologue never reaching the odd ones), counted
    as a conv3 launch."""
    x, w, b, kw = _conv3_case(dev, sizes, 24, 24, option)
    kw["dilated_depth"] = sizes[0]
    got = _conv3_held(lambda: kernels.conv3(x, w, b, **kw),
                      kernels.conv3_plain(x, w, b, **kw), kw)
    assert got[0].shape[1] == 2 * sizes[0]


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
    with pytest.raises(TypeError, match="float16"):
        kernels.conv3(x.half(), w, b)
    # the halo mode (ROADMAP item 15, ported) runs: one conv3_halo launch
    # held to the plain twin (test_conv3_halo_matches_plain has its cases)
    _conv3_held(lambda: kernels.conv3(x, w, b, halo=True, halo_keep=(1, 0)),
                kernels.conv3_plain(x, w, b, halo=True, halo_keep=(1, 0)),
                {}, "conv3_halo")
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
    # under autograd: the kernel forward and the Function's backward
    before = kernels.LAUNCHES["tower_block_s"]
    _grads_close(lambda *a: kernels.fused_tower_block_s(*a, spec, ds_prev),
                 lambda *a: kernels.tower_block_s_plain(*a, spec, ds_prev),
                 (x, sy, w_cat, w_cc_t, b_cat),
                 (_t(x.shape, 45, dev), _t(sy.shape, 46, dev),
                  _t(ds_prev.shape, 47, dev)))
    assert kernels.LAUNCHES["tower_block_s"] == before + 1
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
    # under autograd: the kernel forward and the Function's backward
    before = kernels.LAUNCHES["tower_block"]
    _grads_close(lambda *a: kernels.fused_tower_block(*a, spec, ds_prev),
                 lambda *a: kernels.tower_block_plain(*a, spec, ds_prev),
                 (x, z, w_cat, w_cc_t, b_cat),
                 (_t(x.shape, 45, dev), _t(z.shape, 46, dev),
                  _t(ds_prev.shape, 47, dev)))
    assert kernels.LAUNCHES["tower_block"] == before + 1


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
    # under autograd: the kernel forward and the Function's backward
    before = kernels.LAUNCHES["tower_resident"]
    _grads_close(lambda *a: kernels.resident_tower(*a, spec),
                 lambda *a: kernels.resident_tower_plain(*a, spec),
                 (x, ops, wcat, wcc, b), _t(x.shape, 45, dev))
    assert kernels.LAUNCHES["tower_resident"] == before + 1
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


# ------------------------------------------------------- backward passes

GRAD_RTOL = 1e-5


def _grads_close(fused, plain, args, g):
    """Gradients of ``fused`` (the kernel forward, the Function's
    backward) against autograd through ``plain``, for the same inputs and
    output gradient (a tuple for several outputs)."""
    leaves = [a.clone().requires_grad_(True) for a in args]
    got = torch.autograd.grad(fused(*leaves), leaves, g)
    leaves = [a.clone().requires_grad_(True) for a in args]
    want = torch.autograd.grad(plain(*leaves), leaves, g)
    assert len(got) == len(want) == len(args)
    for a, b in zip(got, want):
        tol = GRAD_RTOL * max(1.0, float(b.abs().max()))
        torch.testing.assert_close(a, b, rtol=0, atol=tol)


@pytest.mark.parametrize("selu", [True, False])
@pytest.mark.parametrize("shape", [
    (1, 4, 120, 120, 78),    # the training shape
    (1, 4, 240, 240, 155),   # the serving shape
    (1, 4, 239, 239, 155),   # odd D and H
    (2, 2, 9, 7, 5),
])
def test_conv_in_backward_matches_plain(dev, shape, selu):
    c = shape[1]
    x = _t(shape, 1, dev)
    w = _t((24, c, 2, 2, 2), 2, dev, 1 / np.sqrt(8 * c))
    b = _t((24,), 3, dev, 0.1)
    d, h, wd = shape[2:]
    g = _t((shape[0], d // 2 + 1, h // 2 + 1, wd // 2 + 1, 24), 4, dev)
    before = kernels.LAUNCHES["conv_in"]
    _grads_close(lambda *a: kernels.conv_in_s2d(*a, apply_selu=selu),
                 lambda *a: kernels.conv_in_plain(*a, apply_selu=selu),
                 (x, w, b), g)
    assert kernels.LAUNCHES["conv_in"] == before + 1


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("shape", [
    (1, 20, 28, 28, 24),     # HNOSeg-XS's spectrum (training and serving)
    (1, 5, 7, 3, 8),
])
def test_freq_chain_backward_matches_plain(dev, shape, n):
    c = shape[-1]
    args = [_t(shape, 5, dev)] + [_t((c, c), 6 + k, dev, 1 / np.sqrt(c))
                                  for k in range(n)]
    before = kernels.LAUNCHES["freq_chain"]
    _grads_close(lambda x, *w: kernels.fused_freq_chain(x, list(w)),
                 lambda x, *w: kernels.freq_chain_plain(x, list(w)),
                 args, _t(shape, 9, dev))
    assert kernels.LAUNCHES["freq_chain"] == before + 1


@pytest.mark.parametrize("shape,sizes", [
    ((1, 4, 61, 61, 40), (120, 120, 78)),     # the training shape
    ((1, 4, 121, 121, 78), (240, 240, 155)),  # the serving shape
    ((1, 3, 6, 8, 8), (6, 8, 8)),             # identity resize
    ((1, 2, 16, 6, 6), (9, 11, 13)),          # D down, H and W up
])
def test_tail_backward_matches_plain(dev, shape, sizes):
    x = _t(shape, 10, dev, 3.0)
    before = kernels.LAUNCHES["tail_resize"]
    _grads_close(lambda a: kernels.fused_tail_softmax(a, sizes),
                 lambda a: kernels.tail_plain(a, sizes), (x,),
                 _t((1, shape[1]) + sizes, 11, dev))
    assert kernels.LAUNCHES["tail_resize"] == before + 1


def test_serving_then_training_on_the_card(dev):
    """Serving builds the cached matrices (the tail's tap tables among
    them) under inference mode; a train step on the kernels afterwards
    saves what it needs for backward and updates every parameter."""
    from multimodal_3d_image_segmentation_tpu_torch.losses import PCCLoss
    from multimodal_3d_image_segmentation_tpu_torch.models import HNOSegXS
    from multimodal_3d_image_segmentation_tpu_torch.runtime.steps import (
        make_predict_step, make_train_step)
    from multimodal_3d_image_segmentation_tpu_torch.kernels import \
        tail_resize
    from multimodal_3d_image_segmentation_tpu_torch.ops import (resize,
                                                                spectral)
    for fn in (spectral._stage_tensor, resize._linear_matrix,
               tail_resize._tap_tables):
        fn.cache_clear()
    model = HNOSegXS(4, 4, 24, [3] * 8, (10, 14, 14), use_kernels=True,
                     device=dev)
    x = _t((1, 4, 40, 36, 30), 12, dev)
    y = torch.from_numpy(np.random.default_rng(13).integers(
        0, 4, (1, 1, 40, 36, 30)).astype(np.float32)).to(dev)
    make_predict_step(model)(x)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt = torch.optim.SGD(model.parameters(), lr=1.0)
    kernels.reset_launch_counts()
    loss = make_train_step(model, opt, None, PCCLoss(), 4)(x, y)
    assert torch.isfinite(loss)
    assert {k: kernels.LAUNCHES[k] for k in
            ("conv_in", "freq_chain", "tail_resize")} == \
        {"conv_in": 1, "freq_chain": 8, "tail_resize": 1}
    for k, p in model.named_parameters():
        assert not torch.equal(before[k], p), k


# the tower grid of a 120x120x78 training volume after conv_in
TRAIN_GRID = (61, 61, 40)


@pytest.mark.parametrize("label,transform,modes,n_ds", BLOCK_SHAPES)
def test_tower_block_backward_matches_plain(dev, label, transform, modes,
                                            n_ds):
    """At HartleyMHASeg's (4 ds rows), HNOSeg's and FNOSeg's training
    shapes, ds_prev's gradient (the ds cotangent) among them."""
    x, z, w_cat, w_cc_t, b_cat, spec, ds_prev = _tower_inputs(
        dev, TRAIN_GRID, modes, 24, n_ds, 48, transform)
    args = (x, z, w_cat, w_cc_t, b_cat) + ((ds_prev,) if n_ds else ())
    g = (_t(x.shape, 49, dev), _t(z.shape, 50, dev))
    g += (_t(ds_prev.shape, 51, dev),) if n_ds else ()
    before = kernels.LAUNCHES["tower_block"]
    _grads_close(lambda *a: kernels.fused_tower_block(*a[:5], spec, *a[5:]),
                 lambda *a: kernels.tower_block_plain(*a[:5], spec, *a[5:]),
                 args, g)
    assert kernels.LAUNCHES["tower_block"] == before + 1


@pytest.mark.parametrize("transform,n_ds", [("Hartley", 0), ("Fourier", 4)])
def test_tower_block_s_backward_matches_plain(dev, transform, n_ds):
    """At HNOSeg's and FNOSeg's training shapes (modes (10,14,14)), the
    resident spectrum's gradient among them."""
    x, sy, w_cat, w_cc_t, b_cat, spec, ds_prev = _tower_inputs(
        dev, TRAIN_GRID, (10, 14, 14), 24, n_ds, 52, transform,
        resident=True)
    args = (x, sy, w_cat, w_cc_t, b_cat) + ((ds_prev,) if n_ds else ())
    g = (_t(x.shape, 53, dev), _t(sy.shape, 54, dev))
    g += (_t(ds_prev.shape, 55, dev),) if n_ds else ()
    before = kernels.LAUNCHES["tower_block_s"]
    _grads_close(
        lambda *a: kernels.fused_tower_block_s(*a[:5], spec, *a[5:]),
        lambda *a: kernels.tower_block_s_plain(*a[:5], spec, *a[5:]),
        args, g)
    assert kernels.LAUNCHES["tower_block_s"] == before + 1


@pytest.mark.parametrize("transform,sizes,modes,nb", [
    ("Fourier", (9, 37, 21), (3, 5, 5), 3),
    ("Hartley", TRAIN_GRID, (10, 14, 14), 24),  # HNOSeg's whole tower
])
def test_tower_resident_backward_matches_plain(dev, transform, sizes, modes,
                                               nb):
    args = _resident_inputs(dev, transform, sizes, modes, 24, nb)
    spec = args[-1]
    before = kernels.LAUNCHES["tower_resident"]
    _grads_close(lambda *a: kernels.resident_tower(*a, spec),
                 lambda *a: kernels.resident_tower_plain(*a, spec),
                 args[:-1], _t(args[0].shape, 56, dev))
    assert kernels.LAUNCHES["tower_resident"] == before + 1


@pytest.mark.parametrize("sizes,ci,co", [((9, 8, 7), 24, 24),
                                         ((13, 11, 9), 48, 24)])
@pytest.mark.parametrize("option", CONV3_OPTIONS)
def test_conv3_backward_matches_plain(dev, sizes, ci, co, option):
    """Every option's gradients, the moment sums' cotangents included,
    the stride-2 and dilation-2 modes among them."""
    x, w, b, kw = _conv3_case(dev, sizes, ci, co, option)
    args, call = flat_call(x, w, b, **kw)
    with torch.no_grad():
        outs = call(kernels.conv3_plain)(*args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    g = tuple(_t(o.shape, 60 + i, dev) for i, o in enumerate(outs))
    before = kernels.LAUNCHES["conv3"]
    _grads_close(call(kernels.conv3), call(kernels.conv3_plain), args,
                 g if len(g) > 1 else g[0])
    assert kernels.LAUNCHES["conv3"] == before + 1


def test_conv3_repacks_its_weight_after_each_optimizer_step(dev):
    """conv3 keeps its packed weight per weight version: after each
    Adamax step (an in-place update) it packs again, so the third forward
    equals conv3_plain on the updated weight."""
    x = _t((1, 9, 8, 7, 24), 70, dev)
    w = torch.nn.Parameter(_t((24, 24, 3, 3, 3), 71, dev, 0.05))
    b = torch.nn.Parameter(_t((24,), 72, dev, 0.1))
    g = _t((1, 9, 8, 7, 24), 73, dev)
    opt = torch.optim.Adamax([w, b], lr=1e-2)
    first = None
    for _ in range(2):
        opt.zero_grad()
        y = kernels.conv3(x, w, b)
        first = y.detach() if first is None else first
        (y * g).sum().backward()
        opt.step()
    with torch.no_grad():
        got = _launched("conv3", lambda: kernels.conv3(x, w, b))
        want = kernels.conv3_plain(x, w, b)
    _close(got, want)
    assert float((got - first).abs().max()) > 1e-3  # the weight moved


# small widths with the kernels' channel counts (C 8): kernel paths, one
# train step each, and the launches it must make
FAMILY_STEPS = {
    "VNetDS": (dict(in_channels=2, out_channels=4, base_num_filters=8,
                    num_blocks=[1, 2], right_leg_indexes=[0, 1]),
               {"conv_in": 1, "conv3": 6, "tail_resize": 1}),
    "HartleyMHASeg": (dict(in_channels=2, out_channels=4, filters=8,
                           num_transform_blocks=2, num_heads=2,
                           num_modes=(2, 3, 2), patch_size=None),
                      {"conv_in": 1, "tower_block": 2, "tail_resize": 1}),
    **{f"NeuralOperatorSeg-{t}-{k}": (
        dict(in_channels=2, out_channels=4, filters=8,
             num_transform_blocks=3, num_modes=(2, 3, 3), transform_type=t,
             tower_kernel=k),
        {"conv_in": 1, "tail_resize": 1,
         {"block": "tower_block", "block_s": "tower_block_s",
          "resident": "tower_resident"}[k]: 1 if k == "resident" else 3})
       for t in ("Hartley", "Fourier") for k in ("block", "block_s",
                                                 "resident")},
}


@pytest.mark.parametrize("family", sorted(FAMILY_STEPS))
def test_family_train_step_on_the_card(dev, family):
    """One PCC-loss step of each family on its kernel path: the launches
    of its kernels, the loss and every gradient within 1e-4 of the plain
    path's (of each tensor's largest magnitude, at least 1), and every
    parameter updated by an SGD step."""
    from multimodal_3d_image_segmentation_tpu_torch import models
    from multimodal_3d_image_segmentation_tpu_torch.losses import PCCLoss
    from multimodal_3d_image_segmentation_tpu_torch.runtime.steps import \
        make_train_step
    from multimodal_3d_image_segmentation_tpu_torch.utils.labels import \
        to_categorical
    kw, launches = FAMILY_STEPS[family]
    cls = getattr(models, family.split("-")[0])
    fast = cls(**kw, use_kernels=True, device=dev)
    plain = cls(**{k: v for k, v in kw.items() if k != "tower_kernel"},
                device=dev)
    plain.load_state_dict(fast.state_dict())
    x = _t((1, 2, 20, 18, 15), 74, dev)
    y = torch.from_numpy(np.random.default_rng(75).integers(
        0, 4, (1, 1, 20, 18, 15)).astype(np.float32)).to(dev)
    grads = []
    for m in (fast, plain):
        kernels.reset_launch_counts()
        loss = PCCLoss()(m(x), to_categorical(y, 4))
        loss.backward()
        torch.cuda.synchronize()
        if m is fast:
            assert {k: v for k, v in kernels.LAUNCHES.items() if v} \
                == launches
        grads.append({"loss": loss.detach(), **{
            k: p.grad for k, p in m.named_parameters()}})
    for k, want in grads[1].items():
        _close(grads[0][k], want)
    before = {k: p.detach().clone() for k, p in fast.named_parameters()}
    opt = torch.optim.SGD(fast.parameters(), lr=1.0)
    assert torch.isfinite(make_train_step(fast, opt, None, PCCLoss(), 4)(
        x, y))
    for k, p in fast.named_parameters():
        assert not torch.equal(before[k], p), k


# The bf16 instances (compute_dtype 'bfloat16' and 'mixed') against their
# plain twins, which compute the same function in fp32 from the exact bf16
# values and round where the kernel rounds. A kernel and its twin sum in
# another order, so a value whose fp32 sums straddle a rounding point
# rounds the other way: one bf16 ulp, at most 2^-7 of the value (rtol), on
# top of the fp32 tests' 1e-5 (atol). The chain rounds after each of its
# stages, so a flip at one stage moves the next stage's inputs by one ulp:
# its bar adds one ulp of the output's largest magnitude.
BF16_ULP = 2.0 ** -7


def _bf16(shape, seed, dev, scale=1.0):
    return _t(shape, seed, dev, scale).to(torch.bfloat16)


@pytest.mark.parametrize("shape", [
    (1, 4, 16, 14, 11),    # even D/H, odd W
    (1, 4, 15, 13, 12),    # odd D/H
    (2, 3, 9, 8, 7),       # batch 2, C 3
    (1, 4, 5, 13, 155),    # the serving W: spans at every offset modulo 8
    (1, 4, 2, 3, 600),     # rows wider than a block
    (1, 1, 3, 30, 3),      # one channel, 8-row bands
])
@pytest.mark.parametrize("f", [8, 24])
@pytest.mark.parametrize("selu", [True, False])
def test_conv_in_bf16_kernel_matches_plain(dev, shape, f, selu):
    c = shape[1]
    x = _bf16(shape, 70, dev)
    w = _t((f, c, 2, 2, 2), 71, dev, 1 / np.sqrt(8 * c))
    b = _t((f,), 72, dev, 0.1)
    with torch.no_grad():
        got = _launched("conv_in_bf16", lambda: kernels.conv_in_s2d(
            x, w, b, apply_selu=selu))
        want = kernels.conv_in_plain(x, w, b, apply_selu=selu)
    assert got.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=BF16_ULP,
                               atol=1e-5)


@pytest.mark.parametrize("offset", list(range(8)))
@pytest.mark.parametrize("shape", [(1, 4, 5, 13, 155), (1, 1, 5, 7, 13)])
def test_conv_in_bf16_kernel_takes_an_unaligned_view(dev, shape, offset):
    # a contiguous view `offset` values into its storage: each span's
    # 16-byte alignment comes from its address, 8 bf16 values a word
    x = _bf16((int(np.prod(shape)) + offset,), 73, dev)[offset:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 == 2 * offset
    c = shape[1]
    w = _t((24, c, 2, 2, 2), 74, dev, 1 / np.sqrt(8 * c))
    b = _t((24,), 75, dev, 0.1)
    with torch.no_grad():
        got = _launched("conv_in_bf16",
                        lambda: kernels.conv_in_s2d(x, w, b))
        torch.testing.assert_close(
            got.float(), kernels.conv_in_plain(x, w, b).float(),
            rtol=BF16_ULP, atol=1e-5)


def test_conv_in_bf16_kernel_batch_element_1_of_the_odd_volume(dev):
    # batch element 1 of a 2 x 4 x 239 x 239 x 155 bf16 volume starts 8
    # bytes past a 16-byte boundary (the reference's odd-D/H variant)
    xx = _bf16((2, 4, 239, 239, 155), 76, dev)
    x = xx[1:]
    assert x.is_contiguous() and x.data_ptr() % 16 == 8
    w = _t((24, 4, 2, 2, 2), 77, dev, 1 / np.sqrt(32))
    b = _t((24,), 78, dev, 0.1)
    with torch.no_grad():
        got = _launched("conv_in_bf16",
                        lambda: kernels.conv_in_s2d(x, w, b))
        want = kernels.conv_in_plain(x, w, b)
    assert got.shape == (1, 120, 120, 78, 24)
    torch.testing.assert_close(got.float(), want.float(), rtol=BF16_ULP,
                               atol=1e-5)


@pytest.mark.parametrize("rows", [1, 33, 129, 15680])
@pytest.mark.parametrize("c", [8, 24])
@pytest.mark.parametrize("n", [1, 3, 8])
def test_freq_chain_bf16_kernel_matches_plain(dev, rows, c, n):
    x = _bf16((rows, c), 80, dev)
    ws = [_bf16((c, c), 81 + k, dev, 1 / np.sqrt(c)) for k in range(n)]
    with torch.no_grad():
        got = _launched("freq_chain_bf16",
                        lambda: kernels.fused_freq_chain(x, ws))
        want = kernels.freq_chain_plain(x, ws)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(
        got.float(), want.float(), rtol=BF16_ULP,
        atol=1e-5 + BF16_ULP * max(1.0, float(want.float().abs().max())))


@pytest.mark.parametrize("offset", list(range(8)))
def test_freq_chain_bf16_kernel_takes_an_unaligned_view(dev, offset):
    rows, c = 131, 24
    x = _bf16((rows * c + offset,), 90, dev)[offset:].view(rows, c)
    assert x.is_contiguous() and x.data_ptr() % 16 == 2 * offset
    ws = [_bf16((c, c), 91 + k, dev, 1 / np.sqrt(c)) for k in range(3)]
    with torch.no_grad():
        got = _launched("freq_chain_bf16",
                        lambda: kernels.fused_freq_chain(x, ws))
        want = kernels.freq_chain_plain(x, ws)
    torch.testing.assert_close(
        got.float(), want.float(), rtol=BF16_ULP,
        atol=1e-5 + BF16_ULP * max(1.0, float(want.float().abs().max())))


def test_freq_chain_bf16_rounds_after_every_stage(dev):
    # against a chain that rounds only at its end, the kernel must differ:
    # the per-stage rounding is the reference's bf16 chain
    x = _bf16((4096, 24), 95, dev)
    ws = [_bf16((24, 24), 96 + k, dev, 1 / np.sqrt(24)) for k in range(3)]
    with torch.no_grad():
        got = kernels.fused_freq_chain(x, ws).float()
        once = kernels.freq_chain_plain(
            x.float(), [w.float() for w in ws]).to(torch.bfloat16).float()
        want = kernels.freq_chain_plain(x, ws).float()
    assert float((got - want).abs().max()) < float((got - once).abs().max())


@pytest.mark.parametrize("sizes_in,sizes,c", [
    (a, b, c) for a, b in TAIL_BAND_CASES for c in (1, 4, 8)] + [
    ((121, 121, 78), (240, 240, 155), 4)])  # the serving shape, W 155
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_tail_bf16_kernel_matches_plain(dev, sizes_in, sizes, c, out_dtype):
    x = _bf16((1, c) + sizes_in, 100, dev, 3.0)
    with torch.no_grad():
        got = _launched("tail_resize_bf16", lambda: kernels.fused_tail_softmax(
            x, sizes, out_dtype))
        want = kernels.tail_plain(x, sizes, out_dtype)
    assert got.dtype == want.dtype == out_dtype
    rtol = BF16_ULP if out_dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=1e-6)


def test_bf16_instances_refuse_what_they_do_not_take(dev):
    x = _bf16((1, 4, 8, 8, 8), 110, dev)
    w = _t((24, 4, 2, 2, 2), 111, dev)
    b = _t((24,), 112, dev)
    with pytest.raises(TypeError):  # the bf16 instance takes fp32 weights
        kernels.conv_in_s2d(x, w.to(torch.bfloat16), b)
    with pytest.raises(TypeError):  # no fp16 instance
        kernels.conv_in_s2d(x.half(), w, b)
    rows = _bf16((10, 24), 113, dev)
    with pytest.raises(TypeError):  # bf16 rows take bf16 weights
        kernels.fused_freq_chain(rows, [_t((24, 24), 114, dev)])
    with pytest.raises(TypeError):
        kernels.fused_freq_chain(rows.float(), [_bf16((24, 24), 114, dev)])
    logits = _bf16((1, 4, 6, 8, 8), 115, dev)
    with pytest.raises(TypeError):  # no fp16 output
        kernels.fused_tail_softmax(logits, (8, 10, 10), torch.float16)
    with pytest.raises(TypeError):  # fp32 logits write fp32 only
        kernels.fused_tail_softmax(logits.float(), (8, 10, 10),
                                   torch.bfloat16)
    with pytest.raises(TypeError):
        kernels.fused_tail_softmax(logits.half(), (8, 10, 10))


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "mixed"])
def test_hnosegxs_bf16_kernel_path_launches_the_bf16_instances(
        dev, compute_dtype):
    from multimodal_3d_image_segmentation_tpu_torch.models import HNOSegXS
    kw = dict(in_channels=4, out_channels=4, filters=24,
              num_transform_blocks=[3, 3], num_modes=(3, 4, 4),
              compute_dtype=compute_dtype)
    plain = HNOSegXS(**kw, device=dev)
    fast = HNOSegXS(**kw, use_kernels=True, device=dev)
    fast.load_state_dict(plain.state_dict())
    x = _t((1, 4, 16, 18, 13), 120, dev)
    before = dict(kernels.LAUNCHES)
    with torch.no_grad():
        got, want = fast(x), plain(x)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
             if v != before[k]}
    chain = "freq_chain_bf16" if compute_dtype == "bfloat16" \
        else "freq_chain"
    assert moved == {"conv_in_bf16": 1, chain: 2, "tail_resize_bf16": 1}
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    # two bf16 paths that round at other places: the probabilities agree
    # to bf16's class, not fp32's
    assert float((got - want).abs().mean()) < 1e-2


# The tower kernels' 'bfloat16' and 'mixed' instances against their twins
# (fp32 sums on the bf16 values, rounded where the kernel rounds). A bf16
# output (out; 'bfloat16''s f) is held to one ulp plus 1e-5 plus one ulp of
# its largest magnitude (a rounding flipped upstream moves later values by
# about that), and at most 1e-3 of its elements more than one ulp of their
# own magnitude plus 1e-5 apart (f is an fp32 sum with cancellation,
# rounded once); an fp32 output (s_f, 'mixed''s f, ds) to 1e-4 of its
# largest magnitude (a flipped bf16 operand upstream moves it by about one
# ulp of that operand's contribution). chip_smoke.py holds the same rule
# at the serving shapes, with controls that must fail it.
TOWER_MODES = [("bfloat16", torch.bfloat16), ("mixed", torch.float32)]


def _held_bf16_tower(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        gf, wf = g.float(), w.float()
        d, scale = (gf - wf).abs(), float(wf.abs().max())
        if g.dtype == torch.float32:
            assert float(d.max()) <= 1e-4 * scale, (float(d.max()), scale)
            continue
        atol = 1e-5 + BF16_ULP * max(1.0, scale)
        assert float((d - BF16_ULP * wf.abs()).max()) <= atol
        mag = torch.maximum(gf.abs(), wf.abs()).clamp_min(2.0 ** -126)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        assert float((d > ulp + 1e-5).float().mean()) <= 1e-3


def _tower_block_args(transform, sizes, modes, c, n_ds, seed, dev):
    spec = tb.make_tower_spec(transform, sizes, modes, c, n_ds=n_ds)
    x = _t(sizes + (c,), seed, dev)
    ops = [_t((c, c), seed + 1 + i, dev, 1 / np.sqrt(c))
           for i in range(1 if transform == "Hartley" else 2)]
    with torch.no_grad():
        s = tbs.spectrum_mix_s(tbs.entry_spectrum_s(x, spec), ops,
                               spec).contiguous()
        z = tb.d_stage_inverse(s, spec).contiguous()
    w_cat = _t((2 * c + n_ds, c), seed + 3, dev, 1 / np.sqrt(c))
    w_cc_t = _t((c, c), seed + 4, dev, 1 / np.sqrt(c))
    b_cat = _t((2 * c,), seed + 5, dev, 0.1)
    ds_prev = _t(sizes + (n_ds,), seed + 6, dev) if n_ds else None
    return spec, x, s, z, w_cat, w_cc_t, b_cat, ds_prev


TOWER_BF16_CASES = [
    ("Hartley", (20, 18, 21), (3, 4, 5), 8, 4),   # short last W tile, ds
    ("Fourier", (13, 40, 17), (3, 6, 5), 8, 0),   # odd KW, two H chunks
    ("Hartley", (24, 33, 26), (10, 14, 12), 24, 0),
    ("Fourier", (22, 30, 29), (10, 14, 14), 24, 3)]
TOWER_BF16_IDS = [f"{t[0]}-c{c}-ds{n}" for t, _, _, c, n in TOWER_BF16_CASES]


@pytest.mark.parametrize("mode,wdtype", TOWER_MODES,
                         ids=[m for m, _ in TOWER_MODES])
@pytest.mark.parametrize("transform,sizes,modes,c,n_ds", TOWER_BF16_CASES,
                         ids=TOWER_BF16_IDS)
def test_tower_block_bf16_instances_match_twins(dev, transform, sizes,
                                                modes, c, n_ds, mode,
                                                wdtype):
    spec, x, s, z, w_cat, w_cc_t, b_cat, ds_prev = _tower_block_args(
        transform, sizes, modes, c, n_ds, 130, dev)
    suffix = "_bf16" if mode == "bfloat16" else "_mixed"
    for fused, plain, spectrum, name in (
            (kernels.fused_tower_block, kernels.tower_block_plain, z,
             "tower_block"),
            (kernels.fused_tower_block_s, kernels.tower_block_s_plain, s,
             "tower_block_s")):
        args = (x.bfloat16(), spectrum, w_cat.to(wdtype), w_cc_t.to(wdtype),
                b_cat, spec, ds_prev)
        with torch.no_grad():
            got = _launched(name + suffix, lambda: fused(*args))
            want = plain(*args)
            again = fused(*args)
        assert got[0].dtype == torch.bfloat16
        assert got[1].dtype == (wdtype if name == "tower_block"
                                else torch.float32)
        _held_bf16_tower(got, want)
        for a, b in zip(again, got):  # a fixed order: the same bits
            assert torch.equal(a, b)


@pytest.mark.parametrize("mode,wdtype", TOWER_MODES,
                         ids=[m for m, _ in TOWER_MODES])
@pytest.mark.parametrize("transform", ["Hartley", "Fourier"])
def test_tower_resident_bf16_instances_match_twins(dev, transform, mode,
                                                   wdtype):
    """One block element by element; six blocks by the whole-model rule:
    the largest distance from a float64 evaluation of the same tower (bf16
    volume and weights, nothing rounded) at most 2x the twin's (the
    kernel's operator mix sums in another fp32 order than the twin's, and
    the next block's bf16 rounding of the spectrum spreads a flip through
    every voxel)."""
    sizes, modes, c = (20, 30, 22), (3, 5, 4), 8
    spec = tb.make_tower_spec(transform, sizes, modes, c)
    pr, nb = (1 if transform == "Hartley" else 2), 6
    x = _t(sizes + (c,), 140, dev, 0.5).bfloat16()
    w = (_t((nb, pr, c, c), 141, dev, 0.3),
         _t((nb, 2 * c, c), 142, dev, 0.3).to(wdtype),
         _t((nb, c, c), 143, dev, 0.3).to(wdtype),
         _t((nb, 2 * c), 144, dev, 0.1))
    name = "tower_resident" + ("_bf16" if mode == "bfloat16" else "_mixed")
    with torch.no_grad():
        w1 = tuple(t[:1] for t in w)
        got = _launched(name, lambda: kernels.resident_tower(x, *w1, spec))
        _held_bf16_tower((got,), (kernels.resident_tower_plain(x, *w1,
                                                               spec),))
        got = kernels.resident_tower(x, *w, spec)
        twin = kernels.resident_tower_plain(x, *w, spec)
        ref = kernels.resident_tower_plain(x.double(),
                                           *(t.double() for t in w), spec)
    assert got.dtype == torch.bfloat16
    k64 = float((got.double() - ref).abs().max())
    assert k64 <= 2 * float((twin.double() - ref).abs().max()) + 1e-6


def test_tower_bf16_instances_refuse_what_they_do_not_take(dev):
    spec, x, s, z, w_cat, w_cc_t, b_cat, _ = _tower_block_args(
        "Hartley", (20, 18, 21), (3, 4, 5), 8, 0, 150, dev)
    xb, wb = x.bfloat16(), w_cat.bfloat16()
    with pytest.raises(TypeError):  # fp32 x with bf16 weights
        kernels.fused_tower_block(x, z, wb, w_cc_t.bfloat16(), b_cat, spec)
    with pytest.raises(TypeError):  # a bf16 z
        kernels.fused_tower_block(xb, z.bfloat16(), wb, w_cc_t.bfloat16(),
                                  b_cat, spec)
    with pytest.raises(TypeError):  # a bf16 resident spectrum
        kernels.fused_tower_block_s(xb, s.bfloat16(), w_cat, w_cc_t, b_cat,
                                    spec)
    with pytest.raises(TypeError):  # a bf16 bias
        kernels.fused_tower_block_s(xb, s, w_cat, w_cc_t, b_cat.bfloat16(),
                                    spec)
    ops = _t((1, 1, 8, 8), 151, dev)
    with pytest.raises(TypeError):  # bf16 operator weights
        kernels.resident_tower(xb, ops.bfloat16(), wb[None, :16],
                               w_cc_t.bfloat16()[None], b_cat[None], spec)


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "mixed"])
@pytest.mark.parametrize("family,tower_kernel", [
    ("HartleyMHASeg", "block"), ("HNOSeg", "block"), ("HNOSeg", "block_s"),
    ("HNOSeg", "resident"), ("FNOSeg", "block")])
def test_tower_families_launch_the_bf16_instances(dev, family, tower_kernel,
                                                  compute_dtype):
    from multimodal_3d_image_segmentation_tpu_torch.models import (
        HartleyMHASeg, NeuralOperatorSeg)
    kw = dict(in_channels=4, out_channels=4, filters=8,
              num_transform_blocks=3, compute_dtype=compute_dtype)
    if family == "HartleyMHASeg":
        cls, kw = HartleyMHASeg, dict(kw, num_heads=2, num_modes=(2, 3, 3),
                                      patch_size=None)
    else:
        cls, kw = NeuralOperatorSeg, dict(
            kw, num_modes=(3, 4, 4),
            transform_type="Hartley" if family == "HNOSeg" else "Fourier")
    plain = cls(**kw, device=dev)
    fast = cls(**kw, use_kernels=True, tower_kernel=tower_kernel, device=dev)
    fast.load_state_dict(plain.state_dict())
    x = _t((1, 4, 16, 18, 13), 160, dev)
    before = dict(kernels.LAUNCHES)
    with torch.no_grad():
        got, want = fast(x), plain(x)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
             if v != before[k]}
    tower = {"block": "tower_block", "block_s": "tower_block_s",
             "resident": "tower_resident"}[tower_kernel]
    suffix = "_bf16" if compute_dtype == "bfloat16" else "_mixed"
    assert moved == {"conv_in_bf16": 1, "tail_resize_bf16": 1,
                     tower + suffix: 1 if tower_kernel == "resident" else 3}
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    # two bf16 paths that round at other places: the probabilities agree
    # to bf16's class, not fp32's
    assert float((got - want).abs().mean()) < 1e-2


# conv3's 'bfloat16' and 'mixed' instances against their twins
# (``conv3_plain`` on the bf16 volume): bf16 outputs one ulp (2^-7 of the
# value) plus 1e-5, at most 1e-3 of the elements more than one ulp of their
# own magnitude apart, and the fp32 moments 1e-5 of the sums of |y| and
# y^2 (the twin's fp32 values differ from the kernel's by the order of the
# sums only; a rounding of the operands left out moves the outputs by a
# tenth of an ulp, which the moments and the share show).
CONV3_MODES = [("bfloat16", torch.bfloat16), ("mixed", torch.float32)]


def _held_bf16_conv3(got, want, n_out):
    """(passes, what it read) of a bf16 instance's outputs against its
    twin's."""
    ok, read = True, []
    for g, w in zip(got[:n_out], want[:n_out]):
        assert g.dtype == w.dtype == torch.bfloat16 and g.shape == w.shape
        gf, wf = g.float(), w.float()
        d = (gf - wf).abs()
        mag = torch.maximum(gf.abs(), wf.abs()).clamp_min(2.0 ** -126)
        share = float((d > torch.exp2(torch.floor(torch.log2(mag)) - 7))
                      .float().mean())
        ok &= bool((d <= 2.0 ** -7 * wf.abs() + 1e-5).all()) and share <= 1e-3
        read.append((float(d.max()), share))
    for y, st, sw in zip(got[:n_out], got[n_out:], want[n_out:]):
        assert st.dtype == torch.float32
        _, scale = _moments64(y)
        rel = float(((st.double() - sw.double()).abs() / scale).max())
        ok &= rel <= 1e-5
        read.append(rel)
    return ok, read


def _rounded_moments_held(got, want, n_out):
    """(passes, what it read) of the moments of a bf16 instance's rounded
    outputs (the stride-2 conv's) against its twin's: the difference of
    two moment sums is at most 1e-5 of the sums of |y| and y^2 (the order
    of the sums) plus what the outputs' own one-ulp flips move them, the
    sum of |g - w| over a channel's elements (first moment) and of
    |g - w| (|g| + |w|) (second), each flip within the per-element bar
    already held; beside it, the moments against float64 sums of the
    kernel's own output at 1e-5."""
    ok, read = True, []
    for g, w, st, sw in zip(got[:n_out], want[:n_out], got[n_out:],
                            want[n_out:]):
        assert st.dtype == torch.float32
        own, scale = _moments64(g)
        gf = g.double().reshape(-1, g.shape[-1])
        wf = w.double().reshape(-1, w.shape[-1])
        d = (gf - wf).abs()
        flips = torch.stack([d.sum(0), (d * (gf.abs() + wf.abs())).sum(0)])
        gap = (st.double() - sw.double()).abs() - flips
        rel = float((gap / scale).max())
        ok &= rel <= 1e-5
        self_rel = float(((st.double() - own).abs() / scale).max())
        ok &= self_rel <= 1e-5
        read.append((rel, self_rel, float(flips.max())))
    return ok, read


def _bf16_conv3_held(got, want, kw, n_out):
    """``_held_bf16_conv3``, the stride-2 conv's moments (of its rounded
    outputs) by ``_rounded_moments_held``."""
    if kw.get("stride", 1) != 2 or len(got) == n_out:
        return _held_bf16_conv3(got, want, n_out)
    ok, read = _held_bf16_conv3(got[:n_out], want[:n_out], n_out)
    ok_m, read_m = _rounded_moments_held(got, want, n_out)
    return ok and ok_m, read + read_m


def _bf16_conv3_case(dev, sizes, ci, co, option, wdtype):
    """A ``_conv3_case`` in a bf16 instance: the volumes and the prologue
    bf16, the weights and biases ``wdtype`` (the tap's bias fp32); the
    stride-2 conv's moments those of its rounded output."""
    x, w, b, kw = _conv3_case(dev, sizes, ci, co, option)
    kw = dict(kw)
    if kw.get("x2") is not None:
        kw["x2"] = kw["x2"].bfloat16()
    if "prologue" in kw:
        kw["prologue"] = tuple(t.bfloat16() for t in kw["prologue"])
    if "residual" in kw:
        kw["residual"] = (kw["residual"][0].to(wdtype), kw["residual"][1])
    return x.bfloat16(), w.to(wdtype), b.to(wdtype), kw


@pytest.mark.parametrize("mode,wdtype", CONV3_MODES,
                         ids=[m for m, _ in CONV3_MODES])
@pytest.mark.parametrize("sizes,ci,co", [((9, 8, 7), 24, 24),
                                         ((8, 6, 10), 48, 96),
                                         ((13, 11, 9), 24, 24)])
@pytest.mark.parametrize("option", CONV3_OPTIONS)
def test_conv3_bf16_instances_match_twins(dev, option, sizes, ci, co, mode,
                                          wdtype):
    x, w, b, kw = _bf16_conv3_case(dev, sizes, ci, co, option, wdtype)
    name = "conv3" + ("_bf16" if mode == "bfloat16" else "_mixed")
    with torch.no_grad():
        got = _launched(name, lambda: kernels.conv3(x, w, b, **kw))
        want = kernels.conv3_plain(x, w, b, **kw)
        again = kernels.conv3(x, w, b, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    again = again if isinstance(again, tuple) else (again,)
    n_out = 2 if kw.get("residual") is not None else 1
    ok, read = _bf16_conv3_held(got, want, kw, n_out)
    assert ok, read
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.parametrize("mode,wdtype", CONV3_MODES,
                         ids=[m for m, _ in CONV3_MODES])
@pytest.mark.parametrize("keep", [(0, 1), (1, 0), (1, 1)])
@pytest.mark.parametrize("option", CONV3_OPTIONS)
def test_conv3_halo_bf16_instances_match_twins(dev, option, keep, mode,
                                               wdtype):
    """The halo mode of the 'bfloat16' and 'mixed' instances, counted under
    conv3_halo_bf16 and conv3_halo_mixed, at the bf16 bar. The stride-2
    conv's moments are those of its rounded outputs
    (``_rounded_moments_held``)."""
    x, w, b, kw = _bf16_conv3_case(dev, (10, 8, 7), 48, 48, option, wdtype)
    kw.update(halo=True, halo_keep=keep)
    name = "conv3_halo" + ("_bf16" if mode == "bfloat16" else "_mixed")
    with torch.no_grad():
        got = _launched(name, lambda: kernels.conv3(x, w, b, **kw))
        want = kernels.conv3_plain(x, w, b, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    ok, read = _bf16_conv3_held(got, want, kw,
                                2 if kw.get("residual") is not None else 1)
    assert ok, read


def _mma_held(x, w, b, kw, name):
    """One launch of the tensor-core body (counted under ``name``) against
    the twin at the bf16 bar, the stride-2 conv's moments (of its rounded
    outputs) by ``_rounded_moments_held``; a second run must give the same
    bits."""
    with torch.no_grad():
        got = _launched(name, lambda: kernels.conv3(x, w, b, **kw))
        want = kernels.conv3_plain(x, w, b, **kw)
        again = kernels.conv3(x, w, b, **kw)
    got, want, again = (t if isinstance(t, tuple) else (t,)
                        for t in (got, want, again))
    n_out = 2 if kw.get("residual") is not None else 1
    ok, read = _bf16_conv3_held(got, want, kw, n_out)
    assert ok, read
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    return got


# the tensor-core body's channel counts: one 8-channel group, the k16 + k8
# chunk of V-Net-DS's level 0, its concat, and a ci over one 64-channel
# chunk; co a part of one n8 tile, one warp's 24 and two warps'
MMA_CHANNELS = [(ci, co) for ci in (8, 24, 48, 72) for co in (4, 24, 48)]
MMA_OPTIONS = ["bare", "x2", "prologue_relu", "residual_stats", "stride2",
               "dilation2"]


@pytest.mark.parametrize("mode,wdtype", CONV3_MODES,
                         ids=[m for m, _ in CONV3_MODES])
@pytest.mark.parametrize("ci,co", MMA_CHANNELS)
@pytest.mark.parametrize("option", MMA_OPTIONS)
def test_conv3_mma_channels_match_twins(dev, option, ci, co, mode, wdtype):
    """The 'bfloat16' and 'mixed' instances (the tensor-core body) at each
    channel count on a grid whose W (13) is no multiple of a brick's 8;
    x2 splits ci in half (c2 a multiple of 4, so 8-byte copies where 8
    channels cross the x1/x2 boundary)."""
    c2 = ci // 2 if option.startswith("x2") else 0
    if c2 % 4:
        pytest.skip("x1/x2 need multiples of 4 channels")
    x, w, b, kw = _bf16_conv3_case(dev, (6, 7, 13), ci - c2, co, option,
                                   wdtype) if not c2 else \
        _bf16_conv3_case_split(dev, (6, 7, 13), ci - c2, c2, co, option,
                               wdtype)
    name = "conv3" + ("_bf16" if mode == "bfloat16" else "_mixed")
    _mma_held(x, w, b, kw, name)


def _bf16_conv3_case_split(dev, sizes, c1, c2, co, option, wdtype):
    """``_bf16_conv3_case`` with x2 of c2 channels."""
    x, w, b, kw = _conv3_case(dev, sizes, c1, co, option, c2=c2)
    kw = dict(kw, x2=kw["x2"].bfloat16())
    return x.bfloat16(), w.to(wdtype), b.to(wdtype), kw


@pytest.mark.parametrize("mode,wdtype", CONV3_MODES,
                         ids=[m for m, _ in CONV3_MODES])
@pytest.mark.parametrize("option", ["bare", "x2", "prologue_elu",
                                    "prologue_selu"])
def test_conv3_mma_dilated_depth_matches_twins(dev, option, mode, wdtype):
    """The depth-dilated mode in both bf16 instances (its odd planes zero
    after the prologue), counted as the instance's conv3 launch."""
    x, w, b, kw = _bf16_conv3_case(dev, (5, 8, 11), 24, 24, option, wdtype)
    kw["dilated_depth"] = 5
    name = "conv3" + ("_bf16" if mode == "bfloat16" else "_mixed")
    got = _mma_held(x, w, b, kw, name)
    assert got[0].shape[1] == 10


# forced plans of the tensor-core body (M tiles a warp, brick depth, height,
# width, warps along N, chunk, split): the 2-tile body's running total over
# all of ci's chunks in one block (chunks of 16 and 48), K ranges of 2-5
# chunks split over two blocks each and summed by the reduce kernel (2 and
# 4 M tiles a warp), 16-wide bricks, one warp along N for 48 channels; a
# call with the residual tap takes one chunk a block (split = chunks)
MMA_PLANS = [(2, 2, 2, 8, 1, 16, 1), (4, 2, 2, 16, 2, 32, 2),
             (2, 1, 4, 16, 2, 16, 2), (4, 4, 2, 8, 1, 48, 2),
             (2, 2, 4, 8, 2, 48, 1)]


@pytest.mark.parametrize("mode,wdtype", CONV3_MODES,
                         ids=[m for m, _ in CONV3_MODES])
@pytest.mark.parametrize("choice", MMA_PLANS)
@pytest.mark.parametrize("option", CONV3_OPTIONS)
def test_conv3_mma_plans_match_twins(dev, option, choice, mode, wdtype):
    import importlib
    conv3_mod = importlib.import_module(
        "multimodal_3d_image_segmentation_tpu_torch.kernels.conv3")
    x, w, b, kw = _bf16_conv3_case(dev, (7, 9, 13), 72, 48, option, wdtype)
    real = conv3_mod.conv3_mma_plan

    def forced(sizes, ci, co, m, _=None, passes=1, residual=False):
        # x2 doubles ci (2-9 chunks); the residual tap reads a block's one
        # chunk
        split = -(-ci // choice[5]) if residual else choice[6]
        return real(sizes, ci, co, m, choice[:6] + (split,), passes=passes,
                    residual=residual)

    conv3_mod.conv3_mma_plan = forced
    try:
        _mma_held(x, w, b, kw,
                  "conv3" + ("_bf16" if mode == "bfloat16" else "_mixed"))
    finally:
        conv3_mod.conv3_mma_plan = real


def test_conv3_mma_plans_report_no_bank_conflict(dev):
    """The planner's plans at V-Net-DS's calls (and forced ones) read 8
    consecutive slots a matrix: no ldmatrix conflicts."""
    import importlib
    conv3_mod = importlib.import_module(
        "multimodal_3d_image_segmentation_tpu_torch.kernels.conv3")
    fields = conv3_mod.MMA_PLAN_FIELDS
    for sizes, ci, co, mode in (((121, 121, 78), 24, 24, 0),
                                ((121, 121, 78), 48, 24, 0),
                                ((121, 121, 78), 24, 48, 1),
                                ((61, 61, 39), 48, 24, 2),
                                ((8, 8, 5), 384, 384, 0)):
        for passes in (1, 2):
            plan = dict(zip(fields, conv3_mod.conv3_mma_plan(
                sizes, ci, co, mode, passes=passes)))
            assert plan["conflict"] == 1, (sizes, ci, co, mode, plan)
            assert plan["threads"] <= 256 and plan["smem"] <= 232448
            # the accumulator chain's bound: 4 M tiles a warp sum a K
            # range in one chain, 2 fold each chunk into a running total
            assert plan["ck"] <= 96
            assert plan["tm"] == 2 or plan["ck"] * plan["chunks"] <= 96
    for choice in MMA_PLANS:
        plan = dict(zip(fields, conv3_mod.conv3_mma_plan((7, 9, 13), 72, 48,
                                                         1, choice)))
        assert plan["conflict"] == 1, (choice, plan)
    for bad in ((2, 2, 2, 8, 1, 24, 3),    # chunks of 24 start off 16
                (2, 2, 2, 8, 1, 16, 6),    # 9 chunks on 6 splits: one empty
                (2, 2, 2, 8, 1, 16, 10),   # more splits than chunks
                (4, 2, 2, 8, 1, 48, 1),    # 144 channels in one chain
                (2, 2, 2, 8, 1, 112, 1)):  # a chunk over 96 channels
        with pytest.raises(ValueError, match="no launch plan"):
            conv3_mod.conv3_mma_plan((7, 9, 13), 144, 48, 0, bad)
    with pytest.raises(ValueError, match="no launch plan"):
        # the residual tap reads a block's one chunk
        conv3_mod.conv3_mma_plan((7, 9, 13), 48, 48, 0, (2, 2, 2, 8, 1, 16, 1),
                                 residual=True)


@pytest.mark.parametrize("mode,wdtype", CONV3_MODES,
                         ids=[m for m, _ in CONV3_MODES])
def test_conv3_bf16_packed_weights_follow_their_weights(dev, mode, wdtype):
    """A repeat call of a bf16 instance gives the same bits; a weight
    updated in place, and a new weight tensor of the same shape in its
    place, each launch with their own values (the packed weights are kept
    per weight version, ``_kept``)."""
    x, w, b, kw = _bf16_conv3_case(dev, (6, 7, 9), 24, 24, "residual_stats",
                                   wdtype)
    name = "conv3" + ("_bf16" if mode == "bfloat16" else "_mixed")

    def held(w):
        got = _launched(name, lambda: kernels.conv3(x, w, b, **kw))
        ok, read = _held_bf16_conv3(got, kernels.conv3_plain(x, w, b, **kw),
                                    2)
        assert ok, read
        return got

    with torch.no_grad():
        first = held(w)
        again = held(w)
        assert all(torch.equal(a, f) for a, f in zip(again, first))
        w.mul_(-1.0)
        flipped = held(w)
        assert not torch.equal(flipped[0], first[0])
        del w, first, again, flipped
        for seed in (30, 31):
            held(_t((24, 24, 3, 3, 3), seed, dev,
                    1 / np.sqrt(27 * 24)).to(wdtype))


def test_conv3_bf16_controls_fail(dev):
    """The twins with a rounding left out miss the bar the kernel meets:
    the prologue output unrounded (both instances), and in 'bfloat16' the
    weights unrounded (the fp32 weights of the same call)."""
    for mode, wdtype in CONV3_MODES:
        x, w, b, kw = _bf16_conv3_case(dev, (9, 8, 7), 48, 48,
                                       "prologue_elu", wdtype)
        with torch.no_grad():
            got = kernels.conv3(x, w, b, **kw)
            ok, _ = _held_bf16_conv3(got, kernels.conv3_plain(x, w, b, **kw),
                                     1)
            bad, read = _held_bf16_conv3(got, kernels.conv3_plain(
                x, w, b, **kw, unrounded={"prologue"}), 1)
        assert ok and not bad, (mode, read)
    x, w, b, kw = _conv3_case(dev, (9, 8, 7), 48, 48, "x2_residual_stats")
    kw = dict(kw, x2=kw["x2"].bfloat16())
    rw, rb = kw["residual"]
    with torch.no_grad():
        got = kernels.conv3(x.bfloat16(), w.bfloat16(), b.bfloat16(),
                            **dict(kw, residual=(rw.bfloat16(), rb)))
        bad, read = _held_bf16_conv3(got, kernels.conv3_plain(
            x.bfloat16(), w, b, **kw), 2)
    assert not bad, read


def test_conv3_bf16_instances_refuse_what_they_do_not_take(dev):
    x, w, b, kw = _bf16_conv3_case(dev, (6, 6, 6), 24, 24, "bare",
                                   torch.bfloat16)
    with pytest.raises(TypeError, match="float32 weight"):
        kernels.conv3(x, w.double(), b)
    with pytest.raises(TypeError, match="x2"):
        kernels.conv3(x, torch.cat([w, w], 1), b, x2=x.float())
    with pytest.raises(TypeError, match="bias"):
        kernels.conv3(x, w, b.double())
    with pytest.raises(ValueError, match="does not fit"):
        kernels.conv3(x, w, b, precision="mixed")
    n = x.numel()
    unaligned = torch.empty(n + 1, dtype=x.dtype, device=dev)[1:]
    with pytest.raises(ValueError, match="16-byte"):
        kernels.conv3(unaligned.view(x.shape).copy_(x), w, b)
    with pytest.raises(NotImplementedError, match="item 12"):
        kernels.conv3(x, w.clone().requires_grad_(), b)


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "mixed"])
def test_vnetds_launches_the_bf16_instances(dev, compute_dtype):
    """V-Net-DS at the serving width in a bf16 mode: one forward launches
    conv_in_bf16 1, conv3's instance 29 and tail_resize_bf16 1, and comes
    within bf16's class of its twins path (each wrapper replaced by its
    plain twin), which launches nothing."""
    from multimodal_3d_image_segmentation_tpu_torch.models import VNetDS
    from multimodal_3d_image_segmentation_tpu_torch.utils.precision_gate \
        import plain_twins
    model = VNetDS(4, 4, 24, [1, 2, 3, 3, 3],
                   right_leg_indexes=[0, 1, 2, 3, 4], use_kernels=True,
                   compute_dtype=compute_dtype, device=dev)
    x = _t((1, 4, 40, 36, 30), 170, dev)
    before = dict(kernels.LAUNCHES)
    with torch.no_grad():
        got = model(x)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
             if v != before[k]}
    suffix = "_bf16" if compute_dtype == "bfloat16" else "_mixed"
    assert moved == {"conv_in_bf16": 1, "tail_resize_bf16": 1,
                     "conv3" + suffix: 29}
    before = dict(kernels.LAUNCHES)
    with torch.no_grad(), plain_twins(family="vnetds"):
        twins = model(x)
    assert kernels.LAUNCHES == before
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert float((got - twins).abs().mean()) < 1e-2
