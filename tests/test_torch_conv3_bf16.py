"""The bf16 twins of conv3 (``conv3_plain`` on a bf16 volume: the
'bfloat16' instance with bf16 weights, the reference's precision 'native',
and the 'mixed' instance with fp32 weights) against the JAX package's
Pallas ``conv3_flat`` in interpret mode on the same bf16 volume, as its own
tests run it on the CPU.

Inputs are made with numpy from a seed, the weights cut to the 16
significant bits that the reference's hi/lo split of a 'mixed' weight
carries exactly (the port's 'mixed' multiplies the fp32 weight itself);
the JAX side runs with
``ops/spectral.PRECISION`` pinned to HIGHEST and ``set_bf16_exact`` set for
'mixed' (its residual weight island), both by ``monkeypatch``. The prologue's
scale and shift are bf16, as the reference's deferred GroupNorm hands them
on. The bar of a twin against the Pallas kernel:
  * its bf16 outputs within one bf16 ulp (2^-7 of the value, plus 1e-5),
    and at most 1e-3 of the elements more than one ulp of their own
    magnitude apart;
  * its largest distance from a float64 evaluation of the same operand
    values (nothing rounded) at most 2x the Pallas kernel's;
  * its fp32 moment sums within 1e-5 of the sums of |y| and y^2 (the sums
    of the fp32 values before the output's rounding; the stride-2 conv's,
    which the reference's decimated GroupNorm takes from the rounded
    outputs, are held to its own rounded outputs).
A rounding of the operands moves each output by about a tenth of an ulp,
which the output's own rounding hides but the fp32 moments show, so a twin
with one rounding left out (the prologue output unrounded; in 'bfloat16'
the weights unrounded) must fail the bar. The fp32 classes run exact fp32
products; a case shows them nearer float64 than the Pallas kernel's
'bf16x3' emulation.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_3d_image_segmentation_tpu.kernels.conv3d_flat import (
    conv3_flat, flat_geom, from_flat, to_flat)
from multimodal_3d_image_segmentation_tpu.ops import spectral as jspectral
from multimodal_3d_image_segmentation_tpu_torch import kernels

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

BF16 = torch.bfloat16
BF16_ULP = 2.0 ** -7
SHARE = 1e-3
STATS_RTOL = 1e-5
MODES = ("bfloat16", "mixed")
SIZES = (5, 6, 7)


@pytest.fixture(autouse=True)
def _jax_flags(monkeypatch):
    monkeypatch.setattr(jspectral, "PRECISION", jax.lax.Precision.HIGHEST)
    monkeypatch.setattr(jspectral, "BF16_EXACT", False)
    return monkeypatch


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _bf16(a):
    """numpy fp32 -> its bf16 values, as fp32 numpy."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(BF16).float().numpy()


def _hi_lo(a):
    """``a`` cut to the 16 significant bits that the reference's hi/lo
    split (``kernels/_common.py``) carries exactly."""
    hi = _bf16(a)
    return hi + _bf16(a - hi)


def _case(seed, c1=8, co=8, c2=0, sizes=SIZES, prologue=False,
          residual=False):
    """numpy operands (fp32; the volumes and the prologue hold bf16
    values, the weights 16 significant bits)."""
    ci = c1 + c2
    op = {"x": _bf16(_rand((1,) + sizes + (c1,), seed)),
          "w": _hi_lo(_rand((co, ci, 3, 3, 3), seed + 1,
                            1 / np.sqrt(27 * ci))),
          "b": _rand((co,), seed + 2, 0.1)}
    if c2:
        op["x2"] = _bf16(_rand((1,) + sizes + (c2,), seed + 3))
    if prologue:
        op["scale"] = _bf16(_rand((ci,), seed + 4, 0.3) + 1.0)
        op["shift"] = _bf16(_rand((ci,), seed + 5, 0.5))
    if residual:
        op["wr"] = _hi_lo(_rand((co, ci), seed + 6, 1 / np.sqrt(ci)))
        op["br"] = _rand((co,), seed + 7, 0.1)
    return op


def _flat(x):
    """(1, D, H, W, C) -> the reference's flat layout, in bf16."""
    g = flat_geom(x.shape[1:4])
    return to_flat(jnp.asarray(x[0].transpose(3, 0, 1, 2), jnp.bfloat16),
                   g), g


def _unflat(yf, g):
    return np.asarray(from_flat(yf, g).astype(jnp.float32)).transpose(
        1, 2, 3, 0)[None]


def _pallas(op, mode, flags, act=None, emit_stats=False,
            precision=None, dilate=False):
    """The Pallas kernel in interpret mode on ``op`` in ``mode`` (the
    weights and bias bf16 in 'bfloat16'); ``dilate``: on the zero-dilated
    2x volume, the transposed conv. Returns numpy (y[, r][, stats...])."""
    flags.setattr(jspectral, "BF16_EXACT", mode == "mixed")
    x = op["x"]
    if dilate:
        xd = np.zeros((1,) + tuple(2 * n for n in x.shape[1:4])
                      + x.shape[4:], np.float32)
        xd[:, ::2, ::2, ::2] = x
        x = xd
    xf, g = _flat(x)
    xin = xf if "x2" not in op else (xf, _flat(op["x2"])[0])
    wdt = jnp.bfloat16 if mode == "bfloat16" else jnp.float32
    kernel = jnp.asarray(op["w"].transpose(2, 3, 4, 1, 0)).astype(wdt)
    kw = {}
    if "scale" in op:
        kw.update(prologue=(jnp.asarray(op["scale"], jnp.bfloat16),
                            jnp.asarray(op["shift"], jnp.bfloat16)),
                  prologue_act=act)
    if "wr" in op:
        kw["residual"] = (jnp.asarray(op["wr"]), jnp.asarray(op["br"]))
    out = conv3_flat(xin, kernel, jnp.asarray(op["b"]).astype(wdt), g,
                     emit_stats=emit_stats,
                     precision=precision or
                     ("native" if mode == "bfloat16" else "mixed"),
                     interpret=True, **kw)
    out = out if isinstance(out, tuple) else (out,)
    n_vol = 2 if "wr" in op else 1
    return ([_unflat(t, g) for t in out[:n_vol]]
            + [np.asarray(t, np.float64) for t in out[n_vol:]])


def _port_args(op, mode, dtype=BF16, weights=None):
    """``op`` as torch tensors for a twin: the volumes and the prologue in
    ``dtype``, the weights in the mode's dtype (``weights``: this dtype
    instead), the residual bias fp32."""
    wdt = weights or (BF16 if mode == "bfloat16" else torch.float32)

    def t(name, dt):
        return torch.from_numpy(np.ascontiguousarray(op[name])).to(dt)
    args = (t("x", dtype), t("w", wdt), t("b", wdt))
    kw = {}
    if "x2" in op:
        kw["x2"] = t("x2", dtype)
    if "scale" in op:
        kw["prologue"] = (t("scale", dtype), t("shift", dtype))
    if "wr" in op:
        kw["residual"] = (t("wr", wdt), t("br", torch.float32))
    return args, kw


def _float64(op, mode, **opts):
    """The same operand values in float64, nothing rounded."""
    args, kw = _port_args(op, mode)
    args = tuple(a.double() for a in args)
    kw = {k: (tuple(t.double() for t in v) if isinstance(v, tuple)
              else v.double()) for k, v in kw.items()}
    out = kernels.conv3_plain(*args, **kw, **opts)
    return [o.numpy() for o in (out if isinstance(out, tuple) else (out,))]


def _moments(y):
    y = y.astype(np.float64).reshape(-1, y.shape[-1])
    return np.stack([y.sum(0), (y * y).sum(0)]), np.stack(
        [np.abs(y).sum(0), (y * y).sum(0)])


def _readings(got, want, ref, n_vol):
    """(passes the bar, what it read): the twin's outputs ``got`` (bf16
    volumes, then fp32 moments) against the Pallas kernel's ``want`` and
    the float64 ``ref``."""
    ok, read = True, {}
    for i in range(n_vol):
        g, w = got[i].float().numpy(), want[i]
        d = np.abs(g - w)
        ok &= bool((d <= BF16_ULP * np.abs(w) + 1e-5).all())
        mag = np.maximum(np.maximum(np.abs(g), np.abs(w)), 2.0 ** -126)
        share = float((d > np.exp2(np.floor(np.log2(mag)) - 7)).mean())
        k64 = float(np.abs(g - ref[i]).max())
        p64 = float(np.abs(w - ref[i]).max())
        ok &= share <= SHARE and k64 <= 2 * p64 + 1e-7
        read[f"out{i}"] = (float(d.max()), share, k64, p64)
    for i, st in enumerate(got[n_vol:]):
        _, scale = _moments(got[i].float().numpy())
        d = np.abs(st.double().numpy() - want[n_vol + i])
        ok &= bool((d <= STATS_RTOL * scale).all())
        read[f"stats{i}"] = float((d / scale).max())
    return ok, read


# case -> (operands, the call's options, the Pallas side's)
CASES = {
    "concat_stats": (dict(c1=8, c2=8, co=12), dict(emit_stats=True), {}),
    "prologue_elu": (dict(prologue=True), dict(prologue_act="elu",
                                               emit_stats=True),
                     dict(act="elu")),
    "prologue_selu": (dict(prologue=True, sizes=(4, 6, 8)),
                      dict(prologue_act="selu", emit_stats=True),
                      dict(act="selu")),
    "prologue_relu": (dict(prologue=True), dict(prologue_act="relu",
                                                emit_stats=True),
                      dict(act="relu")),
    "residual_concat": (dict(c1=8, c2=4, residual=True), dict(
        emit_stats=True), {}),
}


def _pallas_of(name, op, mode, flags):
    _, opts, popts = CASES[name]
    return _pallas(op, mode, flags, emit_stats=opts.get("emit_stats", False),
                   **popts)


@pytest.mark.parametrize("name", list(CASES))
def test_twin_matches_pallas(name, _jax_flags):
    """The bare conv with a virtual concat, the prologue with each kernel
    activation, and the residual tap with both outputs' moments, in both
    bf16 instances."""
    shape, opts, _ = CASES[name]
    op = _case(10 + 10 * list(CASES).index(name), **shape)
    for mode in MODES:
        want = _pallas_of(name, op, mode, _jax_flags)
        args, kw = _port_args(op, mode)
        got = kernels.conv3(*args, **kw, **opts)
        got = got if isinstance(got, tuple) else (got,)
        n_vol = 2 if "wr" in op else 1
        assert all(t.dtype == BF16 for t in got[:n_vol])
        assert all(t.dtype == torch.float32 for t in got[n_vol:])
        ok, read = _readings(got, want, _float64(op, mode, **opts), n_vol)
        assert ok, (mode, read)


def test_stride2_is_the_decimated_conv_with_rounded_moments(_jax_flags):
    """The down conv: the reference convolves at stride 1, keeps the even
    voxels and takes its GroupNorm moments from that bf16 volume; the
    port's bf16 stride 2 gives the same voxels and takes its moments from
    them too (a stride-1 conv's are those of its fp32 values)."""
    op = _case(60, sizes=(7, 5, 6))
    for mode in MODES:
        full = _pallas(op, mode, _jax_flags)[0]
        want = full[:, ::2, ::2, ::2]
        args, kw = _port_args(op, mode)
        y, st = kernels.conv3(*args, stride=2, emit_stats=True)
        assert tuple(y.shape[1:4]) == want.shape[1:4] == (4, 3, 3)
        ref = _float64(op, mode, stride=2)
        ok, read = _readings((y,), [want], ref, 1)
        assert ok, (mode, read)
        # the moments of its own rounded output, as the reference's of its
        # (a one-ulp flip moves them past 1e-5)
        exact, scale = _moments(y.float().numpy())
        assert (np.abs(st.double().numpy() - exact)
                <= STATS_RTOL * scale).all()
        _, st1 = kernels.conv3(*args, emit_stats=True)
        exact, scale = _moments(_float64(op, mode)[0])
        assert (np.abs(st1.double().numpy() - exact)
                <= STATS_RTOL * scale).all()


def test_dilation2_is_the_conv_of_the_dilated_volume(_jax_flags):
    """The transposed up conv: the Pallas kernel on the zero-dilated 2x
    volume with the same conv-layout weight, and its moments (the
    reference's transposed conv emits them over the 2x volume)."""
    op = _case(70, c1=8, co=4, sizes=(3, 4, 5))
    for mode in MODES:
        want = _pallas(op, mode, _jax_flags, emit_stats=True, dilate=True)
        args, kw = _port_args(op, mode)
        got = kernels.conv3(*args, dilation=2, emit_stats=True)
        assert tuple(got[0].shape[1:4]) == (6, 8, 10)
        ok, read = _readings(got, want, _float64(op, mode, dilation=2), 1)
        assert ok, (mode, read)


def test_prologue_unrounded_control_fails(_jax_flags):
    """The twin with the prologue output left unrounded misses the bar the
    twin meets (its moments), in both instances."""
    name = "prologue_elu"
    _, opts, _ = CASES[name]
    op = _case(20, prologue=True)
    for mode in MODES:
        want = _pallas_of(name, op, mode, _jax_flags)
        args, kw = _port_args(op, mode)
        ref = _float64(op, mode, **opts)
        ok, _ = _readings(kernels.conv3_plain(*args, **kw, **opts), want,
                          ref, 1)
        bad, read = _readings(kernels.conv3_plain(
            *args, **kw, **opts, unrounded={"prologue"}), want, ref, 1)
        assert ok and not bad, (mode, read)


def test_bfloat16_weights_unrounded_control_fails(_jax_flags):
    """In 'bfloat16', the twin given the fp32 weights (the 'mixed' twin)
    misses the bar against the Pallas kernel's bf16 weights."""
    op = _case(80, c1=8, c2=8, co=12)
    want = _pallas(op, "bfloat16", _jax_flags, emit_stats=True)
    ref = _float64(op, "bfloat16")
    args, kw = _port_args(op, "bfloat16", weights=torch.float32)
    bad, read = _readings(kernels.conv3(*args, **kw, emit_stats=True), want,
                          ref, 1)
    assert not bad, read


def test_exact_fp32_is_nearer_float64_than_the_bf16x3_emulation():
    """The fp32 classes run exact fp32 products on the card; the Pallas
    kernel's 'bf16x3' (the hi/lo split of ``kernels/_common.py``) is
    farther from a float64 evaluation, so the port needs no emulation."""
    rng = np.random.default_rng(90)
    x = rng.standard_normal((1,) + SIZES + (16,)).astype(np.float32)
    w = (rng.standard_normal((16, 16, 3, 3, 3)) / 12).astype(np.float32)
    b = rng.uniform(-0.1, 0.1, 16).astype(np.float32)
    g = flat_geom(SIZES)
    xf = to_flat(jnp.asarray(x[0].transpose(3, 0, 1, 2)), g)
    pallas = np.asarray(from_flat(conv3_flat(
        xf, jnp.asarray(w.transpose(2, 3, 4, 1, 0)), jnp.asarray(b), g,
        precision="bf16x3", interpret=True), g)).transpose(1, 2, 3, 0)[None]
    port = kernels.conv3(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b)).numpy()
    ref = kernels.conv3_plain(*(torch.from_numpy(a).double()
                                for a in (x, w, b))).numpy()
    d_port = np.abs(port - ref).max()
    d_pallas = np.abs(pallas - ref).max()
    assert d_port < d_pallas / 4, (d_port, d_pallas)


def test_wrapper_instances_refusals_and_training_raise():
    """On the CPU a bf16 volume runs the twin and counts no launch; the
    instance follows the dtypes and ``precision`` is checked against them;
    a forward that autograd would record raises, naming item 12."""
    op = _case(100)
    before = dict(kernels.LAUNCHES)
    for mode, name in (("bfloat16", "native"), ("mixed", "mixed")):
        args, _ = _port_args(op, mode)
        assert kernels.conv3_plain is not kernels.conv3
        got = kernels.conv3(*args, precision=name)
        assert torch.equal(got, kernels.conv3_plain(*args))
        assert torch.equal(got, kernels.conv3(*args, precision="bf16x3"))
        other = "mixed" if name == "native" else "native"
        with pytest.raises(ValueError, match="does not fit"):
            kernels.conv3(*args, precision=other)
        with pytest.raises(ValueError, match="does not fit"):
            kernels.conv3(*args, precision="highest")
        with pytest.raises(NotImplementedError, match="item 12"):
            kernels.conv3(args[0], args[1].requires_grad_(), args[2])
    assert kernels.LAUNCHES == before
    x, w, b = (torch.from_numpy(op[k]) for k in ("x", "w", "b"))
    with pytest.raises(TypeError, match="float32 weight"):
        kernels.conv3(x.bfloat16(), w.double(), b)
    with pytest.raises(TypeError, match="x2"):
        kernels.conv3(x.bfloat16(), torch.cat([w, w], 1), b, x2=x)
