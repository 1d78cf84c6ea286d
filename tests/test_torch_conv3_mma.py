"""conv3's tensor-core body on the CPU: its weight packing and the two-pass
formulation of its 'mixed' instance.

The 'bfloat16' and 'mixed' instances run ``csrc/conv3_mma.cu`` on the card
(``tests/test_torch_kernels_cuda.py`` holds it to the twins there). What
the CPU can check is the arithmetic it is given:

  * ``mma_weight`` packs each tap's (ci, co) matrix into mma.sync's B
    fragment order, zero-padded to 16 input and 24 output channels; an fp32
    weight as its bf16 hi and lo parts, bit for bit the reference's
    ``kernels/_common.py::hi_lo``, which carry it within 2^-16 relative; a
    bf16 weight as its values (one pass; its lo part is 0);
  * 'mixed' as the kernel computes it, emulated in torch ops: the bf16
    activation operand (the prologue's output rounded) times the hi part
    plus the same operand times the lo part, fp32 sums, the bias in fp32,
    y and r rounded once. It is held to the Pallas ``conv3_flat(precision=
    'mixed')`` in interpret mode (with ``ops/spectral.PRECISION`` pinned to
    HIGHEST) and to ``conv3_plain``'s 'mixed' twin (the fp32 weight
    exactly) at the bar ``chip_smoke.py`` holds the kernel to: one bf16 ulp
    (2^-7 of the value) plus 1e-5 on every element, at most 1e-3 of the
    elements more than one ulp of their own magnitude apart, and fp32
    moments within 1e-5 of the sums of |y| and y^2 (the stride-2 conv's,
    of its rounded outputs, against its own).
"""
import importlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from multimodal_3d_image_segmentation_tpu.kernels._common import \
    hi_lo as jax_hi_lo
from multimodal_3d_image_segmentation_tpu.kernels.conv3d_flat import (
    conv3_flat, flat_geom, from_flat, to_flat)
from multimodal_3d_image_segmentation_tpu.ops import spectral as jspectral
from multimodal_3d_image_segmentation_tpu_torch import kernels

# the module (``kernels`` exports the function under the same name)
conv3_mod = importlib.import_module(
    "multimodal_3d_image_segmentation_tpu_torch.kernels.conv3")

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

BF16 = torch.bfloat16
BF16_ULP = 2.0 ** -7
SHARE = 1e-3
STATS_RTOL = 1e-5
ACTS = {"elu": F.elu, "selu": torch.selu, "relu": torch.relu}


@pytest.fixture
def jax_flags(monkeypatch):
    monkeypatch.setattr(jspectral, "PRECISION", jax.lax.Precision.HIGHEST)
    monkeypatch.setattr(jspectral, "BF16_EXACT", True)  # the 'mixed' island
    return monkeypatch


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _bf16(a):
    """numpy fp32 -> its bf16 values, as fp32 numpy."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(BF16).float().numpy()


def _unpack(packed):
    """``mma_weight``'s (passes, taps, K/16, N/8, 8, 4, 2, 2) -> (passes,
    taps, K, N) by the inverse of the fragment order."""
    p, taps, nks, nnt = packed.shape[:4]
    f = packed.permute(0, 1, 2, 6, 5, 7, 3, 4)  # p, tap, ks, half, t, j, nt, g
    return f.reshape(p, taps, 16 * nks, 8 * nnt)


def _taps(w):
    """(co, ci, 3, 3, 3) -> (27, ci, co), tap (kz*3+ky)*3+kx."""
    co, ci = w.shape[:2]
    return w.permute(2, 3, 4, 1, 0).reshape(27, ci, co)


def test_hi_lo_is_the_reference_split_bit_for_bit():
    """An fp32 weight's two passes are the JAX ``hi_lo`` of its taps."""
    w = torch.from_numpy(_rand((24, 48, 3, 3, 3), 1, 0.05))
    got = _unpack(conv3_mod.mma_weight(w))
    assert got.dtype == BF16 and got.shape == (2, 27, 48, 24)
    hi, lo = jax_hi_lo(jnp.asarray(_taps(w).numpy()))
    for part, want in zip(got, (hi, lo)):
        want = np.asarray(want.astype(jnp.float32))
        assert np.array_equal(part.float().numpy(), want)


def test_hi_plus_lo_carries_the_weight_within_2_to_the_minus_16():
    w = torch.from_numpy(_rand((48, 24, 3, 3, 3), 2, 0.05))
    got = _unpack(conv3_mod.mma_weight(w))[:, :, :24].double()
    want = _taps(w).double()
    err = (got[0] + got[1] - want).abs()
    assert float((err - 2.0 ** -16 * want.abs()).max()) <= 0
    # hi alone does not: the lo pass carries bits the weight has
    assert float((got[0] - want).abs().max()) > 2.0 ** -12 * float(
        want.abs().max())


def test_padded_channels_are_zero():
    """ci 12 pads to 16 and co 4 to 24: the pads are zero in both passes,
    and the residual tap packs (co, ci) as one tap of the same layout."""
    w = torch.from_numpy(_rand((4, 12, 3, 3, 3), 3))
    got = _unpack(conv3_mod.mma_weight(w))
    assert got.shape == (2, 27, 16, 24)
    assert not got[:, :, 12:].float().any() and not got[:, :, :, 4:].any()
    assert got[:, :, :12, :4].float().abs().sum() > 0
    wr = torch.from_numpy(_rand((4, 12), 4))
    r = _unpack(conv3_mod.mma_res_weight(wr))
    assert r.shape == (2, 1, 16, 24)
    assert not r[:, :, 12:].float().any() and not r[:, :, :, 4:].any()
    hi, lo = conv3_mod.hi_lo(wr.t())
    assert torch.equal(r[0, 0, :12, :4], hi) and torch.equal(r[1, 0, :12, :4],
                                                             lo)


def test_a_bf16_weight_packs_one_pass_and_its_lo_is_zero():
    w = torch.from_numpy(_rand((24, 24, 3, 3, 3), 5)).to(BF16)
    hi, lo = conv3_mod.hi_lo(w)
    assert torch.equal(hi, w) and not lo.float().any()
    got = _unpack(conv3_mod.mma_weight(w))
    assert got.shape == (1, 27, 32, 24)
    assert torch.equal(got[0, :, :24], _taps(w))


def test_fragments_are_in_mma_sync_order():
    """Lane 4g + t of a warp holds, for k16 step ks of n8 tile nt, B[16ks
    + 2t (+1)][8nt + g] in its first register and B[16ks + 8 + 2t (+1)][8nt
    + g] in its second (the low half the even k): mma.m16n8k16's B
    fragment, read as 8 contiguous bytes."""
    w = torch.from_numpy(_rand((24, 32, 3, 3, 3), 6)).to(BF16)
    packed = conv3_mod.mma_weight(w)
    b = _taps(w)
    flat = packed.reshape(1, 27, 2, 3, 32, 4)  # pass, tap, ks, nt, lane, 4
    rng = np.random.default_rng(7)
    for _ in range(64):
        tap, ks, nt, lane = (int(rng.integers(n)) for n in (27, 2, 3, 32))
        g, t = divmod(lane, 4)
        regs = flat[0, tap, ks, nt, lane]
        k = 16 * ks + 2 * t
        n = 8 * nt + g
        want = torch.stack([b[tap, k, n], b[tap, k + 1, n],
                            b[tap, k + 8, n], b[tap, k + 9, n]])
        assert torch.equal(regs, want)


def test_packing_is_kept_per_weight_version():
    w = torch.from_numpy(_rand((8, 8, 3, 3, 3), 8))
    first = conv3_mod.mma_weight(w)
    assert conv3_mod.mma_weight(w) is first
    with torch.no_grad():
        w.mul_(2.0)
    again = conv3_mod.mma_weight(w)
    assert again is not first
    assert torch.equal(_unpack(again)[0], (2 * _unpack(first)[0].float()).to(
        BF16))


def _case(seed, c1=8, co=8, c2=0, sizes=(5, 6, 7), prologue=False,
          residual=False):
    """numpy operands: the volumes and the prologue bf16 values, the
    weights full fp32 (their hi and lo parts differ from them)."""
    ci = c1 + c2
    op = {"x": _bf16(_rand((1,) + sizes + (c1,), seed)),
          "w": _rand((co, ci, 3, 3, 3), seed + 1, 1 / np.sqrt(27 * ci)),
          "b": _rand((co,), seed + 2, 0.1)}
    if c2:
        op["x2"] = _bf16(_rand((1,) + sizes + (c2,), seed + 3))
    if prologue:
        op["scale"] = _bf16(_rand((ci,), seed + 4, 0.3) + 1.0)
        op["shift"] = _bf16(_rand((ci,), seed + 5, 0.5))
    if residual:
        op["wr"] = _rand((co, ci), seed + 6, 1 / np.sqrt(ci))
        op["br"] = _rand((co,), seed + 7, 0.1)
    return op


def _moments(y):
    y = y.reshape(-1, y.shape[-1]).double()
    return torch.stack([y.sum(0), (y * y).sum(0)]), torch.stack(
        [y.abs().sum(0), (y * y).sum(0)])


def _two_pass(op, act=None, stride=1, emit_stats=False, unrounded=False):
    """The 'mixed' instance as the kernel computes it, in torch ops: y (and
    r) bf16, then the fp32 moments; ``unrounded``: the prologue's output
    left unrounded (a control)."""
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in op.items()}
    xin = t["x"] if "x2" not in t else torch.cat([t["x"], t["x2"]], -1)
    xp = xin
    if "scale" in t:
        xp = ACTS[act](xin * t["scale"] + t["shift"])
        if not unrounded:
            xp = xp.to(BF16).float()
    xcf = xp.permute(0, 4, 1, 2, 3)
    hi, lo = (p.float() for p in conv3_mod.hi_lo(t["w"]))
    y = (F.conv3d(xcf, hi, stride=stride, padding=1)
         + F.conv3d(xcf, lo, stride=stride, padding=1)
         + t["b"][:, None, None, None]).permute(0, 2, 3, 4, 1)
    outs = [y]
    if "wr" in t:
        rhi, rlo = (p.float() for p in conv3_mod.hi_lo(t["wr"]))
        outs.append(xin @ rhi.t() + xin @ rlo.t() + t["br"])
    rounded = [o.to(BF16) for o in outs]
    if not emit_stats:
        return rounded
    return rounded + [_moments(r.float() if stride == 2 else o)[0].float()
                      for o, r in zip(outs, rounded)]


def _pallas(op, act=None, emit_stats=False):
    """The Pallas kernel's 'mixed' in interpret mode on ``op`` (stride 1):
    numpy y[, r][, stats...]."""
    def flat(v):
        g = flat_geom(v.shape[1:4])
        return to_flat(jnp.asarray(v[0].transpose(3, 0, 1, 2), jnp.bfloat16),
                       g), g
    xf, g = flat(op["x"])
    xin = xf if "x2" not in op else (xf, flat(op["x2"])[0])
    kw = {}
    if "scale" in op:
        kw.update(prologue=(jnp.asarray(op["scale"], jnp.bfloat16),
                            jnp.asarray(op["shift"], jnp.bfloat16)),
                  prologue_act=act)
    if "wr" in op:
        kw["residual"] = (jnp.asarray(op["wr"]), jnp.asarray(op["br"]))
    out = conv3_flat(xin, jnp.asarray(op["w"].transpose(2, 3, 4, 1, 0)),
                     jnp.asarray(op["b"]), g, emit_stats=emit_stats,
                     precision="mixed", interpret=True, **kw)
    out = out if isinstance(out, tuple) else (out,)
    n_vol = 2 if "wr" in op else 1
    vols = [np.asarray(from_flat(o, g).astype(jnp.float32)).transpose(
        1, 2, 3, 0)[None] for o in out[:n_vol]]
    return vols + [np.asarray(o, np.float64) for o in out[n_vol:]]


def _twin(op, act=None, stride=1, emit_stats=False):
    """``conv3_plain``'s 'mixed' twin (the fp32 weight exactly)."""
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in op.items()}
    kw = dict(stride=stride, emit_stats=emit_stats)
    if "x2" in t:
        kw["x2"] = t["x2"].to(BF16)
    if "scale" in t:
        kw.update(prologue=(t["scale"].to(BF16), t["shift"].to(BF16)),
                  prologue_act=act)
    if "wr" in t:
        kw["residual"] = (t["wr"], t["br"])
    out = kernels.conv3_plain(t["x"].to(BF16), t["w"], t["b"], **kw)
    return list(out) if isinstance(out, tuple) else [out]


def _held(got, want, n_vol, stride=1):
    """(passes the bar, what it read): ``got``'s bf16 volumes and fp32
    moments against ``want``'s (torch or numpy); the stride-2 conv's
    moments against ``got``'s own rounded outputs."""
    ok, read = True, []
    for g, w in zip(got[:n_vol], want[:n_vol]):
        g = g.float()
        w = w.float() if torch.is_tensor(w) else torch.from_numpy(
            np.array(w, np.float32))
        assert g.shape == w.shape
        d = (g - w).abs()
        mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
        share = float((d > torch.exp2(torch.floor(torch.log2(mag)) - 7))
                      .float().mean())
        ok &= bool((d <= BF16_ULP * w.abs() + 1e-5).all()) and share <= SHARE
        read.append((float(d.max()), share))
    for i, st in enumerate(got[n_vol:]):
        exact, scale = _moments(got[i].float())
        ref = exact if stride == 2 else torch.as_tensor(
            np.array(want[n_vol + i], np.float64))
        rel = float(((st.double() - ref).abs() / scale).max())
        ok &= rel <= STATS_RTOL
        read.append(rel)
    return ok, read


# case -> (operands, the call's options)
CASES = {
    "prologue_elu_stats": (dict(c1=8, c2=8, co=12, prologue=True),
                           dict(act="elu", emit_stats=True)),
    "residual_concat_stats": (dict(c1=16, c2=8, co=8, residual=True),
                              dict(emit_stats=True)),
    "stride2_prologue_stats": (dict(c1=24, co=16, sizes=(7, 5, 6),
                                    prologue=True),
                               dict(act="selu", stride=2, emit_stats=True)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_two_pass_mixed_matches_pallas_and_the_twin(name, jax_flags):
    """The two-pass formulation against the Pallas kernel's 'mixed' (at
    stride 2 the reference convolves at stride 1 and keeps the even
    voxels) and against the 'mixed' twin, both at the kernel's bar."""
    shape, opts = CASES[name]
    op = _case(30 + 10 * list(CASES).index(name), **shape)
    stride = opts.get("stride", 1)
    got = _two_pass(op, **opts)
    n_vol = 2 if "wr" in op else 1
    want = _pallas(op, opts.get("act"), opts["emit_stats"])
    if stride == 2:
        want = [want[0][:, ::2, ::2, ::2]]
    ok, read = _held(got, want, n_vol if stride == 1 else 1, stride)
    assert ok, ("pallas", read)
    ok, read = _held(got, _twin(op, **opts), n_vol, stride)
    assert ok, ("twin", read)
    # the operand rounding matters: the prologue output unrounded misses
    if "scale" in op and stride == 1:
        bad = _two_pass(op, **opts, unrounded=True)
        assert not _held(bad, want, n_vol)[0]
