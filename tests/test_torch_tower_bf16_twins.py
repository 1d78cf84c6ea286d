"""The bf16 twins of the tower kernels (tower_block, tower_block_s and
tower_resident in 'bfloat16' and 'mixed') against the JAX package's Pallas
kernels in interpret mode with a bf16 volume, as its own tests run them on
the CPU (``tests/test_tower_kernel.py``, ``tests/test_tower_kernel_s.py``,
``tests/test_tower_resident.py``).

Inputs are made with numpy from a seed; the JAX side runs with
``ops/spectral.PRECISION`` pinned to HIGHEST by ``monkeypatch``. bf16 rounds
at other places in the two formulations (the Pallas kernels round the
operand of every MXU pass; the port's 'bfloat16' twin rounds where the
CUDA kernel rounds, which follows them, but the resident kernel's depth
stages and the order of the sums differ), so each twin is held by two
bars: the outer one, the JAX tests' own 5e-2 (absolute and relative)
against the Pallas result; the inner one, its largest distance from a
float64 evaluation of the unrounded block at most 2x the Pallas kernel's
(the whole-model rule's factor). 'mixed' has no Pallas counterpart (the
reference serves it on its module path); its twin is held to what it
computes: the fp32 block with only the volume rounded.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_3d_image_segmentation_tpu.kernels import tower_block as jtb
from multimodal_3d_image_segmentation_tpu.kernels import \
    tower_block_s as jtbs
from multimodal_3d_image_segmentation_tpu.kernels import \
    tower_resident as jtr
from multimodal_3d_image_segmentation_tpu.ops import spectral as jspectral
from multimodal_3d_image_segmentation_tpu_torch import kernels
from multimodal_3d_image_segmentation_tpu_torch.kernels import \
    tower_block as tb
from multimodal_3d_image_segmentation_tpu_torch.kernels import \
    tower_block_s as tbs
from multimodal_3d_image_segmentation_tpu_torch.kernels import \
    tower_resident as tr

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

BF16 = torch.bfloat16
BF16_ULP = 2.0 ** -7
C = 8
SIZES, MODES, N_DS = (8, 10, 7), (2, 3, 2), 3
TRANSFORMS = ["Hartley", "Fourier"]


@pytest.fixture(autouse=True)
def _highest(monkeypatch):
    monkeypatch.setattr(jspectral, "PRECISION", jax.lax.Precision.HIGHEST)


def _block_inputs(transform, seed, n_ds=N_DS):
    """numpy x (1, D, H, W, C), the resident spectrum sy (KS, C, KH, KW)
    (the operator on the entry spectrum of x), z = its depth inverse, the
    weights and ds_prev."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1,) + SIZES + (C,)).astype(np.float32)
    spec = tb.make_tower_spec(transform, SIZES, MODES, C, n_ds=n_ds)
    ops = [torch.from_numpy((rng.standard_normal((C, C)) / np.sqrt(C))
                            .astype(np.float32))
           for _ in range(1 if transform == "Hartley" else 2)]
    with torch.no_grad():
        sy = tbs.spectrum_mix_s(tbs.entry_spectrum_s(torch.from_numpy(x[0]),
                                                     spec), ops, spec)
        z = tb.d_stage_inverse(sy, spec)
    w_cat = (rng.standard_normal((2 * C + n_ds, C)) / np.sqrt(C)).astype(
        np.float32)
    w_cc_t = (rng.standard_normal((C, C)) / np.sqrt(C)).astype(np.float32)
    b_cat = rng.uniform(-0.1, 0.1, 2 * C).astype(np.float32)
    ds_prev = rng.standard_normal((1,) + SIZES + (n_ds,)).astype(np.float32)
    return spec, x, sy.numpy(), z.numpy(), w_cat, w_cc_t, b_cat, ds_prev


def _bf16(a):
    """numpy fp32 -> the bf16 values, as fp32 numpy."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(
        jnp.float32))


def _cl(flat, channels):
    """JAX (D, C, W*HL) -> the port's (D, H, W, C), fp32 numpy."""
    return np.asarray(jtb.from_tower_flat(flat.astype(jnp.float32), SIZES,
                                          channels))[0].transpose(1, 2, 3, 0)


def _held(got, want, ref):
    """The two bars of the module docstring: ``got`` (the port's twin)
    against ``want`` (the Pallas kernel), both against ``ref`` (float64)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)
    port, pallas = np.abs(got - ref).max(), np.abs(want - ref).max()
    assert port <= 2 * pallas + 1e-6, (port, pallas)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


@pytest.mark.parametrize("transform", TRANSFORMS)
def test_tower_block_bf16_twin_matches_the_pallas_kernel(transform):
    """tower_block in 'bfloat16': out, f (both bf16) and ds (fp32) against
    ``fused_tower_block`` in interpret mode on the bf16 volume."""
    spec, x, _, z, w_cat, w_cc_t, b_cat, ds_prev = _block_inputs(transform,
                                                                 1)
    xb = _bf16(x)
    with torch.no_grad():
        got = tb.tower_block_plain(_t(xb[0], BF16), _t(z),
                                   _t(w_cat, BF16), _t(w_cc_t, BF16),
                                   _t(b_cat), spec, _t(ds_prev[0]))
        # float64 on the same (bf16) volume and weights, nothing rounded
        ref = tb.tower_block_plain(
            *(_t(a).double() for a in (xb[0], z, _bf16(w_cat),
                                       _bf16(w_cc_t), b_cat)), spec,
            _t(ds_prev[0]).double())
    assert got[0].dtype == got[1].dtype == BF16
    assert got[2].dtype == torch.float32
    jspec = jtb.make_tower_spec(transform, SIZES, MODES, C, n_ds=N_DS)
    want = jtb.fused_tower_block(
        jtb.to_tower_flat(jnp.asarray(xb).astype(jnp.bfloat16)),
        jnp.asarray(z), jnp.asarray(w_cat), jnp.asarray(w_cc_t),
        jnp.asarray(b_cat), jspec, True,
        jtb.to_tower_flat(jnp.asarray(ds_prev)))
    assert want[1].dtype == jnp.bfloat16
    _held(got[0].float(), _cl(want[0], C), ref[0].numpy())
    _held(got[1].float(), np.asarray(want[1].astype(jnp.float32)),
          ref[1].numpy())
    _held(got[2], _cl(want[2], N_DS), ref[2].numpy())


@pytest.mark.parametrize("transform", TRANSFORMS)
def test_tower_block_s_bf16_twin_matches_the_pallas_kernel(transform):
    """tower_block_s in 'bfloat16': out (bf16), s_f and ds (fp32) against
    ``fused_tower_block_s`` in interpret mode on the bf16 volume."""
    spec, x, sy, _, w_cat, w_cc_t, b_cat, ds_prev = _block_inputs(transform,
                                                                  2)
    xb = _bf16(x)
    with torch.no_grad():
        got = tbs.tower_block_s_plain(_t(xb[0], BF16), _t(sy),
                                      _t(w_cat, BF16), _t(w_cc_t, BF16),
                                      _t(b_cat), spec, _t(ds_prev[0]))
        ref = tbs.tower_block_s_plain(
            *(_t(a).double() for a in (xb[0], sy, _bf16(w_cat),
                                       _bf16(w_cc_t), b_cat)), spec,
            _t(ds_prev[0]).double())
    assert got[0].dtype == BF16 and got[1].dtype == torch.float32
    jspec = jtbs.make_tower_spec_s(transform, SIZES, MODES, C, n_ds=N_DS)
    ks, _, kh, kw = sy.shape
    sy3 = np.pad(sy, [(0, 0)] * 3 + [(0, jspec.kwl - kw)]).reshape(
        ks, C * kh, jspec.kwl)
    want = jtbs.fused_tower_block_s(
        jtb.to_tower_flat(jnp.asarray(xb).astype(jnp.bfloat16)),
        jnp.asarray(sy3), jnp.asarray(w_cat), jnp.asarray(w_cc_t),
        jnp.asarray(b_cat), jspec, True,
        jtb.to_tower_flat(jnp.asarray(ds_prev)))
    s_f = np.asarray(want[1]).reshape(ks, C, kh, jspec.kwl)[..., :kw]
    _held(got[0].float(), _cl(want[0], C), ref[0].numpy())
    _held(got[1], s_f, ref[1].numpy())
    _held(got[2], _cl(want[2], N_DS), ref[2].numpy())


@pytest.mark.parametrize("transform", TRANSFORMS)
def test_tower_resident_bf16_twin_matches_the_pallas_kernel(transform):
    """The whole tower (3 blocks) in 'bfloat16' against ``resident_tower``
    in interpret mode on the bf16 volume (the Pallas kernel rounds its
    operator weights to bf16 and keeps the depth stages in fp32; the port
    keeps the operator fp32 and rounds the depth stages' operands, as its
    tower_block_s blocks do)."""
    rng = np.random.default_rng(3)
    pr, nb = (1 if transform == "Hartley" else 2), 3

    def r(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    x = _bf16(r(1, *SIZES, C, scale=0.3))
    ops, wcat, wcc = (r(nb, pr, C, C, scale=0.2), r(nb, 2 * C, C, scale=0.2),
                      r(nb, C, C, scale=0.2))
    b = r(nb, 2 * C, scale=0.1)
    spec = tb.make_tower_spec(transform, SIZES, MODES, C)
    with torch.no_grad():
        got = tr.resident_tower_plain(_t(x[0], BF16), _t(ops),
                                      _t(wcat, BF16), _t(wcc, BF16), _t(b),
                                      spec)
        ref = tr.resident_tower_plain(
            *(_t(a).double() for a in (x[0], ops, _bf16(wcat), _bf16(wcc),
                                       b)), spec)
    assert got.dtype == BF16
    jspec = jtb.make_tower_spec(transform, SIZES, MODES, C)
    want = jtr.resident_tower(
        jtb.to_tower_flat(jnp.asarray(x).astype(jnp.bfloat16)),
        *(jnp.asarray(a) for a in (ops, wcat, wcc, b)), jspec, True)
    _held(got.float(), _cl(want, C), ref.numpy())


@pytest.mark.parametrize("kernel", ["tower_block", "tower_block_s",
                                    "tower_resident"])
def test_mixed_twin_rounds_only_the_volume(kernel):
    """'mixed' (a bf16 volume with fp32 weights): each output is the fp32
    block's on the bf16 volume with out rounded once to bf16, and the
    spectra (f, s_f) are fp32 from that bf16 out. Bar: one bf16 ulp of
    each value on out (the fp32 sums may round the other way), 1e-5 of the
    largest magnitude on the rest (fp32 sums in the same order)."""
    spec, x, sy, z, w_cat, w_cc_t, b_cat, ds_prev = _block_inputs("Fourier",
                                                                  4)
    xb = _t(_bf16(x)[0])
    w = (_t(w_cat), _t(w_cc_t), _t(b_cat))
    with torch.no_grad():
        if kernel == "tower_resident":  # one block, Fourier's two weights
            ops = _t(np.stack([np.eye(C, dtype=np.float32)] * 2)[None])
            args = (ops, w[0][None, :2 * C], w[1][None], w[2][None])
            spec0 = spec._replace(n_ds=0)
            got = kernels.resident_tower(xb.to(BF16), *args, spec0)
            plain = tr.resident_tower_plain(xb, *args, spec0)
            assert got.dtype == BF16
            torch.testing.assert_close(got.float(), plain.to(BF16).float(),
                                       rtol=BF16_ULP, atol=1e-5)
            return
        fn = (kernels.fused_tower_block if kernel == "tower_block"
              else kernels.fused_tower_block_s)
        spectrum = _t(z) if kernel == "tower_block" else _t(sy)
        got = fn(xb.to(BF16), spectrum, *w, spec, _t(ds_prev[0]))
        plain = fn(xb, spectrum, *w, spec, _t(ds_prev[0]))
    assert got[0].dtype == BF16 and got[1].dtype == torch.float32
    torch.testing.assert_close(got[0].float(), plain[0].to(BF16).float(),
                               rtol=BF16_ULP, atol=1e-5)
    # the spectrum of the rounded out, in fp32
    with torch.no_grad():
        if kernel == "tower_block":
            again = tb.entry_forward_hw(got[0].float(), spec)
        else:
            again = tb.d_stage_forward(tb.entry_forward_hw(got[0].float(),
                                                           spec), spec)
    scale = float(again.abs().max())
    torch.testing.assert_close(got[1], again, rtol=0, atol=1e-5 * scale)
    torch.testing.assert_close(got[2], plain[2], rtol=0, atol=1e-5)


def test_wrappers_take_the_instances_dtypes_only():
    """x and the channel-mix weights choose the instance: both fp32, both
    bf16 ('bfloat16'), x bf16 with fp32 weights ('mixed'); anything else
    raises, as does a bf16 spectrum or bias."""
    spec, x, sy, z, w_cat, w_cc_t, b_cat, ds_prev = _block_inputs("Hartley",
                                                                  5)
    xb, xf = _t(x[0], BF16), _t(x[0])
    assert tb.instance(xf, _t(w_cat)) == "float32"
    assert tb.instance(xb, _t(w_cat, BF16)) == "bfloat16"
    assert tb.instance(xb, _t(w_cat)) == "mixed"
    with pytest.raises(TypeError, match="float32"):
        tb.instance(xf, _t(w_cat, BF16))
    with pytest.raises(TypeError, match="float32"):
        tb.fused_tower_block(xb.half(), _t(z), _t(w_cat), _t(w_cc_t),
                             _t(b_cat), spec, _t(ds_prev[0]))
    with pytest.raises(TypeError, match="w_cc_t"):
        tb.fused_tower_block(xb, _t(z), _t(w_cat, BF16), _t(w_cc_t),
                             _t(b_cat), spec, _t(ds_prev[0]))
    with pytest.raises(TypeError, match="float32"):
        tbs.fused_tower_block_s(xb, _t(sy, BF16), _t(w_cat, BF16),
                                _t(w_cc_t, BF16), _t(b_cat), spec,
                                _t(ds_prev[0]))
    with pytest.raises(TypeError, match="float32"):
        tb.fused_tower_block(xb, _t(z), _t(w_cat, BF16), _t(w_cc_t, BF16),
                             _t(b_cat, BF16), spec, _t(ds_prev[0]))
    # the launch counts of each instance exist apart
    for name in ("tower_block", "tower_block_s", "tower_resident"):
        assert {name + s for s in ("", "_bf16", "_mixed")} <= set(
            kernels.LAUNCHES)


def test_bf16_twin_rounds_where_the_kernel_rounds():
    """Each rounding of the 'bfloat16' twin matters: left out alone, it
    moves out or f by more than one ulp on more than 1e-3 of the elements
    (the per-element rule ``chip_smoke.py`` holds the kernel to), except
    f's final rounding, which a bf16 output cannot show; with ``acc``
    float64 the twin differs from the fp32 one only by rounding flips."""
    spec, x, _, z, w_cat, w_cc_t, b_cat, ds_prev = _block_inputs("Hartley",
                                                                 6)
    args = (_t(x[0], BF16), _t(z), _t(w_cat, BF16), _t(w_cc_t, BF16),
            _t(b_cat), spec, _t(ds_prev[0]), torch.float32)

    def share(got, want):
        g, w = got.double(), want.double()
        mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        return float(((g - w).abs() > ulp).double().mean())
    with torch.no_grad():
        want = tb._tower_block_plain_bf16(*args)
        for k in ("z", "y", "t", "F"):
            ctl = tb._tower_block_plain_bf16(*args, frozenset({k}))
            assert max(share(ctl[0].float(), want[0].float()),
                       share(ctl[1].float(), want[1].float())) > 1e-2, k
        wide = tb._tower_block_plain_bf16(*args[:-1], torch.float64)
    assert share(wide[0].float(), want[0].float()) < 1e-2
    assert wide[1].dtype == BF16 and wide[2].dtype == torch.float32
