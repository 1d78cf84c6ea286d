"""The port's resident-spectrum tower block (``kernels/tower_block_s.py``)
and the Fourier stages of ``kernels/tower_block.py`` against the JAX
package's, on the CPU.

Inputs are made with numpy from a seed; the JAX side runs with
``ops/spectral.PRECISION`` pinned to HIGHEST by ``monkeypatch`` (restored
after each test). The JAX spectra are lane-padded to 128 columns; they are
compared sliced to ``[..., :kw]``. Tolerances: 1e-5 against the JAX plain
replays ``_block_reference_s`` / ``_block_reference`` (both fp32, other
summation orders); 1e-4 absolute and relative against the Pallas kernel in
interpret mode, whose fp32 products are packed bf16x3 (the bar of
``tests/test_tower_kernel_s.py``); 1e-6 for the spectrum stages, which are
single einsum chains on both sides.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_3d_image_segmentation_tpu.kernels import tower_block as jtb
from multimodal_3d_image_segmentation_tpu.kernels import \
    tower_block_s as jtbs
from multimodal_3d_image_segmentation_tpu.ops import spectral as jspectral
from multimodal_3d_image_segmentation_tpu_torch import kernels
from multimodal_3d_image_segmentation_tpu_torch.kernels import \
    tower_block as tb
from multimodal_3d_image_segmentation_tpu_torch.kernels import \
    tower_block_s as tbs

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

C = 4
# (transform, sizes, modes, n_ds): odd D, H and W, an odd mw (Fourier KW 3)
CASES = [("Hartley", (8, 6, 5), (2, 3, 2), 0),
         ("Hartley", (7, 9, 6), (2, 3, 2), 4),
         ("Fourier", (8, 6, 5), (2, 3, 2), 4),
         ("Fourier", (7, 9, 7), (2, 3, 3), 0),
         ("Fourier", (9, 7, 11), (3, 2, 5), 4)]
IDS = ["H-865-ds0", "H-796-ds4", "F-865-ds4", "F-797-oddmw", "F-9711-oddmw"]


@pytest.fixture(autouse=True)
def _highest(monkeypatch):
    monkeypatch.setattr(jspectral, "PRECISION", jax.lax.Precision.HIGHEST)


def _op_weights(transform, rng):
    n = 1 if transform == "Hartley" else 2
    return [(rng.standard_normal((C, C)) / np.sqrt(C)).astype(np.float32)
            for _ in range(n)]


def _inputs(transform, sizes, modes, n_ds, seed=0):
    """numpy (x (1, D, H, W, C), sy (KS, C, KH, KW), w_cat, w_cc_t, b_cat,
    ds_prev or None); sy is a real block's: the operator on the entry
    spectrum of x."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1,) + sizes + (C,)).astype(np.float32)
    spec = tbs.make_tower_spec_s(transform, sizes, modes, C, n_ds=n_ds)
    ops = [torch.from_numpy(w) for w in _op_weights(transform, rng)]
    with torch.no_grad():
        sy = tbs.spectrum_mix_s(tbs.entry_spectrum_s(torch.from_numpy(x[0]),
                                                     spec), ops, spec)
    w_cat = (rng.standard_normal((2 * C + n_ds, C)) / np.sqrt(C)).astype(
        np.float32)
    w_cc_t = (rng.standard_normal((C, C)) / np.sqrt(C)).astype(np.float32)
    b_cat = rng.uniform(-0.1, 0.1, 2 * C).astype(np.float32)
    ds_prev = (rng.standard_normal((1,) + sizes + (n_ds,)).astype(np.float32)
               if n_ds else None)
    return x, sy.numpy(), w_cat, w_cc_t, b_cat, ds_prev


def _port(transform, sizes, modes, n_ds, ins, fn=tbs.tower_block_s_plain):
    spec = tbs.make_tower_spec_s(transform, sizes, modes, C, n_ds=n_ds)
    x, sy, w_cat, w_cc_t, b_cat, ds_prev = ins
    t = torch.from_numpy
    with torch.no_grad():
        return fn(t(x[0]), t(sy), t(w_cat), t(w_cc_t), t(b_cat), spec,
                  None if ds_prev is None else t(ds_prev[0]))


def _lane_pad(s, kwl):
    """The port's (KS, C, KH, KW) -> the JAX resident (KS, C*KH, KWL)."""
    ks, c, kh, kw = s.shape
    s = np.pad(s, [(0, 0)] * 3 + [(0, kwl - kw)])
    return jnp.asarray(s.reshape(ks, c * kh, kwl))


def _jax(transform, sizes, modes, n_ds, ins, kernel=False):
    x, sy, w_cat, w_cc_t, b_cat, ds_prev = ins
    spec = jtbs.make_tower_spec_s(transform, sizes, modes, C, n_ds=n_ds)
    args = (jtb.to_tower_flat(jnp.asarray(x)), _lane_pad(sy, spec.kwl),
            jnp.asarray(w_cat), jnp.asarray(w_cc_t), jnp.asarray(b_cat))
    dsp = None if ds_prev is None else jtb.to_tower_flat(jnp.asarray(ds_prev))
    if kernel:
        return spec, jtbs.fused_tower_block_s(*args, spec, True, dsp)
    return spec, jtbs._block_reference_s(*args, spec, ds_prev=dsp)


def _compare(got, want, jspec, sizes, n_ds, **tol):
    assert len(got) == len(want) == (3 if n_ds else 2)
    out = np.asarray(jtb.from_tower_flat(want[0], sizes, C))[0]
    np.testing.assert_allclose(got[0].numpy(), out.transpose(1, 2, 3, 0),
                               **tol)
    ks, _, kh, kw = got[1].shape
    s_f = np.asarray(want[1]).reshape(ks, C, kh, jspec.kwl)[..., :kw]
    np.testing.assert_allclose(got[1].numpy(), s_f, **tol)
    if n_ds:
        ds = np.asarray(jtb.from_tower_flat(want[2], sizes, n_ds))[0]
        np.testing.assert_allclose(got[2].numpy(), ds.transpose(1, 2, 3, 0),
                                   **tol)


@pytest.mark.parametrize("transform,sizes,modes,n_ds", CASES, ids=IDS)
def test_plain_matches_jax_block_reference_s(transform, sizes, modes, n_ds):
    ins = _inputs(transform, sizes, modes, n_ds)
    got = _port(transform, sizes, modes, n_ds, ins)
    jspec, want = _jax(transform, sizes, modes, n_ds, ins)
    _compare(got, want, jspec, sizes, n_ds, atol=1e-5, rtol=0)


@pytest.mark.parametrize("transform,sizes,modes,n_ds", CASES, ids=IDS)
def test_plain_matches_jax_kernel_in_interpret_mode(transform, sizes, modes,
                                                    n_ds):
    ins = _inputs(transform, sizes, modes, n_ds, seed=1)
    got = _port(transform, sizes, modes, n_ds, ins)
    jspec, want = _jax(transform, sizes, modes, n_ds, ins, kernel=True)
    _compare(got, want, jspec, sizes, n_ds, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("transform,sizes,modes", [
    ("Fourier", (8, 6, 5), (2, 3, 2)), ("Fourier", (7, 9, 7), (2, 3, 3)),
    ("Hartley", (9, 7, 11), (3, 2, 5))])
def test_spectrum_stages_match_jax(transform, sizes, modes):
    """entry_forward_hw, d_stage_forward / d_stage_inverse,
    block_spectrum_update, entry_spectrum_s and spectrum_mix_s."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1,) + sizes + (C,)).astype(np.float32)
    ops = _op_weights(transform, rng)
    spec = tb.make_tower_spec(transform, sizes, modes, C)
    jspec = jtb.make_tower_spec(transform, sizes, modes, C)
    jspec_s = jtbs.make_tower_spec_s(transform, sizes, modes, C)
    xf = jtb.to_tower_flat(jnp.asarray(x))
    tops = [torch.from_numpy(w) for w in ops]
    jops = [jnp.asarray(w) for w in ops]
    with torch.no_grad():
        f = tb.entry_forward_hw(torch.from_numpy(x[0]), spec)
        s = tb.d_stage_forward(f, spec)
        z = tb.block_spectrum_update(f, tops, spec)
        s0 = tbs.entry_spectrum_s(torch.from_numpy(x[0]), spec)
        sy = tbs.spectrum_mix_s(s0, tops, spec)
    jf = jtb.entry_forward_hw(xf, jspec)
    ks = tb.spectrum_rows(spec)
    assert s.shape == (ks, C, spec.kh, spec.kw) and s0.shape == s.shape
    assert spec.kw == (modes[2] if transform == "Fourier" else 2 * modes[2])
    kwl = jspec_s.kwl
    js0 = jtbs.entry_spectrum_s(xf, jspec_s)
    jsy = jtbs.spectrum_mix_s(js0, jops, jspec_s)
    for got, want in (
            (f, jf), (s, np.asarray(jtb.d_stage_forward(jf, jspec))
                      .reshape(s.shape)),
            (tb.d_stage_inverse(s, spec), jtb.d_stage_inverse(
                jtb.d_stage_forward(jf, jspec), jspec)),
            (z, jtb.block_spectrum_update(jf, jops, jspec)),
            (s0, np.asarray(js0).reshape(ks, C, spec.kh, kwl)[..., :spec.kw]),
            (sy, np.asarray(jsy).reshape(ks, C, spec.kh, kwl)[..., :spec.kw])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("sizes,modes,n_ds", [((8, 6, 5), (2, 3, 2), 3),
                                              ((7, 9, 7), (2, 3, 3), 0)])
def test_fourier_tower_block_plain_matches_jax(sizes, modes, n_ds):
    """tower_block_plain with the Fourier matrices (an odd KW = 3 in the
    second case) against the JAX ``_block_reference``."""
    x, sy, w_cat, w_cc_t, b_cat, ds_prev = _inputs("Fourier", sizes, modes,
                                                   n_ds, seed=3)
    spec = tb.make_tower_spec("Fourier", sizes, modes, C, n_ds=n_ds)
    jspec = jtb.make_tower_spec("Fourier", sizes, modes, C, n_ds=n_ds)
    z = tb.d_stage_inverse(torch.from_numpy(sy), spec)
    t = torch.from_numpy
    with torch.no_grad():
        got = tb.tower_block_plain(t(x[0]), z, t(w_cat), t(w_cc_t),
                                   t(b_cat), spec,
                                   None if ds_prev is None else t(ds_prev[0]))
    dsp = None if ds_prev is None else jtb.to_tower_flat(jnp.asarray(ds_prev))
    want = jtb._block_reference(jtb.to_tower_flat(jnp.asarray(x)),
                                jnp.asarray(z.numpy()), jnp.asarray(w_cat),
                                jnp.asarray(w_cc_t), jnp.asarray(b_cat),
                                jspec, ds_prev=dsp)
    out = np.asarray(jtb.from_tower_flat(want[0], sizes, C))[0]
    np.testing.assert_allclose(got[0].numpy(), out.transpose(1, 2, 3, 0),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-5, rtol=0)
    assert len(got) == len(want) == (3 if n_ds else 2)


def test_wrapper_runs_the_plain_version_on_cpu_without_a_launch():
    ins = _inputs("Fourier", (7, 9, 7), (2, 3, 3), 4)
    before = dict(kernels.LAUNCHES)
    got = _port("Fourier", (7, 9, 7), (2, 3, 3), 4, ins,
                tbs.fused_tower_block_s)
    want = _port("Fourier", (7, 9, 7), (2, 3, 3), 4, ins)
    assert kernels.LAUNCHES == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_plain_version_chains_like_tower_block():
    """Two blocks on the resident spectrum equal two blocks of tower_block
    with the spectrum update between them (the reference's v5 / v2
    chain test)."""
    sizes, modes = (9, 8, 6), (2, 2, 2)
    for transform in ("Hartley", "Fourier"):
        x, _, w_cat, w_cc_t, b_cat, _ = (
            torch.from_numpy(a) if a is not None else None
            for a in _inputs(transform, sizes, modes, 0, seed=4))
        ops = [torch.from_numpy(w) for w in _op_weights(
            transform, np.random.default_rng(5))]
        spec = tb.make_tower_spec(transform, sizes, modes, C)
        with torch.no_grad():
            x2, f = x[0], tb.entry_forward_hw(x[0], spec)
            x5, s = x[0], tbs.entry_spectrum_s(x[0], spec)
            for _ in range(2):
                z = tb.block_spectrum_update(f, ops, spec)
                x2, f = tb.fused_tower_block(x2, z, w_cat, w_cc_t, b_cat,
                                             spec)
                x5, s = tbs.fused_tower_block_s(
                    x5, tbs.spectrum_mix_s(s, ops, spec), w_cat, w_cc_t,
                    b_cat, spec)
        torch.testing.assert_close(x5, x2, rtol=0, atol=1e-5)
        torch.testing.assert_close(s, tb.d_stage_forward(f, spec), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("transform,modes", [("Hartley", (3, 3, 2)),
                                             ("Hartley", (10, 14, 14)),
                                             ("Fourier", (3, 2, 3))])
def test_kernel_mats_pack_the_depth_rows(transform, modes):
    """The kernels' matrix buffer ends with mi (D, 2, KS) and then mf in
    four-row blocks (ceil(KS / 4), D, 2, 4), zero past KS."""
    sizes = (21, 33, 30)
    spec = tb.make_tower_spec(transform, sizes, modes, C)
    ks, d = tb.spectrum_rows(spec), sizes[0]
    n4 = -(-ks // 4)
    buf = tbs._kernel_mats_s(spec, torch.device("cpu")).numpy()
    head = tb._kernel_mats(spec, torch.device("cpu")).numel()
    assert buf.size == head + d * 2 * ks + n4 * d * 2 * 4
    m = tb._spec_mats(spec)
    mi = buf[head:head + d * 2 * ks].reshape(d, 2, ks)
    np.testing.assert_array_equal(mi, np.asarray(m["d_inv"], np.float32))
    packed = buf[head + d * 2 * ks:].reshape(n4, d, 2, 4)
    mf = np.asarray(m["d_fwd"], np.float32)
    for s in range(n4 * 4):
        want = mf[:, :, s] if s < ks else np.zeros((d, 2), np.float32)
        np.testing.assert_array_equal(packed[s // 4, :, :, s % 4], want)


def test_wrapper_refuses_what_it_does_not_take():
    x, sy, w_cat, w_cc_t, b_cat, ds_prev = (
        torch.from_numpy(a) for a in _inputs("Fourier", (8, 6, 5), (2, 3, 2),
                                             4))
    x, ds_prev = x[0], ds_prev[0]
    spec = tbs.make_tower_spec_s("Fourier", (8, 6, 5), (2, 3, 2), C, n_ds=4)
    with pytest.raises(ValueError, match="sy has shape"):
        tbs.fused_tower_block_s(x, sy[:4], w_cat, w_cc_t, b_cat, spec,
                                ds_prev)
    with pytest.raises(ValueError, match="x has shape"):
        tbs.fused_tower_block_s(x[:5], sy, w_cat, w_cc_t, b_cat, spec,
                                ds_prev)
    with pytest.raises(ValueError, match="ds_prev is required"):
        tbs.fused_tower_block_s(x, sy, w_cat, w_cc_t, b_cat, spec)
    with pytest.raises(TypeError, match="float32"):
        tbs.fused_tower_block_s(x, sy.half(), w_cat, w_cc_t, b_cat, spec,
                                ds_prev)
    with pytest.raises(ValueError, match="'Hartley' or 'Fourier'"):
        tbs.make_tower_spec_s("Cosine", (8, 6, 5), (2, 3, 2), C)
