"""tower_block's tensor-core body ('bfloat16' and 'mixed', on mma.sync;
``csrc/tower_block_mma.cuh``) on the CPU: its packing of the stage
matrices and weights into mma.sync fragment order (``mma_mats``,
``mma_weights``), and its formulation emulated in torch ops from those
packed forms (``tests/tower_mma_emulation.py``, which the tests of
tower_block_s's and tower_resident's bf16 instances share), held to the
plain twins and to the JAX package's Pallas kernel in interpret mode.

The emulation follows the kernel's arithmetic: each product in k steps of
16 (a last one of 8 where K is not a multiple of 16), each step's sum in
fp32 (in 'mixed' the leading parts' product and the smaller parts'
products apart) and the steps added in order; operands rounded to bf16 where the
kernel rounds them ('bfloat16': z, y, t, F), or split into three bf16
parts ('mixed': an fp32 operand times a matrix takes the six products of
parts p and q with p + q < 3, a bf16 operand times a matrix the three of
the matrix's parts); the partial spectra of the W tiles summed in tile
order. It differs from the kernel in the order of
the sums inside a k step and in SELU's last ulps (torch's expm1 here).
Bars: those ``chip_smoke.py`` holds the kernel to against its twin
(``_tower_tol``): a bf16 output one bf16 ulp of each value plus 1e-5 plus
one ulp of its largest magnitude, with at most 1e-3 of the elements more
than one ulp of their own magnitude plus 1e-5 apart; an fp32 output 1e-4
of its largest magnitude. Against the Pallas kernel ('bfloat16' only; the
reference serves 'mixed' on its module path): the JAX tests' 5e-2, and a
distance from float64 at most 2x the Pallas kernel's
(``tests/test_torch_tower_bf16_twins.py``'s two bars).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_3d_image_segmentation_tpu.kernels import _common as jcommon
from multimodal_3d_image_segmentation_tpu.kernels import tower_block as jtb
from multimodal_3d_image_segmentation_tpu.ops import spectral as jspectral
from multimodal_3d_image_segmentation_tpu_torch.kernels import \
    tower_block as tb
from multimodal_3d_image_segmentation_tpu_torch.kernels import \
    tower_block_s as tbs
from tower_mma_emulation import (BF16, TW, _emulate, _stage_parts,
                                 _twin_held, _unpack_a, _unpack_b)

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

# (transform, sizes, modes, C, ds rows): a short last H tile (20 = 16 + 4)
# and W tile (21 = 16 + 5) in both; C 24 and KH 12 give k8 remainders
# (C = 16 + 8, 2KH = 16 + 8); Fourier's KW 5 is odd
CASES = [("Hartley", (6, 20, 21), (2, 4, 3), 8, 3),
         ("Fourier", (4, 20, 21), (2, 6, 5), 24, 0)]
CASE_IDS = ["Hartley-c8-ds3", "Fourier-c24"]


@pytest.fixture(autouse=True)
def _highest(monkeypatch):
    monkeypatch.setattr(jspectral, "PRECISION", jax.lax.Precision.HIGHEST)


def _inputs(transform, sizes, modes, c, n_ds, seed):
    """x (bf16 values, fp32), z, the weights, the bias and ds_prev, made
    with numpy from ``seed`` (z the depth inverse of an operator's output,
    as a tower feeds it)."""
    rng = np.random.default_rng(seed)
    spec = tb.make_tower_spec(transform, sizes, modes, c, n_ds=n_ds)
    x = torch.from_numpy(rng.standard_normal(sizes + (c,)).astype(
        np.float32)).to(BF16).float()
    ops = [torch.from_numpy((rng.standard_normal((c, c)) / np.sqrt(c))
                            .astype(np.float32))
           for _ in range(1 if transform == "Hartley" else 2)]
    with torch.no_grad():
        z = tb.d_stage_inverse(tbs.spectrum_mix_s(tbs.entry_spectrum_s(
            x, spec), ops, spec), spec).contiguous()

    def r(*shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32))
    w_cat = r(2 * c + n_ds, c, scale=1 / np.sqrt(c))
    w_cc_t = r(c, c, scale=1 / np.sqrt(c))
    b_cat = r(2 * c, scale=0.1)
    ds_prev = r(*sizes, n_ds, scale=1.0) if n_ds else None
    return spec, x, z, w_cat, w_cc_t, b_cat, ds_prev


@pytest.mark.parametrize("which", ["a", "b"])
def test_fragments_follow_mma_order_with_zero_padding(which):
    """Lane 4g + t's registers of each fragment hold the elements mma.sync
    reads there (A: rows g, g + 8, columns 2t, 2t + 8 of a 16 x 16 tile, in
    register order (row g, k 2t), (row g + 8, k 2t), (row g, k 2t + 8),
    (row g + 8, k 2t + 8); B: k 2t and 2t + 8 of column g), and the
    padding to whole tiles is zeros."""
    rng = np.random.default_rng(5)
    m, k = (21, 40) if which == "a" else (24, 20)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)
                         ).to(BF16)
    f = tb._a_fragments(a) if which == "a" else tb._b_fragments(a)
    pad = torch.zeros(-(-m // 16) * 16, -(-k // 16) * 16, dtype=BF16)
    if which == "b":
        pad = torch.zeros(-(-m // 16) * 16, -(-k // 8) * 8, dtype=BF16)
    pad[:m, :k] = a
    for lane in range(32):
        g, t = divmod(lane, 4)
        if which == "a":
            for mt in range(f.shape[0]):
                for ks in range(f.shape[1]):
                    regs = f[mt, ks, g, t].reshape(4, 2)
                    for r, (row, col) in enumerate(((g, 2 * t), (g + 8, 2 * t),
                                                    (g, 2 * t + 8),
                                                    (g + 8, 2 * t + 8))):
                        want = pad[16 * mt + row, 16 * ks + col:
                                   16 * ks + col + 2]
                        assert torch.equal(regs[r], want)
        else:
            for ks in range(f.shape[0]):
                for nt in range(f.shape[1]):
                    for half in range(2):
                        want = pad[16 * ks + 8 * half + 2 * t:
                                   16 * ks + 8 * half + 2 * t + 2, 8 * nt + g]
                        assert torch.equal(f[ks, nt, g, t, half], want)
    back = (_unpack_a(f, m, k) if which == "a" else _unpack_b(f, m, k))
    assert torch.equal(back, a)


def test_weight_parts_extend_the_reference_hi_lo_bit_for_bit():
    """'mixed''s fp32 weights pack as three parts: the first two bit for
    bit the JAX ``hi_lo`` of w_cat^T and w_cc_t^T, the third the rounding
    of what they leave, so that the three carry each weight to 2^-24;
    'bfloat16''s bf16 weights as one part of their values; rows past 2C +
    n_ds and K past C are zeros."""
    spec, _, _, w_cat, w_cc_t, _, _ = _inputs(*CASES[0], 7)
    c, n_ds = spec.channels, spec.n_ds
    fcat, fcc = tb.mma_weights(w_cat, w_cc_t)
    assert fcat.dtype == BF16 and fcat.shape[0] == 3 and fcc.shape[0] == 3
    for packed, wt in ((fcat, w_cat.t()), (fcc, w_cc_t.t())):
        hi, lo = jcommon.hi_lo(jnp.asarray(wt.numpy()))
        got = [_unpack_b(p, *wt.shape) for p in packed]
        for g, want in zip(got, (hi, lo)):
            assert np.array_equal(g.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
        rest = wt - got[0].float() - got[1].float()
        assert torch.equal(got[2], rest.to(BF16))
        total = sum(g.double() for g in got)
        assert float((total - wt.double()).abs().max()) <= 2.0 ** -24 * float(
            wt.abs().max())
    full = _unpack_b(fcat[0], 16 * fcat.shape[1], 8 * fcat.shape[2])
    assert not full[c:].any() and not full[:, 2 * c + n_ds:].any()
    bcat, bcc = tb.mma_weights(w_cat.to(BF16), w_cc_t.to(BF16))
    assert bcat.shape[0] == bcc.shape[0] == 1
    assert torch.equal(_unpack_b(bcat[0], c, 2 * c + n_ds), w_cat.to(BF16).t())


@pytest.mark.parametrize("transform,sizes,modes,c,n_ds", CASES,
                         ids=CASE_IDS)
def test_stage_matrices_pack_by_spec(transform, sizes, modes, c, n_ds):
    """``mma_mats`` holds the kernel's fp32 stage matrices (the twins'):
    'bfloat16' their bf16 values, 'mixed' their three parts (their sum
    within 2^-24 of each value), in the C side's layout; the W tiles'
    matrices zero past W, KW and kwp, the H matrices past H and 2KH."""
    spec = tb.make_tower_spec(transform, sizes, modes, c, n_ds=n_ds)
    m = tb._spec_mats(spec)
    d, h, w = sizes
    kh, kw = spec.kh, spec.kw
    cwi, swi = (torch.from_numpy(np.asarray(a, np.float32))
                for a in m["w_inv"])
    cw, sw = (torch.from_numpy(np.asarray(a, np.float32)) for a in m["w_fwd"])
    ha, hb = (torch.from_numpy(np.asarray(a, np.float32)) for a in m["h_inv"])
    mh = torch.from_numpy(np.concatenate(m["h_fwd"], 1).astype(np.float32))
    for passes in (1, 3):
        iw, ih, fh, fw = _stage_parts(spec, passes)
        g = tb.mma_geom(spec)

        def value(parts):
            return sum(p.double() for p in parts).float()

        def near(got, want):
            want = want.to(BF16).float() if passes == 1 else want
            assert torch.allclose(got, want, rtol=2.0 ** -24, atol=1e-12)
        for t in range(g.n_tiles):
            w0, n = t * TW, min(TW, w - t * TW)
            a, b = value(iw[t]), value(fw[t])
            near(a[:n, :kw], cwi[:, w0:w0 + n].t())
            near(a[:n, g.kwp:g.kwp + kw], -swi[:, w0:w0 + n].t())
            near(a[TW:TW + n, :kw], swi[:, w0:w0 + n].t())
            near(b[:n, :kw], cw[w0:w0 + n])
            near(b[TW:TW + n, g.kwp:g.kwp + kw], cw[w0:w0 + n])
            near(b[TW:TW + n, :kw], -sw[w0:w0 + n])
            for mat in (a, b):
                assert not mat[n:TW].any() and not mat[TW + n:].any()
                assert not mat[:, kw:g.kwp].any()
                assert not mat[:, g.kwp + kw:].any()
        near(value(ih)[:h, :2 * kh], torch.cat([ha, hb]).t())
        assert not value(ih)[h:].any() and not value(ih)[:, 2 * kh:].any()
        near(value(fh)[:, :h], mh.t())
        assert not value(fh)[:, h:].any()


def test_packing_is_kept_per_weight_version():
    """The weights are packed once per weight version (conv3's ``_kept``):
    the same tensors give the same packed objects until one is written."""
    _, _, _, w_cat, w_cc_t, _, _ = _inputs(*CASES[0], 8)
    first = tb.mma_weights(w_cat, w_cc_t)
    again = tb.mma_weights(w_cat, w_cc_t)
    assert first[0] is again[0] and first[1] is again[1]
    with torch.no_grad():
        w_cc_t.mul_(2.0)
    third = tb.mma_weights(w_cat, w_cc_t)
    assert third[0] is first[0] and third[1] is not first[1]
    assert torch.equal(_unpack_b(third[1][0], *w_cc_t.shape).float() * 1.0,
                       w_cc_t.t().to(BF16).float())


@pytest.mark.parametrize("mode", ["bfloat16", "mixed"])
@pytest.mark.parametrize("transform,sizes,modes,c,n_ds", CASES,
                         ids=CASE_IDS)
def test_emulated_formulation_matches_the_twins(transform, sizes, modes, c,
                                                n_ds, mode):
    """The tensor-core body's formulation ('bfloat16': one pass of bf16
    values in k steps; 'mixed': the six products of three parts) against
    ``tower_block_plain``'s twin of the same instance, at the bars the
    card holds the kernel to; and each output's largest distance from the
    twin summed in float64 (``acc=float64``, the gate's twins64 path) at
    most 2x the fp32 twin's plus 1e-6, the precision gate's rule for a
    kernel path (``utils/precision_gate.py``): 'mixed' as hi and lo parts
    only (bf16x3) misses it by 2.5-26x."""
    spec, x, z, w_cat, w_cc_t, b_cat, ds_prev = _inputs(
        transform, sizes, modes, c, n_ds, 11)
    wd = BF16 if mode == "bfloat16" else torch.float32
    args = (x.to(BF16), z, w_cat.to(wd), w_cc_t.to(wd), b_cat, spec,
            ds_prev)
    with torch.no_grad():
        got = _emulate(*args)
        want = tb.tower_block_plain(*args)
        ref = tb.tower_block_plain(*args, acc=torch.float64)
    assert got[1].dtype == (BF16 if mode == "bfloat16" else torch.float32)
    _twin_held(got, want)
    for g, w, r in zip(got, want, ref):
        kernel = float((g.double() - r.double()).abs().max())
        twin = float((w.double() - r.double()).abs().max())
        assert kernel <= 2 * twin + 1e-6, (kernel, twin)


def _cl(flat, channels, sizes):
    """JAX (D, C, W*HL) -> the port's (D, H, W, C), fp32 numpy."""
    return np.asarray(jtb.from_tower_flat(flat.astype(jnp.float32), sizes,
                                          channels))[0].transpose(1, 2, 3, 0)


def _pallas_held(got, want, ref):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)
    port, pallas = np.abs(got - ref).max(), np.abs(want - ref).max()
    assert port <= 2 * pallas + 1e-6, (port, pallas)


@pytest.mark.parametrize("transform", ["Hartley", "Fourier"])
def test_bf16_emulation_matches_the_pallas_kernel(transform):
    """The 'bfloat16' formulation against ``fused_tower_block`` in interpret
    mode on the same bf16 volume (C 8, ds rows, short H and W tiles):
    out, f and ds by the two bars of the module docstring."""
    sizes, modes = (6, 20, 21), (2, 4, 3)
    spec, x, z, w_cat, w_cc_t, b_cat, ds_prev = _inputs(
        transform, sizes, modes, 8, 3, 12)
    wb, wcb = w_cat.to(BF16), w_cc_t.to(BF16)
    with torch.no_grad():
        got = _emulate(x.to(BF16), z, wb, wcb, b_cat, spec, ds_prev)
        ref = tb.tower_block_plain(
            *(t.double() for t in (x, z, wb.float(), wcb.float(), b_cat)),
            spec, ds_prev.double())
    jspec = jtb.make_tower_spec(transform, sizes, modes, 8, n_ds=3)
    want = jtb.fused_tower_block(
        jtb.to_tower_flat(jnp.asarray(x.numpy()[None]).astype(jnp.bfloat16)),
        jnp.asarray(z.numpy()), jnp.asarray(w_cat.numpy()),
        jnp.asarray(w_cc_t.numpy()), jnp.asarray(b_cat.numpy()), jspec, True,
        jtb.to_tower_flat(jnp.asarray(ds_prev.numpy()[None])))
    _pallas_held(got[0].float(), _cl(want[0], 8, sizes), ref[0].numpy())
    _pallas_held(got[1].float(), np.asarray(want[1].astype(jnp.float32)),
                 ref[1].numpy())
    _pallas_held(got[2], _cl(want[2], 3, sizes), ref[2].numpy())
