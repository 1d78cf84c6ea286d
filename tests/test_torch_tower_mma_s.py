"""tower_block_s's and tower_resident's 'bfloat16' and 'mixed' instances on
the tensor-core body (``csrc/tower_block_mma.cuh``) on the CPU: the
wrappers' scratch size, the resident tower's stack of packed weights, the
bf16 instances' spec checks, and both kernels' formulations emulated in
torch ops (``tests/tower_mma_emulation.py``: the z pass, the body on tiles
of 16 columns, the tile sum, the depth pass and, for the resident tower,
the operator mix between blocks) held to the plain twins and to the JAX
package's Pallas kernels in interpret mode.

Bars: tower_block_s against its twin, those ``chip_smoke.py`` holds the
kernel to (``_twin_held``: bf16 out one ulp, at most 1e-3 of the elements
more than one ulp apart; fp32 s_f and ds 1e-4 of their largest
magnitude), and each output's distance from the twin summed in float64 at
most 2x the fp32 twin's plus 1e-6 (the precision gate's rule). The
resident tower over several blocks by that float64 rule alone: the
operator mix of a block's s_f and the next block's bf16 rounding of the
spectrum spread a flip through every voxel. Against the Pallas kernels
('bfloat16'; the reference serves 'mixed' on its module path): the JAX
tests' 5e-2, and a distance from float64 at most 2x the Pallas kernel's.
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
from multimodal_3d_image_segmentation_tpu_torch.kernels import \
    tower_block as tb
from multimodal_3d_image_segmentation_tpu_torch.kernels import \
    tower_block_s as tbs
from multimodal_3d_image_segmentation_tpu_torch.kernels import \
    tower_resident as tr
from tower_mma_emulation import (BF16, _twin_held, _unpack_b,
                                 emulate_block_s, emulate_resident)

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

# (transform, sizes, modes, C, ds rows): short last H and W tiles (20 =
# 16 + 4 rows, 21 = 16 + 5 columns); D 11 and 9 not multiples of the depth
# pass's 8 plane groups; C 24 and KH 12 give k8 remainders; Fourier's KW 5
# is odd and goes through ZTensorMma::pair one value at a time
CASES = [("Hartley", (11, 20, 21), (2, 4, 3), 8, 3),
         ("Fourier", (9, 20, 21), (2, 6, 5), 24, 0)]
CASE_IDS = ["Hartley-c8-ds3", "Fourier-c24"]
MODES = [("bfloat16", BF16), ("mixed", torch.float32)]


@pytest.fixture(autouse=True)
def _highest(monkeypatch):
    monkeypatch.setattr(jspectral, "PRECISION", jax.lax.Precision.HIGHEST)


def _r(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32))


def _block_inputs(transform, sizes, modes, c, n_ds, seed):
    """x (bf16 values, fp32), the resident spectrum sy (an operator on the
    entry spectrum of x), the weights, the bias and ds_prev, from numpy."""
    rng = np.random.default_rng(seed)
    spec = tb.make_tower_spec(transform, sizes, modes, c, n_ds=n_ds)
    x = _r(rng, *sizes, c).to(BF16).float()
    ops = [_r(rng, c, c, scale=1 / np.sqrt(c))
           for _ in range(1 if transform == "Hartley" else 2)]
    with torch.no_grad():
        sy = tbs.spectrum_mix_s(tbs.entry_spectrum_s(x, spec), ops,
                                spec).contiguous()
    w_cat = _r(rng, 2 * c + n_ds, c, scale=1 / np.sqrt(c))
    w_cc_t = _r(rng, c, c, scale=1 / np.sqrt(c))
    b_cat = _r(rng, 2 * c, scale=0.1)
    ds_prev = _r(rng, *sizes, n_ds) if n_ds else None
    return spec, x, sy, w_cat, w_cc_t, b_cat, ds_prev


def _tower_inputs(transform, sizes, modes, c, nb, seed):
    """x (bf16 values, fp32) and the stacked weights of nb blocks."""
    rng = np.random.default_rng(seed)
    spec = tb.make_tower_spec(transform, sizes, modes, c)
    pr = 1 if transform == "Hartley" else 2
    return spec, (_r(rng, *sizes, c, scale=0.5).to(BF16).float(),
                  _r(rng, nb, pr, c, c, scale=0.3),
                  _r(rng, nb, 2 * c, c, scale=0.3),
                  _r(rng, nb, c, c, scale=0.3), _r(rng, nb, 2 * c, scale=0.1))


def _cl(flat, channels, sizes):
    """JAX (D, C, W*HL) -> the port's (D, H, W, C), fp32 numpy."""
    return np.asarray(jtb.from_tower_flat(flat.astype(jnp.float32), sizes,
                                          channels))[0].transpose(1, 2, 3, 0)


def _pallas_held(got, want, ref):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)
    port, pallas = np.abs(got - ref).max(), np.abs(want - ref).max()
    assert port <= 2 * pallas + 1e-6, (port, pallas)


def _float64_rule(got, twin, ref):
    kernel = float((got.double() - ref.double()).abs().max())
    plain = float((twin.double() - ref.double()).abs().max())
    assert kernel <= 2 * plain + 1e-6, (kernel, plain)


def test_partial_scratch_follows_each_instances_tile_width():
    """``partial_floats``, which both wrappers size their scratch by: a
    partial spectrum per plane and W tile of 8 columns ('float32', the FMA
    body) or 16 (the tensor-core body), then tower_block_s's z and f or
    tower_resident's s_f."""
    spec = tb.make_tower_spec("Fourier", (121, 121, 78), (10, 14, 14), 24)
    d, _, w = spec.sizes
    ng = 24 * spec.kh * spec.kw
    assert tbs.tile_width("float32") == 8
    for inst in ("bfloat16", "mixed"):
        assert tbs.tile_width(inst) == tb.MMA_TILE_W == 16
        assert tb.mma_geom(spec).n_tiles == -(-w // 16) == 5
    for inst, tiles in (("float32", 10), ("bfloat16", 5), ("mixed", 5)):
        assert tbs.partial_floats(spec, inst) == d * (tiles + 1) * 2 * ng
        assert tbs.partial_floats(spec, inst, "tower_resident") == (
            d * tiles * 2 * ng + 40 * ng)
    with pytest.raises(ValueError, match="tower_block"):
        tbs.partial_floats(spec, "float32", "tower_block")


def test_resident_weight_stack_is_each_blocks_packing():
    """``mma_weight_stack``: block b's slice is ``mma_weights(wcat[b],
    wcc[b])`` bit for bit in both instances (one part of bf16 weights,
    three of fp32 ones), at the fixed stride the kernel reads; the stack
    is kept per weight version of the stacks."""
    _, (_, _, wcat, wcc, _) = _tower_inputs("Hartley", (6, 9, 7), (2, 3, 2),
                                            24, 3, 1)
    for wd, parts in ((BF16, 1), (torch.float32, 3)):
        ws, wcs = wcat.to(wd), wcc.to(wd)
        scat, scc = tb.mma_weight_stack(ws, wcs)
        assert scat.shape[:2] == (3, parts) and scat.is_contiguous()
        # a block's stride in 8-byte B-fragment units, as the .cu computes
        assert scat[0].numel() * 2 // 8 == parts * 2 * 6 * 32
        assert scc[0].numel() * 2 // 8 == parts * 2 * 3 * 32
        for b in range(3):
            one = tb.mma_weights(ws[b].clone(), wcs[b].clone())
            assert torch.equal(scat[b].view(torch.int16),
                               one[0].view(torch.int16))
            assert torch.equal(scc[b].view(torch.int16),
                               one[1].view(torch.int16))
        again = tb.mma_weight_stack(ws, wcs)
        assert again[0] is scat and again[1] is scc
        with torch.no_grad():
            wcs[1].mul_(2.0)
        third = tb.mma_weight_stack(ws, wcs)
        assert third[0] is scat and third[1] is not scc
        assert torch.equal(_unpack_b(third[1][1][0], 24, 24).float(),
                           wcs[1].t().to(BF16).float())


def test_bf16_instances_refuse_kw_above_the_tensor_core_bodys():
    """KW 34 (mw 17, Hartley): the bf16 instances of both kernels raise in
    ``check_kernel_spec`` (which the wrappers call before a launch); their
    fp32 instances, on the FMA body, take it."""
    spec = tb.make_tower_spec("Hartley", (6, 9, 40), (2, 3, 17), 8)
    assert spec.kw == 34
    for kernel in ("tower_block_s", "tower_resident"):
        tb.check_kernel_spec(spec, kernel, "float32")
        for inst in ("bfloat16", "mixed"):
            with pytest.raises(ValueError, match=f"{kernel} .*KW=34"):
                tb.check_kernel_spec(spec, kernel, inst)


@pytest.mark.parametrize("mode,wd", MODES, ids=[m for m, _ in MODES])
@pytest.mark.parametrize("transform,sizes,modes,c,n_ds", CASES,
                         ids=CASE_IDS)
def test_emulated_block_s_matches_the_twins(transform, sizes, modes, c,
                                            n_ds, mode, wd):
    """tower_block_s's bf16 formulation against ``tower_block_s_plain``'s
    twin of the same instance at the card's bars, and by the float64
    rule against the twin summed in float64."""
    spec, x, sy, w_cat, w_cc_t, b_cat, ds_prev = _block_inputs(
        transform, sizes, modes, c, n_ds, 21)
    args = (x.to(BF16), sy, w_cat.to(wd), w_cc_t.to(wd), b_cat, spec,
            ds_prev)
    with torch.no_grad():
        got = emulate_block_s(*args)
        want = tbs.tower_block_s_plain(*args)
        ref = tbs.tower_block_s_plain(*args, acc=torch.float64)
    assert got[0].dtype == BF16 and got[1].dtype == torch.float32
    assert len(got) == len(want) == (3 if n_ds else 2)
    _twin_held(got, want)
    for g, w, r in zip(got, want, ref):
        _float64_rule(g, w, r)


@pytest.mark.parametrize("transform", ["Hartley", "Fourier"])
def test_emulated_block_s_bf16_matches_the_pallas_kernel(transform):
    """'bfloat16' against ``fused_tower_block_s`` in interpret mode on the
    same bf16 volume (C 8, 3 ds rows, short last H and W tiles): out, s_f
    and ds by the two Pallas bars."""
    sizes, modes = (11, 20, 21), (2, 4, 3)
    spec, x, sy, w_cat, w_cc_t, b_cat, ds_prev = _block_inputs(
        transform, sizes, modes, 8, 3, 22)
    wb, wcb = w_cat.to(BF16), w_cc_t.to(BF16)
    with torch.no_grad():
        got = emulate_block_s(x.to(BF16), sy, wb, wcb, b_cat, spec, ds_prev)
        ref = tbs.tower_block_s_plain(
            *(t.double() for t in (x, sy, wb.float(), wcb.float(), b_cat)),
            spec, ds_prev.double())
    jspec = jtbs.make_tower_spec_s(transform, sizes, modes, 8, n_ds=3)
    ks, _, kh, kw = sy.shape
    sy3 = np.pad(sy.numpy(), [(0, 0)] * 3 + [(0, jspec.kwl - kw)]).reshape(
        ks, 8 * kh, jspec.kwl)
    want = jtbs.fused_tower_block_s(
        jtb.to_tower_flat(jnp.asarray(x.numpy()[None]).astype(jnp.bfloat16)),
        jnp.asarray(sy3), jnp.asarray(w_cat.numpy()),
        jnp.asarray(w_cc_t.numpy()), jnp.asarray(b_cat.numpy()), jspec, True,
        jtb.to_tower_flat(jnp.asarray(ds_prev.numpy()[None])))
    s_f = np.asarray(want[1]).reshape(ks, 8, kh, jspec.kwl)[..., :kw]
    _pallas_held(got[0].float(), _cl(want[0], 8, sizes), ref[0].numpy())
    _pallas_held(got[1], s_f, ref[1].numpy())
    _pallas_held(got[2], _cl(want[2], 3, sizes), ref[2].numpy())


@pytest.mark.parametrize("mode,wd", MODES, ids=[m for m, _ in MODES])
def test_emulated_resident_tower_matches_the_twin_by_float64(mode, wd):
    """Three Fourier blocks (odd KW 5, C 8) of the resident tower's bf16
    formulation: each block's tower_block_s formulation with the operator
    mix between them, its largest distance from the same tower in float64
    (bf16 volume and weights, nothing rounded) at most 2x the twin's
    (``resident_tower_plain``); one block also element by element."""
    spec, (x, ops, wcat, wcc, b) = _tower_inputs(
        "Fourier", (11, 20, 21), (2, 4, 5), 8, 3, 23)
    w = (ops, wcat.to(wd), wcc.to(wd), b)
    with torch.no_grad():
        w1 = tuple(t[:1] for t in w)
        _twin_held((emulate_resident(x.to(BF16), *w1, spec),),
                   (tr.resident_tower_plain(x.to(BF16), *w1, spec),))
        got = emulate_resident(x.to(BF16), *w, spec)
        twin = tr.resident_tower_plain(x.to(BF16), *w, spec)
        ref = tr.resident_tower_plain(
            x.double(), *(t.to(wd).double() for t in w), spec)
    assert got.dtype == BF16
    _float64_rule(got, twin, ref)


def test_emulated_resident_bf16_matches_the_pallas_kernel():
    """'bfloat16', three Hartley blocks against ``resident_tower`` in
    interpret mode on the same bf16 volume (two W tiles of 16 columns;
    the Pallas kernel rounds its operator weights to bf16 and keeps the
    depth stages in fp32, the port keeps the operator fp32 and rounds the
    depth stages' operands), by the two Pallas bars."""
    sizes, modes = (8, 12, 21), (2, 3, 3)
    spec, (x, ops, wcat, wcc, b) = _tower_inputs("Hartley", sizes, modes, 8,
                                                 3, 24)
    wb, wcb = wcat.to(BF16), wcc.to(BF16)
    with torch.no_grad():
        got = emulate_resident(x.to(BF16), ops, wb, wcb, b, spec)
        ref = tr.resident_tower_plain(
            *(t.double() for t in (x, ops, wb.float(), wcb.float(), b)),
            spec)
    jspec = jtb.make_tower_spec("Hartley", sizes, modes, 8)
    want = jtr.resident_tower(
        jtb.to_tower_flat(jnp.asarray(x.numpy()[None]).astype(jnp.bfloat16)),
        *(jnp.asarray(a.numpy()) for a in (ops, wcat, wcc, b)), jspec, True)
    _pallas_held(got.float(), _cl(want, 8, sizes), ref.numpy())
