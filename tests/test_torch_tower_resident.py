"""The port's whole-tower kernel module (``kernels/tower_resident.py``)
against the JAX package's, on the CPU.

Inputs are made with numpy from a seed (the scales of
``tests/test_tower_resident.py``); the JAX side runs with
``ops/spectral.PRECISION`` pinned to HIGHEST by ``monkeypatch`` (restored
after each test) and takes the volume in its lane-padded (D, C, W*HL)
layout. Tolerances: 1e-5 against the JAX plain replay ``_reference_chain``
(fp32 on both sides, other summation orders: the bar of
``test_torch_tower_block_s.py`` for its plain block); 0.02 of the largest
value against the Pallas kernel in interpret mode, which rounds the
weights and its matrix operands to bf16 (the bar of
``tests/test_tower_resident.py``); 1e-6 against the chain of
``tower_block_s`` blocks, the same torch ops in the same order.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_3d_image_segmentation_tpu.kernels import tower_block as jtb
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

# (transform, sizes, modes, C, blocks): the JAX tests' sizes; the second
# has odd D, H and W and an odd mw (Fourier KW 3)
CASES = [(t, sizes, modes, c, nb) for t in ("Hartley", "Fourier")
         for sizes, modes, c, nb in (((9, 18, 10), (3, 4, 4), 8, 3),
                                     ((5, 11, 7), (2, 3, 3), 4, 1))]
IDS = [f"{t[0]}-{''.join(map(str, s))}-c{c}-b{nb}"
       for t, s, _, c, nb in CASES]


@pytest.fixture(autouse=True)
def _highest(monkeypatch):
    monkeypatch.setattr(jspectral, "PRECISION", jax.lax.Precision.HIGHEST)


def _inputs(transform, sizes, c, nb, seed=0):
    """numpy x (1, D, H, W, C), op_stack (B, PR, C, C), wcat_stack
    (B, 2C, C), wcc_stack (B, C, C), b_stack (B, 2C)."""
    rng = np.random.default_rng(seed)
    pr = 1 if transform == "Hartley" else 2

    def r(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return (r(1, *sizes, c, scale=0.3), r(nb, pr, c, c, scale=0.2),
            r(nb, 2 * c, c, scale=0.2), r(nb, c, c, scale=0.2),
            r(nb, 2 * c, scale=0.1))


def _port(transform, sizes, modes, c, ins, fn=tr.resident_tower_plain):
    spec = tb.make_tower_spec(transform, sizes, modes, c)
    x, *weights = (torch.from_numpy(a) for a in ins)
    with torch.no_grad():
        return fn(x[0], *weights, spec)


def _jax(transform, sizes, modes, c, ins, kernel=False):
    """The JAX tower on the same inputs -> numpy (D, H, W, C)."""
    spec = jtb.make_tower_spec(transform, sizes, modes, c)
    x, *weights = (jnp.asarray(a) for a in ins)
    xf = jtb.to_tower_flat(x)
    if kernel:
        out = jtr.resident_tower(xf, *weights, spec, True)
    else:
        out = jtr._reference_chain(xf, *weights, spec)
    out = np.asarray(jtb.from_tower_flat(out, sizes, c), np.float32)[0]
    return out.transpose(1, 2, 3, 0)


@pytest.mark.parametrize("transform,sizes,modes,c,nb", CASES, ids=IDS)
def test_plain_matches_jax_reference_chain(transform, sizes, modes, c, nb):
    ins = _inputs(transform, sizes, c, nb)
    got = _port(transform, sizes, modes, c, ins)
    assert got.shape == sizes + (c,)
    np.testing.assert_allclose(got.numpy(),
                               _jax(transform, sizes, modes, c, ins),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("transform,sizes,modes,c,nb", CASES, ids=IDS)
def test_plain_matches_jax_kernel_in_interpret_mode(transform, sizes, modes,
                                                    c, nb):
    ins = _inputs(transform, sizes, c, nb, seed=1)
    got = _port(transform, sizes, modes, c, ins).numpy()
    want = _jax(transform, sizes, modes, c, ins, kernel=True)
    assert np.max(np.abs(got - want)) <= 0.02 * np.max(np.abs(got))


@pytest.mark.parametrize("transform", ["Hartley", "Fourier"])
def test_plain_matches_the_block_s_chain(transform):
    """The tower equals tower_block_s run block by block with each next
    block's operator on the folded spectrum (``spectrum_mix_s``)."""
    sizes, modes, c, nb = (9, 18, 10), (3, 4, 4), 8, 3
    ins = _inputs(transform, sizes, c, nb, seed=2)
    spec = tbs.make_tower_spec_s(transform, sizes, modes, c)
    x, ops, wcat, wcc, b = (torch.from_numpy(a) for a in ins)
    x = x[0]
    with torch.no_grad():
        got = tr.resident_tower_plain(x, ops, wcat, wcc, b, spec)
        s = tbs.spectrum_mix_s(tbs.entry_spectrum_s(x, spec), ops[0], spec)
        for i in range(nb):
            x, s_f = tbs.fused_tower_block_s(x, s, wcat[i], wcc[i], b[i],
                                             spec)
            if i + 1 < nb:
                s = tbs.spectrum_mix_s(s_f, ops[i + 1], spec)
    torch.testing.assert_close(got, x, rtol=0, atol=1e-6)


def test_wrapper_runs_the_plain_version_on_cpu_without_a_launch():
    ins = _inputs("Fourier", (5, 11, 7), 4, 2)
    x0 = ins[0].copy()
    before = dict(kernels.LAUNCHES)
    got = _port("Fourier", (5, 11, 7), (2, 3, 3), 4, ins, tr.resident_tower)
    want = _port("Fourier", (5, 11, 7), (2, 3, 3), 4, ins)
    assert kernels.LAUNCHES == before
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    np.testing.assert_array_equal(ins[0], x0)  # the input is not written
    # on a card the z phase writes each plane's depth-inverse pre-image once
    # per tower block into one (D, 2, C, KH, KW) scratch: 18.2 MB at
    # HNOSeg's shape, 9.1 MB at FNOSeg's (KW 14), both held in L2
    for transform, kw in (("Hartley", 28), ("Fourier", 14)):
        spec = tb.make_tower_spec(transform, (121, 121, 78), (10, 14, 14),
                                  24)
        assert tr.z_scratch_shape(spec) == (121, 2, 24, 28, kw)


def _torch_inputs(transform="Hartley", sizes=(5, 11, 7), c=4, nb=2):
    x, *weights = (torch.from_numpy(a) for a in _inputs(transform, sizes, c,
                                                        nb))
    return (x[0], *weights)


def test_wrapper_refuses_what_it_does_not_take():
    x, ops, wcat, wcc, b = _torch_inputs()
    spec = tb.make_tower_spec("Hartley", (5, 11, 7), (2, 3, 3), 4)
    with pytest.raises(ValueError, match="no deep supervision"):
        tr.resident_tower(x, ops, wcat, wcc, b, spec._replace(n_ds=4))
    with pytest.raises(ValueError, match="op_stack has shape"):
        tr.resident_tower(x, torch.cat([ops, ops], 1), wcat, wcc, b, spec)
    with pytest.raises(ValueError, match="wcc_stack has shape"):
        tr.resident_tower(x, ops, wcat, wcc[:1], b, spec)
    with pytest.raises(ValueError, match="x has shape"):
        tr.resident_tower(x[:4], ops, wcat, wcc, b, spec)
    with pytest.raises(ValueError, match="no block"):
        tr.resident_tower(x, ops[:0], wcat[:0], wcc[:0], b[:0], spec)
    with pytest.raises(TypeError, match="float32"):
        tr.resident_tower(x, ops.half(), wcat, wcc, b, spec)


def test_a_tensor_off_the_cpu_never_runs_the_plain_version():
    """Off the CPU the wrapper launches the kernel or raises: under autograd
    it refuses (forward only), and a device that is not CUDA is refused at
    the launch (meta tensors stand in for a card here)."""
    x, ops, wcat, wcc, b = (t.to("meta") for t in _torch_inputs(c=8))
    spec = tb.make_tower_spec("Hartley", (5, 11, 7), (2, 3, 3), 8)
    wg = wcat.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tr.resident_tower(x, ops, wg, wcc, b, spec)
    before = dict(kernels.LAUNCHES)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA kernel "
                                        "launched for meta"):
        tr.resident_tower(x, ops, wg, wcc, b, spec)
    assert kernels.LAUNCHES == before
