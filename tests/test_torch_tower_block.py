"""The port's tower block (``kernels/tower_block.py``) against the JAX
package's, on the CPU.

Inputs are made with numpy from a seed; the JAX side runs with
``ops/spectral.PRECISION`` pinned to HIGHEST by ``monkeypatch`` (restored
after each test). Tolerances: 1e-5 against the JAX plain replay
``_block_reference`` (both fp32, other summation orders); 1e-4 absolute and
relative against the Pallas kernel in interpret mode, whose fp32 products
are packed bf16x3 (the bar of ``tests/test_tower_kernel.py``); 1e-6 for the
depth and entry stages, which are single einsum chains on both sides.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_3d_image_segmentation_tpu.kernels import tower_block as jtb
from multimodal_3d_image_segmentation_tpu.ops import spectral as jspectral
from multimodal_3d_image_segmentation_tpu_torch import kernels
from multimodal_3d_image_segmentation_tpu_torch.kernels import \
    tower_block as tb

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

MODES = (2, 3, 2)
C = 4
CASES = [((8, 6, 5), 0), ((8, 6, 5), 3), ((7, 9, 6), 0), ((7, 9, 6), 3)]
IDS = ["865-ds0", "865-ds3", "796-ds0", "796-ds3"]


@pytest.fixture(autouse=True)
def _highest(monkeypatch):
    monkeypatch.setattr(jspectral, "PRECISION", jax.lax.Precision.HIGHEST)


def _inputs(sizes, n_ds, seed=0):
    """numpy (x (1, D, H, W, C), z, w_cat, w_cc_t, b_cat, ds_prev or None);
    z is a real block's: the depth inverse of a mixed spectrum of x."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1,) + sizes + (C,)).astype(np.float32)
    spec = tb.make_tower_spec("Hartley", sizes, MODES, C, n_ds=n_ds)
    with torch.no_grad():
        s = tb.d_stage_forward(tb.entry_forward_hw(torch.from_numpy(x[0]),
                                                   spec), spec)
        mix = torch.from_numpy((rng.standard_normal((C, C)) / np.sqrt(C))
                               .astype(np.float32))
        s = torch.selu(torch.einsum("kcxy,oc->koxy", s, mix))
        z = tb.d_stage_inverse(s, spec).numpy()
    w_cat = (rng.standard_normal((2 * C + n_ds, C)) / np.sqrt(C)).astype(
        np.float32)
    w_cc_t = (rng.standard_normal((C, C)) / np.sqrt(C)).astype(np.float32)
    b_cat = rng.uniform(-0.1, 0.1, 2 * C).astype(np.float32)
    ds_prev = (rng.standard_normal((1,) + sizes + (n_ds,)).astype(np.float32)
               if n_ds else None)
    return x, z, w_cat, w_cc_t, b_cat, ds_prev


def _port(sizes, n_ds, x, z, w_cat, w_cc_t, b_cat, ds_prev, fn):
    spec = tb.make_tower_spec("Hartley", sizes, MODES, C, n_ds=n_ds)
    t = torch.from_numpy
    with torch.no_grad():
        return fn(t(x[0]), t(z), t(w_cat), t(w_cc_t), t(b_cat), spec,
                  None if ds_prev is None else t(ds_prev[0]))


def _jax_args(sizes, n_ds, x, z, w_cat, w_cc_t, b_cat, ds_prev):
    spec = jtb.make_tower_spec("Hartley", sizes, MODES, C, n_ds=n_ds)
    args = (jtb.to_tower_flat(jnp.asarray(x)), jnp.asarray(z),
            jnp.asarray(w_cat), jnp.asarray(w_cc_t), jnp.asarray(b_cat))
    dsp = None if ds_prev is None else jtb.to_tower_flat(jnp.asarray(ds_prev))
    return spec, args, dsp


def _to_cl(flat, sizes, channels):
    """JAX (D, C, W*HL) -> the port's (D, H, W, C)."""
    return np.asarray(jtb.from_tower_flat(flat, sizes, channels))[0] \
        .transpose(1, 2, 3, 0)


def _compare(got, want, sizes, n_ds, **tol):
    np.testing.assert_allclose(got[0].numpy(), _to_cl(want[0], sizes, C),
                               **tol)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **tol)
    assert len(got) == len(want) == (3 if n_ds else 2)
    if n_ds:
        assert got[2].dtype == torch.float32
        np.testing.assert_allclose(got[2].numpy(),
                                   _to_cl(want[2], sizes, n_ds), **tol)


@pytest.mark.parametrize("sizes,n_ds", CASES, ids=IDS)
def test_plain_matches_jax_block_reference(sizes, n_ds):
    ins = _inputs(sizes, n_ds)
    got = _port(sizes, n_ds, *ins, tb.tower_block_plain)
    spec, args, dsp = _jax_args(sizes, n_ds, *ins)
    want = jtb._block_reference(*args, spec, ds_prev=dsp)
    _compare(got, want, sizes, n_ds, atol=1e-5, rtol=0)


@pytest.mark.parametrize("sizes,n_ds", CASES, ids=IDS)
def test_plain_matches_jax_kernel_in_interpret_mode(sizes, n_ds):
    ins = _inputs(sizes, n_ds, seed=1)
    got = _port(sizes, n_ds, *ins, tb.tower_block_plain)
    spec, args, dsp = _jax_args(sizes, n_ds, *ins)
    want = jtb.fused_tower_block(*args, spec, True, dsp)
    _compare(got, want, sizes, n_ds, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("sizes", [(8, 6, 5), (7, 9, 6), (9, 7, 11)])
def test_entry_and_depth_stages_match_jax(sizes):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1,) + sizes + (C,)).astype(np.float32)
    spec = tb.make_tower_spec("Hartley", sizes, MODES, C)
    jspec = jtb.make_tower_spec("Hartley", sizes, MODES, C)
    with torch.no_grad():
        f = tb.entry_forward_hw(torch.from_numpy(x[0]), spec)
        s = tb.d_stage_forward(f, spec)
        z = tb.d_stage_inverse(s, spec)
    jf = jtb.entry_forward_hw(jtb.to_tower_flat(jnp.asarray(x)), jspec)
    js = jtb.d_stage_forward(jf, jspec)
    jz = jtb.d_stage_inverse(js, jspec)
    assert f.shape == (sizes[0], 2, C, 6, 4)
    assert s.shape == (4, C, 6, 4) and z.shape == f.shape
    for got, want in ((f, jf), (s, js), (z, jz)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=0)


def test_wrapper_runs_the_plain_version_on_cpu_without_a_launch():
    ins = _inputs((7, 9, 6), 3)
    before = dict(kernels.LAUNCHES)
    got = _port((7, 9, 6), 3, *ins, tb.fused_tower_block)
    want = _port((7, 9, 6), 3, *ins, tb.tower_block_plain)
    assert kernels.LAUNCHES == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_wrapper_takes_float64_on_cpu():
    x, z, w_cat, w_cc_t, b_cat, ds_prev = _inputs((8, 6, 5), 3)
    spec = tb.make_tower_spec("Hartley", (8, 6, 5), MODES, C, n_ds=3)
    t = lambda a: torch.from_numpy(a).double()  # noqa: E731
    with torch.no_grad():
        out, f, ds = tb.fused_tower_block(t(x[0]), t(z), t(w_cat),
                                          t(w_cc_t), t(b_cat), spec,
                                          t(ds_prev[0]))
        o32 = _port((8, 6, 5), 3, x, z, w_cat, w_cc_t, b_cat, ds_prev,
                    tb.fused_tower_block)
    assert out.dtype == f.dtype == ds.dtype == torch.float64
    for g, w in zip((out, f, ds), o32):
        assert float((g - w.double()).abs().max()) < 1e-5


def test_wrapper_refuses_what_it_does_not_take():
    x, z, w_cat, w_cc_t, b_cat, ds_prev = (
        None if a is None else torch.from_numpy(a)
        for a in _inputs((8, 6, 5), 3))
    x, ds_prev = x[0], ds_prev[0]
    spec = tb.make_tower_spec("Hartley", (8, 6, 5), MODES, C, n_ds=3)
    spec0 = spec._replace(n_ds=0)
    with pytest.raises(ValueError, match="x has shape"):
        tb.fused_tower_block(x[:, :5], z, w_cat, w_cc_t, b_cat, spec,
                             ds_prev)
    with pytest.raises(ValueError, match="z has shape"):
        tb.fused_tower_block(x, z[..., :3], w_cat, w_cc_t, b_cat, spec,
                             ds_prev)
    with pytest.raises(ValueError, match="w_cat has shape"):
        tb.fused_tower_block(x, z, w_cat[:8], w_cc_t, b_cat, spec, ds_prev)
    with pytest.raises(ValueError, match="ds_prev is required"):
        tb.fused_tower_block(x, z, w_cat, w_cc_t, b_cat, spec)
    with pytest.raises(ValueError, match="n_ds=0"):
        tb.fused_tower_block(x, z, w_cat[:8], w_cc_t, b_cat, spec0,
                             ds_prev)
    with pytest.raises(TypeError, match="float32"):
        tb.fused_tower_block(x.half(), z, w_cat, w_cc_t, b_cat, spec,
                             ds_prev)
    with pytest.raises(TypeError, match="float32"):
        tb.fused_tower_block(x, z, w_cat, w_cc_t, b_cat.int(), spec,
                             ds_prev)
    with pytest.raises(ValueError, match="smaller than 2 \\* modes"):
        tb.make_tower_spec("Hartley", (8, 5, 5), MODES, C)
    with pytest.raises(ValueError, match="'Hartley' or 'Fourier'"):
        tb.make_tower_spec("Cosine", (8, 6, 5), MODES, C)


# The kernels' block layout (csrc/tower_block.cuh smem_floats; the CUDA
# tests hold kernel_smem_bytes to the C side) at the three shapes that serve
# tower_block, grid 121x121x78, C 24.
@pytest.mark.parametrize("transform,modes,n_ds", [
    ("Hartley", (8, 12, 12), 4),    # HartleyMHASeg, KH = KW = 24
    ("Hartley", (10, 14, 14), 0),   # HNOSeg, KH = KW = 28
    ("Fourier", (10, 14, 14), 0),   # FNOSeg, KW 14
], ids=["hartleymha", "hnoseg", "fnoseg"])
def test_kernel_smem_bytes_at_the_serving_shapes(transform, modes, n_ds):
    spec = tb.make_tower_spec(transform, (121, 121, 78), modes, 24,
                              n_ds=n_ds)
    got = tb.kernel_smem_bytes(spec)
    # two blocks fit an SM's 228 KB of shared memory (1 KB reserved each)
    assert 0 < got and 2 * (got + 1024) <= 228 * 1024


def test_kernel_spec_check_refuses_what_the_body_does_not_take():
    spec = tb.make_tower_spec("Hartley", (121, 121, 78), (10, 14, 14), 24)
    tb.check_kernel_spec(spec, "tower_block")  # the serving shape passes
    # F's registers hold KH <= 32 (modes (10, 17, 14): KH 34)
    with pytest.raises(ValueError, match="KH=34 > 32"):
        tb.check_kernel_spec(spec._replace(kh=34), "tower_block")
    with pytest.raises(ValueError, match="no instance for C=12"):
        tb.check_kernel_spec(spec._replace(channels=12), "tower_block")
