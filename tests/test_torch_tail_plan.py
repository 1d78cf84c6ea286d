"""The fused tail's plan on the CPU: the shared-memory layouts of its two
instances (``kernels/tail_resize.py::tail_smem_bytes``, which mirrors
``csrc/tail_resize.cu``; the CUDA tests hold the two equal) and the routing
predicate ``tail_supported``, held to the layout of the design before the
bf16-logit instance's persistent one (its formula copied here as a
literal): the predicate accepts every shape that one accepted, and the
persistent instance's block of one row fits wherever it does. The rows a
tile copies are bounded as the layout assumes, and the tail on the CPU
(``tail_plain``) is held to the JAX package's Pallas kernel in interpret
mode at shapes whose bands do not divide the planes. The persistent tile
list lives in the kernel (tile = block + k x grid), not in Python.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_3d_image_segmentation_tpu.kernels import \
    tail_resize as jtail
from multimodal_3d_image_segmentation_tpu.ops import spectral as jspectral
from multimodal_3d_image_segmentation_tpu_torch import kernels
from multimodal_3d_image_segmentation_tpu_torch.kernels import \
    tail_resize as ktail
from multimodal_3d_image_segmentation_tpu_torch.ops.resize import \
    _linear_taps_np

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

SMEM = 232448  # shared memory a block may use on an H100
BF16_ULP = 2.0 ** -7
HS = [1, 2, 3, 5, 6, 9, 17, 60, 121, 240]
WS = list(range(1, 40, 7)) + [78, 155, 300, 600, 774, 860, 1000, 1489,
                              1650, 2000, 3000]
OUT_WS = [1, 9, 78, 155, 240, 700, 1650, 3000, 10000, 19000]


@pytest.fixture(autouse=True)
def _highest(monkeypatch):
    monkeypatch.setattr(jspectral, "PRECISION", jax.lax.Precision.HIGHEST)


def old_smem_bytes(c, rows, h, w, out_h, out_w):
    """The design before this one (a block of ``rows`` rows, the band's
    input rows along D or 1,024 staged voxels, the W and H taps, the rows
    along H, fp32), which routed a shape where 4 rows fit."""
    in_rows = min(h, (rows - 1) * h // out_h + 3)
    return 4 * (max(c * in_rows * w, c * 1024) + 3 * out_w + 3 * rows
                + c * rows * w)


@pytest.mark.parametrize("c", [1, 2, 3, 4, 6, 8])
def test_the_predicate_takes_every_shape_the_old_layout_took(c):
    taken = 0
    for h in HS:
        for out_h in HS + [500]:
            for w in WS:
                for out_w in OUT_WS:
                    if old_smem_bytes(c, 4, h, w, out_h, out_w) > SMEM:
                        continue
                    taken += 1
                    assert kernels.tail_supported((1, c, 3, h, w),
                                                  (5, out_h, out_w)), \
                        (c, h, w, out_h, out_w)
                    assert ktail.tail_smem_bytes(c, 1, h, w, out_h, out_w,
                                                 2) <= SMEM, \
                        (c, h, w, out_h, out_w)
    assert taken > 1000


def test_the_widest_rows_are_no_narrower():
    """At C 4 and 8, the widest input row routed (kept or upsampled) is the
    old layout's, and the bf16-logit instance's block of one row fits it:
    about 1,650 and 830 kept."""
    for c in (4, 8):
        for h, out_h, grow in ((6, 9, 1.0), (9, 9, 1.0), (121, 240, 2.0)):
            def fits(w, new):
                out_w = int(w * grow)
                if new:
                    return kernels.tail_supported((1, c, 3, h, w),
                                                  (4, out_h, out_w))
                return old_smem_bytes(c, 4, h, w, out_h, out_w) <= SMEM
            old = max(w for w in range(1, 3000) if fits(w, False))
            new = max(w for w in range(1, 5000) if fits(w, True))
            assert new >= old, (c, h, out_h, old, new)
            assert ktail.tail_smem_bytes(c, 1, h, new, out_h,
                                         int(new * grow), 2) <= SMEM
    assert kernels.tail_supported((1, 4, 3, 6, 1489), (4, 9, 1489))


def test_a_tile_reads_no_more_rows_than_its_slot_holds():
    """The rows a band of R output rows reads (its first tap's lo to its
    last tap's hi) stay within the layout's bound, min(h, ceil((R - 1) h /
    H) + 2), for every band and R up to 16 (upsampling, downsampling and
    identity)."""
    for h in [1, 2, 3, 7, 9, 20, 36, 40, 121]:
        for out_h in [1, 2, 5, 9, 11, 19, 37, 40, 60, 240]:
            lo, hi, _ = _linear_taps_np(h, out_h)
            assert (hi - lo <= 1).all() and (hi <= h - 1).all()
            for r in range(1, 17):
                bound = min(h, ((r - 1) * h + out_h - 1) // out_h + 2)
                for y0 in range(0, out_h, r):
                    y1 = min(y0 + r, out_h) - 1
                    assert hi[y1] - lo[y0] + 1 <= bound, (h, out_h, r, y0)


def test_the_serving_shape_plans_sixteen_rows_within_four_blocks_an_sm():
    """At the serving shape the bf16-logit instance's block of 16 rows fits
    four blocks an SM (56 KB each), and the fp32-logit instance's (the most
    rows, a multiple of 4, up to 16, within 48 KB) takes 16 rows."""
    assert ktail.tail_smem_bytes(4, 16, 121, 78, 240, 155, 2) <= 56 * 1024
    assert ktail.tail_smem_bytes(4, 16, 121, 78, 240, 155) <= 48 * 1024


def test_the_predicate_refuses_what_the_kernel_does_not_take():
    assert not kernels.tail_supported((2, 4, 3, 6, 8), (4, 9, 8))
    assert not kernels.tail_supported((1, 9, 3, 6, 8), (4, 9, 8))
    assert not kernels.tail_supported((1, 4, 3, 6, 70000), (4, 9, 8))
    assert ktail.tail_smem_bytes(4, 1, 6, 70000, 9, 8, 2) > SMEM
    assert not kernels.tail_supported((1, 4, 3, 6, 8), (4, 9, 60000))
    assert not kernels.tail_supported((1, 4, 0, 6, 8), (4, 9, 8))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_bands_that_do_not_divide_the_planes_hold_the_pallas_kernel(
        out_dtype):
    """bf16 logits (1, 4, 6, 9, 20) -> (11, 37, 39): H 37 is two 16-row
    bands and one of 5, H W odd. The CPU path (``tail_plain``, which the
    kernel's bits follow) against the Pallas kernel in interpret mode, the
    bar of ``tests/test_torch_bf16_twins.py``: 2e-4, plus one bf16 ulp for
    a bf16 output."""
    rng = np.random.default_rng(21)
    x = jnp.asarray(rng.standard_normal((1, 4, 6, 9, 20)) * 3,
                    jnp.float32).astype(jnp.bfloat16)
    sizes = (11, 37, 39)
    assert kernels.tail_supported(x.shape, sizes)
    want = np.asarray(jtail.fused_tail_softmax(
        x, sizes, jnp.dtype(out_dtype), True).astype(jnp.float32))
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16)
    got = kernels.fused_tail_softmax(xt, sizes, getattr(torch, out_dtype))
    np.testing.assert_allclose(
        got.float().numpy(), want,
        rtol=BF16_ULP if out_dtype == "bfloat16" else 0, atol=2e-4)
