"""The bf16 twins of conv_in, freq_chain and tail_resize against the JAX
package's Pallas kernels in interpret mode, as its own tests run them on
the CPU, and the ``compute_dtype`` options around them (the name check,
the ``use_autocast`` warning). Inputs are made with numpy from a seed;
each bar says where it comes from. The whole model in both modes is
``tests/test_torch_mixed_precision.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodal_3d_image_segmentation_tpu.kernels import conv_in as jconv_in
from multimodal_3d_image_segmentation_tpu.kernels import \
    freq_chain as jfreq_chain
from multimodal_3d_image_segmentation_tpu.kernels import \
    tail_resize as jtail
from multimodal_3d_image_segmentation_tpu_torch import kernels
from multimodal_3d_image_segmentation_tpu_torch.models import HNOSegXS
from multimodal_3d_image_segmentation_tpu_torch.runtime.run import \
    warn_autocast

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

BF16_ULP = 2.0 ** -7
SMALL = dict(in_channels=3, out_channels=4, filters=8,
             num_transform_blocks=[2] * 4, num_modes=(4, 5, 5))


@pytest.mark.parametrize("weights", ["bfloat16", "mixed"])
@pytest.mark.parametrize("shape", [(1, 4, 8, 10, 13), (1, 4, 9, 11, 12)])
def test_conv_in_twin_matches_the_pallas_kernel(shape, weights):
    """The bf16 twin against the Pallas kernel in interpret mode on bf16
    input (even D/H: the raw kernel; odd: the padded one), with the
    weights bf16 ('bfloat16') or fp32 ('mixed'). Bar: one bf16 ulp (both
    sum in fp32 in another order and round once), atol 1e-5."""
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal(shape), jnp.float32).astype(
        jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((2, 2, 2, 4, 24)) / np.sqrt(32),
                    jnp.float32)
    b = jnp.asarray(rng.uniform(-0.1, 0.1, 24), jnp.float32)
    if weights == "bfloat16":
        k, b = k.astype(jnp.bfloat16), b.astype(jnp.bfloat16)
    want = np.asarray(jconv_in.conv_in_s2d(x, k, b, interpret=True)
                      .astype(jnp.float32))
    wt = torch.from_numpy(np.asarray(k.astype(jnp.float32))).permute(
        4, 3, 0, 1, 2).contiguous()
    bt = torch.from_numpy(np.asarray(b.astype(jnp.float32)))
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
        torch.bfloat16)
    got = kernels.conv_in_s2d(xt, wt, bt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_ULP,
                               atol=1e-5)


@pytest.mark.parametrize("n", [1, 3])
def test_freq_chain_twin_matches_the_pallas_kernel(n):
    """The bf16 chain twin against the Pallas kernel in interpret mode on
    bf16 rows (weights cast to bf16, as the reference casts them). Bar:
    one bf16 ulp of each value and of the largest magnitude (a rounding
    flipped at one stage moves the next stage's inputs by one ulp)."""
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal((1, 6, 8, 8, 24)),
                    jnp.float32).astype(jnp.bfloat16)
    ws = [jnp.asarray(rng.standard_normal((24, 24)) / np.sqrt(24),
                      jnp.float32) for _ in range(n)]
    want = np.asarray(jfreq_chain.fused_freq_chain(x, ws, interpret=True)
                      .astype(jnp.float32))
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
        torch.bfloat16)
    wts = [torch.from_numpy(np.asarray(w)).to(torch.bfloat16) for w in ws]
    got = kernels.fused_freq_chain(xt, wts)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), want, rtol=BF16_ULP,
        atol=1e-5 + BF16_ULP * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_tail_twin_matches_the_pallas_kernel(out_dtype):
    """The bf16-input tail twin against the Pallas kernel in interpret mode
    (as tests/test_tail_resize.py runs it on bf16). Bar: 2e-4, the fp32
    tail's bar against the kernel's bf16x3 H/W dots
    (tests/test_torch_kernels.py), plus one bf16 ulp for a bf16 output."""
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((1, 4, 8, 9, 10)) * 3,
                    jnp.float32).astype(jnp.bfloat16)
    sizes = (17, 21, 23)
    want = np.asarray(jtail.fused_tail_softmax(
        x, sizes, jnp.dtype(out_dtype), True).astype(jnp.float32))
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
        torch.bfloat16)
    got = kernels.fused_tail_softmax(xt, sizes, getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype)
    np.testing.assert_allclose(
        got.float().numpy(), want,
        rtol=BF16_ULP if out_dtype == "bfloat16" else 0, atol=2e-4)


def test_unknown_compute_dtype_raises():
    with pytest.raises(ValueError, match="compute_dtype"):
        HNOSegXS(**SMALL, compute_dtype="float16")


@pytest.mark.parametrize("section", ["train", "test"])
def test_use_autocast_warns(capsys, section):
    warn_autocast(section)
    out = capsys.readouterr().out
    assert f"[{section}] use_autocast is ignored" in out
    assert "compute_dtype" in out
