"""conv_in's bf16 instance on the bf16 tensor cores (``csrc/conv_in_mma.cu``)
on the CPU: its weight packing into mma.sync fragment order
(``kernels/conv_in.py::mma_weight``) and its formulation emulated in torch
ops from the packed form, held to the plain twin (``conv_in_plain``) and to
the JAX package's Pallas ``conv_in_s2d`` in interpret mode.

The emulation follows the kernel's arithmetic: K = 8 C in the order (c, kz,
ky, kx), padded to a multiple of 16 with zeros; the pad = 1 border as zero
operands; each k step of 16 summed in fp32 (the weights' leading part's
products, then the smaller parts' products apart) and folded in order onto
a running fp32 total started at the bias; SELU; one rounding to bf16. It
differs from the kernel in the order of the sums inside a k step (the
tensor cores' own truncation is not modelled: each step's sum here is the
exact sum rounded once) and in SELU's last ulps (torch's expm1 here).

Bars: the bf16 instances' (``chip_smoke.py``): one bf16 ulp of each value
plus 1e-5, and at most 1e-3 of the elements more than one ulp of their own
magnitude apart; 'mixed' weights (fp32, not bf16 values) also at most 1e-3
of the elements differing from the twin at all, which the weights' hi part
alone must exceed. Against the Pallas kernel, the bar of
``tests/test_torch_bf16_twins.py``: one bf16 ulp plus 1e-5.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from multimodal_3d_image_segmentation_tpu.kernels import conv_in as jconv_in
from multimodal_3d_image_segmentation_tpu.ops import spectral as jspectral
from multimodal_3d_image_segmentation_tpu_torch.kernels import \
    conv_in as kci
from multimodal_3d_image_segmentation_tpu_torch.kernels.tower_block import \
    parts3

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

BF16 = torch.bfloat16
BF16_ULP = 2.0 ** -7
SHARE = 1e-3


@pytest.fixture(autouse=True)
def _highest(monkeypatch):
    monkeypatch.setattr(jspectral, "PRECISION", jax.lax.Precision.HIGHEST)


def _weights(f, c, seed, kind):
    """(F, C, 2, 2, 2) fp32 weights and an (F,) bias: bf16 values
    ('bfloat16', as the model rounds them) or unrounded fp32 ('mixed')."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.standard_normal((f, c, 2, 2, 2))
                          / np.sqrt(8 * c)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-0.1, 0.1, f).astype(np.float32))
    if kind == "bfloat16":
        w, b = w.to(BF16).float(), b.to(BF16).float()
    return w, b


def _volume(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(BF16)


def _unpack(packed):
    """(KS, F/8, NP, 8, 4, 2, 2) fragments -> NP (16 KS, F) fp32 matrices:
    element [ks, nt, p, g, t, half, j] is part p of row 16 ks + 8 half + 2t
    + j, column 8 nt + g."""
    ks, nt, np_ = packed.shape[:3]
    m = packed.float().permute(2, 0, 5, 4, 6, 1, 3)
    return m.reshape(np_, 16 * ks, 8 * nt)


def _emulate(x, packed, bias, apply_selu):
    """The kernel's formulation in torch ops (module docstring)."""
    b_, c, d, h, w = x.shape
    mats = _unpack(packed).double()
    kp = mats.shape[1]
    xp = F.pad(x.double(), (1, 1 + (w % 2 == 0), 1, 1 + (h % 2 == 0),
                            1, 1 + (d % 2 == 0)))
    d2, h2, w2 = d // 2 + 1, h // 2 + 1, w // 2 + 1
    cols = []  # (B, D2, H2, W2) per k, in the order (c, kz, ky, kx)
    for ci in range(c):
        for kz in range(2):
            for ky in range(2):
                for kx in range(2):
                    cols.append(xp[:, ci, kz:kz + 2 * d2:2, ky:ky + 2 * h2:2,
                                   kx:kx + 2 * w2:2])
    a = torch.stack(cols, -1)
    a = F.pad(a, (0, kp - a.shape[-1]))
    tot = bias.float().expand(a.shape[:-1] + bias.shape).clone()
    for q in range(kp // 16):
        ak = a[..., 16 * q:16 * q + 16]
        lead = (ak @ mats[0, 16 * q:16 * q + 16]).float()
        tot = tot + lead
        if mats.shape[0] > 1:
            rest = sum(ak @ m[16 * q:16 * q + 16] for m in mats[1:])
            tot = tot + rest.float()
    if apply_selu:
        tot = torch.selu(tot)
    return tot.to(BF16)


def _held(got, want):
    """(within one ulp plus 1e-5 everywhere, the share more than one ulp of
    its own magnitude apart, the share differing at all)."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    ok = bool((d <= BF16_ULP * w.abs() + 1e-5).all())
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ok, float((d > ulp).float().mean()), float((d > 0).float().mean())


@pytest.mark.parametrize("c,f", [(4, 24), (3, 8)])
def test_packed_parts_sum_to_the_weight(c, f):
    """Three bf16 parts a weight, each the rounding of what the parts before
    leave, sum exactly to the fp32 weight, in the kernel's K order (c, kz,
    ky, kx) and fragment layout; K pads to 16 with zero rows (C 3: 24 ->
    32)."""
    w, _ = _weights(f, c, 1, "mixed")
    packed = kci._mma_pack(w)
    ks = -(-c // 2)
    assert packed.dtype == BF16
    assert tuple(packed.shape) == (ks, f // 8, 3, 8, 4, 2, 2)
    mats = _unpack(packed).double()
    k = w.permute(1, 2, 3, 4, 0).reshape(8 * c, f).double()
    assert torch.equal(mats.sum(0)[:8 * c], k)
    assert not mats[:, 8 * c:].any()
    assert torch.equal(mats[0][:8 * c], k.to(BF16).double())


def test_packed_layout_round_trips_to_the_torch_weight():
    """Row k = ((c * 2 + kz) * 2 + ky) * 2 + kx of the unpacked matrix is
    weight[:, c, kz, ky, kx]; lane 4g + t holds rows 2t, 2t + 1, 2t + 8,
    2t + 9 of column g of each n tile."""
    w, _ = _weights(24, 4, 2, "mixed")
    mats = _unpack(kci._mma_pack(w)).double().sum(0)
    for ci, kz, ky, kx in [(0, 0, 0, 0), (1, 0, 1, 1), (3, 1, 0, 1),
                           (2, 1, 1, 0)]:
        k = ((ci * 2 + kz) * 2 + ky) * 2 + kx
        assert torch.equal(mats[k].float(), w[:, ci, kz, ky, kx])
    frag = kci._mma_pack(w)[0, 1, 0, 5, 2]  # k step 0, n tile 1, g 5, t 2
    assert torch.equal(frag.reshape(4).float(),
                       w[13, :, :, :, :].reshape(32)[[4, 5, 12, 13]]
                       .to(BF16).float())


def test_bf16_valued_weights_pack_one_part():
    """'bfloat16''s weights are bf16 values: their lower parts are zero,
    so the kernel runs one part (6 mma a tile at C 4, F 24, not 18)."""
    w, _ = _weights(24, 4, 3, "bfloat16")
    packed = kci._mma_pack(w)
    assert packed.shape[2] == 1
    hi, mid, lo = parts3(w)
    assert not mid.any() and not lo.any()
    wm, _ = _weights(24, 4, 3, "mixed")
    assert kci._mma_pack(wm).shape[2] == 3


# (shape, F, SELU, weights): even and odd D/H, C 4 and 3 (K padded), F 24
# and 8, the serving width W 155 (odd), batch 2 (the padded Pallas variant)
CASES = [((1, 4, 8, 10, 13), 24, True, "bfloat16"),
         ((1, 4, 9, 11, 12), 24, True, "mixed"),
         ((1, 3, 8, 6, 9), 8, False, "mixed"),
         ((1, 3, 7, 9, 10), 8, True, "bfloat16"),
         ((2, 4, 6, 8, 7), 24, False, "mixed"),
         ((1, 4, 4, 6, 155), 24, True, "bfloat16")]


@pytest.mark.parametrize("shape,f,selu,kind", CASES)
def test_emulation_holds_the_twin_and_the_pallas_kernel(shape, f, selu,
                                                        kind):
    c = shape[1]
    x = _volume(shape, 10)
    w, b = _weights(f, c, 11, kind)
    got = _emulate(x, kci._mma_pack(w), b, selu)
    twin = kci.conv_in_plain(x, w, b, apply_selu=selu)
    assert got.shape == twin.shape and got.dtype == twin.dtype == BF16
    ok, share, differ = _held(got, twin)
    assert ok and share <= SHARE
    if kind == "mixed":
        assert differ <= SHARE
    # the Pallas kernel in interpret mode: (kz, ky, kx, C, F) weights, bf16
    # in 'bfloat16', fp32 in 'mixed'; batch 1 a call
    k = jnp.asarray(w.permute(2, 3, 4, 1, 0).numpy())
    bj = jnp.asarray(b.numpy())
    if kind == "bfloat16":
        k, bj = k.astype(jnp.bfloat16), bj.astype(jnp.bfloat16)
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    want = np.concatenate([np.asarray(jconv_in.conv_in_s2d(
        xj[i:i + 1], k, bj, interpret=True, apply_selu=selu).astype(
            jnp.float32)) for i in range(shape[0])])
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_ULP,
                               atol=1e-5)


def test_the_hi_part_alone_fails_the_mixed_bar():
    """The control: 'mixed' weights carried by their hi part only (one bf16
    part, as the 'bfloat16' packing would take them) differ from the twin
    on far more than 1e-3 of the elements."""
    x = _volume((1, 4, 10, 12, 33), 12)
    w, b = _weights(24, 4, 13, "mixed")
    twin = kci.conv_in_plain(x, w, b)
    full = _emulate(x, kci._mma_pack(w), b, True)
    hi = _emulate(x, kci._mma_pack(w.to(BF16).float()), b, True)
    assert _held(full, twin)[2] <= SHARE
    assert _held(hi, twin)[2] > SHARE
