"""The port's CUDA kernels against their plain PyTorch versions on a card.

Every test here needs a CUDA device and skips without one. The file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest`` skips the repository conftest, which configures JAX.)
Tolerances: 1e-5 absolute for conv_in and freq_chain (fp32 FMA order
against cuDNN / cuBLAS in full fp32), 1e-6 on the tail's probabilities.
"""
import numpy as np
import pytest
import torch

from multimodal_3d_image_segmentation_tpu_torch import kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(shape, seed, dev, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(a.astype(np.float32)).to(dev)


def _launched(name, fn):
    before = kernels.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    return out


@pytest.mark.parametrize("shape", [
    (1, 4, 16, 14, 11),   # even D/H, odd W
    (1, 4, 15, 13, 12),   # odd D/H
    (2, 3, 9, 8, 7),      # batch 2
])
@pytest.mark.parametrize("f", [8, 24])
def test_conv_in_kernel_matches_plain(dev, shape, f):
    c = shape[1]
    x = _t(shape, 0, dev)
    w = _t((f, c, 2, 2, 2), 1, dev, 1 / np.sqrt(8 * c))
    b = _t((f,), 2, dev, 0.1)
    with torch.no_grad():
        got = _launched("conv_in", lambda: kernels.conv_in_s2d(x, w, b))
        want = kernels.conv_in_plain(x, w, b)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        raw = kernels.conv_in_s2d(x, w, b, apply_selu=False)
        torch.testing.assert_close(
            raw, kernels.conv_in_plain(x, w, b, apply_selu=False),
            rtol=0, atol=1e-5)


@pytest.mark.parametrize("c", [8, 24])
def test_freq_chain_kernel_matches_plain(dev, c):
    x = _t((1, 10, 14, 14, c), 3, dev)
    ws = [_t((c, c), 4 + k, dev, 1 / np.sqrt(c)) for k in range(3)]
    with torch.no_grad():
        got = _launched("freq_chain",
                        lambda: kernels.fused_freq_chain(x, ws))
        torch.testing.assert_close(got, kernels.freq_chain_plain(x, ws),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape,sizes", [
    ((1, 4, 12, 10, 8), (31, 25, 19)),
    ((1, 2, 7, 9, 11), (14, 18, 22)),
    ((1, 3, 6, 8, 8), (6, 8, 8)),
    ((1, 8, 16, 6, 6), (9, 11, 13)),
])
def test_tail_kernel_matches_plain(dev, shape, sizes):
    x = _t(shape, 5, dev, 3.0)
    with torch.no_grad():
        got = _launched("tail_resize",
                        lambda: kernels.fused_tail_softmax(x, sizes))
        torch.testing.assert_close(got, kernels.tail_plain(x, sizes),
                                   rtol=0, atol=1e-6)


def test_kernels_refuse_what_they_do_not_take(dev):
    x = _t((1, 4, 8, 8, 8), 6, dev)
    w = _t((24, 4, 2, 2, 2), 7, dev)
    b = _t((24,), 8, dev)
    with pytest.raises(TypeError):
        kernels.conv_in_s2d(x.double(), w.double(), b.double())
    with pytest.raises(ValueError):
        kernels.conv_in_s2d(x.transpose(2, 3), w, b)  # not contiguous
    with pytest.raises(ValueError):
        kernels.conv_in_s2d(x, w.cpu(), b)             # wrong device
    with pytest.raises(ValueError):
        kernels.fused_freq_chain(_t((1, 4, 4, 4, 12), 9, dev),
                                 [_t((12, 12), 10, dev)])  # no C=12 instance
    with pytest.raises(ValueError):
        kernels.conv_in_s2d(x, _t((16, 4, 2, 2, 2), 11, dev),
                            _t((16,), 12, dev))        # no F=16 instance
    wg = w.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kernels.conv_in_s2d(x, wg, b)                  # forward only
    with torch.no_grad():
        kernels.conv_in_s2d(x, wg, b)
