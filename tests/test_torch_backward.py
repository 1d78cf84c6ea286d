"""The backward passes of the port's kernel Functions (conv_in, freq_chain,
tail_resize) on the CPU against ``jax.vjp`` of the JAX package's kernels,
and against autograd through their plain twins.

On a CPU tensor each kernel wrapper runs its plain forward, and its
``torch.autograd.Function`` runs the same backward as on the card (the
reference's closed forms, or a replay of the plain twin). The JAX side
runs its Pallas kernels in interpret mode, at 'highest' (pinned with
``monkeypatch``, as ``tests/test_runtime.py`` leaves 'high' behind).

Tolerance: a Function's gradients within 1e-5 of each JAX gradient's
largest magnitude, at least 1 (fp32 sums over a few hundred rows; the
freq_chain weights' reach 4e-5 absolute at magnitude 80).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_3d_image_segmentation_tpu.kernels import conv_in as jconv_in
from multimodal_3d_image_segmentation_tpu.kernels import \
    freq_chain as jfreq_chain
from multimodal_3d_image_segmentation_tpu.kernels import \
    tail_resize as jtail
from multimodal_3d_image_segmentation_tpu.ops import spectral as jspectral
from multimodal_3d_image_segmentation_tpu_torch import kernels

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

GRAD_RTOL = 1e-5


@pytest.fixture
def highest(monkeypatch):
    monkeypatch.setattr(jspectral, "PRECISION", jax.lax.Precision.HIGHEST)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _leaf(a):
    return torch.from_numpy(np.array(a)).requires_grad_(True)


def _close(got, want, rtol):
    want = np.asarray(want)
    atol = rtol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=atol)


@pytest.mark.parametrize("shape,n", [
    ((1, 6, 8, 4, 24), 3),   # the flagship width and chain
    ((1, 5, 7, 3, 16), 1),
    ((2, 4, 4, 2, 8), 2),
])
def test_freq_chain_gradients_match_jax(shape, n, highest):
    c = shape[-1]
    x, g = _rand(shape, 0), _rand(shape, 9)
    ws = [_rand((c, c), 1 + k, 0.2) for k in range(n)]
    _, vjp = jax.vjp(
        lambda a, *w: jfreq_chain.fused_freq_chain(a, list(w),
                                                   interpret=True),
        jnp.asarray(x), *map(jnp.asarray, ws))
    want = vjp(jnp.asarray(g))
    xt, wts = _leaf(x), [_leaf(w) for w in ws]
    kernels.fused_freq_chain(xt, wts).backward(torch.from_numpy(g))
    _close(xt.grad, want[0], GRAD_RTOL)
    for wt, w_want in zip(wts, want[1:]):
        _close(wt.grad, w_want, GRAD_RTOL)


@pytest.mark.parametrize("selu", [True, False])
@pytest.mark.parametrize("shape", [
    (1, 2, 8, 6, 5),    # even D/H: the raw Pallas path
    (1, 3, 7, 6, 5),    # odd D: the padded Pallas path
    (1, 4, 6, 4, 7),
])
def test_conv_in_gradients_match_jax(shape, selu, highest):
    c, f = shape[1], 8
    x = _rand(shape, 3)
    w = _rand((f, c, 2, 2, 2), 4, 1 / np.sqrt(8 * c))
    b = _rand((f,), 5, 0.1)
    d, h, wd = shape[2:]
    g = _rand((1, d // 2 + 1, h // 2 + 1, wd // 2 + 1, f), 6)
    _, vjp = jax.vjp(
        lambda a, k, bb: jconv_in.conv_in_s2d(a, k, bb, interpret=True,
                                              apply_selu=selu),
        jnp.asarray(x), jnp.asarray(w.transpose(2, 3, 4, 1, 0)),
        jnp.asarray(b))
    gx, gk, gb = vjp(jnp.asarray(g))
    xt, wt, bt = _leaf(x), _leaf(w), _leaf(b)
    kernels.conv_in_s2d(xt, wt, bt, apply_selu=selu).backward(
        torch.from_numpy(g))
    _close(xt.grad, gx, GRAD_RTOL)
    _close(wt.grad, np.asarray(gk).transpose(4, 3, 0, 1, 2), GRAD_RTOL)
    _close(bt.grad, gb, GRAD_RTOL)


def test_conv_in_gradient_only_where_asked():
    """The replay differentiates only the inputs that need a gradient."""
    x = torch.from_numpy(_rand((1, 2, 6, 6, 5), 7))
    w, b = _leaf(_rand((8, 2, 2, 2, 2), 8, 0.25)), _leaf(_rand((8,), 9))
    kernels.conv_in_s2d(x, w, b).sum().backward()
    assert x.grad is None and w.grad is not None and b.grad is not None


@pytest.mark.parametrize("shape,sizes", [
    ((1, 4, 12, 10, 8), (31, 25, 19)),    # odd upsample, all axes
    ((1, 2, 7, 9, 11), (14, 18, 22)),     # exact 2x
    ((1, 3, 6, 8, 8), (6, 8, 8)),         # identity resize
    ((1, 2, 16, 6, 6), (9, 11, 13)),      # D downsample + HW upsample
])
def test_tail_gradients_match_jax(shape, sizes, highest, monkeypatch):
    monkeypatch.setenv("M3SEG_PALLAS_TAIL", "1")
    x, g = _rand(shape, 1), _rand((1, shape[1]) + sizes, 2)
    _, vjp = jax.vjp(
        lambda a: jtail.fused_tail_softmax(a, sizes, jnp.float32, True),
        jnp.asarray(x))
    xt = _leaf(x)
    kernels.fused_tail_softmax(xt, sizes).backward(torch.from_numpy(g))
    _close(xt.grad, vjp(jnp.asarray(g))[0], GRAD_RTOL)


@pytest.mark.parametrize("fn", ["freq_chain", "conv_in", "tail"])
def test_functions_match_autograd_through_plain_twin(fn):
    """float64: the Functions' backward passes are the exact gradients of
    their plain twins (which is what the card's CUDA tests check in fp32)."""
    def f64(a):
        return torch.from_numpy(np.asarray(a, np.float64)).requires_grad_()

    if fn == "freq_chain":
        args = [f64(_rand((1, 4, 5, 3, 8), 0))] + [
            f64(_rand((8, 8), k, 0.3)) for k in (1, 2)]
        def fused(x, *w): return kernels.fused_freq_chain(x, list(w))
        def plain(x, *w): return kernels.freq_chain_plain(x, list(w))
    elif fn == "conv_in":
        args = [f64(_rand((1, 3, 7, 6, 5), 0)),
                f64(_rand((8, 3, 2, 2, 2), 1, 0.3)), f64(_rand((8,), 2))]
        fused, plain = kernels.conv_in_s2d, kernels.conv_in_plain
    else:
        args = [f64(_rand((1, 3, 5, 6, 4), 0))]
        def fused(x): return kernels.fused_tail_softmax(x, (9, 11, 7))
        def plain(x): return kernels.tail_plain(x, (9, 11, 7))
    g = torch.from_numpy(np.asarray(
        _rand(tuple(plain(*args).shape), 3), np.float64))
    got = torch.autograd.grad(fused(*args), args, g)
    want = torch.autograd.grad(plain(*args), args, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)
