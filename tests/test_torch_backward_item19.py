"""The backward passes of conv3 and the three tower kernels (their
``torch.autograd.Function``s) on the CPU, against ``jax.vjp`` of the JAX
package's kernels and against autograd through their plain twins.

On a CPU tensor each wrapper runs its plain forward, and its Function runs
the same backward as on the card: a replay of the plain twin under
autograd, as the reference's custom VJPs replay their XLA references. The
JAX side runs its Pallas kernels in interpret mode, at 'highest' (pinned
with ``monkeypatch``, as ``tests/test_runtime.py`` leaves 'high' behind).
Layouts convert with the helpers of ``tests/test_torch_tower_block.py``,
``test_torch_tower_block_s.py`` and ``test_torch_conv3.py``.

Tolerance: a Function's gradients within 1e-5 of each JAX gradient's
largest magnitude, at least 1 (fp32 sums in other orders); float64
gradients against autograd through the plain twin within 1e-12.
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
from multimodal_3d_image_segmentation_tpu.kernels.conv3d_flat import (
    conv3_flat, flat_geom, from_flat, to_flat)
from multimodal_3d_image_segmentation_tpu.ops import spectral as jspectral
from multimodal_3d_image_segmentation_tpu_torch import kernels
from multimodal_3d_image_segmentation_tpu_torch.kernels import \
    tower_block as tb
from multimodal_3d_image_segmentation_tpu_torch.kernels import \
    tower_block_s as tbs

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

GRAD_RTOL = 1e-5
C = 8


@pytest.fixture(autouse=True)
def _highest(monkeypatch):
    monkeypatch.setattr(jspectral, "PRECISION", jax.lax.Precision.HIGHEST)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _leaf(a):
    return torch.from_numpy(np.array(a)).requires_grad_(True)


def _close(got, want, rtol=GRAD_RTOL):
    want = np.asarray(want)
    assert got is not None and tuple(got.shape) == want.shape
    atol = rtol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=atol)


def _vjp(fn, args, cot):
    """``jax.vjp`` of ``fn`` at ``args``, applied to ``cot``, in one
    compiled program (op by op, the replay compiles each op apart)."""
    return jax.jit(lambda a, c: jax.vjp(fn, *a)[1](c))(tuple(args), cot)


def _cl_to_flat(a):
    """The port's (D, H, W, C) -> JAX (D, C, W*HL)."""
    return jtb.to_tower_flat(jnp.asarray(a[None]))


def _flat_to_cl(flat, sizes, channels):
    """JAX (D, C, W*HL) -> the port's (D, H, W, C)."""
    return np.asarray(jtb.from_tower_flat(flat, sizes, channels))[0] \
        .transpose(1, 2, 3, 0)


# ------------------------------------------------------------ tower_block

def _block_inputs(transform, sizes, modes, n_ds, seed):
    """numpy x (D, H, W, C), the block's spectrum operand sy (KS, C, KH,
    KW) of a real block (the operator on the entry spectrum of x), w_cat,
    w_cc_t, b_cat and ds_prev (or None)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(sizes + (C,)).astype(np.float32)
    spec = tb.make_tower_spec(transform, sizes, modes, C, n_ds=n_ds)
    ops = [torch.from_numpy((rng.standard_normal((C, C)) / np.sqrt(C))
                            .astype(np.float32))
           for _ in range(1 if transform == "Hartley" else 2)]
    with torch.no_grad():
        sy = tbs.spectrum_mix_s(tbs.entry_spectrum_s(torch.from_numpy(x),
                                                     spec), ops, spec)
    w_cat = (rng.standard_normal((2 * C + n_ds, C)) / np.sqrt(C)).astype(
        np.float32)
    w_cc_t = (rng.standard_normal((C, C)) / np.sqrt(C)).astype(np.float32)
    b_cat = rng.uniform(-0.1, 0.1, 2 * C).astype(np.float32)
    ds_prev = (rng.standard_normal(sizes + (n_ds,)).astype(np.float32)
               if n_ds else None)
    return spec, x, sy.numpy(), w_cat, w_cc_t, b_cat, ds_prev


BLOCK_CASES = [("Hartley", (8, 6, 5), (2, 3, 2), 0),
               ("Hartley", (7, 9, 6), (2, 3, 2), 3),
               ("Fourier", (8, 6, 5), (2, 3, 2), 4),
               ("Fourier", (7, 9, 7), (2, 3, 3), 0)]
BLOCK_IDS = ["H-ds0", "H-ds3", "F-ds4", "F-oddkw-ds0"]


@pytest.mark.parametrize("transform,sizes,modes,n_ds", BLOCK_CASES,
                         ids=BLOCK_IDS)
def test_tower_block_gradients_match_jax(transform, sizes, modes, n_ds):
    spec, x, sy, w_cat, w_cc_t, b_cat, ds_prev = _block_inputs(
        transform, sizes, modes, n_ds, 0)
    with torch.no_grad():
        z = tb.d_stage_inverse(torch.from_numpy(sy), spec).numpy()
    d, _, _ = sizes
    g_out = _rand(sizes + (C,), 1)
    g_f = _rand((d, 2, C, spec.kh, spec.kw), 2)
    g_ds = _rand(sizes + (n_ds,), 3) if n_ds else None

    jspec = jtb.make_tower_spec(transform, sizes, modes, C, n_ds=n_ds)
    jargs = [_cl_to_flat(x), jnp.asarray(z), jnp.asarray(w_cat),
             jnp.asarray(w_cc_t), jnp.asarray(b_cat)]
    if n_ds:
        jargs.append(_cl_to_flat(ds_prev))
    cot = [_cl_to_flat(g_out), jnp.asarray(g_f)]
    if n_ds:
        cot.append(_cl_to_flat(g_ds))
    want = _vjp(lambda *a: jtb.fused_tower_block(*a[:5], jspec, True,
                                                 a[5] if n_ds else None),
                jargs, tuple(cot))

    leaves = [_leaf(a) for a in (x, z, w_cat, w_cc_t, b_cat)]
    dsp = _leaf(ds_prev) if n_ds else None
    before = dict(kernels.LAUNCHES)
    outs = kernels.fused_tower_block(*leaves, spec, dsp)
    torch.autograd.backward(
        outs, [torch.from_numpy(g) for g in (g_out, g_f, g_ds)
               if g is not None])
    assert kernels.LAUNCHES == before  # CPU tensors: no launch
    _close(leaves[0].grad, _flat_to_cl(want[0], sizes, C))
    for leaf, w in zip(leaves[1:], want[1:5]):
        _close(leaf.grad, w)
    if n_ds:
        _close(dsp.grad, _flat_to_cl(want[5], sizes, n_ds))


# ---------------------------------------------------------- tower_block_s

def _lane_pad(s, kwl):
    """The port's (KS, C, KH, KW) -> the JAX resident (KS, C*KH, KWL)."""
    ks, c, kh, kw = s.shape
    s = np.pad(s, [(0, 0)] * 3 + [(0, kwl - kw)])
    return jnp.asarray(s.reshape(ks, c * kh, kwl))


@pytest.mark.parametrize("transform,sizes,modes,n_ds", BLOCK_CASES[1:3],
                         ids=BLOCK_IDS[1:3])
def test_tower_block_s_gradients_match_jax(transform, sizes, modes, n_ds):
    spec, x, sy, w_cat, w_cc_t, b_cat, ds_prev = _block_inputs(
        transform, sizes, modes, n_ds, 4)
    ks = tb.spectrum_rows(spec)
    g_out = _rand(sizes + (C,), 5)
    g_sf = _rand((ks, C, spec.kh, spec.kw), 6)
    g_ds = _rand(sizes + (n_ds,), 7)

    jspec = jtbs.make_tower_spec_s(transform, sizes, modes, C, n_ds=n_ds)
    jargs = (_cl_to_flat(x), _lane_pad(sy, jspec.kwl), jnp.asarray(w_cat),
             jnp.asarray(w_cc_t), jnp.asarray(b_cat), _cl_to_flat(ds_prev))
    want = _vjp(lambda *a: jtbs.fused_tower_block_s(*a[:5], jspec, True,
                                                   a[5]),
                jargs, (_cl_to_flat(g_out), _lane_pad(g_sf, jspec.kwl),
                        _cl_to_flat(g_ds)))

    leaves = [_leaf(a) for a in (x, sy, w_cat, w_cc_t, b_cat, ds_prev)]
    outs = kernels.fused_tower_block_s(*leaves[:5], spec, leaves[5])
    torch.autograd.backward(outs, [torch.from_numpy(g)
                                   for g in (g_out, g_sf, g_ds)])
    _close(leaves[0].grad, _flat_to_cl(want[0], sizes, C))
    _close(leaves[1].grad, np.asarray(want[1]).reshape(
        ks, C, spec.kh, jspec.kwl)[..., :spec.kw])
    for leaf, w in zip(leaves[2:5], want[2:5]):
        _close(leaf.grad, w)
    _close(leaves[5].grad, _flat_to_cl(want[5], sizes, n_ds))


# --------------------------------------------------------- tower_resident

def _resident_inputs(transform, sizes, nb, seed):
    """numpy x (D, H, W, C) and the stacked weights of nb blocks (the
    scales of ``tests/test_tower_resident.py``)."""
    rng = np.random.default_rng(seed)
    pr = 1 if transform == "Hartley" else 2

    def r(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return (r(*sizes, C, scale=0.3), r(nb, pr, C, C, scale=0.2),
            r(nb, 2 * C, C, scale=0.2), r(nb, C, C, scale=0.2),
            r(nb, 2 * C, scale=0.1))


@pytest.mark.parametrize("transform,modes", [("Hartley", (2, 3, 3)),
                                             ("Fourier", (2, 3, 3))])
def test_resident_tower_gradients_match_jax(transform, modes):
    """The 2-block tower, its Function's backward a replay of the whole
    plain tower."""
    sizes = (5, 11, 7)
    ins = _resident_inputs(transform, sizes, 2, 8)
    g = _rand(sizes + (C,), 9)
    jspec = jtb.make_tower_spec(transform, sizes, modes, C)
    want = _vjp(lambda *a: jtr.resident_tower(*a, jspec, True),
                [_cl_to_flat(ins[0]), *map(jnp.asarray, ins[1:])],
                _cl_to_flat(g))

    spec = tb.make_tower_spec(transform, sizes, modes, C)
    leaves = [_leaf(a) for a in ins]
    kernels.resident_tower(*leaves, spec).backward(torch.from_numpy(g))
    _close(leaves[0].grad, _flat_to_cl(want[0], sizes, C))
    for leaf, w in zip(leaves[1:], want[1:]):
        _close(leaf.grad, w)


# ------------------------------------------------------------------ conv3

def _flat(x):
    """(1, D, H, W, C) numpy -> the reference's flat layout."""
    g = flat_geom(x.shape[1:4])
    return to_flat(jnp.asarray(x[0].transpose(3, 0, 1, 2)), g), g


def _unflat(yf, g):
    return np.asarray(from_flat(yf, g)).transpose(1, 2, 3, 0)[None]


def _conv3_case(option, sizes=(5, 6, 7), c1=8, co=12, seed=10):
    """The conv's operands as numpy, None where the option has none:
    (x, x2, weight, bias, scale, shift, res_weight, res_bias), and the
    option's static arguments."""
    c2 = 4 if option == "prologue_x2" else 0
    ci = c1 + c2
    x = _rand((1,) + sizes + (c1,), seed)
    x2 = _rand((1,) + sizes + (c2,), seed + 1) if c2 else None
    w = _rand((co, ci, 3, 3, 3), seed + 2, 1 / np.sqrt(27 * ci))
    b = _rand((co,), seed + 3, 0.1)
    sc = sh = rw = rb = None
    kw = {}
    if option == "prologue_x2":
        sc, sh = _rand((ci,), seed + 4, 0.3) + 1, _rand((ci,), seed + 5, 0.5)
        kw = dict(prologue_act="elu")
    if option == "residual_stats":
        rw = _rand((co, ci), seed + 6, 1 / np.sqrt(ci))
        rb = _rand((co,), seed + 7, 0.1)
        kw = dict(emit_stats=True)
    if option in ("stride2", "dilation2"):
        kw = {option[:-1]: 2, "emit_stats": True}
    return (x, x2, w, b, sc, sh, rw, rb), kw


def _conv3_call(args, kw):
    x, x2, w, b, sc, sh, rw, rb = args
    return kernels.conv3(
        x, w, b, x2=x2, prologue=None if sc is None else (sc, sh),
        residual=None if rw is None else (rw, rb), **kw)


def _conv3_plain_call(args, kw):
    x, x2, w, b, sc, sh, rw, rb = args
    return kernels.conv3_plain(
        x, w, b, x2=x2, prologue=None if sc is None else (sc, sh),
        residual=None if rw is None else (rw, rb), **kw)


@pytest.mark.parametrize("option", ["bare", "prologue_x2", "residual_stats"])
def test_conv3_gradients_match_jax(option):
    """The bare conv, the deferred GroupNorm + ELU prologue on the virtual
    concat (x, x2), and the 1x1 residual tap with both outputs' moment
    sums, whose cotangents flow too."""
    args, kw = _conv3_case(option)
    x, x2, w, b, sc, sh, rw, rb = args
    present = [i for i, a in enumerate(args) if a is not None]
    g = flat_geom(x.shape[1:4])
    n_out = 2 if rw is not None else 1
    cot_cl = [_rand(x.shape[:4] + (w.shape[0],), 20 + i)
              for i in range(n_out)]
    cot_st = ([_rand((2, w.shape[0]), 30 + i) for i in range(n_out)]
              if kw.get("emit_stats") else [])

    def jax_conv(*vals):
        full = [None] * 8
        for i, v in zip(present, vals):
            full[i] = v
        jx, jx2, jw, jb, jsc, jsh, jrw, jrb = full
        return conv3_flat(
            jx if jx2 is None else (jx, jx2), jw, jb, g,
            prologue=None if jsc is None else (jsc, jsh),
            prologue_act=kw.get("prologue_act"), precision="highest",
            interpret=True, emit_stats=kw.get("emit_stats", False),
            residual=None if jrw is None else (jrw, jrb))

    def to_jax(i, a):
        if i in (0, 1):
            return _flat(a)[0]
        if i == 2:
            return jnp.asarray(a.transpose(2, 3, 4, 1, 0))  # DHWIO
        return jnp.asarray(a)

    cot = [_flat(c)[0] for c in cot_cl] + [jnp.asarray(c) for c in cot_st]
    want = dict(zip(present, _vjp(
        jax_conv, [to_jax(i, args[i]) for i in present],
        cot[0] if len(cot) == 1 else tuple(cot))))

    leaves = [None if a is None else _leaf(a) for a in args]
    outs = _conv3_call(leaves, kw)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, [torch.from_numpy(c)
                                   for c in cot_cl + cot_st])
    for i in present:
        w_i = want[i]
        if i in (0, 1):
            w_i = _unflat(w_i, g)
        elif i == 2:
            w_i = np.asarray(w_i).transpose(4, 3, 0, 1, 2)
        _close(leaves[i].grad, w_i)


# ------------------------------------- every Function against its plain twin

def _f64(a):
    return None if a is None else torch.from_numpy(
        np.asarray(a, np.float64)).requires_grad_()


def _grads_equal(fused, plain, args):
    """float64: the Function's gradients are autograd's through its plain
    twin, for the same inputs and seeded output gradients."""
    live = [a for a in args if a is not None]
    want_out = plain(*args)
    want_out = want_out if isinstance(want_out, tuple) else (want_out,)
    gs = [torch.from_numpy(np.asarray(_rand(tuple(o.shape), 40 + i),
                                      np.float64))
          for i, o in enumerate(want_out)]
    want = torch.autograd.grad(want_out, live, gs)
    got_out = fused(*args)
    got_out = got_out if isinstance(got_out, tuple) else (got_out,)
    got = torch.autograd.grad(got_out, live, gs)
    assert len(got) == len(want) == len(live)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("option", ["bare", "prologue_x2", "residual_stats",
                                    "stride2", "dilation2"])
def test_conv3_function_matches_autograd_through_plain_twin(option):
    """Also the port's stride-2 and dilation-2 modes, which the JAX
    ``conv3_flat`` does not have."""
    args, kw = _conv3_case(option, sizes=(5, 4, 6), c1=4, co=8)
    _grads_equal(lambda *a: _conv3_call(a, kw),
                 lambda *a: _conv3_plain_call(a, kw),
                 [_f64(a) for a in args])


@pytest.mark.parametrize("kernel", ["block", "block_s"])
@pytest.mark.parametrize("transform,n_ds", [("Hartley", 3), ("Fourier", 0)])
def test_tower_block_functions_match_autograd_through_plain_twin(
        kernel, transform, n_ds):
    spec, x, sy, w_cat, w_cc_t, b_cat, ds_prev = _block_inputs(
        transform, (7, 9, 7), (2, 3, 3), n_ds, 11)
    if kernel == "block":
        with torch.no_grad():
            sy = tb.d_stage_inverse(torch.from_numpy(sy), spec).numpy()
        fused, plain = kernels.fused_tower_block, kernels.tower_block_plain
    else:
        fused, plain = kernels.fused_tower_block_s, tbs.tower_block_s_plain
    args = [_f64(a) for a in (x, sy, w_cat, w_cc_t, b_cat, ds_prev)]
    _grads_equal(lambda *a: fused(*a[:5], spec, a[5] if n_ds else None),
                 lambda *a: plain(*a[:5], spec, a[5] if n_ds else None),
                 args if n_ds else args[:5] + [None])


def test_resident_tower_function_matches_autograd_through_plain_twin():
    spec = tb.make_tower_spec("Fourier", (5, 11, 7), (2, 3, 3), C)
    args = [_f64(a) for a in _resident_inputs("Fourier", (5, 11, 7), 3, 12)]
    _grads_equal(lambda *a: kernels.resident_tower(*a, spec),
                 lambda *a: kernels.resident_tower_plain(*a, spec), args)


def test_gradients_only_where_asked():
    """The replay differentiates only the inputs that need a gradient: a
    conv3 call with a frozen input and a tower block whose weights alone
    are trained."""
    args, kw = _conv3_case("residual_stats")
    ts = [None if a is None else torch.from_numpy(a) for a in args]
    ts[2].requires_grad_(True)
    y, r, st, rst = _conv3_call(ts, kw)
    (y.sum() + st.sum()).backward()
    assert ts[2].grad is not None
    assert all(t.grad is None for i, t in enumerate(ts)
               if i != 2 and t is not None)
    spec, *ins = _block_inputs("Hartley", (7, 9, 6), (2, 3, 2), 0, 13)
    x, sy, w_cat, w_cc_t, b_cat = (torch.from_numpy(a) for a in ins[:5])
    w_cat.requires_grad_(True)
    out, f = kernels.fused_tower_block(
        x, tb.d_stage_inverse(sy, spec), w_cat, w_cc_t, b_cat, spec)
    out.sum().backward()  # f unused: no gradient reaches it
    assert w_cat.grad is not None and x.grad is None
