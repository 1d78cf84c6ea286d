"""The port's depth sharding (``parallel/``) against the JAX package's, on
the CPU.

The port's ranks are gloo processes (``parallel/ranks.py::run_ranks``:
spawned with ``torch.multiprocessing``, a ``FileStore`` in ``tmp_path``,
one thread each); each test starts one world and runs all of its cases in
it, while the JAX side runs meanwhile in this process on the 8-device CPU
mesh that ``conftest.py`` sets up: ``parallel/halo.py::conv3_flat_sharded``
and ``parallel/flat_sharded.py::make_flat_sharded_apply`` with the Pallas
conv in interpret mode, at the shapes of ``tests/test_parallel.py``
(``TestHaloShardedConv``, ``TestFlatShardedVNet``). The JAX conv runs at
precision 'highest' (exact fp32 products, as the port's; its default
'bf16x3' is about 5e-6 relative), so both sides are fp32 and differ only
in summation order: 1e-5 absolute on outputs and probabilities, 1e-5
relative on moment sums. The sharded V-Net-DS is also held to the port's
own unsharded kernel path. Inputs are made with numpy from a seed;
weights pass through ``utils/jax_compat.py``.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_3d_image_segmentation_tpu import models as jmodels
from multimodal_3d_image_segmentation_tpu.kernels import conv3d_flat
from multimodal_3d_image_segmentation_tpu.models import \
    architectures as jarch
from multimodal_3d_image_segmentation_tpu.ops.flatvol import (flat_geom,
                                                              from_flat,
                                                              to_flat)
from multimodal_3d_image_segmentation_tpu.parallel import make_mesh
from multimodal_3d_image_segmentation_tpu.parallel import \
    flat_sharded as jflat
from multimodal_3d_image_segmentation_tpu.parallel.halo import \
    conv3_flat_sharded
from multimodal_3d_image_segmentation_tpu_torch.models import VNetDS
from multimodal_3d_image_segmentation_tpu_torch.parallel import flat_sharded
from multimodal_3d_image_segmentation_tpu_torch.parallel.ranks import \
    run_ranks
from multimodal_3d_image_segmentation_tpu_torch.utils.jax_compat import \
    state_dict_from_jax

import torch_rank_cases

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

ATOL = 1e-5
MOMENTS_RTOL = 1e-5
# tests/test_parallel.py::TestFlatShardedVNet's cases: (shape, ranks, the
# image axis split, the model's options)
VNET_CASES = [
    ((14, 12, 12), 2, 0, dict(num_blocks=[1, 2], right_leg_indexes=[0, 1])),
    ((10, 12, 12), 2, 0, dict(num_blocks=[1, 1], right_leg_indexes=[0, 1])),
    ((13, 12, 14), 2, 2, dict(num_blocks=[1, 1], right_leg_indexes=[0, 1])),
    ((30, 12, 12), 4, 0, dict(num_blocks=[1, 1], right_leg_indexes=[0])),
    ((14, 12, 12), 2, 0, dict(num_blocks=[1, 1], use_snn=True,
                              activation="selu", right_leg_indexes=[0, 1])),
]
VNET_BASE = dict(in_channels=2, out_channels=3, base_num_filters=4)


@pytest.fixture
def highest(monkeypatch):
    """The JAX conv3_flat at precision 'highest' wherever it is called."""
    real = conv3d_flat.conv3_flat

    def exact(*args, **kw):
        kw["precision"] = "highest"
        return real(*args, **kw)
    monkeypatch.setattr(conv3d_flat, "conv3_flat", exact)


def _in_ranks(world, tmp_path, cases):
    """Start ``world`` ranks running ``cases`` (a list of (fn, args)) in a
    thread; returns the future of every rank's results per case."""
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(lambda: [run_ranks(fn, world, tmp_path / f"case{i}",
                                         *args)
                               for i, (fn, args) in enumerate(cases)])
    pool.shutdown(wait=False)
    return fut


def _conv_case(seed=0, d=16, h=10, w=9, ci=6, co=5):
    rng = np.random.default_rng(seed)
    x4 = rng.standard_normal((ci, d, h, w)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 3, ci, co)) * 0.2).astype(np.float32)
    b = rng.standard_normal((co,)).astype(np.float32)
    return x4, k, b


def _cl(x4):
    """(C, D, H, W) -> the port's (1, D, H, W, C)."""
    return np.ascontiguousarray(x4.transpose(1, 2, 3, 0)[None])


@pytest.mark.parametrize("n", [2, 4])
def test_conv3_sharded_matches_jax(tmp_path, highest, n):
    """``conv3_sharded`` on n ranks against ``conv3_flat_sharded`` on n
    devices of the mesh: bare with moment sums (d=16), and the residual
    tap and an ELU prologue (d=12; the tap's 4 outputs, the port's conv
    taking as many)."""
    rng = np.random.default_rng(3)
    rk = rng.standard_normal((4, 6)).astype(np.float32)
    rb = rng.standard_normal((4,)).astype(np.float32)
    scale = rng.standard_normal((6,)).astype(np.float32)
    shift = rng.standard_normal((6,)).astype(np.float32)
    x16, k, b = _conv_case()
    x12, k12, b12 = _conv_case(d=12)
    cases = [(x16, k, b, dict(emit_stats=True)),
             (x12, k12[..., :4], b12[:4], dict(residual=(rk, rb))),
             (x12, k12, b12, dict(prologue=(scale, shift),
                                  prologue_act="elu"))]
    # the port's weights in torch's (co, ci, kd, kh, kw) layout
    fut = _in_ranks(n, tmp_path, [
        (torch_rank_cases.sharded_conv3_case,
         (_cl(x4), np.ascontiguousarray(kk.transpose(4, 3, 0, 1, 2)), bb, c))
        for x4, kk, bb, c in cases])
    mesh = make_mesh(n_data=8 // n, n_spatial=n)
    want = []
    for x4, kk, bb, c in cases:
        g = flat_geom(*x4.shape[1:])
        jc = {key: (tuple(jnp.asarray(a) for a in v) if isinstance(v, tuple)
                    else v) for key, v in c.items()}
        out = conv3_flat_sharded(to_flat(jnp.asarray(x4), g), jnp.asarray(kk),
                                 jnp.asarray(bb), g, mesh,
                                 precision="highest", interpret=True, **jc)
        out = out if isinstance(out, tuple) else (out,)
        n_vol = 2 if "residual" in c else 1
        want.append([_cl(np.asarray(from_flat(t, g))) for t in out[:n_vol]]
                    + [np.asarray(t) for t in out[n_vol:]])
    for (_, _, _, c), ranks, wt in zip(cases, fut.result(), want):
        n_vol = 2 if "residual" in c else 1
        for got in ranks:  # every rank gathers the same volume
            assert len(got) == len(wt)
            for a, e in zip(got[:n_vol], wt[:n_vol]):
                np.testing.assert_allclose(a, e, atol=ATOL)
            for a, e in zip(got[n_vol:], wt[n_vol:]):
                np.testing.assert_allclose(a, e, rtol=MOMENTS_RTOL,
                                           atol=0)


def _vnet_jax(shape, n, dim, kw, monkeypatch):
    """A case's volume, weights (numpy state dict), the JAX sharded
    forward and the port's unsharded kernel path."""
    monkeypatch.setattr(jarch.VNetDS, "_use_flat",
                        lambda self, x_cf: (self.use_pallas and self.ndim == 5
                                            and self.channel_first_io
                                            and x_cf.shape[0] == 1))
    mkw = dict(VNET_BASE, **kw)
    x = np.random.default_rng(0).standard_normal(
        (1, 2) + shape).astype(np.float32)
    model = jmodels.VNetDS(**mkw, use_pallas=True)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros_like(x))
    state = {k: v.numpy() for k, v in state_dict_from_jax(
        jax.device_get(params["params"]), mkw["num_blocks"]).items()}
    return mkw, x, state, params, model


def vnet_world(n, tmp_path, monkeypatch, which):
    """Cases ``which`` of ``VNET_CASES``, all on n ranks, against the JAX
    sharded apply and the port's unsharded kernel path."""
    cases = [VNET_CASES[i] for i in which]
    assert all(c[1] == n for c in cases)
    setups = [_vnet_jax(shape, n, dim, kw, monkeypatch)
              for shape, _, dim, kw in cases]
    fut = _in_ranks(n, tmp_path, [
        (torch_rank_cases.sharded_vnet_case, (mkw, state, x, case[2]))
        for case, (mkw, x, state, _, _) in zip(cases, setups)])
    mesh = make_mesh(n_data=1, n_spatial=n)
    want = [np.asarray(jax.jit(jflat.make_flat_sharded_apply(
        model, mesh, dim=case[2]))(params, jnp.asarray(x)))
        for case, (_, x, _, params, model) in zip(cases, setups)]
    got = fut.result()
    for case, (mkw, x, state, _, _), wt, ranks in zip(cases, setups, want,
                                                     got):
        port = VNetDS(**mkw, use_kernels=True)
        port.load_state_dict({k: torch.from_numpy(v)
                              for k, v in state.items()})
        with torch.no_grad():
            unsharded = port(torch.from_numpy(x)).numpy()
        for r, out in enumerate(ranks):  # every rank returns the output
            assert out.shape == (1, 3) + case[0], (case, r, out.shape)
            np.testing.assert_allclose(out, wt, atol=ATOL,
                                       err_msg=f"{case} rank {r}")
            np.testing.assert_allclose(out, unsharded, atol=ATOL,
                                       err_msg=f"{case} rank {r}")


def test_sharded_vnet_matches_jax_on_2_ranks(tmp_path, highest, monkeypatch):
    """Two 2-rank cases: a deep level replicated, and the split along image
    axis 2 (``tests/test_torch_sharded_vnet.py`` has the other two)."""
    vnet_world(2, tmp_path, monkeypatch, [1, 2])


def test_sharded_vnet_matches_jax_on_4_ranks(tmp_path, highest, monkeypatch):
    vnet_world(4, tmp_path, monkeypatch, [3])


def test_sharding_plan_is_the_jax_plan():
    """``shard_schedule`` and ``flat_vnet_shardable`` decide as the JAX
    package's do, the flagship's 240x240x155 included (axis 2, level 0
    only over 2 ranks)."""
    for d0 in range(1, 41):
        for n in (2, 3, 4, 8):
            for ns in (1, 3, 5):
                assert (flat_sharded.shard_schedule(d0, ns, n)
                        == jflat.shard_schedule(d0, ns, n))
    for size in [(240, 240, 155), (14, 12, 12), (13, 12, 14), (16, 16, 12),
                 (30, 12, 12), (10, 12, 12)]:
        for blocks in ([1, 2, 3, 3, 3], [1, 1], [0, 1]):
            for n in (1, 2, 4):
                for resize in (True, False):
                    assert flat_sharded.flat_vnet_shardable(
                        size, blocks, resize, n) == \
                        jflat.flat_vnet_shardable(size, blocks, resize, n)
    assert flat_sharded.flat_vnet_shardable((240, 240, 155),
                                            [1, 2, 3, 3, 3], True, 2) == 2
    assert flat_sharded.shard_schedule(78, 5, 2) == [True] + [False] * 4
