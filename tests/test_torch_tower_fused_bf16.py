"""The towers' kernel path in 'bfloat16', on its plain twins, against the
JAX package's fused tower path at bf16, on the CPU; a forward that autograd
would record in a bf16 mode raises; the precision gate of a tower family
runs on the CPU.

The JAX fused path runs as its own tests run it
(``tests/test_tower_kernel.py::test_model_fused_path_bf16``): its routing
gate is monkeypatched open for the test, and the Pallas kernels run in
interpret mode; nothing in the JAX package changes. Weights pass through
``utils/jax_compat.py``; inputs are made with numpy from a seed. Bars: the
JAX tests' own 5e-2 (absolute and relative) against the JAX fused result;
and the port's mean distance from a float64 evaluation of the model at
most 2x the JAX fused result's. The port runs all three of
NeuralOperatorSeg's tower kernels against the JAX ``block`` path (the JAX
model routes only that one at bf16 outside its slow tests).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_3d_image_segmentation_tpu.models import \
    architectures as jarch
from multimodal_3d_image_segmentation_tpu.ops import spectral as jspectral
from multimodal_3d_image_segmentation_tpu_torch.models import (
    HartleyMHASeg, NeuralOperatorSeg)
from multimodal_3d_image_segmentation_tpu_torch.utils.jax_compat import \
    state_dict_from_jax

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

REPO = Path(__file__).resolve().parents[1]
# tests/test_tower_kernel.py's fused-model sizes
NOSEG = dict(in_channels=2, out_channels=3, filters=4,
             num_transform_blocks=3, num_modes=(2, 2, 2))
MHA = dict(in_channels=2, out_channels=3, filters=4, num_transform_blocks=2,
           num_heads=2, num_modes=(2, 2, 2))
X_SHAPE = (1, 2, 12, 11, 9)


@pytest.fixture(autouse=True)
def _highest(monkeypatch):
    monkeypatch.setattr(jspectral, "PRECISION", jax.lax.Precision.HIGHEST)
    monkeypatch.setattr(jspectral, "BF16_EXACT", False)


def _dist(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).mean())


def _fused(monkeypatch, jcls, tcls, kw, tower_kernel):
    """(port kernel path on its twins in 'bfloat16', JAX fused path at
    bf16, port float64 evaluation) of one model's probabilities."""
    monkeypatch.setattr(jcls, "_use_fused_tower",
                        lambda self, x: (self.use_pallas and x.shape[0] == 1
                                         and self.use_block_skip))
    x = np.random.default_rng(13).standard_normal(X_SHAPE).astype(
        np.float32)
    params = jcls(**kw).init(jax.random.PRNGKey(0),
                             jnp.zeros_like(x))["params"]
    want = np.asarray(jcls(**kw, use_pallas=True, compute_dtype="bfloat16")
                      .apply({"params": params}, jnp.asarray(x)),
                      np.float32)
    state = state_dict_from_jax(jax.device_get(params))
    port = tcls(**kw, compute_dtype="bfloat16", use_kernels=True,
                tower_kernel=tower_kernel)
    port.load_state_dict(state, strict=True)
    ref = tcls(**kw).double()
    ref.load_state_dict(state)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
        r64 = ref(torch.from_numpy(x).double()).numpy()
    return got, want, r64


def _held(got, want, r64):
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)
    assert _dist(got, r64) <= 2 * _dist(want, r64), (_dist(got, r64),
                                                    _dist(want, r64))


@pytest.mark.parametrize("tower_kernel", ["block", "block_s", "resident"])
@pytest.mark.parametrize("transform", ["Hartley", "Fourier"])
def test_neuraloperator_kernel_path_matches_the_jax_fused_path(
        monkeypatch, transform, tower_kernel):
    _held(*_fused(monkeypatch, jarch.NeuralOperatorSeg, NeuralOperatorSeg,
                  dict(NOSEG, transform_type=transform), tower_kernel))


@pytest.mark.parametrize("tower_kernel", ["block", "block_s"])
def test_hartleymha_kernel_path_matches_the_jax_fused_path(monkeypatch,
                                                           tower_kernel):
    _held(*_fused(monkeypatch, jarch.HartleyMHASeg, HartleyMHASeg, MHA,
                  tower_kernel))


@pytest.mark.parametrize("family", ["HartleyMHASeg", "HNOSeg", "FNOSeg"])
def test_a_recorded_forward_in_a_bf16_mode_raises(family):
    """Serving only: a forward that autograd would record in 'bfloat16' or
    'mixed' raises, naming ROADMAP item 12 (bf16 training); under no_grad
    it serves."""
    cls, kw = {"HartleyMHASeg": (HartleyMHASeg, MHA),
               "HNOSeg": (NeuralOperatorSeg,
                          dict(NOSEG, transform_type="Hartley")),
               "FNOSeg": (NeuralOperatorSeg,
                          dict(NOSEG, transform_type="Fourier"))}[family]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        X_SHAPE).astype(np.float32))
    for mode in ("bfloat16", "mixed"):
        for use_kernels in (False, True):
            m = cls(**kw, compute_dtype=mode, use_kernels=use_kernels)
            with pytest.raises(NotImplementedError, match="item 12"):
                m(x)
            with torch.no_grad():
                assert m(x).shape == (1, 3) + X_SHAPE[2:]


def test_precision_gate_of_a_tower_runs_on_the_cpu(tmp_path):
    """``utils/precision_gate.py --cpu --family hnoseg`` end to end at a
    tiny shape and 6 steps, in a fresh interpreter that never loads jax:
    HNOSeg's kernel paths on all three tower kernels, each bf16 mode held
    to its twins path. On the CPU every kernel path runs the twins, so
    each keeps the rule exactly; the untrained oracle's failure is the
    only one, and the 4-bit control breaks the rule."""
    out = tmp_path / "gate.json"
    code = (
        "import sys\n"
        "import torch\n"
        "torch.set_num_threads(1)  # one core, beside the other workers\n"
        "from multimodal_3d_image_segmentation_tpu_torch.utils import "
        "precision_gate\n"
        "rc = precision_gate.main(['--cpu', '--family', 'hnoseg', "
        "'--steps', '6', '--train-size', '24', '24', '16', '--eval-size', "
        f"'32', '32', '22', '--out', {str(out)!r}])\n"
        "print('RC', rc, 'jax' in sys.modules, any(\n"
        "    n.split('.')[0] == 'multimodal_3d_image_segmentation_tpu'\n"
        "    for n in sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=600)
    assert run.returncode == 0, run.stderr
    assert "RC 1 False False" in run.stdout, run.stdout[-2000:]
    res = json.loads(out.read_text())
    assert res["family"] == "hnoseg"
    assert len(res["failures"]) == 1 and "learned" in res["failures"][0]
    for kernel in ("block", "block_s", "resident"):
        for mode in ("bf16", "mixed"):
            rec = res[f"{mode}_kernels_{kernel}"]
            assert rec["rule_broken_vs_twins_on"] == []
            assert rec["max_abs_vs_twins"] == 0.0
    assert res["control_weights_4bit"]["rule_broken_vs_twins_on"]
