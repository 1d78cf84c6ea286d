"""The port's bf16 serving modes ('bfloat16' and 'mixed') against the JAX
package's, on the CPU; the kernels' bf16 twins are held to the Pallas
kernels in ``tests/test_torch_bf16_twins.py``.

The JAX side runs as its own tests run it: the module path of HNOSeg-XS
built as ``tests/test_mixed_precision.py`` builds it (``set_bf16_exact``
for 'mixed', 'highest' transform precision), the Pallas kernels in
interpret mode. Inputs are made with numpy from a seed; weights pass
through ``utils/jax_compat.py``. bf16 rounds at other places in the two
frameworks (XLA's CPU rounds after each elementwise op, torch's CPU kernels
once per op, a kernel once per stage), so the whole model is held to the
JAX result by distances, not values: each bar says where it comes from.
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

from multimodal_3d_image_segmentation_tpu import models as jmodels
from multimodal_3d_image_segmentation_tpu.ops import spectral as jspectral
from multimodal_3d_image_segmentation_tpu_torch.models import HNOSegXS
from multimodal_3d_image_segmentation_tpu_torch.ops import spectral
from multimodal_3d_image_segmentation_tpu_torch.runtime.run import \
    _build_model
from multimodal_3d_image_segmentation_tpu_torch.utils.jax_compat import \
    state_dict_from_jax

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

REPO = Path(__file__).resolve().parents[1]
# tests/test_mixed_precision.py's model and volume
SMALL = dict(in_channels=3, out_channels=4, filters=8,
             num_transform_blocks=[2] * 4, num_modes=(4, 5, 5))


def _smooth_volume(shape, c=3, seed=0):
    """tests/test_mixed_precision.py's low-frequency volume, channel-first:
    its DHT coefficients come from cancellation, so matrix rounding
    shows."""
    rng = np.random.default_rng(seed)
    grids = np.meshgrid(*[np.linspace(0, 2 * np.pi, s) for s in shape],
                        indexing="ij")
    chans = []
    for _ in range(c):
        f = np.zeros(shape)
        for _ in range(4):
            k = rng.integers(1, 4, 3)
            f = f + rng.standard_normal() * np.cos(
                k[0] * grids[0] + k[1] * grids[1] + k[2] * grids[2])
        chans.append(f)
    return np.stack(chans)[None].astype(np.float32)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX module path in fp32, 'bfloat16' and 'mixed' on one volume,
    and its weights as a torch state dict."""
    x = _smooth_volume((32, 32, 26))
    saved = jspectral.PRECISION, jspectral.BF16_EXACT
    jspectral.set_fp32_transform_precision("highest")
    out = {}
    try:
        for name, dtype, exact in (("float32", "float32", False),
                                   ("bfloat16", "bfloat16", False),
                                   ("mixed", "bfloat16", True)):
            jspectral.set_bf16_exact(exact)
            m = jmodels.HNOSegXS(**SMALL, compute_dtype=dtype)
            params = m.init(jax.random.PRNGKey(0), jnp.zeros_like(x))[
                "params"]
            out[name] = np.asarray(m.apply({"params": params},
                                           jnp.asarray(x)), np.float32)
    finally:
        jspectral.PRECISION, jspectral.BF16_EXACT = saved
    return x, out, state_dict_from_jax(jax.device_get(params))


def _port(state, x, compute_dtype, use_kernels):
    m = HNOSegXS(**SMALL, compute_dtype=compute_dtype,
                 use_kernels=use_kernels)
    m.load_state_dict(state, strict=True)
    with torch.no_grad():
        y = m(torch.from_numpy(x))
    assert y.dtype == torch.float32
    return y.numpy()


def _dist(a, b):
    return float(np.abs(a - b).mean())


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("mode", ["bfloat16", "mixed"])
def test_hnosegxs_mode_matches_jax(jax_runs, mode, use_kernels):
    """Bar: the port's mean distance from the JAX result in the same mode
    at most 2x the JAX mode's own distance from JAX fp32 (the whole-model
    rule's factor): the two frameworks round bf16 at other places, so they
    may differ by as much as one bf16 run from fp32, not more. On the CPU
    the kernel path runs the kernels' plain twins."""
    x, runs, state = jax_runs
    got = _port(state, x, mode, use_kernels)
    own = _dist(runs[mode], runs["float32"])
    assert own > 1e-4  # the mode rounds: bf16, not fp32
    assert _dist(got, runs[mode]) <= 2 * own, (_dist(got, runs[mode]), own)
    # and it is a bf16 result, not an fp32 one computed by mistake
    assert _dist(got, _port(state, x, "float32", use_kernels)) > 1e-4


@pytest.mark.parametrize("use_kernels", [False, True])
def test_hnosegxs_mixed_no_worse_than_bfloat16(jax_runs, use_kernels):
    """Bar: 'mixed' within 1.1x of 'bfloat16''s mean distance from fp32,
    the margin of tests/test_mixed_precision.py (activation-storage
    rounding dominates both); it differs from 'bfloat16'."""
    x, runs, state = jax_runs
    bf = _port(state, x, "bfloat16", use_kernels)
    mx = _port(state, x, "mixed", use_kernels)
    assert np.any(bf != mx)
    ref = runs["float32"]
    assert _dist(mx, ref) <= 1.1 * _dist(bf, ref), (_dist(mx, ref),
                                                     _dist(bf, ref))


@pytest.mark.parametrize("mixed", [False, True])
def test_transform_island_matches_jax(monkeypatch, mixed):
    """dht_crop + dht_pad_inverse on a bf16 volume, island fp32 ('mixed')
    or bf16, against the JAX pair under set_bf16_exact. Bar: a mean
    distance at most 2x the JAX result's own from float64 ('mixed' is the
    fp32 island on the same bf16 input, so it sits at fp32's class); the
    output dtype is the island's."""
    monkeypatch.setattr(jspectral, "PRECISION", jax.lax.Precision.HIGHEST)
    monkeypatch.setattr(jspectral, "BF16_EXACT", mixed)
    x64 = _smooth_volume((24, 24, 20)).transpose(0, 2, 3, 4, 1).astype(
        np.float64)
    modes = (6, 6, 6)
    xb = jnp.asarray(x64.astype(np.float32)).astype(jnp.bfloat16)
    want = np.asarray(jspectral.dht_pad_inverse(
        jspectral.dht_crop(xb, modes), x64.shape[1:-1]).astype(jnp.float32))
    exact = np.asarray(jspectral.dht_pad_inverse(
        jspectral.dht_crop(jnp.asarray(x64), modes), x64.shape[1:-1]))
    isl = torch.float32 if mixed else torch.bfloat16
    xt = torch.from_numpy(x64.astype(np.float32)).to(torch.bfloat16)
    y = spectral.dht_crop(xt, modes, isl)
    got = spectral.dht_pad_inverse(y, x64.shape[1:-1], isl)
    assert y.dtype == got.dtype == isl
    got = got.float().numpy()
    assert _dist(got, want) <= 2 * max(_dist(want, exact), 1e-7)
    if mixed:  # only the input's rounding is left
        assert _dist(got, exact) < 1e-2 * float(np.abs(exact).max())


class _Data:
    def get_num_x_modalities(self):
        return 3


@pytest.mark.parametrize("mode,dtypes", [
    ("float32", (torch.float32, torch.float32)),
    ("bfloat16", (torch.bfloat16, torch.bfloat16)),
    ("mixed", (torch.bfloat16, torch.float32))])
def test_run_config_maps_compute_dtype(mode, dtypes):
    """``[model] compute_dtype`` reaches the model by name ('mixed' is the
    reference's 'bfloat16' with set_bf16_exact), as the JAX package's
    tests/test_mixed_precision.py checks its mapping."""
    cfg = {"model": {"model_name": "HNOSegXS", "out_channels": 4,
                     "filters": 8, "num_transform_blocks": [2, 2],
                     "num_modes": [4, 5, 5], "compute_dtype": mode}}
    model = _build_model(cfg, _Data(), lambda: (32, 32, 26))
    assert model.compute_dtype == mode
    assert spectral.compute_dtypes(mode) == dtypes
    assert all(m.compute_dtype == mode for m in model.modules()
               if hasattr(m, "compute_dtype"))


def test_precision_gate_runs_on_the_cpu(tmp_path):
    """``utils/precision_gate.py --cpu`` end to end at a tiny shape and 6
    steps, in a fresh interpreter that never loads jax. An untrained
    network has not learned every class, so the gate reports that failure
    and exits 1; every mode has its readings."""
    out = tmp_path / "gate.json"
    code = (
        "import sys\n"
        "import torch\n"
        "torch.set_num_threads(1)  # one core, beside the other workers\n"
        "from multimodal_3d_image_segmentation_tpu_torch.utils import "
        "precision_gate\n"
        "rc = precision_gate.main(['--cpu', '--steps', '6', '--train-size',"
        " '32', '32', '24', '--eval-size', '40', '40', '30', "
        f"'--out', {str(out)!r}])\n"
        "print('RC', rc, 'jax' in sys.modules, any(\n"
        "    n.split('.')[0] == 'multimodal_3d_image_segmentation_tpu'\n"
        "    for n in sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=300)
    assert run.returncode == 0, run.stderr
    assert run.stdout.splitlines()[-1].split() == ["RC", "1", "False",
                                                   "False"]
    res = json.loads(out.read_text())
    from multimodal_3d_image_segmentation_tpu_torch.utils import \
        precision_gate
    for name in precision_gate.MODES:
        assert len(res[name]["per_class_dice_mean"]) == 3
    for name in ("bf16_kernels", "mixed_kernels"):
        assert 0 <= res[name]["argmax_agreement_vs_plain"] <= 1
        assert "dice_bar_met" in res[name]
        # on the CPU each wrapper runs its twin: the rule holds exactly
        assert res[name]["argmax_agreement_vs_twins"] == 1.0
        assert res[name]["rule_broken_vs_twins_on"] == []
    assert res["bf16_twins64"]["argmax_agreement_vs_twins"] < 1.0
    assert "rule_broken_vs_twins_on" in res[precision_gate.CONTROL]
    assert not res["fp32_plain"]["all_classes_learned"]
    assert len(res["failures"]) == 1 and "learned" in res["failures"][0]
    assert set(res["activations_fp32"]) == {"conv_in", "conv1"} | {
        f"layers_{i}" for i in range(8)}
