"""V-Net-DS in the serving modes 'bfloat16' and 'mixed' against the JAX
package in the same mode, on the CPU: the port's module path against the
JAX module path (``VNetDS.__call__``), and its kernel path (each kernel
wrapper runs its plain twin on the CPU) against the JAX flat path
(``_flat_forward``, the Pallas conv3 in interpret mode), which its own
tests reach by monkeypatching ``_use_flat`` (``tests/test_kernels.py``,
``test_vnetds_flat_bf16``).

The JAX side runs with ``compute_dtype="bfloat16"``, ``set_bf16_exact(True)``
for 'mixed' and ``ops/spectral.PRECISION`` pinned to HIGHEST, all by
``monkeypatch``. Weights pass through ``utils/jax_compat.py``; inputs are
made with numpy from a seed. bf16 rounds at other places in the two
frameworks (XLA on the CPU also rounds inside its bf16 convolutions, which
the card's fp32 sums do not), so a whole model is held by distances (the
mean absolute difference of the probabilities): the port's distance from a
float64 evaluation of the model at most 2x the JAX path's, and the share
of voxels whose argmax differs from the JAX path's at most 1%. Two variants
at small widths: GroupNorm + ELU, and the self-normalizing SELU one.
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
from multimodal_3d_image_segmentation_tpu.models import \
    architectures as jarch
from multimodal_3d_image_segmentation_tpu.ops import spectral as jspectral
from multimodal_3d_image_segmentation_tpu_torch import kernels
from multimodal_3d_image_segmentation_tpu_torch.models import VNetDS
from multimodal_3d_image_segmentation_tpu_torch.utils.jax_compat import \
    state_dict_from_jax

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

REPO = Path(__file__).resolve().parent.parent
BASE = dict(in_channels=2, out_channels=3, base_num_filters=4,
            num_blocks=[1, 2, 2], right_leg_indexes=[0, 1, 2])
VARIANTS = {"gn": BASE,
            "snn": dict(BASE, activation="selu", use_snn=True)}
X_SHAPE = (1, 2, 16, 16, 12)
MODES = ("bfloat16", "mixed")
DISAGREE = 0.01


def _dist(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).mean())


def _disagree(a, b):
    return float((np.asarray(a).argmax(1) != np.asarray(b).argmax(1)).mean())


@pytest.fixture(scope="module", params=list(VARIANTS))
def jax_runs(request):
    """A variant's JAX module and flat paths in both modes on one volume,
    its weights as a torch state dict, and the port's float64 evaluation
    of the same weights."""
    kw = VARIANTS[request.param]
    x = np.random.default_rng(7).standard_normal(X_SHAPE).astype(np.float32)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jspectral, "PRECISION", jax.lax.Precision.HIGHEST)
        mp.setattr(jarch.VNetDS, "_use_flat",
                   lambda self, x_cf: self.use_pallas and x_cf.shape[0] == 1)
        params = jmodels.VNetDS(**kw).init(jax.random.PRNGKey(0),
                                           jnp.asarray(x))["params"]
        for mode in MODES:
            mp.setattr(jspectral, "BF16_EXACT", mode == "mixed")
            for path in ("module", "kernels"):
                out[mode, path] = np.asarray(jmodels.VNetDS(
                    **kw, compute_dtype="bfloat16",
                    use_pallas=path == "kernels").apply(
                        {"params": params}, jnp.asarray(x)), np.float32)
    state = state_dict_from_jax(jax.device_get(params), kw["num_blocks"])
    ref = VNetDS(**kw).double()
    ref.load_state_dict(state)
    with torch.no_grad():
        out["float64"] = ref(torch.from_numpy(x).double()).numpy()
    return request.param, x, out, state


@pytest.mark.parametrize("path", ["module", "kernels"])
@pytest.mark.parametrize("mode", MODES)
def test_mode_matches_the_jax_path(jax_runs, mode, path):
    """The port's path in ``mode`` against the JAX path in ``mode`` (the
    module docstring's bars); a bf16 result, not an fp32 one computed by
    mistake, and the kernel path counts no launch on the CPU."""
    variant, x, runs, state = jax_runs
    m = VNetDS(**VARIANTS[variant], compute_dtype=mode,
               use_kernels=path == "kernels")
    m.load_state_dict(state, strict=True)
    before = dict(kernels.LAUNCHES)
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    assert kernels.LAUNCHES == before
    assert got.dtype == torch.float32 and got.shape == X_SHAPE[:1] + (3,) \
        + X_SHAPE[2:]
    got = got.numpy()
    want, ref = runs[mode, path], runs["float64"]
    own = _dist(want, ref)
    assert own > 1e-5, own  # the JAX mode rounds: bf16, not fp32
    assert _dist(got, ref) <= 2 * own, (_dist(got, ref), own)
    assert _disagree(got, want) <= DISAGREE, _disagree(got, want)
    assert _dist(got, ref) > 1e-5  # and so does the port's


def test_recorded_bf16_forward_raises():
    """A bf16 forward that autograd would record raises, naming item 12,
    on both paths; under no_grad it serves."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        X_SHAPE).astype(np.float32))
    for mode in MODES:
        for use_kernels in (False, True):
            m = VNetDS(**BASE, compute_dtype=mode, use_kernels=use_kernels)
            with pytest.raises(NotImplementedError, match="item 12"):
                m(x)
            with torch.no_grad():
                assert m(x).shape == (1, 3) + X_SHAPE[2:]


def test_precision_gate_of_vnetds_runs_on_the_cpu(tmp_path):
    """``utils/precision_gate.py --cpu --family vnetds`` end to end at a
    tiny shape and 6 steps, in a fresh interpreter that never loads jax:
    each bf16 mode's kernel path held to its twins path (conv3's twin
    ``conv3_plain``). On the CPU every kernel path runs the twins, so each
    keeps the rule exactly; the untrained oracle's failure is the only
    one, and the 4-bit control on the conv3 weights breaks the rule."""
    out = tmp_path / "gate.json"
    code = (
        "import sys\n"
        "import torch\n"
        "torch.set_num_threads(1)  # one core, beside the other workers\n"
        "from multimodal_3d_image_segmentation_tpu_torch.utils import "
        "precision_gate\n"
        "rc = precision_gate.main(['--cpu', '--family', 'vnetds', "
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
    assert res["family"] == "vnetds"
    assert len(res["failures"]) == 1 and "learned" in res["failures"][0]
    for mode in ("bf16", "mixed"):
        rec = res[f"{mode}_kernels"]
        assert rec["rule_broken_vs_twins_on"] == []
        assert rec["max_abs_vs_twins"] == 0.0
    assert res["control_weights_4bit"]["rule_broken_vs_twins_on"]
    assert "rule_broken_vs_twins_on" in res["probe_prologue_unrounded"]
    assert set(res["activations_fp32"]) >= {"conv_in", "encode_0",
                                            "decode_0"}


def test_precision_gate_trains_deterministically():
    """The V-Net-DS gate trains under PyTorch's deterministic algorithms
    (its verdict must not hang on the order of the backward passes'
    sums): two trainings give the same weights to the bit, and the global
    settings are on inside the context and restored after it."""
    from multimodal_3d_image_segmentation_tpu_torch.utils import \
        precision_gate
    assert "vnetds" in precision_gate.DETERMINISTIC_TRAINING

    def settings():
        return (torch.are_deterministic_algorithms_enabled(),
                torch.backends.cudnn.benchmark,
                os.environ.get("CUBLAS_WORKSPACE_CONFIG"))

    before = settings()
    with precision_gate._deterministic():
        inside = settings()
    assert inside[0] and not inside[1] and inside[2] is not None
    assert settings() == before
    runs = [precision_gate.train(torch.device("cpu"), 2, (16, 16, 12), 2,
                                 family="vnetds") for _ in range(2)]
    assert settings() == before
    (s1, h1, _), (s2, h2, _) = runs
    assert h1 == h2 and s1.keys() == s2.keys()
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
