"""HartleyMHASeg, HNOSeg and FNOSeg in the serving modes 'bfloat16' and
'mixed' against the JAX package's module path in the same mode, on the
CPU: the port's module path and its kernel path (each kernel wrapper runs
its plain twin on the CPU).

The JAX side runs as its own tests run it: ``compute_dtype="bfloat16"``,
with ``set_bf16_exact(True)`` for 'mixed', and ``ops/spectral.PRECISION``
pinned to HIGHEST; both flags are restored. Weights pass through
``utils/jax_compat.py``; inputs are made with numpy from a seed. bf16
rounds at other places in the two frameworks, so a whole model is held by
distances (the mean absolute difference of the probabilities), not
values, with the bars of ``tests/test_torch_mixed_precision.py``: the
port's distance from the JAX result in the same mode at most 2x that JAX
result's own distance from JAX fp32; and the port's distance from a
float64 evaluation of the model at most 2x the JAX result's.
"""
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

NOSEG = dict(in_channels=2, out_channels=3, filters=8,
             num_transform_blocks=3, num_modes=(2, 3, 2))
MHA = dict(in_channels=2, out_channels=3, filters=8, num_transform_blocks=2,
           num_heads=2, num_modes=(2, 2, 2), patch_size=2)
X_SHAPE = (1, 2, 12, 12, 10)
# family -> (JAX class, port class, kwargs)
FAMILIES = {
    "HartleyMHASeg": (jarch.HartleyMHASeg, HartleyMHASeg, MHA),
    "HNOSeg": (jarch.NeuralOperatorSeg, NeuralOperatorSeg,
               dict(NOSEG, transform_type="Hartley")),
    "FNOSeg": (jarch.NeuralOperatorSeg, NeuralOperatorSeg,
               dict(NOSEG, transform_type="Fourier")),
}


def _dist(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).mean())


@pytest.fixture(scope="module", params=list(FAMILIES))
def jax_runs(request):
    """A family's JAX module path in fp32, 'bfloat16' and 'mixed' on one
    volume, its weights as a torch state dict, and the port's float64
    evaluation of the same weights."""
    name = request.param
    jcls, tcls, kw = FAMILIES[name]
    x = np.random.default_rng(7).standard_normal(X_SHAPE).astype(np.float32)
    saved = jspectral.PRECISION, jspectral.BF16_EXACT
    jspectral.set_fp32_transform_precision("highest")
    out = {}
    try:
        params = jcls(**kw).init(jax.random.PRNGKey(0),
                                 jnp.zeros_like(x))["params"]
        for mode, dtype, exact in (("float32", "float32", False),
                                   ("bfloat16", "bfloat16", False),
                                   ("mixed", "bfloat16", True)):
            jspectral.set_bf16_exact(exact)
            out[mode] = np.asarray(jcls(**kw, compute_dtype=dtype).apply(
                {"params": params}, jnp.asarray(x)), np.float32)
    finally:
        jspectral.PRECISION, jspectral.BF16_EXACT = saved
    state = state_dict_from_jax(jax.device_get(params))
    ref = tcls(**kw).double()
    ref.load_state_dict(state)
    with torch.no_grad():
        out["float64"] = ref(torch.from_numpy(x).double()).numpy()
    return name, x, out, state


def _port(name, state, x, compute_dtype, use_kernels):
    _, tcls, kw = FAMILIES[name]
    m = tcls(**kw, compute_dtype=compute_dtype, use_kernels=use_kernels)
    m.load_state_dict(state, strict=True)
    with torch.no_grad():
        y = m(torch.from_numpy(x))
    assert y.dtype == torch.float32
    return y.numpy()


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["module", "kernels"])
@pytest.mark.parametrize("mode", ["bfloat16", "mixed"])
def test_mode_matches_the_jax_module_path(jax_runs, mode, use_kernels):
    """The port in ``mode`` against the JAX module path in ``mode`` (module
    docstring's two bars); and it is a bf16 result, not an fp32 one
    computed by mistake."""
    name, x, runs, state = jax_runs
    got = _port(name, state, x, mode, use_kernels)
    own = _dist(runs[mode], runs["float32"])
    assert own > 1e-5, own  # the JAX mode rounds: bf16, not fp32
    assert _dist(got, runs[mode]) <= 2 * own, (_dist(got, runs[mode]), own)
    assert (_dist(got, runs["float64"])
            <= 2 * _dist(runs[mode], runs["float64"])), (
        _dist(got, runs["float64"]), _dist(runs[mode], runs["float64"]))
    assert _dist(got, _port(name, state, x, "float32", use_kernels)) > 1e-6
