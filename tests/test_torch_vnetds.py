"""The port's V-Net-DS against the JAX package's, on the CPU.

Weights pass from JAX to torch through ``utils/jax_compat.py``; inputs are
made with numpy from a seed. The JAX side is the module path (its flat
kernel path is gated to the TPU). Tolerance: 3e-5 on probabilities, the
bar of the JAX package's own flat-vs-module test
(``tests/test_kernels.py``): both sides are fp32 and differ in summation
order and in how GroupNorm's variance is formed.
"""
from io import StringIO
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_3d_image_segmentation_tpu import models as jmodels
from multimodal_3d_image_segmentation_tpu.data.dataset import InputData
from multimodal_3d_image_segmentation_tpu.data.nifti import (read_img,
                                                            write_image)
from multimodal_3d_image_segmentation_tpu.data.normalization import \
    normalize_modalities
from multimodal_3d_image_segmentation_tpu.runtime.train_test import \
    testing as jtesting
from multimodal_3d_image_segmentation_tpu.utils.torch_compat import \
    export_reference_state_dict
from multimodal_3d_image_segmentation_tpu_torch import kernels
from multimodal_3d_image_segmentation_tpu_torch.models import VNetDS
from multimodal_3d_image_segmentation_tpu_torch.runtime import config
from multimodal_3d_image_segmentation_tpu_torch.runtime.inference import \
    run_inference
from multimodal_3d_image_segmentation_tpu_torch.runtime.run import \
    _build_model
from multimodal_3d_image_segmentation_tpu_torch.utils.jax_compat import \
    state_dict_from_jax

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

REPO = Path(__file__).resolve().parent.parent
PROB_ATOL = 3e-5
CONFIG_WIDTH = dict(in_channels=4, out_channels=4, base_num_filters=24,
                    num_blocks=[1, 2, 3, 3, 3],
                    right_leg_indexes=[0, 1, 2, 3, 4])
# the configurations of tests/test_kernels.py's flat-vs-module test
CONFIGS = [
    dict(in_channels=2, out_channels=3, base_num_filters=4,
         num_blocks=[1, 2, 2], right_leg_indexes=[0, 1, 2]),
    dict(in_channels=2, out_channels=3, base_num_filters=4,
         num_blocks=[1, 2], right_leg_indexes=[0],
         activation="selu", use_snn=True),
    dict(in_channels=2, out_channels=3, base_num_filters=4,
         num_blocks=[1, 1], use_residual=False, use_resize=False),
    dict(in_channels=2, out_channels=3, base_num_filters=4,
         num_blocks=[0], right_leg_indexes=[0]),
]


def _x(shape=(1, 2, 16, 16, 12), seed=7):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax(kw, x):
    jm = jmodels.VNetDS(**kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    return jm, params


def _sd(kw, params):
    return state_dict_from_jax(jax.device_get(params), kw["num_blocks"],
                               kw.get("use_residual", True))


def _gn_bias(key):
    return ".normalization.bias" in key


def test_config_width_parameter_count():
    tm = VNetDS(**CONFIG_WIDTH, use_kernels=True)
    assert sum(p.numel() for p in tm.parameters()) == 22547764


@pytest.mark.parametrize("kw", CONFIGS[:3], ids=["gn", "snn", "nores"])
def test_state_dict_from_jax_equals_reference_export(kw):
    """Same keys and values as ``export_reference_state_dict``. The one
    difference is a layout fault of that export: it reshapes GroupNorm
    biases to (1, C, 1, 1, 1), the spectral operators' bias layout, where
    torch's GroupNorm (the reference's) stores (C,); the port keeps (C,)."""
    jm, params = _jax(kw, _x())
    ref = export_reference_state_dict(jm, params)
    got = _sd(kw, params)
    assert set(got) == set(ref)
    for k, v in ref.items():
        if _gn_bias(k):
            assert v.shape == (1, v.size, 1, 1, 1)
            v = v.reshape(-1)
        assert tuple(got[k].shape) == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), v)
    own = {k: tuple(t.shape) for k, t in VNetDS(**kw).state_dict().items()}
    assert own == {k: tuple(t.shape) for k, t in got.items()}


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("kw", CONFIGS, ids=["gn", "snn", "nores", "zero"])
def test_vnetds_matches_jax_module_path(kw, use_kernels):
    x = _x()
    jm, params = _jax(kw, x)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = VNetDS(**kw, use_kernels=use_kernels)
    tm.load_state_dict(_sd(kw, params), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=PROB_ATOL)


def test_kernel_path_counts_no_launch_on_cpu_and_takes_odd_sizes():
    """On CPU tensors the kernel path runs every kernel's plain version
    (no launch counted) and equals the module path, at odd sizes too."""
    kw = CONFIGS[0]
    x = torch.from_numpy(_x((1, 2, 13, 11, 9), 3))
    plain = VNetDS(**kw)
    fast = VNetDS(**kw, use_kernels=True)
    fast.load_state_dict(plain.state_dict())
    before = dict(kernels.LAUNCHES)
    with torch.no_grad():
        torch.testing.assert_close(fast(x), plain(x), rtol=0, atol=PROB_ATOL)
    assert kernels.LAUNCHES == before


def test_float64_model_is_a_reference_for_the_fp32_model():
    kw = CONFIGS[0]
    x = torch.from_numpy(_x())
    m = VNetDS(**kw, use_kernels=True)
    ref = VNetDS(**kw).double()
    ref.load_state_dict(m.state_dict())
    with torch.no_grad():
        got, want = m(x), ref(x.double())
    assert want.dtype == torch.float64 and got.dtype == torch.float32
    assert float((got.double() - want).abs().max()) < 1e-5


@pytest.mark.parametrize("opts,exc", [
    (dict(ndim=4), NotImplementedError),
    (dict(compute_dtype="bfloat16"), NotImplementedError),
    (dict(compute_dtype="mixed"), NotImplementedError),
    (dict(spatial_shard=("spatial", 2)), NotImplementedError),
    (dict(use_kernels=True, kernel_size=5), ValueError),
    (dict(use_kernels=True, channel_first_io=False), ValueError),
    (dict(right_leg_indexes=[1, 2]), ValueError),
])
def test_unported_options_raise(opts, exc):
    with pytest.raises(exc, match="ROADMAP" if exc is NotImplementedError
                       else None):
        VNetDS(**{**CONFIGS[0], **opts})


def test_kernel_path_refuses_batch_2():
    m = VNetDS(**CONFIGS[0], use_kernels=True)
    with pytest.raises(ValueError, match="batch 1"):
        with torch.no_grad():
            m(torch.zeros(2, 2, 8, 8, 8))


class _Sizes:
    def get_num_x_modalities(self):
        return 4


def test_build_model_from_the_vnet_ds_config():
    cfg = config.get_config(str(REPO / "configs" / "config_vnet-ds.ini"))
    model = _build_model(cfg, _Sizes(), lambda: (240, 240, 155))
    assert isinstance(model, VNetDS) and model.use_kernels  # use_pallas
    assert model.right_leg_indexes == [0, 1, 2, 3, 4]
    assert sum(p.numel() for p in model.parameters()) == 22547764


SHAPE = (16, 16, 12)
SERVE_MODEL = CONFIGS[0]
SERVE_CONFIG = """
[main]
output_dir = '{out}'
visible_devices = 'cpu'

[input_lists]
data_dir = '{data}'
data_lists_test_paths = [{lists}]

[input_args]
idx_x_modalities = [0, 1]
idx_y_modalities = [2]
batch_size = 1
num_workers = 0
use_data_normalization = True

[model]
model_name = 'VNetDS'
out_channels = 3
base_num_filters = 4
num_blocks = [1, 2, 2]
right_leg_indexes = [0, 1, 2]
use_pallas = True
transform_precision = 'high'

[test]
output_folder = 'inference'
"""


def test_serving_vnet_ds_matches_jax_testing(tmp_path):
    """run_inference serves V-Net-DS with ``visible_devices = 'cpu'``; its
    label maps match the JAX engine's testing() with the same weights."""
    rng = np.random.default_rng(0)
    data, lists = tmp_path / "data", []
    for m in ("t1", "t2", "seg"):
        names = []
        for i in range(2):
            vol = (rng.integers(0, 3, SHAPE).astype(np.uint8) if m == "seg"
                   else (rng.standard_normal(SHAPE) + 3).astype(np.float32))
            write_image(vol, data / f"case{i}" / f"{m}.nii.gz")
            names.append(f"case{i}/{m}.nii.gz")
        p = data / f"{m}.txt"
        p.write_text("\n".join(names) + "\n")
        lists.append(str(p))
    cfg = config.get_config(StringIO(SERVE_CONFIG.format(
        out=tmp_path / "out", data=data,
        lists=", ".join(f"'{p}'" for p in lists))), "serve.ini")

    jm, params = _jax(SERVE_MODEL, np.zeros((1, 2) + SHAPE, np.float32))
    data_lists = [[str(data / n) for n in Path(p).read_text().splitlines()]
                  for p in lists]
    input_data = InputData(reader=read_img, data_lists_test=data_lists,
                           idx_x_modalities=[0, 1], idx_y_modalities=[2],
                           x_processing=normalize_modalities, batch_size=1,
                           num_workers=0)
    jtesting(jm, params, input_data, str(tmp_path / "jax"), is_print=False)

    (tmp_path / "out" / "model").mkdir(parents=True)
    torch.save(_sd(SERVE_MODEL, params), tmp_path / "out" / "model" /
               "model.pt")
    stats = run_inference(cfg)
    assert stats["n_volumes"] == 2
    for i in range(2):
        want = read_img(str(tmp_path / "jax" / "images" /
                            f"case{i}_pred.nii.gz"))
        got = read_img(str(tmp_path / "out" / "inference" / "images" /
                           f"case{i}_pred.nii.gz"))
        assert got.shape == SHAPE
        assert np.mean(got != want) <= 1e-4
