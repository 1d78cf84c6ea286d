"""The port's serving entry against the JAX package's, on the CPU.

Two tiny synthetic NIfTI cases go through ``runtime/inference.py`` of the
port and through the JAX ``testing()`` with the same weights; the label
maps must agree (at most 1e-4 of the voxels may differ, on argmax ties
between fp32 summation orders).
"""
import os
import subprocess
import sys
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
from multimodal_3d_image_segmentation_tpu.runtime import \
    config as jconfig
from multimodal_3d_image_segmentation_tpu.runtime.train_test import \
    testing as jtesting
from multimodal_3d_image_segmentation_tpu.utils import labels as jlabels
from multimodal_3d_image_segmentation_tpu_torch.device import resolve_device
from multimodal_3d_image_segmentation_tpu_torch.runtime import config
from multimodal_3d_image_segmentation_tpu_torch.runtime.inference import \
    run_inference
from multimodal_3d_image_segmentation_tpu_torch.runtime.run import \
    _build_model
from multimodal_3d_image_segmentation_tpu_torch.utils.jax_compat import \
    state_dict_from_jax
from multimodal_3d_image_segmentation_tpu_torch.utils.labels import \
    remap_labels

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

REPO = Path(__file__).resolve().parent.parent
SHAPE = (16, 16, 12)
MODEL = dict(out_channels=3, filters=8, num_transform_blocks=[2, 2, 2],
             num_modes=(3, 4, 4))

CONFIG = """
[main]
output_dir = '{out}'
is_train = False
is_test = True
is_statistics = False
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
model_name = 'HNOSegXS'
out_channels = 3
filters = 8
num_transform_blocks = [2, 2, 2]
num_modes = (3, 4, 4)
use_pallas = {use_pallas}
transform_precision = 'high'

[test]
output_folder = 'inference'
"""


def _write_cases(root: Path):
    rng = np.random.default_rng(0)
    lists = []
    for m in ("t1", "t2", "seg"):
        names = []
        for i in range(2):
            if m == "seg":
                vol = rng.integers(0, 3, SHAPE).astype(np.uint8)
            else:
                vol = (rng.standard_normal(SHAPE) + 3).astype(np.float32)
            write_image(vol, root / f"case{i}" / f"{m}.nii.gz")
            names.append(f"case{i}/{m}.nii.gz")
        p = root / f"{m}.txt"
        p.write_text("\n".join(names) + "\n")
        lists.append(str(p))
    return lists


def _cfg(tmp_path, use_pallas=True):
    data = tmp_path / "data"
    lists = _write_cases(data)
    text = CONFIG.format(out=tmp_path / "out", data=data,
                         lists=", ".join(f"'{p}'" for p in lists),
                         use_pallas=use_pallas)
    return config.get_config(StringIO(text), "serve.ini"), lists


@pytest.mark.parametrize("use_pallas", [True, False])
def test_serving_matches_jax_testing(tmp_path, use_pallas):
    cfg, lists = _cfg(tmp_path, use_pallas)
    data_lists = [[str(tmp_path / "data" / n)
                   for n in Path(p).read_text().splitlines()] for p in lists]

    # JAX: the same model and the engine's testing() on the same lists
    jm = jmodels.HNOSegXS(in_channels=2, **MODEL, use_pallas=use_pallas)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 2) + SHAPE))["params"]
    input_data = InputData(reader=read_img, data_lists_test=data_lists,
                           idx_x_modalities=[0, 1], idx_y_modalities=[2],
                           x_processing=normalize_modalities, batch_size=1,
                           num_workers=0)
    jax_dir = tmp_path / "jax"
    jtesting(jm, params, input_data, str(jax_dir), is_print=False)

    # the port: weights converted to model.pt, served through the CLI entry
    (tmp_path / "out" / "model").mkdir(parents=True)
    torch.save(state_dict_from_jax(jax.device_get(params)),
               tmp_path / "out" / "model" / "model.pt")
    stats = run_inference(cfg)
    assert stats["n_volumes"] == 2

    port_dir = tmp_path / "out" / "inference"
    for i in range(2):
        want = read_img(str(jax_dir / "images" / f"case{i}_pred.nii.gz"))
        got = read_img(str(port_dir / "images" / f"case{i}_pred.nii.gz"))
        assert got.shape == SHAPE
        assert set(np.unique(got).tolist()) <= {0, 1, 2}
        assert np.mean(got != want) <= 1e-4
        np.testing.assert_array_equal(
            read_img(str(port_dir / "images" / f"case{i}_true.nii.gz")),
            read_img(str(jax_dir / "images" / f"case{i}_true.nii.gz")))
    lines = (port_dir / "prediction_time_memory.txt").read_text().splitlines()
    assert lines[0].startswith("Average prediction time: ")
    assert lines[1].startswith("peak_device_memory: ")
    assert lines[2].startswith("device_memory_in_use: ")


def test_port_never_imports_jax(tmp_path):
    """A fresh interpreter that imports the port (its training, metrics and
    run modules too), parses a config, runs CPU forwards of every model and
    a train step never loads jax, flax or any module of the JAX package,
    nor pandas or matplotlib (the card's host has neither)."""
    code = (
        "import sys, torch\n"
        "from multimodal_3d_image_segmentation_tpu_torch import losses, "
        "metrics, surfels\n"
        "from multimodal_3d_image_segmentation_tpu_torch.runtime import "
        "checkpoint, optim, run, steps, train_test\n"
        "from multimodal_3d_image_segmentation_tpu_torch.data import "
        "augmentation, dataset\n"
        "from multimodal_3d_image_segmentation_tpu_torch.models import "
        "HartleyMHASeg, HNOSegXS, NeuralOperatorSeg, VNetDS\n"
        "import multimodal_3d_image_segmentation_tpu_torch.kernels."
        "tower_block_s\n"
        "import multimodal_3d_image_segmentation_tpu_torch.ops.operators\n"
        "from multimodal_3d_image_segmentation_tpu_torch.runtime import "
        "inference, config\n"
        "from multimodal_3d_image_segmentation_tpu_torch.utils import "
        "jax_compat, labels, precision_gate\n"
        "import multimodal_3d_image_segmentation_tpu_torch.data\n"
        "import multimodal_3d_image_segmentation_tpu_torch.kernels\n"
        "torch.set_num_threads(1)\n"
        "m = HNOSegXS(2, 3, 8, [2, 2], (3, 4, 4), use_kernels=True)\n"
        "with torch.no_grad():\n"
        "    y = m(torch.randn(1, 2, 12, 10, 8))\n"
        "assert y.shape == (1, 3, 12, 10, 8)\n"
        "opt = optim.build_optimizer({'optimizer_name': 'Adamax'}, "
        "m.parameters())\n"
        "steps.make_train_step(m, opt, None, losses.PCCLoss(), 3)(\n"
        "    torch.randn(1, 2, 12, 10, 8), torch.zeros(1, 1, 12, 10, 8))\n"
        "v = VNetDS(2, 3, 4, [1, 1], right_leg_indexes=[0, 1], "
        "use_kernels=True)\n"
        "with torch.no_grad():\n"
        "    assert v(torch.randn(1, 2, 12, 10, 8)).shape == (1, 3, 12, 10, 8)\n"
        "a = HartleyMHASeg(2, 3, 4, 2, 2, (2, 2, 2), patch_size=2, "
        "use_kernels=True)\n"
        "with torch.no_grad():\n"
        "    assert a(torch.randn(1, 2, 12, 10, 8)).shape == (1, 3, 12, 10, 8)\n"
        "for t in ('Hartley', 'Fourier'):\n"
        "    for k in ('block', 'block_s', 'resident'):\n"
        "        n = NeuralOperatorSeg(2, 3, 4, 2, (2, 2, 2), t, "
        "use_kernels=True, tower_kernel=k)\n"
        "        with torch.no_grad():\n"
        "            assert n(torch.randn(1, 2, 12, 10, 8)).shape == "
        "(1, 3, 12, 10, 8)\n"
        f"config.get_config({str(REPO / 'configs' / 'config_inference_hnoseg_xs.ini')!r})\n"
        "print('jax' in sys.modules, 'flax' in sys.modules, any(\n"
        "    n.split('.')[0] == 'multimodal_3d_image_segmentation_tpu'\n"
        "    for n in sys.modules), 'pandas' in sys.modules,\n"
        "    'matplotlib' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False"] * 5


def test_get_config_matches_jax():
    path = str(REPO / "configs" / "config_inference_hnoseg_xs.ini")
    got, want = config.get_config(path), jconfig.get_config(path)
    assert got.keys() == want.keys()
    for k in got:
        if k != "config":
            assert got[k] == want[k]
    assert got["config"].getvalue() == want["config"].getvalue()


class _Sizes:
    def get_num_x_modalities(self):
        return 4


class _Sizes2:
    def get_num_x_modalities(self):
        return 2


def test_build_model_from_the_serving_config():
    cfg = config.get_config(
        str(REPO / "configs" / "config_inference_hnoseg_xs.ini"))
    model = _build_model(cfg, _Sizes(), lambda: (240, 240, 155))
    assert model.use_kernels  # [model] use_pallas = True
    assert sum(p.numel() for p in model.parameters()) == 28248

    cfg["model"]["transform_precision"] = "default"
    with pytest.raises(ValueError, match="transform_precision"):
        _build_model(cfg, _Sizes(), lambda: (240, 240, 155))
    cfg["model"]["transform_precision"] = "highest"
    cfg["model"].update(model_name="NeuralOperatorSeg",
                        num_transform_blocks=2, weights_type="individual")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _build_model(cfg, _Sizes(), lambda: (240, 240, 155))


def test_parallel_section_is_refused():
    cfg = config.get_config(
        str(REPO / "configs" / "config_inference_hnoseg_xs.ini"))
    cfg["parallel"] = {"n_data": 1, "n_spatial": 2}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_inference(cfg)


def test_autocast_warns_and_serves(tmp_path, capsys):
    """``[test] use_autocast`` is ignored with a warning pointing to
    ``[model] compute_dtype``, as the JAX package's run_inference does, and
    the volumes are served."""
    cfg, _ = _cfg(tmp_path)
    (tmp_path / "out" / "model").mkdir(parents=True)
    torch.save(_build_model(cfg, _Sizes2(), lambda: SHAPE).state_dict(),
               tmp_path / "out" / "model" / "model.pt")
    cfg["test"]["use_autocast"] = True
    stats = run_inference(cfg)
    assert "[test] use_autocast is ignored" in capsys.readouterr().out
    assert stats["n_volumes"] == 2  # _write_cases' two cases


@pytest.mark.parametrize("as_tensor", [False, True])
def test_remap_labels_matches_jax(as_tensor):
    y = np.random.default_rng(1).integers(0, 5, (6, 7)).astype(np.uint8)
    mapping = {1: 2, 2: 3, 4: 0}
    want = np.asarray(jlabels.remap_labels(y, mapping))
    got = remap_labels(torch.from_numpy(y) if as_tensor else y, mapping)
    np.testing.assert_array_equal(np.asarray(got), want)
    assert remap_labels(y, None) is y


def test_resolve_device_without_cuda(monkeypatch):
    """Without CUDA only an explicit CPU request serves; anything else
    raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for asked in ("0", 0, None, torch.device("cuda", 0)):
        with pytest.raises(RuntimeError, match="visible_devices = 'cpu'"):
            resolve_device(asked)
    for asked in ("cpu", " CPU ", torch.device("cpu")):
        assert resolve_device(asked) == torch.device("cpu")


def test_profiling_busy_time_is_the_union_of_intervals():
    from multimodal_3d_image_segmentation_tpu_torch.utils.profiling import \
        _busy_us
    assert _busy_us([]) == 0.0
    assert _busy_us([(0, 4), (2, 6), (10, 11), (3, 5)]) == 7.0


MHA_CONFIG = """
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
model_name = 'HartleyMHASeg'
out_channels = 3
filters = 4
num_transform_blocks = 2
num_heads = 2
num_modes = (2, 2, 2)
patch_size = 2
use_pallas = True
transform_precision = 'high'

[test]
output_folder = 'inference'
"""


def test_serving_hartleymha_matches_jax_testing(tmp_path, monkeypatch):
    """run_inference serves a tiny HartleyMHASeg on its kernel path (plain
    versions on the CPU); its label maps match the JAX engine's testing()
    (the JAX module path; its fused path is gated to the TPU) with the same
    weights."""
    from multimodal_3d_image_segmentation_tpu.ops import spectral
    monkeypatch.setattr(spectral, "PRECISION", jax.lax.Precision.HIGHEST)
    lists = _write_cases(tmp_path / "data")
    cfg = config.get_config(StringIO(MHA_CONFIG.format(
        out=tmp_path / "out", data=tmp_path / "data",
        lists=", ".join(f"'{p}'" for p in lists))), "serve.ini")
    data_lists = [[str(tmp_path / "data" / n)
                   for n in Path(p).read_text().splitlines()] for p in lists]
    jm = jmodels.HartleyMHASeg(2, 3, 4, 2, 2, (2, 2, 2), patch_size=2,
                               use_pallas=True)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 2) + SHAPE))["params"]
    input_data = InputData(reader=read_img, data_lists_test=data_lists,
                           idx_x_modalities=[0, 1], idx_y_modalities=[2],
                           x_processing=normalize_modalities, batch_size=1,
                           num_workers=0)
    jtesting(jm, params, input_data, str(tmp_path / "jax"), is_print=False)

    (tmp_path / "out" / "model").mkdir(parents=True)
    torch.save(state_dict_from_jax(jax.device_get(params)),
               tmp_path / "out" / "model" / "model.pt")
    assert run_inference(cfg)["n_volumes"] == 2
    for i in range(2):
        want = read_img(str(tmp_path / "jax" / "images" /
                            f"case{i}_pred.nii.gz"))
        got = read_img(str(tmp_path / "out" / "inference" / "images" /
                           f"case{i}_pred.nii.gz"))
        assert got.shape == SHAPE
        assert np.mean(got != want) <= 1e-4


NOSEG_CONFIG = """
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
model_name = 'NeuralOperatorSeg'
out_channels = 3
filters = 4
num_transform_blocks = 2
num_modes = (2, 2, 2)
transform_type = '{transform}'
use_pallas = True
tower_kernel = 'resident'
transform_precision = 'high'

[test]
output_folder = 'inference'
"""


@pytest.mark.parametrize("transform", ["Hartley", "Fourier"])
def test_serving_noseg_resident_matches_jax_testing(tmp_path, monkeypatch,
                                                    transform):
    """run_inference serves a tiny HNOSeg / FNOSeg with tower_kernel =
    'resident' (the whole tower in one resident_tower call, its plain
    version on the CPU); its label maps match the JAX engine's testing()
    (the JAX module path) with the same weights."""
    from multimodal_3d_image_segmentation_tpu.ops import spectral
    monkeypatch.setattr(spectral, "PRECISION", jax.lax.Precision.HIGHEST)
    lists = _write_cases(tmp_path / "data")
    cfg = config.get_config(StringIO(NOSEG_CONFIG.format(
        out=tmp_path / "out", data=tmp_path / "data", transform=transform,
        lists=", ".join(f"'{p}'" for p in lists))), "serve.ini")
    data_lists = [[str(tmp_path / "data" / n)
                   for n in Path(p).read_text().splitlines()] for p in lists]
    jm = jmodels.NeuralOperatorSeg(2, 3, 4, 2, (2, 2, 2), transform,
                                   use_pallas=True)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 2) + SHAPE))["params"]
    input_data = InputData(reader=read_img, data_lists_test=data_lists,
                           idx_x_modalities=[0, 1], idx_y_modalities=[2],
                           x_processing=normalize_modalities, batch_size=1,
                           num_workers=0)
    jtesting(jm, params, input_data, str(tmp_path / "jax"), is_print=False)

    (tmp_path / "out" / "model").mkdir(parents=True)
    torch.save(state_dict_from_jax(jax.device_get(params)),
               tmp_path / "out" / "model" / "model.pt")
    assert _build_model(cfg, _Sizes2(), lambda: SHAPE).tower_kernel == \
        "resident"
    assert run_inference(cfg)["n_volumes"] == 2
    for i in range(2):
        want = read_img(str(tmp_path / "jax" / "images" /
                            f"case{i}_pred.nii.gz"))
        got = read_img(str(tmp_path / "out" / "inference" / "images" /
                           f"case{i}_pred.nii.gz"))
        assert got.shape == SHAPE
        assert np.mean(got != want) <= 1e-4


VNET_CONFIG = """
[main]
output_dir = '{out}'
is_train = False
is_test = True
is_statistics = False
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
num_blocks = [1, 2]
right_leg_indexes = [0, 1]
use_pallas = True
transform_precision = 'high'

[test]
output_folder = 'inference'
save_npz = True
"""
MSGPACK_FAMILIES = {
    "HNOSeg-XS": (CONFIG.replace("{use_pallas}", "True").replace(
        "[test]\n", "[test]\nsave_npz = True\n"),
        lambda: jmodels.HNOSegXS(in_channels=2, **MODEL)),
    "V-Net-DS": (VNET_CONFIG, lambda: jmodels.VNetDS(
        in_channels=2, out_channels=3, base_num_filters=4, num_blocks=[1, 2],
        right_leg_indexes=[0, 1])),
}


@pytest.mark.parametrize("family", sorted(MSGPACK_FAMILIES))
def test_serving_a_jax_run_directory_matches_jax_testing(tmp_path, family):
    """A run directory that holds only the JAX package's
    ``model/model.msgpack`` (written by its ``save_params``) serves through
    the port's run_inference; the label maps and ``[test] save_npz``'s
    ``y_true_pred.npz`` match the JAX engine's testing() (its module path)
    on the same weights."""
    from multimodal_3d_image_segmentation_tpu.runtime.checkpoint import \
        save_params
    text, make = MSGPACK_FAMILIES[family]
    lists = _write_cases(tmp_path / "data")
    cfg = config.get_config(StringIO(text.format(
        out=tmp_path / "out", data=tmp_path / "data",
        lists=", ".join(f"'{p}'" for p in lists))), "serve.ini")
    data_lists = [[str(tmp_path / "data" / n)
                   for n in Path(p).read_text().splitlines()] for p in lists]
    jm = make()
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 2) + SHAPE))["params"]
    input_data = InputData(reader=read_img, data_lists_test=data_lists,
                           idx_x_modalities=[0, 1], idx_y_modalities=[2],
                           x_processing=normalize_modalities, batch_size=1,
                           num_workers=0)
    jtesting(jm, params, input_data, str(tmp_path / "jax"), is_print=False,
             save_npz=True)
    save_params(str(tmp_path / "out" / "model" / "model.msgpack"), params)
    assert sorted(os.listdir(tmp_path / "out" / "model")) == [
        "model.msgpack"]
    assert run_inference(cfg)["n_volumes"] == 2
    for i in range(2):
        want = read_img(str(tmp_path / "jax" / "images" /
                            f"case{i}_pred.nii.gz"))
        got = read_img(str(tmp_path / "out" / "inference" / "images" /
                           f"case{i}_pred.nii.gz"))
        assert got.shape == SHAPE
        assert np.mean(got != want) <= 1e-4
    want = np.load(tmp_path / "jax" / "y_true_pred.npz")
    got = np.load(tmp_path / "out" / "inference" / "y_true_pred.npz")
    assert sorted(got.files) == sorted(want.files) == ["y_pred", "y_true"]
    for k in want.files:
        assert got[k].shape == want[k].shape == (2,) + SHAPE
        assert got[k].dtype == want[k].dtype
    np.testing.assert_array_equal(got["y_true"], want["y_true"])
    assert np.mean(got["y_pred"] != want["y_pred"]) <= 1e-4


def test_save_npz_without_labels(tmp_path):
    """Test lists without a label modality: ``y_true_pred.npz`` holds
    ``y_pred`` alone, as the reference's does."""
    from multimodal_3d_image_segmentation_tpu_torch.data.dataset import \
        InputData as TInputData
    from multimodal_3d_image_segmentation_tpu_torch.data.nifti import \
        read_img as tread_img
    from multimodal_3d_image_segmentation_tpu_torch.models import HNOSegXS
    from multimodal_3d_image_segmentation_tpu_torch.runtime.train_test \
        import testing
    lists = _write_cases(tmp_path / "data")
    data_lists = [[str(tmp_path / "data" / n)
                   for n in Path(p).read_text().splitlines()]
                  for p in lists[:2]]
    input_data = TInputData(reader=tread_img, data_lists_test=data_lists,
                            idx_x_modalities=[0, 1], batch_size=1,
                            num_workers=0)
    stats = testing(HNOSegXS(in_channels=2, **MODEL), input_data,
                    str(tmp_path / "test"), is_print=False, save_npz=True)
    assert stats["n_volumes"] == 2
    got = np.load(tmp_path / "test" / "y_true_pred.npz")
    assert got.files == ["y_pred"] and got["y_pred"].shape == (2,) + SHAPE
    assert got["y_pred"].dtype == np.uint8


def test_load_weights_without_a_weights_file(tmp_path):
    """A run directory with neither weights file raises; the JAX package's
    sharded Orbax export raises naming its ROADMAP item."""
    from multimodal_3d_image_segmentation_tpu_torch.models import HNOSegXS
    from multimodal_3d_image_segmentation_tpu_torch.runtime.inference import \
        load_weights
    model = HNOSegXS(in_channels=2, **MODEL)
    with pytest.raises(FileNotFoundError, match="model.msgpack"):
        load_weights(str(tmp_path), model)
    (tmp_path / "model.msgpack.orbax").mkdir()
    with pytest.raises(NotImplementedError, match="item 7"):
        load_weights(str(tmp_path), model)
