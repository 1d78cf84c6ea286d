"""The port's ``runtime/run.py::run`` end to end on the CPU: HNOSeg-XS
trained, tested and scored from ``configs/config_hnoseg_xs.ini``, cut only
in image size (16x16x12), epochs and reader processes, on a synthetic
BraTS-layout dataset; the other families from their own INIs, also cut in
width and depth; resuming with ``is_continue``; serving the run directory;
and the options that are not ported yet."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodal_3d_image_segmentation_tpu_torch.data import (read_img,
                                                            write_image)
from multimodal_3d_image_segmentation_tpu_torch.runtime.config import \
    get_config
from multimodal_3d_image_segmentation_tpu_torch.runtime.inference import \
    run_inference
from multimodal_3d_image_segmentation_tpu_torch.runtime.run import run
from multimodal_3d_image_segmentation_tpu_torch.runtime.train_test import \
    get_losses_from_file

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

REPO = Path(__file__).resolve().parent.parent
SHAPE = (16, 16, 12)
MODS = ["t1c", "t1n", "t2f", "t2w", "seg"]
SPLITS = {"train": ("train-0.6", 3), "valid": ("valid-0.1", 2),
          "test": ("test-0.3", 2)}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """4 modalities and a label map per case, in the list files the
    config names."""
    root = tmp_path_factory.mktemp("brats")
    rng = np.random.default_rng(0)
    for split, (tag, n) in SPLITS.items():
        lists = {m: [] for m in MODS}
        for i in range(n):
            case = f"{split}_{i}"
            for m in MODS[:4]:
                vol = rng.standard_normal(SHAPE).astype(np.float32) + 2
                write_image(vol, root / "data" / case / f"{m}.nii.gz")
                lists[m].append(f"{case}/{m}.nii.gz")
            seg = rng.integers(0, 4, SHAPE).astype(np.uint8)
            write_image(seg, root / "data" / case / "seg.nii.gz")
            lists["seg"].append(f"{case}/seg.nii.gz")
        (root / "lists").mkdir(exist_ok=True)
        for m in MODS:
            (root / "lists" / f"{m}_{tag}.txt").write_text(
                "\n".join(lists[m]) + "\n")
    return root


def _config_text(dataset, out_dir, num_epochs=3, config="config_hnoseg_xs.ini",
                 extra=()):
    """The config's text with only the paths, the device, the epochs and
    the reader processes replaced."""
    text = (REPO / "configs" / config).read_text()
    subs = {"output_dir": repr(str(out_dir)),
            "data_dir": repr(str(dataset / "data") + "/"),
            "list_dir": repr(str(dataset / "lists")),
            "visible_devices": "'cpu'", "num_epochs": str(num_epochs),
            "num_workers": "0", **dict(extra)}
    for key, val in subs.items():
        text, n = re.subn(rf"(?m)^{key} = .*$", f"{key} = {val}", text)
        assert n == 1, key
    return text


def _config(tmp_path, dataset, out_dir, **kw):
    path = tmp_path / "config.ini"
    path.write_text(_config_text(dataset, out_dir, **kw))
    return get_config(str(path))


def _ids(split):
    return [f"{split}_{i}" for i in range(SPLITS[split][1])]


def test_run_trains_tests_and_scores(tmp_path, dataset):
    out = tmp_path / "run"
    cfg = _config(tmp_path, dataset, out)
    model = run(cfg)
    assert sum(p.numel() for p in model.parameters()) == 28248
    for f in ("config.ini", "model/model.pt", "model/checkpoint.pt",
              "stdout.txt", "model_summary.txt", "model_graph.pdf",
              "plot_loss.pdf", "test/prediction_time_memory.txt",
              "test/results_regional.csv",
              "test/average_results_regional.txt"):
        assert (out / f).is_file(), f
    log = (out / "stdout.txt").read_text()
    assert log.startswith("train_num_batches: 3\nvalid_num_batches: 2\n")
    assert re.findall(r"Epoch: (\d+)", log) == ["0", "1", "2"]
    train, valid = get_losses_from_file(str(out / "stdout.txt"))
    assert len(train) == len(valid) == 3
    assert np.isfinite(train + valid).all()
    # selection: after int(3 * 0.5) = 1 epoch, so epoch 2 (the last)
    assert "Best epoch: 2" in log and "Best checkpoint saved." in log
    assert "Total params: 28,248" in (out / "model_summary.txt").read_text()
    best = torch.load(out / "model" / "model.pt", weights_only=True)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(best[k], v, rtol=0, atol=0)

    rows = (out / "test" / "results_regional.csv").read_text().splitlines()
    assert rows[0].split("\t")[:2] == ["ID", "dice background"]
    assert [r.split("\t")[0] for r in rows[1:]] == _ids("test") + ["End"]
    for pid in _ids("test"):
        pred = read_img(str(out / "test" / "images" / f"{pid}_pred.nii.gz"))
        assert pred.shape == SHAPE and set(np.unique(pred)) <= {0, 1, 2, 3}

    # serving the run directory gives the run's own test labels
    cfg["test"]["output_folder"] = "served"
    run_inference(cfg)
    for pid in _ids("test"):
        np.testing.assert_array_equal(
            read_img(str(out / "served" / "images" / f"{pid}_pred.nii.gz")),
            read_img(str(out / "test" / "images" / f"{pid}_pred.nii.gz")))


def test_run_refuses_an_existing_output_dir(tmp_path, dataset):
    (tmp_path / "run").mkdir()
    with pytest.raises(RuntimeError, match="already exists"):
        run(_config(tmp_path, dataset, tmp_path / "run"))


def test_resume_truncates_the_log_at_the_restored_epoch(tmp_path, dataset):
    """Two epochs with a checkpoint each, then a crash in the middle of
    epoch 2 (its lines logged, no checkpoint); resuming restores epoch 1,
    cuts the log back to its checkpoint line and runs epochs 2 and 3."""
    out = tmp_path / "run"
    extra = {"is_test": "False", "is_statistics": "False"}
    cfg = _config(tmp_path, dataset, out, num_epochs=2, extra=extra)
    cfg["train"]["checkpoint_epoch"] = 1
    run(cfg)
    with open(out / "stdout.txt", "a") as f:
        f.write("\n-------------------------\nEpoch: 2\ntrain_loss: 0.5\n")
    ckpt = torch.load(out / "model" / "checkpoint.pt", weights_only=True)
    assert ckpt["epoch"] == 1

    cfg = _config(tmp_path, dataset, out, num_epochs=4, extra=extra)
    cfg["main"]["is_continue"] = True
    cfg["train"]["checkpoint_epoch"] = 1
    run(cfg)
    log = (out / "stdout.txt").read_text()
    assert re.findall(r"Epoch: (\d+)", log) == ["0", "1", "2", "3"]
    train, valid = get_losses_from_file(str(out / "stdout.txt"))
    assert len(train) == len(valid) == 4 and 0.5 not in train
    ckpt = torch.load(out / "model" / "checkpoint.pt", weights_only=True)
    assert ckpt["epoch"] == 3
    # 3 train batches an epoch: the scheduler was restored, not restarted
    assert ckpt["scheduler"]["last_epoch"] == 12

    with pytest.raises(RuntimeError, match="start_epoch"):
        run(cfg)  # nothing left to train


# the other families' configs, cut in width and depth only (the keys each
# INI sets; the rest as the file sets it)
FAMILY_WIDTHS = {
    "config_vnet-ds.ini": {"base_num_filters": "4", "num_blocks": "[1, 1]",
                           "right_leg_indexes": "[0, 1]"},
    "config_hartleymha.ini": {"filters": "4", "num_transform_blocks": "2",
                              "num_heads": "2", "num_modes": "(2, 2, 2)"},
    "config_hnoseg.ini": {"filters": "4", "num_transform_blocks": "2",
                          "num_modes": "(2, 2, 2)"},
    "config_fnoseg.ini": {"filters": "4", "num_transform_blocks": "2",
                          "num_modes": "(2, 2, 2)"},
}


@pytest.mark.parametrize("config", sorted(FAMILY_WIDTHS))
def test_test_and_statistics_of_another_family(tmp_path, dataset, config):
    """V-Net-DS, HartleyMHASeg, HNOSeg and FNOSeg train from their own INI
    (kernel paths on: each kernel Function's plain forward and its
    backward on the CPU) for one epoch at small width, then test and score;
    serving the run directory gives the run's own test labels."""
    out = tmp_path / "run"
    cfg = _config(tmp_path, dataset, out, num_epochs=1, config=config,
                  extra=FAMILY_WIDTHS[config])
    assert cfg["model"]["use_pallas"] is True
    model = run(cfg)
    assert model.use_kernels
    train, valid = get_losses_from_file(str(out / "stdout.txt"))
    assert len(train) == len(valid) == 1
    assert np.isfinite(train + valid).all()
    best = torch.load(out / "model" / "model.pt", weights_only=True)
    assert set(best) == set(model.state_dict())
    rows = (out / "test" / "results_regional.csv").read_text().splitlines()
    assert [r.split("\t")[0] for r in rows[1:]] == _ids("test") + ["End"]
    cfg["test"]["output_folder"] = "served"
    run_inference(cfg)
    for pid in _ids("test"):
        pred = read_img(str(out / "test" / "images" / f"{pid}_pred.nii.gz"))
        assert pred.shape == SHAPE and set(np.unique(pred)) <= {0, 1, 2, 3}
        np.testing.assert_array_equal(
            read_img(str(out / "served" / "images" / f"{pid}_pred.nii.gz")),
            pred)


@pytest.mark.parametrize("section,key,val,item", [
    ("parallel", "n_data", 2, "item 15"),
    ("augmentation", "device", True, "item 13"),
    ("model", "compute_dtype", "mixed", "item 12"),
])
def test_options_not_ported_raise(tmp_path, dataset, section, key, val,
                                  item):
    cfg = _config(tmp_path, dataset, tmp_path / "run")
    cfg.setdefault(section, {})[key] = val
    with pytest.raises(NotImplementedError, match=item):
        run(cfg)


def test_train_use_autocast_warns_and_trains(tmp_path, dataset, capsys):
    """``[train] use_autocast`` is ignored with a warning pointing to
    ``[model] compute_dtype``, as the JAX package's run does, and the run
    trains."""
    out = tmp_path / "run"
    extra = {"is_test": "False", "is_statistics": "False"}
    cfg = _config(tmp_path, dataset, out, num_epochs=1, extra=extra)
    cfg["train"]["use_autocast"] = True
    run(cfg)
    assert "[train] use_autocast is ignored" in capsys.readouterr().out
    assert (out / "model" / "model.pt").is_file()


def test_cli_runs_the_config(tmp_path, dataset):
    """``python -m ...runtime.run config.ini`` in a fresh interpreter: one
    epoch, then test and statistics."""
    config = tmp_path / "config_hnoseg_xs.ini"
    config.write_text(_config_text(dataset, tmp_path / "run", num_epochs=1))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-m",
         "multimodal_3d_image_segmentation_tpu_torch.runtime.run",
         str(config)], capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "dice_mean:" in out.stdout
    assert (tmp_path / "run" / "config_hnoseg_xs.ini").is_file()
    assert (tmp_path / "run" / "test" / "results_regional.csv").is_file()
