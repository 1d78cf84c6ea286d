"""Depth-sharded serving through the port's entry points, on the CPU.

``runtime/inference.py::run_inference`` serves V-Net-DS's kernel path from
``configs/config_vnet-ds.ini`` (cut only in width, to base 8, and in image
size) with ``[parallel] n_spatial = 2`` over 2 gloo ranks
(``parallel/ranks.py::run_ranks``, the process group in a ``FileStore``);
the labels rank 0 writes must equal the unsharded serve's. The image size
is 16x16x14: its last axis gives 8 planes after conv_in, so the first two
levels run sharded (16x16x12 gives no axis an even count, and raises). The
options the port does not serve sharded raise, naming ROADMAP item 15.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodal_3d_image_segmentation_tpu_torch.data import (read_img,
                                                            write_image)
from multimodal_3d_image_segmentation_tpu_torch.models import VNetDS
from multimodal_3d_image_segmentation_tpu_torch.parallel import (make_mesh,
                                                                multihost)
from multimodal_3d_image_segmentation_tpu_torch.parallel.ranks import \
    run_ranks
from multimodal_3d_image_segmentation_tpu_torch.runtime.config import \
    get_config
from multimodal_3d_image_segmentation_tpu_torch.runtime.inference import \
    run_inference
from multimodal_3d_image_segmentation_tpu_torch.runtime.run import (
    _build_model, run)

import torch_rank_cases

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

REPO = Path(__file__).resolve().parent.parent
MODS = ["t1c", "t1n", "t2f", "t2w", "seg"]
N_CASES = 2


def _dataset(root, shape):
    rng = np.random.default_rng(0)
    lists = {m: [] for m in MODS}
    for i in range(N_CASES):
        case = f"case{i}"
        for m in MODS[:4]:
            write_image(rng.standard_normal(shape).astype(np.float32) + 2,
                        root / "data" / case / f"{m}.nii.gz")
            lists[m].append(f"{case}/{m}.nii.gz")
        write_image(rng.integers(0, 4, shape).astype(np.uint8),
                    root / "data" / case / "seg.nii.gz")
        lists["seg"].append(f"{case}/seg.nii.gz")
    (root / "lists").mkdir(parents=True, exist_ok=True)
    for m in MODS:
        for split in ("train-0.6", "valid-0.1", "test-0.3"):
            (root / "lists" / f"{m}_{split}.txt").write_text(
                "\n".join(lists[m]) + "\n")


def _config(root, out_dir, parallel=None, model="config_vnet-ds.ini",
            extra=()):
    """The INI with its paths, the device, the reader processes and the
    width replaced, serving only, and a ``[parallel]`` section."""
    text = (REPO / "configs" / model).read_text()
    subs = {"output_dir": repr(str(out_dir)),
            "data_dir": repr(str(root / "data") + "/"),
            "list_dir": repr(str(root / "lists")),
            "visible_devices": "'cpu'", "num_workers": "0",
            "is_train": "False", "is_statistics": "False", **dict(extra)}
    for key, val in subs.items():
        text, n = re.subn(rf"(?m)^{key} = .*$", f"{key} = {val}", text)
        assert n == 1, key
    if parallel:
        text += "\n[parallel]\n" + "".join(f"{k} = {v}\n"
                                           for k, v in parallel.items())
    path = out_dir.parent / f"{out_dir.name}.ini"
    path.write_text(text)
    return path


def _model_dir(root, out_dir, size=(16, 16, 14)):
    """A V-Net-DS of the config's width (base 8) with random weights from a
    seed, saved where run_inference reads it; returns the config path."""
    cfg = get_config(str(_config(root, out_dir, extra={
        "base_num_filters": "8"})))
    model = VNetDS(4, 4, 8, cfg["model"]["num_blocks"],
                   right_leg_indexes=cfg["model"]["right_leg_indexes"],
                   generator=torch.Generator().manual_seed(3))
    (out_dir / "model").mkdir(parents=True)
    torch.save(model.state_dict(), out_dir / "model" / "model.pt")


def test_sharded_serving_matches_unsharded(tmp_path):
    """run_inference over 2 gloo ranks writes (rank 0 alone) the labels of
    the unsharded serve of the same weights."""
    _dataset(tmp_path, (16, 16, 14))
    out = tmp_path / "served"
    _model_dir(tmp_path, out)
    plain = _config(tmp_path, out, extra={"base_num_filters": "8"})
    run_inference(get_config(str(plain)))
    cfg = get_config(str(plain))
    sharded = _config(tmp_path, out, parallel={"n_data": 1, "n_spatial": 2},
                      extra={"base_num_filters": "8",
                             "output_folder": "'sharded'"})
    stats = run_ranks(torch_rank_cases.serve, 2, tmp_path / "ranks",
                      str(sharded))
    assert [s["n_volumes"] for s in stats] == [N_CASES, N_CASES]
    want_dir = out / cfg["test"]["output_folder"] / "images"
    got_dir = out / "sharded" / "images"
    for i in range(N_CASES):
        want = read_img(str(want_dir / f"case{i}_pred.nii.gz"))
        got = read_img(str(got_dir / f"case{i}_pred.nii.gz"))
        assert got.shape == (16, 16, 14)
        np.testing.assert_array_equal(got, want)
    lines = (out / "sharded" / "prediction_time_memory.txt").read_text()
    assert lines.startswith("Average prediction time: ")
    assert "device_time_of_a_predict_step: nan ms" in lines


@pytest.mark.parametrize("case", ["shape", "n_data", "train", "tower",
                                  "module_path"])
def test_what_is_not_served_sharded_raises(tmp_path, case):
    """An image size with no axis to shard, a data axis, training under
    [parallel], a tower family and V-Net-DS's module path under
    n_spatial = 2 raise, naming ROADMAP item 15 (before any process group
    is needed, or, for the shape, where the model is built)."""
    out = tmp_path / "run"
    out.mkdir()
    par = {"n_data": 1, "n_spatial": 2}
    model, extra = "config_vnet-ds.ini", {}
    if case == "n_data":
        par["n_data"] = 2
    elif case == "train":
        extra = {"is_train": "True"}
    elif case == "tower":
        model = "config_hnoseg.ini"
    elif case == "module_path":
        extra = {"use_pallas": "False"}
    _dataset(tmp_path, (16, 16, 12))
    cfg = get_config(str(_config(tmp_path, out, par, model, extra)))
    with pytest.raises(NotImplementedError, match="item 15"):
        if case == "shape":
            _build_model(cfg, _Sizes(), lambda: (16, 16, 12), None,
                         n_spatial=2)
        elif case == "train":
            run(cfg)
        else:
            run_inference(cfg)


class _Sizes:
    def get_num_x_modalities(self):
        return 4


def test_layout_and_backend_choice():
    """NCCL only where each rank of a host has a card of its own; a rank
    meant for a card without CUDA raises instead of moving to the CPU;
    without a process group the mesh is one rank, and a data axis raises."""
    assert multihost.choose_backend(False, 4, 4) == "nccl"
    assert multihost.choose_backend(False, 2, 1) == "gloo"
    assert multihost.choose_backend(True, 2, 0) == "gloo"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            multihost._device(False, 0)
    assert multihost._device(True, 3) == torch.device("cpu")
    assert make_mesh(1, 1) == 1
    with pytest.raises(NotImplementedError, match="item 15"):
        make_mesh(2, 1)
    with pytest.raises(ValueError, match="rank"):
        make_mesh(1, 2)
