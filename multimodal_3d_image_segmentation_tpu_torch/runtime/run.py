"""Experiment CLI, the port of
``multimodal_3d_image_segmentation_tpu/runtime/run.py``.

Usage: ``python -m multimodal_3d_image_segmentation_tpu_torch.runtime.run
config.ini``. One config trains (``is_train``), tests (``is_test``) and
writes the regional statistics (``is_statistics``), with the sections and
run artifacts of the upstream ``experiments/run.py:29-197``. The run is on
the card named by ``[main] visible_devices``, or on the CPU where it says
``'cpu'``. Every family trains: HNOSeg-XS, V-Net-DS, HartleyMHASeg and
NeuralOperatorSeg (HNOSeg, FNOSeg).

``[parallel] n_spatial = N`` (with ``n_data = 1``) serves V-Net-DS's kernel
path depth-sharded over N ranks (``parallel/``), each started by
``python -m torch.distributed.run --nproc-per-node N``; rank 0 writes the
outputs. Training under ``[parallel]``, a data axis above 1 and the other
families under ``n_spatial > 1`` raise (ROADMAP item 15).
"""
from __future__ import annotations

import copy
import os
import sys
from functools import partial
from typing import Optional

import torch

from .. import not_ported
from ..data.dataset import InputData
from ..data.nifti import read_img
from ..data.normalization import normalize_modalities
from ..device import check_transform_precision, resolve_device
from ..losses import get_loss
from ..metrics import statistics_regional
from ..models import HartleyMHASeg, HNOSegXS, NeuralOperatorSeg, VNetDS
from ..parallel import flat_vnet_shardable, make_mesh, multihost
from .checkpoint import load_weights
from .config import get_config, save_config
from .optim import build_optimizer, build_schedule
from .train_test import testing, training

__all__ = ["run", "get_data_lists", "warn_autocast", "serving_layout",
           "main"]

_MODELS = {"HartleyMHASeg": HartleyMHASeg, "HNOSegXS": HNOSegXS,
           "NeuralOperatorSeg": NeuralOperatorSeg, "VNetDS": VNetDS}


def warn_autocast(section: str) -> None:
    """``[train]`` / ``[test] use_autocast`` is ignored, as the reference
    ignores it: mixed precision is ``[model] compute_dtype``."""
    print(f"Warning: [{section}] use_autocast is ignored; use [model] "
          "compute_dtype = 'bfloat16' or 'mixed' for mixed precision.")


def get_data_lists(data_lists_paths, data_dir=None):
    """Read per-modality filename list files (upstream
    ``experiments/utils.py:210-231``)."""
    if data_lists_paths is None:
        return None
    data_dir = data_dir or ""
    data_lists = []
    for dl_path in data_lists_paths:
        dl_path = os.path.expanduser(dl_path)
        with open(dl_path) as f:
            a_list = f.read().splitlines()
        data_lists.append([os.path.join(data_dir, fname) for fname in a_list])
    return data_lists


def serving_layout(config_args):
    """(device, n_spatial) of a run: without ``[parallel]`` (or with one
    rank in it) the device ``[main] visible_devices`` names and None; with
    ``n_spatial > 1`` this rank's device and that rank count, after
    joining the process group (``parallel/multihost.py``). A data axis
    above 1, and a model other than V-Net-DS's kernel path under
    ``n_spatial > 1``, raise (ROADMAP item 15)."""
    visible = config_args["main"].get("visible_devices")
    par = config_args.get("parallel")
    if par is None:
        return resolve_device(visible), None
    n_data = par.get("n_data")
    if n_data is not None and int(n_data) != 1:
        not_ported(f"[parallel] n_data = {n_data} (data parallelism)", 15)
    n = int(par.get("n_spatial", 1))
    if n == 1:
        return resolve_device(visible), None
    model_cfg = config_args["model"]
    if model_cfg["model_name"] != "VNetDS":
        not_ported(f"{model_cfg['model_name']} depth-sharded ([parallel] "
                   f"n_spatial = {n})", 15)
    if not model_cfg.get("use_pallas", False):
        not_ported("V-Net-DS's module path depth-sharded ([parallel] needs "
                   "[model] use_pallas = True)", 15)
    device = multihost.initialize(visible)[2]
    return device, make_mesh(1, n)


def _build_model(config_args, input_data, image_size_getter,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None,
                 n_spatial: Optional[int] = None) -> torch.nn.Module:
    """``[model]`` section -> the port's model on ``device``, initialized
    from ``generator`` (default: seeded with 0). With ``n_spatial > 1``
    ranks (``serving_layout``), V-Net-DS's kernel path depth-sharded over
    the default process group (``parallel/flat_sharded.py``); an image size
    that does not shard raises (ROADMAP item 15).

    ``use_pallas`` maps to ``use_kernels``; ``transform_precision`` 'high'
    and 'highest' both mean exact fp32 (``device.py``); ``compute_dtype``
    'float32', 'bfloat16' or 'mixed' passes through by name (the
    reference maps 'mixed' to 'bfloat16' plus a process-wide flag; the
    port's models take 'mixed' itself)."""
    model_args = copy.deepcopy(config_args["model"])
    model_args["in_channels"] = input_data.get_num_x_modalities()
    model_args["ndim"] = len(image_size_getter()) + 2
    model_args.pop("device", None)  # placement comes from visible_devices
    tp = model_args.pop("transform_precision", None)
    if tp is not None:
        check_transform_precision(tp)
    model_name = model_args.pop("model_name")
    if model_name not in _MODELS:
        raise ValueError(f"unknown model_name {model_name!r}")
    model_args["use_kernels"] = bool(model_args.pop("use_pallas", False))
    # the rest (HartleyMHASeg's num_heads, NeuralOperatorSeg's
    # transform_type and weights_type, ...) passes through by name
    for key in ("num_modes", "patch_size"):
        if isinstance(model_args.get(key), list):
            model_args[key] = tuple(model_args[key])
    if n_spatial is not None:
        n = n_spatial
        image_size = tuple(image_size_getter())
        dim = flat_vnet_shardable(image_size, model_args["num_blocks"],
                                  model_args.get("use_resize", True), n)
        if dim is None:
            not_ported(f"V-Net-DS depth-sharded over {n} ranks at image "
                       f"size {image_size} (no image axis shards its first "
                       "level)", 15)
        model_args["spatial_shard"] = (None, n, dim)
    return _MODELS[model_name](**model_args, generator=generator,
                               device=device)


def _statistics(config_args, data_lists_test, test_dir, is_print):
    """Regional Dice (and surface Dice, HD95) of the test predictions
    against the ground truths, written under ``test_dir``."""
    idx_y_modalities = config_args["input_args"].get("idx_y_modalities")
    if not idx_y_modalities:
        print("Statistics cannot be computed without valid "
              "idx_y_modalities (ground truths).")
        return
    if is_print:
        print("\nComputing statistics")
    y_list_test = data_lists_test[idx_y_modalities[0]]
    ids = [fn.split("/")[-2] for fn in y_list_test]
    images = os.path.join(str(test_dir), "images")
    y_true = [read_img(os.path.join(images, f"{i}_true.nii.gz"))
              for i in ids]
    y_pred = [read_img(os.path.join(images, f"{i}_pred.nii.gz"))
              for i in ids]
    if is_print:
        print(f"There are {len(y_true)} samples loaded.")
    stats = config_args.get("statistics", {})
    if is_print:
        print("-------- Regional result statistics --------")
    statistics_regional(
        y_true, y_pred, y_list_test, test_dir,
        stats.get("region_names"), stats.get("region_labels"), is_print,
        use_surface_dice=stats.get("use_surface_dice", True),
        use_hd95=stats.get("use_hd95", True),
        nproc=config_args["input_args"].get("num_workers"))


def run(config_args):
    """Run an experiment: train and/or test and/or statistics. Returns
    the model (None when only statistics ran)."""
    main_args = config_args["main"]
    is_train, is_test = main_args["is_train"], main_args["is_test"]
    if "parallel" in config_args and is_train:
        not_ported("training under [parallel] (sharded or data-parallel "
                   "training)", 15)
    output_dir = os.path.expanduser(main_args["output_dir"])
    device, n_spatial = serving_layout(config_args)
    writer = multihost.process_index() == 0

    input_lists = copy.deepcopy(config_args["input_lists"])
    data_dir = input_lists.get("data_dir")  # None = lists hold full paths
    data_dir = os.path.expanduser(data_dir) if data_dir else data_dir
    data_lists = {split: get_data_lists(
        input_lists.get(f"data_lists_{split}_paths"), data_dir)
        for split in ("train", "valid", "test")}

    input_args = copy.deepcopy(config_args["input_args"])
    if input_args.pop("use_data_normalization", True):
        x_processing = partial(normalize_modalities,
                               mask_val=input_args.pop("mask_val", 0),
                               clip_val=input_args.pop("clip_val", None))
    else:
        x_processing = None
    transform_args = copy.deepcopy(config_args.get("augmentation"))
    if transform_args and transform_args.get("device", False):
        not_ported("[augmentation] device = True (on-device augmentation)",
                   13)
    input_data = None
    if is_train or is_test:
        input_data = InputData(
            reader=read_img, data_lists_train=data_lists["train"],
            data_lists_valid=data_lists["valid"],
            data_lists_test=data_lists["test"], x_processing=x_processing,
            transform_kwargs=transform_args, **input_args)

    model = None
    if is_train:
        if os.path.exists(output_dir) and not main_args.get("is_continue",
                                                            False):
            raise RuntimeError(f"output_dir already exists! \n{output_dir}")
        os.makedirs(output_dir, exist_ok=True)
        save_config(config_args, output_dir)

        train_args = copy.deepcopy(config_args["train"])
        if train_args.pop("use_autocast", None):
            warn_autocast("train")
        if train_args.pop("checkpoint_backend", "msgpack") != "msgpack":
            not_ported("[train] checkpoint_backend = 'orbax'", 15)
        gen = torch.Generator().manual_seed(int(train_args.pop("seed", 0)))
        model = _build_model(config_args, input_data,
                             input_data.get_train_image_size, device, gen)
        num_epochs = train_args.get("num_epochs", 100)
        optimizer_args = copy.deepcopy(config_args["optimizer"])
        optimizer = build_optimizer(optimizer_args, model.parameters())
        scheduler = build_schedule(
            optimizer, config_args.get("scheduler"),
            optimizer_args.get("lr", 1e-3),
            input_data.get_train_num_batches(), num_epochs)
        loss_args = copy.deepcopy(config_args["loss"])
        loss_fn = get_loss(loss_args.pop("loss_name"), **loss_args)
        model = training(model=model, input_data=input_data,
                         output_dir=output_dir, loss_fn=loss_fn,
                         optimizer=optimizer, scheduler=scheduler,
                         **train_args)
    elif is_test:
        model = _build_model(config_args, input_data,
                             input_data.get_test_image_size, device,
                             n_spatial=n_spatial)
        model.load_state_dict(load_weights(os.path.join(output_dir, "model"),
                                           model), strict=True)

    if not is_test and not main_args["is_statistics"]:
        return model

    test_args = copy.deepcopy(config_args.get("test", {}))
    test_dir = os.path.join(output_dir, test_args.pop("output_folder",
                                                      "test"))
    if "is_print" not in test_args and "train" in config_args:
        is_print = config_args["train"].get("is_print", True)
    else:
        is_print = test_args.get("is_print", True)
    test_args.pop("is_print", None)
    if test_args.pop("use_autocast", None):
        warn_autocast("test")
    if is_test:
        testing(model=model, input_data=input_data, output_dir=test_dir,
                is_print=is_print and writer, writer=writer, **test_args)
    if main_args["is_statistics"] and writer:
        _statistics(config_args, data_lists["test"], test_dir, is_print)
    return model


def main():
    run(get_config(sys.argv[1]))


if __name__ == "__main__":
    main()
