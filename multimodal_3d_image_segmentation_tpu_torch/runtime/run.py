"""Model construction from a config, the port of the serving subset of
``multimodal_3d_image_segmentation_tpu/runtime/run.py``
(``get_data_lists``, ``_build_model``)."""
from __future__ import annotations

import copy
import os
from typing import Optional

import torch

from .. import not_ported
from ..device import check_transform_precision
from ..models import HNOSegXS

__all__ = ["get_data_lists"]

# model families of the reference -> ROADMAP item that ports them
_UNPORTED_MODELS = {"VNetDS": 8, "HartleyMHASeg": 9,
                    "NeuralOperatorSeg": 10}


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


def _build_model(config_args, input_data, image_size_getter,
                 device: Optional[torch.device] = None) -> HNOSegXS:
    """``[model]`` section -> the port's model on ``device``.

    ``use_pallas`` maps to ``use_kernels``; ``transform_precision`` 'high'
    and 'highest' both mean exact fp32 (``device.py``)."""
    model_args = copy.deepcopy(config_args["model"])
    model_args["in_channels"] = input_data.get_num_x_modalities()
    model_args["ndim"] = len(image_size_getter()) + 2
    model_args.pop("device", None)  # placement comes from visible_devices
    tp = model_args.pop("transform_precision", None)
    if tp is not None:
        check_transform_precision(tp)
    model_name = model_args.pop("model_name")
    if model_name in _UNPORTED_MODELS:
        not_ported(f"model {model_name}", _UNPORTED_MODELS[model_name])
    if model_name != "HNOSegXS":
        raise ValueError(f"unknown model_name {model_name!r}")
    model_args["use_kernels"] = bool(model_args.pop("use_pallas", False))
    if isinstance(model_args.get("num_modes"), list):
        model_args["num_modes"] = tuple(model_args["num_modes"])
    return HNOSegXS(**model_args, device=device)
