"""Serving CLI, the port of
``multimodal_3d_image_segmentation_tpu/runtime/inference.py``.

Usage: ``python -m multimodal_3d_image_segmentation_tpu_torch.runtime.inference
config.ini`` with the same config dialect. Weights are read from
``<output_dir>/model/``, by what the run directory holds: ``model.pt``, a
torch state dict in the upstream reference's key names (the upstream
project's own weights-only format), or else ``model.msgpack``, the JAX
package's export (``utils/msgpack_params.py`` reads it and
``utils/jax_compat.py`` converts it), so a run directory that the JAX
package wrote serves here too. ``[model] compute_dtype = 'bfloat16'`` or
``'mixed'`` serves in that mode (every family). The model is shape-polymorphic, so a model trained at one size
serves at another (zero-shot super-resolution).
"""
from __future__ import annotations

import copy
import os
import sys
from functools import partial

from .. import not_ported
from ..data.dataset import InputData
from ..data.nifti import read_img
from ..data.normalization import normalize_modalities
from ..device import resolve_device
from .checkpoint import load_weights
from .config import get_config
from .run import _build_model, get_data_lists, warn_autocast
from .train_test import testing

__all__ = ["run_inference", "load_weights", "main"]


def run_inference(config_args):
    """Serve the test lists of ``config_args``; returns ``testing``'s
    timing and memory numbers."""
    if "parallel" in config_args:
        not_ported("[parallel] sharded serving", 15)
    output_dir = os.path.expanduser(config_args["main"]["output_dir"])
    device = resolve_device(config_args["main"].get("visible_devices"))

    input_lists = copy.deepcopy(config_args["input_lists"])
    data_dir = input_lists.get("data_dir")  # None = lists hold full paths
    data_dir = os.path.expanduser(data_dir) if data_dir else data_dir
    data_lists_test = get_data_lists(
        input_lists.get("data_lists_test_paths"), data_dir)

    input_args = copy.deepcopy(config_args["input_args"])
    if input_args.pop("use_data_normalization", True):
        mask_val = input_args.pop("mask_val", 0)
        clip_val = input_args.pop("clip_val", None)
        x_processing = partial(normalize_modalities, mask_val=mask_val,
                               clip_val=clip_val)
    else:
        x_processing = None
    input_data = InputData(reader=read_img, data_lists_test=data_lists_test,
                           x_processing=x_processing, **input_args)

    model = _build_model(config_args, input_data,
                         input_data.get_test_image_size, device)
    model.load_state_dict(load_weights(os.path.join(output_dir, "model"),
                                       model), strict=True)

    test_args = copy.deepcopy(config_args.get("test", {}))
    test_dir = os.path.join(output_dir,
                            test_args.pop("output_folder", "inference"))
    if test_args.pop("use_autocast", None):
        warn_autocast("test")
    return testing(model=model, input_data=input_data, output_dir=test_dir,
                   **test_args)


def main():
    run_inference(get_config(sys.argv[1]))


if __name__ == "__main__":
    main()
