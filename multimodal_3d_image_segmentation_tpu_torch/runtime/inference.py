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
``'mixed'`` serves in that mode (every family). The model is
shape-polymorphic, so a model trained at one size serves at another
(zero-shot super-resolution).

Depth-sharded serving: with ``[parallel] n_spatial = N`` (``n_data = 1``)
V-Net-DS's kernel path (``use_pallas = True``, fp32) serves split along
one image axis over N ranks, started as

    python -m torch.distributed.run --standalone --nproc-per-node N \
        -m multimodal_3d_image_segmentation_tpu_torch.runtime.inference \
        config.ini

Every rank reads the same volumes; rank 0 alone writes the labels,
``y_true_pred.npz`` and ``prediction_time_memory.txt``, and each rank
prints a line ``rank <r>: {...}``, a JSON object of its numbers
(``testing``'s) and its kernel launches (``parallel/multihost.py`` picks
the card and the backend).
"""
from __future__ import annotations

import copy
import json
import os
import sys
from functools import partial

from ..data.dataset import InputData
from ..data.nifti import read_img
from ..data.normalization import normalize_modalities
from ..kernels import LAUNCHES
from ..parallel import multihost
from .checkpoint import load_weights
from .config import get_config
from .run import _build_model, get_data_lists, serving_layout, warn_autocast
from .train_test import testing

__all__ = ["run_inference", "load_weights", "main"]


def run_inference(config_args):
    """Serve the test lists of ``config_args``; returns ``testing``'s
    timing and memory numbers (this rank's, when sharded)."""
    output_dir = os.path.expanduser(config_args["main"]["output_dir"])
    device, n_spatial = serving_layout(config_args)

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
                         input_data.get_test_image_size, device,
                         n_spatial=n_spatial)
    model.load_state_dict(load_weights(os.path.join(output_dir, "model"),
                                       model), strict=True)

    test_args = copy.deepcopy(config_args.get("test", {}))
    test_dir = os.path.join(output_dir,
                            test_args.pop("output_folder", "inference"))
    if test_args.pop("use_autocast", None):
        warn_autocast("test")
    if n_spatial is None:
        return testing(model=model, input_data=input_data,
                       output_dir=test_dir, **test_args)
    rank = multihost.process_index()
    is_print = test_args.pop("is_print", True)
    stats = testing(model=model, input_data=input_data, output_dir=test_dir,
                    is_print=is_print and rank == 0, writer=rank == 0,
                    **test_args)
    line = f"rank {rank}: " + json.dumps(dict(
        rank=rank, ranks=n_spatial, device=str(device), **stats,
        launches={k: v for k, v in LAUNCHES.items() if v}))
    sys.stdout.write(line + "\n")  # one write: the ranks share the console
    sys.stdout.flush()
    return stats


def main():
    run_inference(get_config(sys.argv[1]))


if __name__ == "__main__":
    main()
