"""Serving loop, the port of ``testing`` and ``save_output`` of
``multimodal_3d_image_segmentation_tpu/runtime/train_test.py``.

Per-volume prediction on the test split with the upstream protocol
(``experiments/train_test.py:384-426``): argmax on the device, the first
volume excluded from the average time, ``{pid}_true/_pred.nii.gz`` outputs
and ``prediction_time_memory.txt``. A volume's time is the wall clock from
the host batch to the label volume read back on the host (the readback
marks completion); CUDA events beside it give the device-side time of the
forward + argmax. Peak memory comes from PyTorch's caching allocator.
"""
from __future__ import annotations

import math
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..data.nifti import write_image
from ..utils.labels import remap_labels
from .steps import make_predict_step

__all__ = ["testing", "save_output"]


def save_output(y, data_lists_test, idx_sample, output_dir,
                output_origin=None, suffix=""):
    """Save a label map as ``{pid}{suffix}.nii.gz`` with the patient ID
    taken from the parent folder name (upstream
    ``experiments/utils.py:234-257``)."""
    y = np.asarray(y, dtype=np.uint8)
    fname = data_lists_test[0][idx_sample]
    pid = fname.split("/")[-2]
    out = os.path.join(output_dir, f"{pid}{suffix}.nii.gz")
    write_image(y, out, origin=output_origin)


def _memory_mib(device: torch.device) -> Dict[str, float]:
    if device.type != "cuda":
        nan = float("nan")
        return {"peak": nan, "peak_reserved": nan, "in_use": nan}
    mib = 1024 ** 2
    return {"peak": torch.cuda.max_memory_allocated(device) / mib,
            "peak_reserved": torch.cuda.max_memory_reserved(device) / mib,
            "in_use": torch.cuda.memory_allocated(device) / mib}


def testing(model: torch.nn.Module, input_data, output_dir: str,
            label_mapping: Optional[Dict[int, int]] = None,
            output_origin=None, is_print: bool = True,
            save_npz: bool = False) -> Dict[str, float]:
    """Predict every test volume, write the label maps and the timing and
    memory file; with ``save_npz`` also ``y_true_pred.npz``, the
    reference's bulk output: ``y_pred`` (the label maps stacked) and, where
    every volume has one, ``y_true``. Returns the numbers as a dict:
    ``avg_time_s`` (wall clock with readback, first volume excluded),
    ``avg_device_ms`` (CUDA events, first volume excluded; nan off CUDA),
    ``peak_mib``, ``peak_reserved_mib``, ``in_use_mib`` and
    ``n_volumes``."""
    if input_data.batch_size != 1:
        raise ValueError("testing() follows the per-volume protocol: set "
                         "[input_args] batch_size = 1")
    os.makedirs(output_dir, exist_ok=True)
    device = next(model.parameters()).device
    cuda = device.type == "cuda"
    data_lists_test = input_data.data_lists_test

    if is_print:
        print("test_num_batches:", input_data.get_test_num_batches())
        print()
        print("Testing started")
        print(output_dir)

    model.eval()
    predict_step = make_predict_step(model)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    test_flow = input_data.get_test_flow()
    start_time = time.time()
    predict_times, device_ms = [], []
    npz_true, npz_pred = [], []
    n = 0
    try:
        for i, xy in enumerate(test_flow):
            s_time = time.time()
            y_true = None
            if isinstance(xy, (tuple, list)):
                x, y = xy
                y_true = np.asarray(y, dtype=np.uint8)[0, 0]
            else:
                x = xy
            x = torch.from_numpy(np.asarray(x, np.float32)).to(device)
            if cuda:
                ev0 = torch.cuda.Event(enable_timing=True)
                ev1 = torch.cuda.Event(enable_timing=True)
                ev0.record()
            y_dev = predict_step(x)
            if cuda:
                ev1.record()
            y_pred = y_dev.cpu().numpy()  # readback = completion
            e_time = time.time()

            if y_true is not None:
                save_output(y_true, data_lists_test, i,
                            os.path.join(output_dir, "images"),
                            output_origin, "_true")
            y_pred = y_pred[0]
            if label_mapping is not None:
                y_pred = remap_labels(y_pred, label_mapping)
            save_output(y_pred, data_lists_test, i,
                        os.path.join(output_dir, "images"), output_origin,
                        "_pred")
            if save_npz:
                npz_true.append(y_true)
                npz_pred.append(y_pred)
            if i != 0:  # the first volume includes one-time set-up
                predict_times.append(e_time - s_time)
                if cuda:
                    device_ms.append(ev0.elapsed_time(ev1))
            n += 1
    finally:
        if hasattr(test_flow, "close"):
            test_flow.close()
    end_time = time.time()

    if save_npz:
        arrays = {"y_pred": np.stack(npz_pred)}
        if all(t is not None for t in npz_true):
            arrays["y_true"] = np.stack(npz_true)
        np.savez_compressed(os.path.join(output_dir, "y_true_pred.npz"),
                            **arrays)
    mem = _memory_mib(device)
    avg_time = float(np.mean(predict_times)) if predict_times else math.nan
    avg_dev = float(np.mean(device_ms)) if device_ms else math.nan

    lines = [f"Average prediction time: {avg_time}",
             f"peak_device_memory: {mem['peak']:.2f} MiB",
             f"device_memory_in_use: {mem['in_use']:.2f} MiB",
             f"peak_device_memory_reserved: {mem['peak_reserved']:.2f} MiB"]
    if is_print:
        print(f"\nTime used: {end_time - start_time:.2f} seconds.")
        print("\n".join(lines))
        print(f"Average device time (CUDA events): {avg_dev} ms")
    with open(os.path.join(output_dir, "prediction_time_memory.txt"),
              "w") as f:
        print("\n".join(lines), file=f)
    return {"avg_time_s": avg_time, "avg_device_ms": avg_dev,
            "peak_mib": mem["peak"], "peak_reserved_mib": mem["peak_reserved"],
            "in_use_mib": mem["in_use"], "n_volumes": n}
