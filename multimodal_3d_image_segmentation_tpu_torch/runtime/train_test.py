"""Training and serving loops, the port of
``multimodal_3d_image_segmentation_tpu/runtime/train_test.py``.

Training (``training``) keeps the upstream run artifacts and selection
rules (``experiments/train_test.py:31-286``): an epoch loop of train and
validation phases with the losses averaged per epoch and the schedule
stepped per batch; the best model is the lowest validation loss after
``selection_epoch_portion`` of the epochs, exported to ``model/model.pt``;
``model/checkpoint.pt`` every ``checkpoint_epoch`` epochs and on each new
best; a resumed run restores the states and cuts ``stdout.txt`` back to
the restored epoch's checkpoint line, so the loss curves that
``get_losses_from_file`` reads from the log stay consistent. Everything
printed goes to ``stdout.txt`` too; ``model_summary.txt`` lists the
parameters. ``model_graph.pdf`` and ``plot_loss.pdf`` need matplotlib,
imported only when they are drawn; without it a printed line says they
were not written.

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
import re
import time
from os.path import join
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.nifti import write_image
from ..utils.labels import remap_labels
from .checkpoint import load_checkpoint, save_checkpoint, save_model
from .steps import make_eval_step, make_predict_step, make_train_step

__all__ = ["training", "testing", "save_output", "get_losses_from_file",
           "plot_losses", "save_model_summary", "save_model_graph"]


class _Tee:
    """Print (when ``is_print``) and append to ``stdout.txt``: the
    upstream print-and-tee (``experiments/train_test.py:177-184``)."""

    def __init__(self, path, is_print=True):
        self.path = path
        self.is_print = is_print

    def __call__(self, *args, **kwargs):
        if self.is_print:
            print(*args, **kwargs)
        with open(self.path, "a") as f:
            print(*args, file=f, **kwargs)


def save_model_summary(model: torch.nn.Module, input_shape, path=None
                       ) -> str:
    """The parameters' names, shapes and counts, and their total (the
    upstream torchinfo summary's role, ``experiments/utils.py:122-134``)."""
    rows = [(name, tuple(p.shape), p.numel())
            for name, p in model.named_parameters()]
    width = max([len("Parameter")] + [len(r[0]) for r in rows])
    lines = [f"Model: {type(model).__name__}",
             f"Input shape: {tuple(input_shape)}", "",
             f"{'Parameter':<{width}}  {'Shape':<22}  Count"]
    lines += [f"{n:<{width}}  {str(s):<22}  {c:,}" for n, s, c in rows]
    lines += ["", f"Total params: {sum(r[2] for r in rows):,}"]
    txt = "\n".join(lines) + "\n"
    if path is not None:
        with open(path, "w") as f:
            f.write(txt)
    return txt


def save_model_graph(model: torch.nn.Module, path) -> None:
    """The module tree as a PDF (``model_graph.pdf``, the upstream
    torchview rendering's role): one box per module in definition order,
    indented by depth, with its own parameter count. Needs matplotlib."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    rows = [(name, type(m).__name__,
             sum(p.numel() for p in m.parameters(recurse=False)))
            for name, m in model.named_modules()]
    box_h, gap = 0.7, 0.35
    fig, ax = plt.subplots(figsize=(11, max(2.0, len(rows) * (box_h + gap)
                                            + 1.0)))
    ax.set_axis_off()
    for i, (name, type_name, n_params) in enumerate(rows):
        depth = name.count(".") + (1 if name else 0)
        text = f"{name or type(model).__name__}  [{type_name}]"
        if n_params:
            text += f"   params: {n_params:,}"
        ax.text(0.5 * depth, -i * (box_h + gap), text, fontsize=8,
                family="monospace", verticalalignment="center",
                bbox=dict(boxstyle="round,pad=0.35", facecolor="white",
                          edgecolor="#4c72b0", linewidth=1.2))
    ax.set_xlim(-0.5, 10.5)
    ax.set_ylim(-len(rows) * (box_h + gap) - 0.5, box_h)
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


#: Per-epoch scalar series recoverable from a training log.
LOG_SERIES = {
    "train_loss": re.compile(r"\btrain_loss:\s*(\S+)"),
    "valid_loss": re.compile(r"\bvalid_loss:\s*(\S+)"),
}


def get_losses_from_file(filename) -> Tuple[List[float], List[float]]:
    """(train_loss, valid_loss) per epoch, read back from ``stdout.txt``:
    the log is the source of the loss curves."""
    series = {name: [] for name in LOG_SERIES}
    with open(filename) as f:
        for line in f:
            for name, pattern in LOG_SERIES.items():
                m = pattern.search(line)
                if m:
                    series[name].append(float(m.group(1)))
    train_loss, valid_loss = series["train_loss"], series["valid_loss"]
    if len(train_loss) != len(valid_loss):
        raise ValueError(
            f"unbalanced loss log: {len(train_loss)} train_loss vs "
            f"{len(valid_loss)} valid_loss entries in {filename}")
    return train_loss, valid_loss


def plot_losses(num_epochs, start_plot_epoch, losses, styles, labels,
                output_file) -> None:
    """The loss curves (``plot_loss.pdf``), epochs before
    ``start_plot_epoch`` left out. Needs matplotlib."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(10, 5))
    epochs = np.arange(num_epochs)
    for series, style, label in zip(losses, styles, labels):
        y = np.asarray(series)[start_plot_epoch:num_epochs]
        ax.plot(epochs[start_plot_epoch:start_plot_epoch + len(y)], y,
                style, label=label)
    ax.set_xlabel("Epoch", fontsize=16)
    ax.set_ylabel("Value", fontsize=16)
    ax.tick_params(labelsize=14)
    ax.grid(True, which="both", alpha=0.5)
    ax.legend(loc="upper right", fontsize=14)
    fig.savefig(output_file, bbox_inches="tight")
    plt.close(fig)


def _has_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def _truncate_log(stdout_file: str, epoch: int) -> None:
    """Cut the log after the checkpoint line of ``epoch`` (else after the
    last checkpoint line)."""
    if not os.path.exists(stdout_file):
        return
    with open(stdout_file) as f:
        lines = f.readlines()
    cur = idx = last_any = None
    for i, ln in enumerate(lines):
        m = re.match(r"Epoch:\s*(\d+)", ln.strip())
        if m:
            cur = int(m.group(1))
        if "checkpoint" in ln:
            last_any = i
            if cur == epoch:
                idx = i
    if idx is None:
        idx = last_any
    if idx is not None:
        with open(stdout_file, "w") as f:
            f.writelines(lines[:idx + 1])


def _epoch_loss(losses: List[torch.Tensor]) -> float:
    """Mean of an epoch's device scalars, read back once, in float64."""
    if not losses:
        return math.nan
    return float(np.mean(torch.stack(losses).cpu().numpy()
                         .astype(np.float64)))


def training(model: torch.nn.Module, input_data, output_dir: str, loss_fn,
             optimizer: torch.optim.Optimizer, scheduler=None,
             label_mapping: Optional[Dict[int, int]] = None,
             num_epochs: int = 100, selection_epoch_portion: float = 0.8,
             checkpoint_epoch: int = 10, is_plot_model: bool = False,
             is_print: bool = True, plot_epoch_portion=None
             ) -> torch.nn.Module:
    """Train ``model`` in place on its device; returns it holding the best
    weights (those of the last epoch when no epoch was selected).

    Args mirror the upstream ``training`` (``experiments/train_test.py:
    31-68``); ``scheduler`` is stepped per batch
    (``runtime/optim.py::build_schedule``)."""
    model_dir = join(output_dir, "model")
    model_path = join(model_dir, "model.pt")
    chkpt_path = join(model_dir, "checkpoint.pt")
    stdout_file = join(output_dir, "stdout.txt")
    os.makedirs(model_dir, exist_ok=True)
    tee = _Tee(stdout_file, is_print)
    device = next(model.parameters()).device
    num_labels = model.out_channels
    input_shape = ((1, input_data.get_num_x_modalities())
                   + tuple(input_data.get_train_image_size()))

    if os.path.exists(chkpt_path):
        epoch, min_loss, best_epoch = load_checkpoint(
            chkpt_path, model, optimizer, scheduler)
        start_epoch = epoch + 1
        if start_epoch >= num_epochs:
            raise RuntimeError(
                f"Checkpoint detected, but start_epoch ({start_epoch}) >= "
                f"num_epochs ({num_epochs})")
        if is_print:
            print(f"Checkpoint loaded for epoch {start_epoch}")
        _truncate_log(stdout_file, epoch)
    else:
        start_epoch, min_loss, best_epoch = 0, float("inf"), None
        tee("train_num_batches:", input_data.get_train_num_batches())
        tee("valid_num_batches:", input_data.get_valid_num_batches())
        tee()
        save_model_summary(model, input_shape,
                           join(output_dir, "model_summary.txt"))
        if is_plot_model:
            if _has_matplotlib():
                save_model_graph(model, join(output_dir, "model_graph.pdf"))
            elif is_print:
                print("model_graph.pdf not written: matplotlib is not "
                      "installed")

    train_step = make_train_step(model, optimizer, scheduler, loss_fn,
                                 num_labels, label_mapping)
    eval_step = make_eval_step(model, loss_fn, num_labels, label_mapping)

    def put(x, y):
        return (torch.from_numpy(np.asarray(x, np.float32)).to(device),
                torch.from_numpy(np.asarray(y)).to(device))

    if is_print:
        print("Training started")
        print(output_dir)
    train_flow = input_data.get_train_flow(shuffle=True)
    valid_flow = input_data.get_valid_flow()
    start_time = time.time()
    try:
        for epoch in range(start_epoch, num_epochs):
            model.train()
            train_loss = _epoch_loss([train_step(*put(x, y))
                                      for x, y in train_flow])
            tee("\n-------------------------")
            tee(f"Epoch: {epoch}")
            tee(f"train_loss: {train_loss}")

            model.eval()
            valid_loss = _epoch_loss([eval_step(*put(x, y))
                                      for x, y in valid_flow])
            tee(f"valid_loss: {valid_loss}")

            # selection before the periodic save, so that a checkpoint of
            # a new best carries its min_loss and best_epoch
            selection_epoch = int(num_epochs * selection_epoch_portion)
            is_best = ((epoch > selection_epoch or epoch == num_epochs - 1)
                       and valid_loss < min_loss)
            if is_best:
                min_loss, best_epoch = valid_loss, epoch
                save_model(model_path, model)
            if (epoch + 1) % checkpoint_epoch == 0:
                save_checkpoint(chkpt_path, model, optimizer, scheduler,
                                epoch, min_loss, best_epoch)
                tee("Standard checkpoint saved.")
            elif is_best:
                save_checkpoint(chkpt_path, model, optimizer, scheduler,
                                epoch, min_loss, best_epoch)
                tee("Best checkpoint saved.")
    finally:
        train_flow.close()
        valid_flow.close()
    end_time = time.time()

    if best_epoch is not None:
        model.load_state_dict(torch.load(model_path, map_location=device,
                                         weights_only=True))
    else:  # no epoch ran, or no finite validation loss
        save_model(model_path, model)

    if _has_matplotlib():
        start_plot_epoch = (int(num_epochs * plot_epoch_portion)
                            if plot_epoch_portion is not None else 0)
        plot_losses(num_epochs, start_plot_epoch,
                    get_losses_from_file(stdout_file), ["r", "b--"],
                    ["Train loss", "Valid loss"],
                    join(output_dir, "plot_loss.pdf"))
    elif is_print:
        print("plot_loss.pdf not written: matplotlib is not installed")

    tee(f"\nTime used: {end_time - start_time:.2f} seconds.")
    tee(f"Best epoch: {best_epoch}")
    tee(f"Min loss: {min_loss}")
    return model


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
