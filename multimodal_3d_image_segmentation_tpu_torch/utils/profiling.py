"""Device-time profile of a serving step, or of a train step, on one
CUDA card.

    python -m multimodal_3d_image_segmentation_tpu_torch.utils.profiling \
        [--model hnosegxs|vnetds|hartleymha|hnoseg|fnoseg]
        [--tower-kernel block_s|block|resident] [--train]
        [--compute-dtype float32|bfloat16|mixed] [--trace trace.json]

At the width of the serving config (HNOSeg-XS: filters 24, blocks [3]*8;
V-Net-DS: base 24, blocks [1,2,3,3,3], right leg [0..4]; HartleyMHASeg:
filters 24, 16 blocks, 4 heads, modes (8,12,12), patch 2; HNOSeg and
FNOSeg: filters 24, 24 blocks, modes (10,14,14), shared weights, Hartley or
Fourier; seeded random weights, one random 4-modality 240x240x155 volume
already on the card) it prints:

  * forward + argmax in ms (CUDA events; median, min, max of 20 runs
    after 3 warm-ups) of the plain path and the kernel path, in the order
    plain, kernels, kernels, plain, so drift between the two shows (the
    kernel path on ``--tower-kernel`` where given: HartleyMHASeg takes
    block or block_s, HNOSeg and FNOSeg all three);
  * ``torch.profiler``'s table of 5 kernel-path steps, by self device time;
  * per step: the device busy time, each hand-written kernel's time, and
    the device's idle share over the span of the 5 back-to-back steps.

It excludes the host side of serving (NIfTI reads, the host-to-device
copy, the label readback), which ``runtime/train_test.py::testing``
measures. ``--train`` times and profiles the model's train step instead
(``runtime/steps.py::make_train_step``: forward, PCC loss, backward,
Adamax) at the configs' training size 120x120x78, batch 1, on a seeded
batch with seeded labels 0-3. ``--compute-dtype`` serves in 'bfloat16'
or 'mixed' (both paths; the kernel path on the bf16 instances).
"""
from __future__ import annotations

import argparse
import statistics
import subprocess

import numpy as np
import torch

from ..losses import PCCLoss
from ..models import HartleyMHASeg, HNOSegXS, NeuralOperatorSeg, VNetDS
from ..runtime.steps import make_predict_step, make_train_step

__all__ = ["step_ms", "profile_steps"]

MODELS = {
    "hnosegxs": (HNOSegXS, dict(in_channels=4, out_channels=4, filters=24,
                                num_transform_blocks=[3] * 8,
                                num_modes=(10, 14, 14))),
    "vnetds": (VNetDS, dict(in_channels=4, out_channels=4,
                            base_num_filters=24, num_blocks=[1, 2, 3, 3, 3],
                            right_leg_indexes=[0, 1, 2, 3, 4])),
    "hartleymha": (HartleyMHASeg, dict(in_channels=4, out_channels=4,
                                       filters=24, num_transform_blocks=16,
                                       num_heads=4, num_modes=(8, 12, 12),
                                       patch_size=2)),
    **{name: (NeuralOperatorSeg, dict(in_channels=4, out_channels=4,
                                      filters=24, num_transform_blocks=24,
                                      num_modes=(10, 14, 14),
                                      transform_type=transform))
       for name, transform in (("hnoseg", "Hartley"),
                               ("fnoseg", "Fourier"))},
}
SIZE = (240, 240, 155)
TRAIN_SIZE = (120, 120, 78)
SEED = 0
N_TIMED = 20
OWN_KERNELS = ("conv_in_kernel", "conv_in_mma_kernel", "freq_chain_kernel",
               "tail_kernel",
               "conv3_brick", "conv3_split_sum", "tower_block_kernel",
               "tower_block_mma_kernel",
               "tower_spectrum_tiles", "tower_block_s_kernel",
               "tower_block_s_mma_kernel",
               "tower_spectrum_z", "tower_spectrum_depth",
               "tower_resident_kernel", "tower_resident_mma_kernel")
N_PROFILED = 5


def step_ms(step, x, runs: int, warmup: int = 3):
    """CUDA-event times in ms of ``runs`` calls of ``step(x)``."""
    for _ in range(warmup):
        step(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        step(x)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def _busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def profile_steps(step, x, trace=None):
    """Profile ``N_PROFILED`` steps; returns the profiler and a summary."""
    from torch.profiler import ProfilerActivity, profile
    step(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(N_PROFILED):
            step(x)
        torch.cuda.synchronize()
    if trace:
        prof.export_chrome_trace(trace)
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    summary = {"device_events": len(dev)}
    if spans:
        span = max(e for _, e in spans) - min(s for s, _ in spans)
        busy = _busy_us(spans)
        summary.update(
            busy_ms_per_step=busy / 1e3 / N_PROFILED,
            idle_share=1 - busy / span,
            kernels_per_step=len(dev) / N_PROFILED,
            **{f"{k}_ms_per_step": sum(
                e.time_range.end - e.time_range.start for e in dev
                if k in e.name) / 1e3 / N_PROFILED
               for k in OWN_KERNELS})
    return prof, summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(MODELS), default="hnosegxs")
    ap.add_argument("--tower-kernel", choices=("block_s", "block",
                                               "resident"),
                    help="the spectral towers' kernel (default: the "
                         "model's)")
    ap.add_argument("--train", action="store_true",
                    help="the train step at 120x120x78")
    ap.add_argument("--compute-dtype", default="float32",
                    choices=("float32", "bfloat16", "mixed"),
                    help="the model's compute dtype (serving only in "
                         "'bfloat16' and 'mixed')")
    ap.add_argument("--trace", help="write a Chrome trace here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA device")
    dev = torch.device("cuda:0")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    size = TRAIN_SIZE if args.train else SIZE
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.standard_normal((1, 4) + size,
                                             dtype=np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, 4, (1, 1) + size).astype(
        np.float32)).to(dev)
    cls, kw = MODELS[args.model]
    steps = {}
    if args.tower_kernel:
        kw = dict(kw, tower_kernel=args.tower_kernel)
    if args.compute_dtype != "float32":
        kw = dict(kw, compute_dtype=args.compute_dtype)
    for use_kernels in (False, True):
        model = cls(**kw, use_kernels=use_kernels, device=dev,
                    generator=torch.Generator().manual_seed(SEED))
        if args.train:
            opt = torch.optim.Adamax(model.parameters(), lr=5e-3)
            steps[use_kernels] = (lambda a, s=make_train_step(
                model, opt, None, PCCLoss(), 4): s(a, y))
        else:
            steps[use_kernels] = make_predict_step(model.eval())
    fast = "kernels" + (f" (tower_kernel={args.tower_kernel})"
                        if args.tower_kernel else "")
    what = "train step" if args.train else "forward+argmax"
    for name, use_kernels in (("plain", False), (fast, True), (fast, True),
                              ("plain", False)):
        t = step_ms(steps[use_kernels], x, N_TIMED)
        print(f"{args.model} {name} {what} ms median "
              f"{statistics.median(t):.4f} "
              f"min {min(t):.4f} max {max(t):.4f} ({N_TIMED} runs, "
              f"size {size})")
    prof, summary = profile_steps(steps[True], x, args.trace)
    print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                    row_limit=20))
    print(f"kernel path, {N_PROFILED} back-to-back steps: " + ", ".join(
        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in summary.items()))


if __name__ == "__main__":
    main()
