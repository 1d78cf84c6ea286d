#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Usage, from the root of a checkout:  python3 chip_smoke.py

Drives the port's serving paths once at full width on 4-modality
240x240x155 volumes, batch 1, fp32, random weights from a seed: HNOSeg-XS
(filters 24, blocks [3]*8, modes (10,14,14); also with ``[model]
compute_dtype`` 'bfloat16' and 'mixed'), V-Net-DS (base 24, blocks
[1,2,3,3,3], right leg [0..4], 22,547,764 parameters; also in 'bfloat16'
and 'mixed', and depth-sharded over 2 ranks on the card), HartleyMHASeg
(filters 24, 16 blocks, 4 heads, modes (8,12,12), patch 2, deep
supervision, 178,532 parameters; also in 'bfloat16' and 'mixed'), and
HNOSeg and FNOSeg (NeuralOperatorSeg: filters 24, 24 blocks, modes
(10,14,14), shared weights, Hartley or Fourier, 57,360 and 71,184
parameters), the last two on their default tower kernel ``tower_kernel``
'block' and on 'resident', HNOSeg also on 'block_s', and both in
'bfloat16' and 'mixed' on all three; then trains each of the five
families at the same widths on 1x4x120x120x78 volumes, the configs'
training size. It checks them:

  1. device   the card's name and power limit, torch and CUDA versions;
  2. build    compile the CUDA kernels from ``csrc/`` (one nvcc per source,
              all at once, sm_90a);
  3. kernels  conv_in (also at the odd-D/H shape 239x239x155),
              freq_chain (both also timed back to back, with their
              registers and spills from the build log), tail_resize,
              tower_block (at the three shapes
              it serves: HartleyMHASeg's, HNOSeg's and FNOSeg's),
              tower_block_s (at the same three) and tower_resident (the
              whole 24-block tower at HNOSeg's and FNOSeg's shapes, with
              its phase clock, the z phase included) against their plain
              PyTorch versions at the serving shapes, with their times,
              the plain versions' and the bound (tail_resize's rate
              against 3.35 TB/s; tower_block_s's time beside tower_block
              with the depth stages around it), the tower kernels'
              registers and spills from the build log, their occupancy
              and tower_resident's persistent grid;
  3b. bf16   the bf16 instances of conv_in (also at 239x239x155, batch
              element 1 of two), freq_chain and tail_resize (fp32 and bf16
              probabilities) against their plain twins in the working type
              (one bf16 ulp; the chain one more ulp of its largest
              magnitude; at most 1e-3 of the elements more than one ulp
              of their own magnitude apart, which the chain rounded once
              at its end or with its first stage unrounded must fail),
              with their times, bounds and the fp32 instances' times in
              the same run;
  3c. towers  the 'bfloat16' and 'mixed' instances of tower_block and
              tower_block_s at the three shapes, and of tower_resident at
              HNOSeg's and FNOSeg's, against their plain twins in the
              working type (bf16 outputs: one ulp plus one ulp of the
              largest magnitude, at most 1e-3 of the elements more than one
              ulp of their own magnitude plus 1e-5 apart; fp32 outputs 1e-4
              of the largest magnitude; tower_resident one block so, two
              and 24 blocks at most 2x the twin's distance from float64),
              with controls (the twin with one of its roundings left out)
              that must fail, each instance's time beside the fp32
              instance's and its bound;
  4. serve    ``runtime/inference.py::run_inference`` on 3 synthetic NIfTI
              cases through ``configs/config_inference_hnoseg_xs.ini``; the
              launch counts (reset just before) must be 3 / 24 / 3; then
              with ``compute_dtype = 'bfloat16'`` set on the loaded config
              (conv_in_bf16 3, freq_chain_bf16 24, tail_resize_bf16 3) and
              with 'mixed' (conv_in_bf16 3, freq_chain 24, tail_resize_bf16
              3), each with its wall, device and peak beside fp32's;
  4b. gate    ``utils/precision_gate.py``: HNOSeg-XS trained 400 steps at
              1x4x120x120x78 on synthetic blob volumes, evaluated zero-shot
              at 240x240x155 in every mode; fails unless the oracle learned
              every class, both bf16 modes' kernel paths keep the
              whole-model rule against their twins paths (the same
              formulation in plain ops) and a control with 4-bit weights
              breaks it; the 1e-3 Dice bar is reported;
  5. model    the HNOSeg-XS kernel path against the plain path
              (``use_kernels=False``) with the same weights, both held to a
              float64 evaluation: on one served volume on the card, and on
              a small volume against the CPU. Two controls, the kernel path
              fed TF32-rounded operands (as a kernel on TF32 tensor cores
              would compute), must fail the same bars;
  6. conv3    every conv3 call of one V-Net-DS forward (recorded with its
              real inputs) against the plain version, with each call's
              launch plan (brick, channel tile, chunk, split) beside the
              kernel's, the plain version's and ``F.conv3d``'s times and
              the bound, and the kernel's registers and spills from the
              build log; the kernel's total must be below ``F.conv3d``'s;
  6b. conv3 bf16  every conv3 call of one V-Net-DS forward in 'bfloat16'
              and in 'mixed' (recorded with its real inputs) on the
              tensor-core body (``csrc/conv3_mma.cu``) against its plain
              twin (one bf16 ulp, at most 1e-3 of the elements more than one
              ulp of their own magnitude apart, the fp32 moments 1e-5 of the
              sums of |y| and y^2; the stride-2 calls' moments, of the
              rounded outputs, against float64 sums of the kernel's own
              output), a second run bit-identical, and the twin with the
              prologue output unrounded (and in 'bfloat16' the fp32
              weights) as controls that must fail; each call's launch plan
              (M tiles a warp, brick, warps along N, chunk, split) and time
              beside the fp32 instance's on the same call, the plain
              twin's, cuDNN's bf16 ``F.conv3d`` + bias and the bound, and
              the tensor-core body's registers and spills from the build
              log; each instance's total is printed beside cuDNN's bf16
              total at the end of the run;
  6c. conv3 halo  conv3's halo mode (depth-sharded slabs) in all three
              instances at every level-0 and level-1 call of V-Net-DS in
              the orientation a sharded forward runs it (image axis 2 as
              depth: 78 and 39 planes), each on a first, a middle and a
              last slab (keep flags (0, 1), (1, 1), (1, 0)): stride 1 with
              the prologue, virtual concat, residual tap and moments,
              stride 2 and dilation 2, against the plain twin at 6's bar
              (the bf16 instances at 6b's, with its controls); the twin
              with the read halo planes zeroed, and where a prologue meets
              a global end the twin with that keep flag forced to 1, are
              controls that must fail; the first rank's calls of a sharded
              forward timed beside ``F.conv3d`` + bias over the halo'd slab
              and the bound; the depth-dilated mode (``dilated_depth``) on
              the last up conv's source against its twin, timed beside
              ``F.conv3d`` over the dilated volume;
  7. serve    run_inference serves the same cases through
              ``configs/config_vnet-ds.ini``; launches (reset just before)
              must be conv_in 3, conv3 87, tail_resize 3; then with
              ``compute_dtype`` 'bfloat16' (conv_in_bf16 3, conv3_bf16 87,
              tail_resize_bf16 3) and 'mixed' (conv3_mixed 87), each with
              its wall, device and peak beside fp32's; then V-Net-DS
              depth-sharded over 2 ranks through the real entry point,
              ``python -m torch.distributed.run --standalone
              --nproc-per-node 2 -m ...runtime.inference`` on the INI with
              ``[parallel] n_data = 1, n_spatial = 2`` (the two ranks share
              the card over gloo; NCCL across cards is not exercised):
              each rank's launches (conv_in 1, conv3 27, conv3_halo 2,
              tail_resize 1 a forward) and peak memory, the labels against
              the unsharded serve's (at most 1e-5 of the voxels apart);
              beside it a direct forward over 2 ranks spawned from the
              script: its probabilities within 1e-4 of the unsharded kernel
              path and at most 2x its distance from the float64 model,
              which the forward with its halo exchange replaced by zeros
              must fail (both run in the background during the gate and
              the model phase below, which time nothing, and are checked
              after them); the precision
              gate of a trained V-Net-DS (4b's rule; the control's 4-bit
              weights the conv3 weights, the probe the prologue output
              unrounded);
  8. model    the V-Net-DS kernel path against its plain path and float64,
              on a served volume and on a small volume against the CPU; a
              control with conv3's operands in TF32 must fail the bars;
  9. serve    run_inference serves the same cases through
              ``configs/config_hartleymha.ini``; launches (reset just before)
              must be conv_in 3, tower_block 48, tail_resize 3; then with
              ``compute_dtype`` 'bfloat16' (conv_in_bf16 3, tower_block_bf16
              48, tail_resize_bf16 3) and 'mixed' (tower_block_mixed 48);
              then the precision gate of a trained HartleyMHASeg (4b's
              rule, its kernel path on tower_block);
 10. model    the HartleyMHASeg kernel path against its plain path and
              float64, on a served volume and on a small volume against the
              CPU, with both tower kernels; a control with tower_block's
              operands in TF32 must fail the bars;
 11. serve    run_inference serves the same cases through
              ``configs/config_hnoseg.ini`` and ``configs/config_fnoseg.ini``;
              launches (reset just before each) must be conv_in 3,
              tower_block 72, tail_resize 3; then again with
              ``tower_kernel = 'resident'`` set on the loaded config:
              conv_in 3, tower_resident 3, tail_resize 3; HNOSeg also with
              ``tower_kernel = 'block_s'``: conv_in 3, tower_block_s 72,
              tail_resize 3; then each in 'bfloat16' and 'mixed' on all
              three tower kernels (conv_in_bf16 3, tail_resize_bf16 3 and
              72 of tower_block's or tower_block_s's instance, or 3 of
              tower_resident's); then the precision gate of each trained
              family (HNOSeg's kernel paths on all three tower kernels);
 12. model    for each of the two, the kernel paths on tower_block (the
              default), tower_block_s and tower_resident against the plain
              path and float64 on a served volume, and the first on a
              small volume against the CPU; a control with each tower
              kernel's operands in TF32 must fail the bars; forward +
              argmax times of the three tower kernels;
 13. backward the backward passes (each kernel's forward, its
              ``torch.autograd.Function``'s backward) against autograd
              through the plain twins, with their times beside the plain
              graphs': conv_in (with and without SELU), freq_chain and
              tail_resize at HNOSeg-XS's training shapes, tower_block at
              HartleyMHASeg's, HNOSeg's and FNOSeg's (the 61x61x40 grid of
              a 120x120x78 volume), tower_block_s at HNOSeg's,
              tower_resident (HNOSeg's 24-block tower, with the peak memory
              of its replay), and conv3 at every call of one V-Net-DS
              training forward at 1x4x120x120x78; run after serving in the
              same process, so the matrices serving cached under inference
              mode are saved for backward here;
 14. train    one full-width train step of each family at 1x4x120x120x78
              on the kernel path and the plain path from the same weights:
              HNOSeg-XS, V-Net-DS, HartleyMHASeg, HNOSeg (on tower_block,
              tower_block_s and tower_resident) and FNOSeg; the launches a
              step (conv_in 1 and tail_resize 1, with freq_chain 8, conv3
              29, tower_block 16 or 24, tower_block_s 24 or
              tower_resident 1); the loss and every gradient held to a
              float64 evaluation, each tensor on its own
              (``utils/train_bars.py``: HNOSeg-XS and V-Net-DS each
              tensor's largest error at most 2x the plain path's plus 1e-6
              of scale; the three towers the loss so, and each gradient's
              RMS error at most 5x the larger of the plain path's and the
              plain twins path's (which must launch no kernel) and of their
              typical level, as SELU's kink moves gradients by chance
              factors on any fp32 path, and the typical error at most 2x);
              a fault planted in one tower gradient (a block's w_cc_t
              columns scaled by 1.05) that must fail, with the smallest
              scaling the rules fail; a TF32 control that must fail
              (conv_in's, conv3's or tower_block's operands rounded); each
              path's step time (forward, backward, Adamax) and peak
              memory;
 15. run      ``runtime/run.py::run`` on ``configs/config_hnoseg_xs.ini``,
              ``config_vnet-ds.ini``, ``config_hartleymha.ini``,
              ``config_hnoseg.ini`` and ``config_fnoseg.ini`` (1 epoch
              each) on 4 train and 2 valid
              synthetic cases at 120x120x78, then test and statistics on
              2; the launches of each run (reset just before); its
              artifacts and finite losses; run_inference on each run
              directory gives the run's own test labels.

Every failed check raises, so the exit code is not 0. The script refuses
to run without CUDA. The line before the last is a JSON object with the
kernels' numbers (``launches`` summed over the serving runs, both ranks
of the sharded one, and the runs; conv3_halo's times are of the first
rank's calls of a sharded forward; the bf16 instances carry ``fp32_ms``, the fp32 instance's time in
the same run, and conv_in_bf16 the odd shape's numbers (``odd_*``),
tail_resize_bf16 the bf16 output's (``out_*``); ``backward_ms`` and
``backward_plain_ms`` from phase 13; times are
medians of CUDA-event runs, conv3's of back-to-back calls, and conv_in and
freq_chain also give ``stream_ms``, back to back; ``bound_ms`` is
the larger of the bytes over 3.35 TB/s and the operations over 67 TFLOP/s
fp32, the H100 SXM's data sheet rates); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
SEED = 0
SHAPE = (240, 240, 155)
FLAGSHIP = dict(in_channels=4, out_channels=4, filters=24,
                num_transform_blocks=[3] * 8, num_modes=(10, 14, 14))
VNET = dict(in_channels=4, out_channels=4, base_num_filters=24,
            num_blocks=[1, 2, 3, 3, 3], right_leg_indexes=[0, 1, 2, 3, 4])
MHA = dict(in_channels=4, out_channels=4, filters=24, num_transform_blocks=16,
           num_heads=4, num_modes=(8, 12, 12), patch_size=2)
NOSEG = dict(in_channels=4, out_channels=4, filters=24,
             num_transform_blocks=24, num_modes=(10, 14, 14))
# the tower grid of a 240x240x155 volume after conv_in (k 2, stride 2, pad 1)
GRID = (121, 121, 78)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOPS = 67e12          # H100 SXM data sheet, CUDA cores
BF16_FLOPS = 989e12         # H100 SXM data sheet, bf16 tensor cores, dense
# The bound of every instance with a bf16 volume, 'mixed' too, takes its
# operations at BF16_FLOPS: the TPU kernels compute a bf16 activation times
# an fp32-class weight as bf16 matrix passes (the weight split hi/lo), work
# the card's bf16 tensor cores can do. Counted as two passes, the
# operations' time would double.
N_CASES = 3
# CUDA-event runs each kernel time is the median of: few enough that the
# whole script stays near 900 s
N_TIMED = 10
# (kernel, source, the TPU kernel's pallas_call it replaces)
KERNELS = [
    ("conv_in", "multimodal_3d_image_segmentation_tpu_torch/csrc/conv_in.cu",
     "multimodal_3d_image_segmentation_tpu/kernels/conv_in.py:277"),
    ("freq_chain",
     "multimodal_3d_image_segmentation_tpu_torch/csrc/freq_chain.cu",
     "multimodal_3d_image_segmentation_tpu/kernels/freq_chain.py:58"),
    ("tail_resize",
     "multimodal_3d_image_segmentation_tpu_torch/csrc/tail_resize.cu",
     "multimodal_3d_image_segmentation_tpu/kernels/tail_resize.py:149"),
    ("conv3", "multimodal_3d_image_segmentation_tpu_torch/csrc/conv3.cu",
     "multimodal_3d_image_segmentation_tpu/kernels/conv3d_flat.py:305"),
    ("tower_block",
     "multimodal_3d_image_segmentation_tpu_torch/csrc/tower_block.cu",
     "multimodal_3d_image_segmentation_tpu/kernels/tower_block.py:377"),
    ("tower_block_s",
     "multimodal_3d_image_segmentation_tpu_torch/csrc/tower_block_s.cu",
     "multimodal_3d_image_segmentation_tpu/kernels/tower_block_s.py:332"),
    ("tower_resident",
     "multimodal_3d_image_segmentation_tpu_torch/csrc/tower_resident.cu",
     "multimodal_3d_image_segmentation_tpu/kernels/tower_resident.py:244"),
    # the bf16 instances ([model] compute_dtype 'bfloat16' and 'mixed')
    ("conv_in_bf16",
     "multimodal_3d_image_segmentation_tpu_torch/csrc/conv_in.cu",
     "multimodal_3d_image_segmentation_tpu/kernels/conv_in.py:277"),
    ("freq_chain_bf16",
     "multimodal_3d_image_segmentation_tpu_torch/csrc/freq_chain.cu",
     "multimodal_3d_image_segmentation_tpu/kernels/freq_chain.py:58"),
    ("tail_resize_bf16",
     "multimodal_3d_image_segmentation_tpu_torch/csrc/tail_resize.cu",
     "multimodal_3d_image_segmentation_tpu/kernels/tail_resize.py:149"),
    # the tower kernels' 'bfloat16' and 'mixed' instances
    ("tower_block_bf16",
     "multimodal_3d_image_segmentation_tpu_torch/csrc/tower_block.cu",
     "multimodal_3d_image_segmentation_tpu/kernels/tower_block.py:377"),
    ("tower_block_mixed",
     "multimodal_3d_image_segmentation_tpu_torch/csrc/tower_block.cu",
     "multimodal_3d_image_segmentation_tpu/kernels/tower_block.py:377"),
    ("tower_block_s_bf16",
     "multimodal_3d_image_segmentation_tpu_torch/csrc/tower_block_s.cu",
     "multimodal_3d_image_segmentation_tpu/kernels/tower_block_s.py:332"),
    ("tower_block_s_mixed",
     "multimodal_3d_image_segmentation_tpu_torch/csrc/tower_block_s.cu",
     "multimodal_3d_image_segmentation_tpu/kernels/tower_block_s.py:332"),
    ("tower_resident_bf16",
     "multimodal_3d_image_segmentation_tpu_torch/csrc/tower_resident.cu",
     "multimodal_3d_image_segmentation_tpu/kernels/tower_resident.py:244"),
    ("tower_resident_mixed",
     "multimodal_3d_image_segmentation_tpu_torch/csrc/tower_resident.cu",
     "multimodal_3d_image_segmentation_tpu/kernels/tower_resident.py:244"),
    # conv3's 'bfloat16' and 'mixed' instances
    ("conv3_bf16", "multimodal_3d_image_segmentation_tpu_torch/csrc/conv3.cu",
     "multimodal_3d_image_segmentation_tpu/kernels/conv3d_flat.py:305"),
    ("conv3_mixed", "multimodal_3d_image_segmentation_tpu_torch/csrc/conv3.cu",
     "multimodal_3d_image_segmentation_tpu/kernels/conv3d_flat.py:305"),
    # conv3's halo mode (depth-sharded volumes): the Pallas kernel body
    # with halo=True, in each instance
    ("conv3_halo", "multimodal_3d_image_segmentation_tpu_torch/csrc/conv3.cu",
     "multimodal_3d_image_segmentation_tpu/kernels/conv3d_flat.py:105"),
    ("conv3_halo_bf16",
     "multimodal_3d_image_segmentation_tpu_torch/csrc/conv3.cu",
     "multimodal_3d_image_segmentation_tpu/kernels/conv3d_flat.py:105"),
    ("conv3_halo_mixed",
     "multimodal_3d_image_segmentation_tpu_torch/csrc/conv3.cu",
     "multimodal_3d_image_segmentation_tpu/kernels/conv3d_flat.py:105"),
]


def per_volume(**counts):
    """A main path's launches per volume: ``counts``, 0 for every other
    kernel."""
    return {name: counts.get(name, 0) for name, _, _ in KERNELS}


# each main path's launches per volume
PER_VOLUME_HNOSEG = per_volume(conv_in=1, freq_chain=8, tail_resize=1)
PER_VOLUME_HNOSEG_BF16 = per_volume(conv_in_bf16=1, freq_chain_bf16=8,
                                    tail_resize_bf16=1)
# 'mixed': the spectra stay fp32, so the chain takes its fp32 instance
PER_VOLUME_HNOSEG_MIXED = per_volume(conv_in_bf16=1, freq_chain=8,
                                     tail_resize_bf16=1)
PER_VOLUME_VNET = per_volume(conv_in=1, tail_resize=1, conv3=29)
PER_VOLUME_VNET_BF16 = per_volume(conv_in_bf16=1, tail_resize_bf16=1,
                                  conv3_bf16=29)
PER_VOLUME_VNET_MIXED = per_volume(conv_in_bf16=1, tail_resize_bf16=1,
                                   conv3_mixed=29)
PER_VOLUME_MHA = per_volume(conv_in=1, tail_resize=1, tower_block=16)
PER_VOLUME_NOSEG = per_volume(conv_in=1, tail_resize=1, tower_block=24)
PER_VOLUME_NOSEG_BLOCK_S = per_volume(conv_in=1, tail_resize=1,
                                      tower_block_s=24)
PER_VOLUME_NOSEG_RESIDENT = per_volume(conv_in=1, tail_resize=1,
                                       tower_resident=1)


def per_volume_tower(mode, tower, n):
    """A tower family's launches per volume in a bf16 mode: conv_in's and
    the tail's bf16 instances and ``n`` launches of ``tower``'s instance
    ('bfloat16' or 'mixed')."""
    suffix = "_bf16" if mode == "bfloat16" else "_mixed"
    return per_volume(conv_in_bf16=1, tail_resize_bf16=1,
                      **{tower + suffix: n})
BF16_ULP = 2.0 ** -7  # one bf16 ulp, relative
# the share of a bf16 output's elements that may lie more than one ulp of
# their own magnitude from the plain twin's. On an H100 (700 W) the chain
# and the tail read 0 and conv_in 8.4e-7; the chain rounded once at its
# end read 0.141 and with its first stage unrounded 0.147 (the controls of
# phase_kernels_bf16, which must fail)
BF16_SHARE = 1e-3
# the tower kernels' fp32 outputs of a bf16 instance (s_f, 'mixed''s f, ds):
# a rounding flipped upstream moves them by about one bf16 ulp of one
# operand's contribution, 1.3e-5 of the largest magnitude at most on an
# H100 (700 W); the controls of phase_towers_bf16 read 2e-4 to 4e-4
TOWER_FP32_REL = 1e-4


T0 = time.perf_counter()


def header(text):
    """A phase's header line, with the seconds since the script started."""
    print(f"{text} (at {time.perf_counter() - T0:.0f} s)", flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def median_ms(torch, fn, n=N_TIMED, warmup=3):
    """Median of ``n`` CUDA-event timings of ``fn`` after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(flops, nbytes, peak=FP32_FLOPS):
    """(ms, 'bytes' or 'operations'): the least time on the card, the
    operations at ``peak`` (the rate of their operands' type)."""
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                     else "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def phase_device(torch):
    header("== device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print(smi[0])
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"devices {torch.cuda.device_count()}")


def phase_build(kernels):
    header("== build")
    t0 = time.perf_counter()
    lib = kernels.library()
    print(f"kernel library {lib.path.name}: nvcc {lib.build_seconds:.2f} s, "
          f"build + load {time.perf_counter() - t0:.2f} s")
    # each kernel's registers, shared memory and spills (ptxas -v)
    for line in lib.build_log.splitlines():
        if "Used" in line or "spill" in line or "Function properties" in line:
            print(line.strip())


def held_to(torch, got, want, tol, share_atol=0.0):
    """(passed, max abs err, (rtol, atol), share): ``got`` against
    ``want`` within ``tol`` = (rtol, atol) (or a function of the float
    ``want`` giving them) on every element; for a bf16 output also the
    share of elements more than one ulp of their own magnitude (plus
    ``share_atol``) apart, which must stay within ``BF16_SHARE`` (else
    None)."""
    gf, wf = got.float(), want.float()
    rtol, atol = tol(wf) if callable(tol) else tol
    d = (gf - wf).abs()
    err = float(d.max())
    ok = bool(np.isfinite(err)) and float((d - rtol * wf.abs()).max()) <= atol
    share = None
    if got.dtype == torch.bfloat16:
        mag = torch.maximum(gf.abs(), wf.abs()).clamp_min(2.0 ** -126)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        share = float((d > ulp + share_atol).float().mean())
        ok = ok and share <= BF16_SHARE
    return ok, err, (rtol, atol), share


def kernel_case(torch, kernels, name, kern, plain, tol, bnd, lib):
    """Launch ``kern`` once (its kernel's count must move by one), hold it
    to ``plain`` in the output's type within ``tol`` (``held_to``), and
    time the kernel, the
    plain version and the library call ``lib``; returns the result and
    the kernel's output."""
    launched = name.removesuffix("_odd").removesuffix("_out")
    before = kernels.LAUNCHES[launched]
    got = kern()
    torch.cuda.synchronize()
    check(kernels.LAUNCHES[launched] == before + 1,
          f"{name}: launch count did not move")
    want = plain()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: {tuple(got.shape)} {got.dtype} != {tuple(want.shape)} "
          f"{want.dtype}")
    ok, err, (rtol, atol), share = held_to(torch, got, want, tol)
    check(ok, f"{name}: max abs err {err}, tolerance (rtol {rtol:g}, atol "
              f"{atol:g}), share more than one bf16 ulp apart {share} "
              f"(bar {BF16_SHARE:g})")
    if share is not None:
        print(f"{name}: {share:.3e} of the elements more than one bf16 ulp "
              f"apart (bar {BF16_SHARE:g})")
    ms = median_ms(torch, kern)
    plain_ms = median_ms(torch, plain)
    lib_ms = median_ms(torch, lib) if lib is not None else None
    b_ms, b_by = bnd
    print(f"{name}: out {tuple(got.shape)} {str(got.dtype)[6:]} max_abs_err "
          f"{err:.3e} (rtol {rtol:g}, atol {atol:.3g})  kernel {ms:.4f} ms  "
          f"plain {plain_ms:.4f} ms  library "
          f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms  bound "
          f"{b_ms:.4f} ms ({b_by}) (medians of {N_TIMED}, CUDA events)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}, got


def print_rate(name, logits, probs, ms):
    moved = nbytes(logits, probs)
    rate = moved / (ms * 1e-3)
    print(f"{name}: {rate / 1e9:.1f} GB/s of {moved / 1e6:.1f} MB (logits "
          f"in, probabilities out), {rate / HBM_BYTES_PER_S:.1%} of 3.35 "
          "TB/s")


def phase_kernels(torch, kernels, dev):
    """Each HNOSeg-XS kernel against its plain version at the serving
    shapes; conv_in and freq_chain also back to back (``stream_ms``), with
    their registers and spills from the build log."""
    header("== kernels")
    import torch.nn.functional as F
    from multimodal_3d_image_segmentation_tpu_torch.utils.tower_sweep import \
        EDGE_KINDS, build_report, stream_ms
    build_report(EDGE_KINDS)
    rng = np.random.default_rng(SEED)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    x = t(rng.standard_normal((1, 4) + SHAPE))
    odd = (239, 239, 155)  # odd D and H: the Pallas kernel's other variant
    x_odd = t(rng.standard_normal((1, 4) + odd))
    out_odd = 120 * 120 * 78
    w = t(rng.standard_normal((24, 4, 2, 2, 2)) / np.sqrt(32))
    b = t(rng.uniform(-0.1, 0.1, 24))
    spec = t(rng.standard_normal((1, 20, 28, 28, 24)))
    ws = [t(rng.standard_normal((24, 24)) / np.sqrt(24)) for _ in range(3)]
    logits = t(rng.standard_normal((1, 4, 121, 121, 78)))
    out_cl = 121 * 121 * 78
    rows = spec.numel() // 24
    cases = {  # kernel, plain, (rtol, atol), bound, library call
        "conv_in": (lambda: kernels.conv_in_s2d(x, w, b),
                    lambda: kernels.conv_in_plain(x, w, b), (0, 1e-5),
                    bound(2 * out_cl * 8 * 4 * 24,
                          nbytes(x, w, b) + out_cl * 24 * 4),
                    lambda: F.conv3d(x, w, b, stride=2, padding=1)),
        "conv_in_odd": (lambda: kernels.conv_in_s2d(x_odd, w, b),
                        lambda: kernels.conv_in_plain(x_odd, w, b),
                        (0, 1e-5),
                        bound(2 * out_odd * 8 * 4 * 24,
                              nbytes(x_odd, w, b) + out_odd * 24 * 4),
                        lambda: F.conv3d(x_odd, w, b, stride=2, padding=1)),
        "freq_chain": (lambda: kernels.fused_freq_chain(spec, ws),
                       lambda: kernels.freq_chain_plain(spec, ws), (0, 1e-5),
                       bound(3 * 2 * rows * 24 * 24,
                             2 * nbytes(spec) + nbytes(*ws)), None),
        "tail_resize": (lambda: kernels.fused_tail_softmax(logits, SHAPE),
                        lambda: kernels.tail_plain(logits, SHAPE), (0, 1e-6),
                        # 7 lerps and the softmax's exp, sum and divide
                        bound(17 * 4 * int(np.prod(SHAPE)),
                              nbytes(logits) + 4 * 4 * int(np.prod(SHAPE))),
                        None),
    }
    results = {}
    with torch.inference_mode():
        for name, (kern, plain, tol, bnd, lib) in cases.items():
            results[name], got = kernel_case(torch, kernels, name, kern,
                                             plain, tol, bnd, lib)
            ms = results[name]["ms"]
            if name.removesuffix("_odd") in ("conv_in", "freq_chain"):
                results[name]["stream_ms"] = stream_ms(kern)
                print(f"{name}: kernel {results[name]['stream_ms']:.4f} ms "
                      f"back to back (median of 5 runs of 20 calls) against "
                      f"{ms:.4f} ms a call")
            if name == "tail_resize":
                print_rate(name, logits, got, ms)
    return results


def tower_block_work(spec, vol_bytes=4, f_bytes=4):
    """(flops, bytes) of one tower_block call: x, z and ds_prev read once,
    out, f and ds written once (weights and stage matrices are KB); the
    volume's and f's elements take ``vol_bytes`` and ``f_bytes`` (2 in the
    bf16 instances), z and ds 4."""
    d, h, w = spec.sizes
    c, kh, kw, nds = spec.channels, spec.kh, spec.kw, spec.n_ds
    macs = d * (4 * c * kh * kw * w            # inverse W stage
                + h * w * c * 2 * kh           # inverse H stage
                + h * w * c * (2 * c + nds)    # p, q and ds
                + h * w * c * c                # W_cc_t
                + c * w * 2 * kh * h           # forward H stage
                + 4 * c * kh * kw * w)         # forward W stage
    moved = (2 * vol_bytes * d * h * w * c + (4 + f_bytes) * d * 2 * c * kh
             * kw + 4 * 2 * d * h * w * nds)
    return 2 * macs, moved


def tower_block_s_work(spec, ks, vol_bytes=4):
    """(flops, bytes) of one tower_block_s call: tower_block's operations
    plus the two depth stages (2 KS C KH KW MACs per plane each way); x,
    sy and ds_prev read once, out, s_f and ds written once (no z or f); the
    volume's elements take ``vol_bytes``."""
    d, h, w = spec.sizes
    c, kh, kw, nds = spec.channels, spec.kh, spec.kw, spec.n_ds
    flops = tower_block_work(spec)[0] + 2 * d * 4 * ks * c * kh * kw
    moved = (2 * vol_bytes * d * h * w * c + 4 * 2 * ks * c * kh * kw
             + 4 * 2 * d * h * w * nds)
    return flops, moved


def tower_resident_work(spec, ks, nb, vol_bytes=4, w_bytes=4):
    """(flops, bytes) of one tower_resident call of nb blocks: nb
    tower_block_s blocks and nb operator mixes of the packed spectrum (block
    0's entry spectrum, built before the launch, does the forward work that
    the last block skips); x read and out written once (``vol_bytes`` an
    element), and the weights (the channel mixes ``w_bytes`` an element)."""
    c, kh, kw = spec.channels, spec.kh, spec.kw
    pr = 1 if spec.transform == "Hartley" else 2
    mix_macs = pr * ks * c * c * kh * kw
    flops = nb * (tower_block_s_work(spec, ks)[0] + 2 * mix_macs)
    moved = (2 * vol_bytes * int(np.prod(spec.sizes)) * c
             + nb * (4 * (pr * c * c + 2 * c) + w_bytes * 3 * c * c))
    return flops, moved


def _tower_operands(torch, tb, dev, spec, seed):
    """Random block operands at ``spec``: x, the spectrum after a Hartley
    SELU or a Fourier mix (the packed spectrum s, KS rows), the weights
    and ds_prev."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    c, nds = spec.channels, spec.n_ds
    x = t(rng.standard_normal(spec.sizes + (c,)))
    ops = [t(rng.standard_normal((c, c)) / np.sqrt(c))
           for _ in range(1 if spec.transform == "Hartley" else 2)]
    s = tb.spectrum_mix(tb.d_stage_forward(tb.entry_forward_hw(x, spec),
                                           spec), ops, spec).contiguous()
    w_cat = t(rng.standard_normal((2 * c + nds, c)) / np.sqrt(c))
    w_cc_t = t(rng.standard_normal((c, c)) / np.sqrt(c))
    b_cat = t(rng.uniform(-0.1, 0.1, 2 * c))
    ds_prev = t(rng.standard_normal(spec.sizes + (nds,))) if nds else None
    return x, s, w_cat, w_cc_t, b_cat, ds_prev


def _held_to_plain(torch, kernels, name, label, kern, plain, outs):
    """One launch of ``kern`` against ``plain``: 1e-5 of each output's
    largest magnitude (at least 1), and a second run bit-identical.
    Returns the largest error."""
    before = kernels.LAUNCHES[name]
    got = kern()
    torch.cuda.synchronize()
    check(kernels.LAUNCHES[name] == before + 1,
          f"{label}: launch count did not move")
    want = plain()
    err = 0.0
    for oname, g, wt in zip(outs, got, want):
        check(g.shape == wt.shape, f"{label} {oname}: shape")
        e = float((g - wt).abs().max())
        tol = 1e-5 * max(1.0, float(wt.abs().max()))
        check(np.isfinite(e) and e <= tol,
              f"{label} {oname}: max abs err {e} > {tol}")
        print(f"{label} {oname} {tuple(g.shape)}: max abs err {e:.3e} (tol "
              f"{tol:.3e}, largest |value| {float(wt.abs().max()):.3f})")
        err = max(err, e)
    # the partial spectra are summed in a fixed order: the same bits from
    # run to run
    check(all(bool(torch.equal(a, b)) for a, b in zip(kern(), got)),
          f"{label}: a second run differs")
    return err


def phase_tower_block(torch, kernels, dev):
    """tower_block against its plain version at the three shapes it serves
    (grid 121x121x78, C 24): HartleyMHASeg's (Hartley, modes (8,12,12), 4
    deep-supervision rows), HNOSeg's (Hartley, modes (10,14,14), no ds
    rows) and FNOSeg's (Fourier, modes (10,14,14), KW 14). Tolerance: 1e-5
    of each output's largest magnitude (at least 1): the kernel sums up to
    56 fp32 products in another order than cuBLAS; a TF32 operand would miss
    by about 5e-4 of it. Each shape's time beside its bound, the blocks per
    SM and registers the CUDA runtime reports, and the tower kernels'
    registers and spills from the build log. The kernels line reports
    HartleyMHASeg's shape."""
    header("== tower_block")
    from multimodal_3d_image_segmentation_tpu_torch.kernels import \
        tower_block as tb
    from multimodal_3d_image_segmentation_tpu_torch.utils.tower_sweep import \
        BLOCK_SHAPES, TOWER_KINDS, build_report
    build_report(TOWER_KINDS)
    results = {}
    for i, (label, transform, modes, nds) in enumerate(BLOCK_SHAPES):
        spec = tb.make_tower_spec(transform, GRID, modes, 24, n_ds=nds)
        with torch.inference_mode():
            x, s, w_cat, w_cc_t, b_cat, ds_prev = _tower_operands(
                torch, tb, dev, spec, SEED + 3 + 2 * i)
            z = tb.d_stage_inverse(s, spec).contiguous()
            args = (x, z, w_cat, w_cc_t, b_cat, spec, ds_prev)

            def kern():
                return kernels.fused_tower_block(*args)

            def plain():
                return kernels.tower_block_plain(*args)
            err = _held_to_plain(torch, kernels, "tower_block",
                                 f"tower_block {label}", kern, plain,
                                 ("out", "f", "ds")[:3 if nds else 2])
            ms, plain_ms = median_ms(torch, kern), median_ms(torch, plain)
        flops, moved = tower_block_work(spec)
        b_ms, b_by = bound(flops, moved)
        print(f"tower_block {label} ({transform}, KH {spec.kh}, KW "
              f"{spec.kw}, ds {nds}): kernel {ms:.4f} ms  plain "
              f"{plain_ms:.4f} ms  library None  bound {b_ms:.4f} ms "
              f"({b_by}; {flops / 1e9:.3f} GFLOP, {moved / 1e6:.1f} MB), "
              f"{flops / ms / 1e9:.2f} TFLOP/s (medians of {N_TIMED}, CUDA "
              f"events); shared memory {tb.kernel_smem_bytes(spec)} B per "
              f"block; occupancy (blocks per SM, registers per thread) "
              f"{tb.occupancy(spec)}")
        results[label] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "library_ms": None}
        del x, s, z, args
    out = dict(results["HartleyMHASeg"])
    out["max_abs_err"] = max(r["max_abs_err"] for r in results.values())
    return out


def phase_tower_block_s(torch, kernels, dev):
    """tower_block_s against its plain version at the three shapes that
    serve it: HNOSeg's (Hartley, modes (10,14,14), KS 20, no ds rows),
    FNOSeg's (Fourier, KS 40, KW 14) and HartleyMHASeg's (modes
    (8,12,12), 4 ds rows), each on the 121x121x78 grid with C 24. The
    tolerance is tower_block's, on out, s_f and ds; a second run must give
    the same bits. Also both tower kernels' occupancy (resident blocks per
    SM and registers, from the CUDA runtime) at those shapes. The kernels
    line reports HNOSeg's shape."""
    header("== tower_block_s")
    from multimodal_3d_image_segmentation_tpu_torch.kernels import \
        tower_block as tb
    from multimodal_3d_image_segmentation_tpu_torch.kernels import \
        tower_block_s as tbs
    shapes = [("HNOSeg", "Hartley", (10, 14, 14), 0),
              ("FNOSeg", "Fourier", (10, 14, 14), 0),
              ("HartleyMHASeg", "Hartley", (8, 12, 12), 4)]
    results = {}
    for i, (label, transform, modes, nds) in enumerate(shapes):
        spec = tb.make_tower_spec(transform, GRID, modes, 24, n_ds=nds)
        ks = tb.spectrum_rows(spec)
        with torch.inference_mode():
            x, sy, w_cat, w_cc_t, b_cat, ds_prev = _tower_operands(
                torch, tb, dev, spec, SEED + 6 + i)
            args = (x, sy, w_cat, w_cc_t, b_cat, spec, ds_prev)

            def kern():
                return kernels.fused_tower_block_s(*args)

            def plain():
                return kernels.tower_block_s_plain(*args)
            err = _held_to_plain(torch, kernels, "tower_block_s",
                                 f"tower_block_s {label}", kern, plain,
                                 ("out", "s_f", "ds"))
            ms, plain_ms = median_ms(torch, kern), median_ms(torch, plain)
            # the same block on tower_block: the depth stages as einsums
            # around the kernel
            def v2():
                z = tb.d_stage_inverse(sy, spec).contiguous()
                res = kernels.fused_tower_block(x, z, *args[2:])
                return tb.d_stage_forward(res[1], spec)
            v2_ms = median_ms(torch, v2)
        flops, moved = tower_block_s_work(spec, ks)
        b_ms, b_by = bound(flops, moved)
        occ_s, occ_v2 = tbs.occupancy(spec), tb.occupancy(spec)
        print(f"tower_block_s {label} ({transform}, KS {ks}, KH {spec.kh}, "
              f"KW {spec.kw}, ds {nds}): kernel {ms:.4f} ms  plain "
              f"{plain_ms:.4f} ms  library None  bound {b_ms:.4f} ms "
              f"({b_by}; {flops / 1e9:.3f} GFLOP, {moved / 1e6:.1f} MB), "
              f"{flops / ms / 1e9:.2f} TFLOP/s; tower_block with the depth "
              f"stages around it {v2_ms:.4f} ms (medians of {N_TIMED}, CUDA "
              f"events); shared memory {tb.kernel_smem_bytes(spec)} B per "
              f"block; occupancy (blocks per SM, registers per thread): "
              f"tower_block_s {occ_s}, tower_block {occ_v2}")
        print(f"tower_block_s {label}: {ms:.4f} ms against tower_block with "
              f"the depth stages around it {v2_ms:.4f} ms: "
              f"{ms / v2_ms:.3f} of its time")
        results[label] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "library_ms": None}
    out = dict(results["HNOSeg"])
    out["max_abs_err"] = max(r["max_abs_err"] for r in results.values())
    return out


def phase_tower_resident(torch, kernels, dev):
    """tower_resident against its plain version at HNOSeg's and FNOSeg's
    serving shapes (grid 121x121x78, C 24, modes (10,14,14), 24 blocks) with
    the models' own seeded weights: 1e-5 of the output's largest magnitude
    (at least 1), the tower_block_s bar; a second run must give the same
    bits and the input must be untouched. Beside the kernel's time: the
    plain version's, the same 24 blocks as tower_block_s launches with the
    operator between them, the bound, the persistent grid and the
    occupancy. The kernels line reports HNOSeg's shape."""
    header("== tower_resident")
    from multimodal_3d_image_segmentation_tpu_torch.kernels import \
        tower_block as tb
    from multimodal_3d_image_segmentation_tpu_torch.kernels import \
        tower_block_s as tbs
    from multimodal_3d_image_segmentation_tpu_torch.kernels import \
        tower_resident as tr
    from multimodal_3d_image_segmentation_tpu_torch.models import \
        NeuralOperatorSeg
    nb = NOSEG["num_transform_blocks"]
    results = {}
    for i, (label, transform) in enumerate((("HNOSeg", "Hartley"),
                                            ("FNOSeg", "Fourier"))):
        spec = tb.make_tower_spec(transform, GRID, NOSEG["num_modes"], 24)
        ks = tb.spectrum_rows(spec)
        model = NeuralOperatorSeg(**NOSEG, transform_type=transform,
                                  generator=torch.Generator().manual_seed(
                                      SEED), device=dev)
        with torch.inference_mode():
            weights = model.resident_operands()
            x = torch.from_numpy(np.random.default_rng(SEED + 9 + i)
                                 .standard_normal(GRID + (24,),
                                                  dtype=np.float32)).to(dev)
            x0 = x.clone()

            def kern():
                return kernels.resident_tower(x, *weights, spec)

            def plain():
                return kernels.resident_tower_plain(x, *weights, spec)

            def chain():
                ops, wcat, wcc, b = weights
                y = x
                s = tbs.spectrum_mix_s(tbs.entry_spectrum_s(y, spec), ops[0],
                                       spec)
                for j in range(nb):
                    y, s_f = kernels.fused_tower_block_s(
                        y, s.contiguous(), wcat[j], wcc[j], b[j], spec)
                    if j + 1 < nb:
                        s = tbs.spectrum_mix_s(s_f, ops[j + 1], spec)
                return y
            err = _held_to_plain(torch, kernels, "tower_resident",
                                 f"tower_resident {label}",
                                 lambda: (kern(),), lambda: (plain(),),
                                 ("out",))
            check(bool(torch.equal(x, x0)),
                  f"tower_resident {label}: the input was written")
            # where the 24 blocks leave fp32: the kernel's and the plain
            # version's distance from a float64 evaluation of the tower, and
            # the kernel's from the same blocks launched one by one
            got = kern()
            ref = kernels.resident_tower_plain(
                x.double(), *(w.double() for w in weights), spec)
            print(f"tower_resident {label}: max abs err against float64: "
                  f"kernel {float((got.double() - ref).abs().max()):.3e}, "
                  f"plain {float((plain().double() - ref).abs().max()):.3e}"
                  f"; kernel against the block_s chain "
                  f"{float((got - chain()).abs().max()):.3e}")
            del got, ref
            tr.phase_ms(reset=True)
            ms = median_ms(torch, kern)
            calls = N_TIMED + 3  # median_ms's runs and warm-up calls
            phases = {k: v / calls for k, v in tr.phase_ms(reset=True).items()}
            plain_ms, chain_ms = median_ms(torch, plain), median_ms(torch, chain)
        flops, moved = tower_resident_work(spec, ks, nb)
        b_ms, b_by = bound(flops, moved)
        (blocks, regs), grid = tr.occupancy(spec), tr.resident_grid(spec)
        print(f"tower_resident {label} ({transform}, {nb} blocks, KS {ks}, "
              f"KH {spec.kh}, KW {spec.kw}): kernel {ms:.4f} ms  plain "
              f"{plain_ms:.4f} ms  library None  bound {b_ms:.4f} ms "
              f"({b_by}; {flops / 1e9:.3f} GFLOP, {moved / 1e6:.1f} MB), "
              f"{flops / ms / 1e9:.2f} TFLOP/s; {nb} x (spectrum_mix_s + "
              f"fused_tower_block_s) {chain_ms:.4f} ms (medians of "
              f"{N_TIMED}, CUDA events); persistent grid {grid} blocks, "
              f"{blocks} per SM, {regs} registers per thread, shared memory "
              f"{tb.kernel_smem_bytes(spec)} B per block")
        print(f"tower_resident {label} phases per call (ms, mean of {calls} "
              f"calls, block 0's globaltimer after each grid barrier): "
              f"z phases (each plane's z, once per block) "
              f"{phases['z']:.4f}, bodies of the first {nb - 1} blocks "
              f"{phases['body']:.4f}, depth passes {phases['depth']:.4f}, "
              f"operator mixes {phases['mix']:.4f}, last block's body "
              f"{phases['last_body']:.4f}")
        results[label] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "library_ms": None}
        del model, weights, x, x0
        torch.cuda.empty_cache()
    out = dict(results["HNOSeg"])
    out["max_abs_err"] = max(r["max_abs_err"] for r in results.values())
    return out


def phase_kernels_bf16(torch, kernels, dev, fp32):
    """The bf16 instances against their plain twins (the same function in
    fp32 from the exact bf16 values, rounded where the kernel rounds) at
    the serving shapes, in the working type: conv_in also at the odd
    239x239x155 (batch element 1 of two, 8 bytes past a 16-byte boundary),
    the tail with fp32 and bf16 probabilities; each with its time, bound
    and the fp32 instance's time in this run (``fp32``)."""
    header("== kernels, bf16 instances")
    import torch.nn.functional as F
    rng = np.random.default_rng(SEED + 5)
    bf16 = torch.bfloat16

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            dev, dtype)

    def r16(a):  # rounded through bf16, kept fp32 ('bfloat16' weights)
        return a.to(bf16).float()

    x = t(rng.standard_normal((1, 4) + SHAPE), bf16)
    x_odd = t(rng.standard_normal((2, 4, 239, 239, 155)), bf16)[1:]
    check(x_odd.data_ptr() % 16 == 8, "odd volume's element 1 alignment")
    out_odd = 120 * 120 * 78
    w = r16(t(rng.standard_normal((24, 4, 2, 2, 2)) / np.sqrt(32)))
    b = r16(t(rng.uniform(-0.1, 0.1, 24)))
    spec = t(rng.standard_normal((1, 20, 28, 28, 24)), bf16)
    ws = [t(rng.standard_normal((24, 24)) / np.sqrt(24), bf16)
          for _ in range(3)]
    logits = t(rng.standard_normal((1, 4) + GRID) * 3, bf16)
    out_cl = int(np.prod(GRID))
    rows = spec.numel() // 24
    n_out = int(np.prod(SHAPE))
    # kernel, plain twin, (rtol, atol), bound, library call, fp32 instance
    ulp = (BF16_ULP, 1e-5)
    cases = {
        "conv_in_bf16": (
            lambda: kernels.conv_in_s2d(x, w, b),
            lambda: kernels.conv_in_plain(x, w, b), ulp,
            bound(2 * out_cl * 8 * 4 * 24,
                  nbytes(x, w, b) + out_cl * 24 * 2),
            lambda: F.conv3d(x, w.to(bf16), b.to(bf16), stride=2,
                             padding=1), "conv_in"),
        "conv_in_bf16_odd": (
            lambda: kernels.conv_in_s2d(x_odd, w, b),
            lambda: kernels.conv_in_plain(x_odd, w, b), ulp,
            bound(2 * out_odd * 8 * 4 * 24,
                  nbytes(x_odd, w, b) + out_odd * 24 * 2),
            lambda: F.conv3d(x_odd, w.to(bf16), b.to(bf16), stride=2,
                             padding=1), "conv_in_odd"),
        # a rounding flipped at one stage moves the next stage's inputs by
        # one ulp: one more ulp of the largest magnitude
        "freq_chain_bf16": (
            lambda: kernels.fused_freq_chain(spec, ws),
            lambda: kernels.freq_chain_plain(spec, ws),
            lambda want: (BF16_ULP, 1e-5 + BF16_ULP * max(
                1.0, float(want.abs().max()))),
            bound(3 * 2 * rows * 24 * 24, 2 * nbytes(spec) + nbytes(*ws),
                  BF16_FLOPS),
            None, "freq_chain"),
        "tail_resize_bf16": (
            lambda: kernels.fused_tail_softmax(logits, SHAPE),
            lambda: kernels.tail_plain(logits, SHAPE), (0.0, 1e-6),
            bound(17 * 4 * n_out, nbytes(logits) + 4 * 4 * n_out), None,
            "tail_resize"),
        "tail_resize_bf16_out": (
            lambda: kernels.fused_tail_softmax(logits, SHAPE, bf16),
            lambda: kernels.tail_plain(logits, SHAPE, bf16), (BF16_ULP, 1e-6),
            bound(17 * 4 * n_out, nbytes(logits) + 4 * 2 * n_out), None,
            "tail_resize"),
    }
    results = {}
    with torch.inference_mode():
        for name, (kern, plain, tol, bnd, lib, f32) in cases.items():
            results[name], got = kernel_case(torch, kernels, name, kern,
                                             plain, tol, bnd, lib)
            results[name]["fp32_ms"] = fp32[f32]["ms"]
            print(f"{name}: the fp32 instance {fp32[f32]['ms']:.4f} ms in "
                  "this run")
            if name.startswith("tail"):
                print_rate(name, logits, got, results[name]["ms"])
            del got
        # controls of the chain's rounding after every stage: the chain
        # rounded once at its end, or with its first stage's rounding
        # skipped, must fail the check the kernel passed
        want = kernels.freq_chain_plain(spec, ws)
        for label, rounded in (("rounded once at the end", ()),
                               ("first stage not rounded", (1,))):
            y = spec.float()
            for k, wk in enumerate(ws):
                y = torch.selu(F.linear(y, wk.float()) + y)
                if k in rounded:
                    y = y.to(bf16).float()
            ok, err, _, share = held_to(torch, y.to(bf16), want,
                                        cases["freq_chain_bf16"][2])
            print(f"freq_chain_bf16 control, chain {label}: max abs err "
                  f"{err:.3e}, {share:.3e} of the elements more than one "
                  "ulp apart")
            check(not ok, f"freq_chain_bf16 control ({label}) passed")
    out = {k: results[k] for k in ("conv_in_bf16", "freq_chain_bf16",
                                   "tail_resize_bf16")}
    for k, extra in (("conv_in_bf16", "conv_in_bf16_odd"),
                     ("tail_resize_bf16", "tail_resize_bf16_out")):
        tag = extra.removeprefix(k + "_")
        out[k] = dict(out[k], **{f"{tag}_{f}": v for f, v in
                                 results[extra].items()
                                 if f in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms")})
    return out


# the tower kernels' bf16 instances by compute_dtype: (name suffix, the
# channel-mix weights' dtype name)
TOWER_MODES = (("bfloat16", "_bf16", "bfloat16"), ("mixed", "_mixed",
                                                   "float32"))
# the twins' roundings whose controls must fail, per kernel (HNOSeg's shape)
TOWER_CONTROLS = {"tower_block": ({"F"}, {"z"}),
                  "tower_block_s": ({"sy"}, {"f"}),
                  "tower_resident": ({"sy"},)}


def _tower_tol(torch, got):
    """(tolerance, share_atol) of a tower kernel output of a bf16
    instance: a bf16 output (out; 'bfloat16''s f) one bf16 ulp plus 1e-5
    plus one ulp of its largest magnitude (a rounding flipped upstream),
    and at most ``BF16_SHARE`` of its elements more than one ulp of their
    own magnitude plus 1e-5 apart (f is an fp32 sum with cancellation,
    rounded once: near 0 its fp32 summation order shows); an fp32 output
    ``TOWER_FP32_REL`` of its largest magnitude."""
    if got.dtype == torch.bfloat16:
        return (lambda w: (BF16_ULP, 1e-5 + BF16_ULP * max(
            1.0, float(w.abs().max())))), 1e-5
    return (lambda w: (0.0, TOWER_FP32_REL * float(w.abs().max()))), 0.0


def _held_tower(torch, label, names, got, want):
    """(passed, largest error, largest share): each output of a tower
    kernel's bf16 instance (or of a control) against its twin's, by
    ``_tower_tol``; prints each reading."""
    ok_all, err, share_max = True, 0.0, 0.0
    for oname, g, w in zip(names, got, want):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{label} {oname}: {tuple(g.shape)} {g.dtype} against "
              f"{tuple(w.shape)} {w.dtype}")
        tol, share_atol = _tower_tol(torch, g)
        ok, e, (rtol, atol), share = held_to(torch, g, w, tol, share_atol)
        print(f"{label} {oname} {str(g.dtype)[6:]}: max abs err {e:.3e} "
              f"(rtol {rtol:g}, atol {atol:.3g}, largest |value| "
              f"{float(w.float().abs().max()):.3f})" + (
                  "" if share is None else f", {share:.3e} of the elements "
                  f"more than one ulp of their own magnitude + "
                  f"{share_atol:g} apart (bar {BF16_SHARE:g})"))
        ok_all, err = ok_all and ok, max(err, e)
        share_max = max(share_max, share or 0.0)
    return ok_all, err, share_max


def phase_towers_bf16(torch, kernels, dev):
    """The tower kernels' 'bfloat16' and 'mixed' instances against their
    plain twins (fp32 sums on the bf16 values, rounded where the kernel
    rounds) in the working type, at the shapes their fp32 instances are
    checked at: tower_block and tower_block_s at HartleyMHASeg's, HNOSeg's
    and FNOSeg's, each output by ``_tower_tol`` and a second run
    bit-identical; tower_resident at HNOSeg's and FNOSeg's, one block by
    ``_tower_tol``, two blocks and the whole 24-block tower by the
    whole-model rule (the largest distance from a float64 evaluation of the
    same tower at most 2x the twin's: the kernel's operator mix sums in
    another fp32 order than the twin's, and the next block's bf16 rounding
    of the spectrum spreads a flip through every voxel). At HNOSeg's shape the 'bfloat16' twin with one of its
    roundings left out (``TOWER_CONTROLS``) must fail the check the kernel
    passed. Each instance's time beside the fp32 instance's in this run and
    its bound (operations at the bf16 rate for 'bfloat16', fp32 for
    'mixed', whose operands are fp32; bytes at each element's size). The
    kernels line reports tower_block at HartleyMHASeg's shape, the others
    at HNOSeg's, with the largest error over the shapes."""
    header("== tower kernels, bf16 and mixed instances")
    from multimodal_3d_image_segmentation_tpu_torch.kernels import \
        tower_block as tb
    from multimodal_3d_image_segmentation_tpu_torch.kernels import \
        tower_block_s as tbs
    from multimodal_3d_image_segmentation_tpu_torch.kernels import \
        tower_resident as tr
    from multimodal_3d_image_segmentation_tpu_torch.models import \
        NeuralOperatorSeg
    from multimodal_3d_image_segmentation_tpu_torch.utils.tower_sweep import \
        BLOCK_SHAPES
    bf16 = torch.bfloat16
    dtypes = {"bfloat16": bf16, "float32": torch.float32}
    results = {}

    def record(name, label, err, ms, fp32_ms, plain_ms, bnd, share):
        b_ms, b_by = bnd
        print(f"{name} {label}: kernel {ms:.4f} ms (the fp32 instance "
              f"{fp32_ms:.4f} ms in this run)  plain {plain_ms:.4f} ms  "
              f"library None  bound {b_ms:.4f} ms ({b_by}) (medians of "
              f"{N_TIMED}, CUDA events)")
        results.setdefault(name, {})[label] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "fp32_ms": fp32_ms, "share_beyond_ulp": share}

    for i, (label, transform, modes, nds) in enumerate(BLOCK_SHAPES):
        spec = tb.make_tower_spec(transform, GRID, modes, 24, n_ds=nds)
        ks = tb.spectrum_rows(spec)
        with torch.inference_mode():
            x, s, w_cat, w_cc_t, b_cat, ds_prev = _tower_operands(
                torch, tb, dev, spec, SEED + 20 + i)
            z = tb.d_stage_inverse(s, spec).contiguous()
            xb = x.to(bf16)
            for kernel, fused, plain, spectrum, outs in (
                    ("tower_block", kernels.fused_tower_block,
                     kernels.tower_block_plain, z, ("out", "f", "ds")),
                    ("tower_block_s", kernels.fused_tower_block_s,
                     kernels.tower_block_s_plain, s, ("out", "s_f", "ds"))):
                outs = outs[:3 if nds else 2]
                fp32_ms = median_ms(torch, lambda: fused(
                    x, spectrum, w_cat, w_cc_t, b_cat, spec, ds_prev))
                for mode, suffix, wname in TOWER_MODES:
                    wd = dtypes[wname]
                    args = (xb, spectrum, w_cat.to(wd), w_cc_t.to(wd), b_cat,
                            spec, ds_prev)
                    name = kernel + suffix
                    before = kernels.LAUNCHES[name]
                    got = fused(*args)
                    torch.cuda.synchronize()
                    check(kernels.LAUNCHES[name] == before + 1,
                          f"{name} {label}: launch count did not move")
                    want = plain(*args)
                    ok, err, share = _held_tower(torch, f"{name} {label}",
                                                 outs, got, want)
                    check(ok, f"{name} {label}: outside its tolerance")
                    check(all(bool(torch.equal(a, b))
                              for a, b in zip(fused(*args), got)),
                          f"{name} {label}: a second run differs")
                    if mode == "bfloat16" and label == "HNOSeg":
                        for left in TOWER_CONTROLS[kernel]:
                            ctl = plain(*args, unrounded=frozenset(left))
                            bad, _, _ = _held_tower(
                                torch, f"{name} control, {sorted(left)} "
                                "unrounded", outs, ctl, want)
                            check(not bad, f"{name} control ({left}) passed")
                    ms = median_ms(torch, lambda: fused(*args))
                    plain_ms = median_ms(torch, lambda: plain(*args))
                    vb = 2
                    if kernel == "tower_block":
                        work = tower_block_work(spec, vb,
                                                2 if wd == bf16 else 4)
                    else:
                        work = tower_block_s_work(spec, ks, vb)
                    record(name, label, err, ms, fp32_ms, plain_ms,
                           bound(*work, BF16_FLOPS), share)
                    del got, want
            del x, s, z, xb

    nb = NOSEG["num_transform_blocks"]
    for i, (label, transform) in enumerate((("HNOSeg", "Hartley"),
                                            ("FNOSeg", "Fourier"))):
        spec = tb.make_tower_spec(transform, GRID, NOSEG["num_modes"], 24)
        ks = tb.spectrum_rows(spec)
        model = NeuralOperatorSeg(**NOSEG, transform_type=transform,
                                  generator=torch.Generator().manual_seed(
                                      SEED), device=dev)
        with torch.inference_mode():
            x = torch.from_numpy(np.random.default_rng(SEED + 9 + i)
                                 .standard_normal(GRID + (24,),
                                                  dtype=np.float32)).to(dev)
            xb = x.to(bf16)
            w32 = model.resident_operands()
            fp32_ms = median_ms(torch, lambda: kernels.resident_tower(
                x, *w32, spec))
            for mode, suffix, wname in TOWER_MODES:
                name = "tower_resident" + suffix
                w = model.resident_operands(dtypes[wname])
                # one block element by element (the last block has no depth
                # pass or mix); from the second block on, the operator mix
                # sums s_f in another fp32 order than the twin's einsum, and
                # in 'bfloat16' the next z pass rounds that spectrum to
                # bf16, so a few flips spread through every voxel: two
                # blocks and the whole tower are held to float64 below
                w1 = tuple(t[:1] for t in w)
                before = kernels.LAUNCHES[name]
                got = kernels.resident_tower(xb, *w1, spec)
                torch.cuda.synchronize()
                check(kernels.LAUNCHES[name] == before + 1,
                      f"{name} {label}: launch count did not move")
                want = kernels.resident_tower_plain(xb, *w1, spec)
                ok, err1, share = _held_tower(
                    torch, f"{name} {label}, 1 block", ("out",), (got,),
                    (want,))
                check(ok, f"{name} {label}: 1 block outside the tolerance")
                if mode == "bfloat16" and label == "HNOSeg":
                    for left in TOWER_CONTROLS["tower_resident"]:
                        ctl, _ = tbs.tower_block_s_plain(
                            xb, tr._entry(xb, w1[0], w1[1], spec), w1[1][0],
                            w1[2][0], w1[3][0], spec,
                            unrounded=frozenset(left))
                        bad, _, _ = _held_tower(
                            torch, f"{name} control, {sorted(left)} "
                            "unrounded", ("out",), (ctl,), (want,))
                        check(not bad, f"{name} control ({left}) passed")
                for n_blocks in (2, nb):
                    wn = tuple(t[:n_blocks] for t in w)
                    got = kernels.resident_tower(xb, *wn, spec)
                    check(bool(torch.equal(
                        kernels.resident_tower(xb, *wn, spec), got)),
                        f"{name} {label}: a second run differs")
                    twin = kernels.resident_tower_plain(xb, *wn, spec)
                    ref = kernels.resident_tower_plain(
                        xb.double(), *(t.double() for t in wn), spec)
                    k64 = float((got.double() - ref).abs().max())
                    t64 = float((twin.double() - ref).abs().max())
                    print(f"{name} {label}, {n_blocks} blocks: max abs err "
                          f"against float64 (the same bf16 volume and "
                          f"weights, nothing rounded) kernel {k64:.3e}, twin "
                          f"{t64:.3e} (bar 2x the twin's), largest |value| "
                          f"{float(ref.abs().max()):.3f}")
                    check(k64 <= 2 * t64 + 1e-6,
                          f"{name} {label}, {n_blocks} blocks: {k64} from "
                          f"float64, twin {t64}")
                    del twin, ref
                ms = median_ms(torch, lambda: kernels.resident_tower(
                    xb, *w, spec))
                plain_ms = median_ms(torch, lambda: kernels.resident_tower_plain(
                    xb, *w, spec), n=5)
                (blocks, regs) = tr.occupancy(spec, mode)
                print(f"{name} {label}: persistent grid "
                      f"{tr.resident_grid(spec, mode)} blocks, {blocks} per "
                      f"SM, {regs} registers per thread")
                record(name, label, err1, ms, fp32_ms, plain_ms,
                       bound(*tower_resident_work(
                           spec, ks, nb, 2, 2 if mode == "bfloat16" else 4),
                           BF16_FLOPS),
                       share)
        del model, x, xb
        torch.cuda.empty_cache()
    out = {}
    for name, by_label in results.items():
        first = ("HartleyMHASeg" if name.startswith("tower_block_")
                 and not name.startswith("tower_block_s") else "HNOSeg")
        out[name] = dict(by_label[first])
        out[name]["max_abs_err"] = max(r["max_abs_err"]
                                       for r in by_label.values())
    return out


def phase_gate(torch, dev, family="hnosegxs"):
    """The trained-network precision gate (``utils/precision_gate.py``):
    train ``family`` at 120x120x78, evaluate zero-shot at 240x240x155 in
    every mode; its failures fail the run, its 1e-3 Dice bar is reported."""
    header(f"== precision gate ({family}, trained)")
    from multimodal_3d_image_segmentation_tpu_torch.utils import \
        precision_gate
    res = precision_gate.run_gate(dev, family=family)
    check(not res["failures"], f"precision gate {family}: "
                               f"{res['failures']}")
    for name in precision_gate.modes_of(family):
        if "twins" in name or name == "fp32_plain":
            continue
        print(f"gate {family} {name}: Dice delta vs the fp32 oracle "
              f"{res[name]['dice_delta_vs_oracle']}, 1e-3 bar "
              f"{'met' if res[name]['dice_bar_met'] else 'missed'}")
    return res


def _write_cases(root: Path):
    """3 synthetic 4-modality cases + label maps as NIfTI, and list files."""
    from multimodal_3d_image_segmentation_tpu_torch.data import write_image
    rng = np.random.default_rng(SEED + 1)
    mods = ["t1c", "t1n", "t2f", "t2w"]
    lists = {m: [] for m in mods + ["seg"]}
    # label map: background around nested ellipsoids (tumour-like regions;
    # it also keeps the gzip of the written "_true" maps fast)
    r = np.sqrt(sum(((g - n / 2) / (n / 4)) ** 2
                    for g, n in zip(np.ogrid[tuple(map(slice, SHAPE))],
                                    SHAPE)))
    seg = np.select([r < 0.3, r < 0.6, r < 1.0], [3, 1, 2], 0).astype(
        np.uint8)
    for i in range(N_CASES):
        case = f"case_{i}"
        for m in mods:
            vol = rng.standard_normal(SHAPE, dtype=np.float32) + 2.0
            write_image(vol, root / case / f"{m}.nii")
            lists[m].append(f"{case}/{m}.nii")
        write_image(seg, root / case / "seg.nii")
        lists["seg"].append(f"{case}/seg.nii")
    paths = []
    for m, names in lists.items():
        p = root / f"{m}_test.txt"
        p.write_text("\n".join(names) + "\n")
        paths.append(str(p))
    return paths


SERVED = {}  # label -> run_inference's timing and memory numbers


def phase_serve(torch, kernels, work: Path, list_paths, label, config,
                model, n_params, per_volume, model_keys=None):
    """A main path: run_inference through a serving config (with
    ``model_keys`` set on its [model] section), its launch counts set to 0
    just before and read just after."""
    header(f"== serve {label}")
    from multimodal_3d_image_segmentation_tpu_torch.data import read_img
    from multimodal_3d_image_segmentation_tpu_torch.runtime.config import \
        get_config
    from multimodal_3d_image_segmentation_tpu_torch.runtime.inference import \
        run_inference

    out_dir = work / label
    check(sum(p.numel() for p in model.parameters()) == n_params,
          f"{label} parameter count != {n_params:,}")
    (out_dir / "model").mkdir(parents=True)
    torch.save(model.state_dict(), out_dir / "model" / "model.pt")
    cfg = get_config(str(REPO / "configs" / config))
    cfg["main"]["output_dir"] = str(out_dir)
    cfg["input_lists"]["data_dir"] = str(work / "data")
    cfg["input_lists"]["data_lists_test_paths"] = list_paths
    cfg["model"].update(model_keys or {})

    kernels.reset_launch_counts()
    stats = run_inference(cfg)
    launches = dict(kernels.LAUNCHES)
    want = {k: v * N_CASES for k, v in per_volume.items()}
    check(launches == want, f"main-path launches {launches} != {want}")
    print(f"main-path launches ({N_CASES} volumes): {launches}")

    pred_dir = out_dir / cfg["test"]["output_folder"] / "images"
    for i in range(N_CASES):
        y = read_img(str(pred_dir / f"case_{i}_pred.nii.gz"))
        check(y.shape == SHAPE, f"prediction shape {y.shape}")
        check(set(np.unique(y).tolist()) <= {0, 1, 2, 3},
              f"labels {np.unique(y)} outside 0..3")
    check(stats["n_volumes"] == N_CASES, f"{stats['n_volumes']} volumes")
    SERVED[label] = stats
    print(f"serving {label}: {N_CASES} predictions of {SHAPE}; average "
          f"prediction time {stats['avg_time_s'] * 1e3:.3f} ms/volume (wall "
          f"clock with readback, mean of the {N_CASES - 1} volumes after the "
          f"first), device {stats['device_ms']:.3f} ms a predict step "
          f"(CUDA events, the last volume, readers idle); "
          f"peak allocated {stats['peak_mib']:.1f} MiB, peak reserved "
          f"{stats['peak_reserved_mib']:.1f} MiB")
    return launches


def served_bf16(torch, kernels, work: Path, list_paths, launches, label,
                config, model, n_params, per_volume_bf16, per_volume_mixed):
    """``label``'s model served in 'bfloat16' and 'mixed' through
    ``run_inference`` (``[model] compute_dtype`` set on the loaded config)
    with each mode's launches a volume; its wall, device and peak printed
    beside the fp32 path's (``label``, served before)."""
    for mode, per_vol in (("bfloat16", per_volume_bf16),
                          ("mixed", per_volume_mixed)):
        name = f"{label}-{mode}"
        got = phase_serve(torch, kernels, work, list_paths, name, config,
                          model, n_params, per_vol, {"compute_dtype": mode})
        for k, v in got.items():
            launches[k] += v
        a, f = SERVED[name], SERVED[label]
        print(f"serving {name} against fp32: wall "
              f"{a['avg_time_s'] * 1e3:.3f} against "
              f"{f['avg_time_s'] * 1e3:.3f} ms/volume, device "
              f"{a['device_ms']:.3f} against {f['device_ms']:.3f} "
              f"ms, peak allocated {a['peak_mib']:.1f} against "
              f"{f['peak_mib']:.1f} MiB")


def served_mode(torch, kernels, work: Path, list_paths, launches, label,
                config, model, n_params, mode, tower, n, tower_kernel):
    """A tower family served in a bf16 mode through ``run_inference``:
    ``[model] compute_dtype = mode`` and ``tower_kernel`` set on the
    loaded config, the launches of conv_in's and the tail's bf16 instances
    and ``n`` of ``tower``'s instance a volume; its wall, device and peak
    printed beside the fp32 path's (``label``, served before)."""
    keys = {"compute_dtype": mode}
    if tower_kernel != "block":
        keys["tower_kernel"] = tower_kernel
    name = f"{label}-{mode}" + ("" if tower_kernel == "block"
                                else f"-{tower_kernel}")
    got = phase_serve(torch, kernels, work, list_paths, name, config, model,
                      n_params, per_volume_tower(mode, tower, n), keys)
    for k, v in got.items():
        launches[k] += v
    fp32 = label + ("" if tower_kernel == "block" else f"-{tower_kernel}")
    a, f = SERVED[name], SERVED.get(fp32, SERVED[label])
    print(f"serving {name} against fp32 ({fp32}): wall "
          f"{a['avg_time_s'] * 1e3:.3f} against {f['avg_time_s'] * 1e3:.3f} "
          f"ms/volume, device {a['device_ms']:.3f} against "
          f"{f['device_ms']:.3f} ms, peak allocated {a['peak_mib']:.1f} "
          f"against {f['peak_mib']:.1f} MiB")


# Whole-model bars. The random-init flagship grows activations to
# O(100-500), so rounding differences of a few ulp (conv_in against cuDNN)
# reach the softmax at the 1e-4 class, on the plain path as much as on the
# kernel path. So the kernel path is held to the plain path's own distance
# from a float64 evaluation of the model times "ratio", and to "abs"
# against the plain path; argmax agreement must reach "agree". On an H100
# (700 W) the sound kernel path read ratio 1.03, 1.5e-4 and 0.9999985 at
# the served volume; the two TF32 controls below read ratios 407 and 457,
# 4.4e-2 and 4.9e-2, agreement 0.99919 and 0.99894. The bars sit between,
# nearer the sound side, and the controls must fail them.
BARS_HNOSEG = {"ratio": 2.0, "abs": 1e-3, "agree": 0.9999}
# V-Net-DS normalizes every conv output (GroupNorm), so its activations
# stay O(1) and fp32 rounding differences stay near 1e-6 on the
# probabilities; the bars were set from a prediction written down before
# the first run on the card (PERF.md, Findings). On an H100 (700 W) the
# sound kernel path read ratio 0.37-0.93, 2.5e-6 to 2.8e-6 and 0.9999977
# or more; the TF32 control 299-350x, 7.3e-4 to 8.6e-4 and 0.99934-0.99936,
# and must fail them.
BARS_VNET = {"ratio": 4.0, "abs": 1e-4, "agree": 0.9999}
# HartleyMHASeg is, like HNOSeg-XS, a random-init SNN without normalization;
# the bars are HNOSeg-XS's, set from a prediction written down before the
# first run on the card (PERF.md, Findings).
BARS_MHA = {"ratio": 2.0, "abs": 1e-3, "agree": 0.9999}
# HNOSeg and FNOSeg are random-init SNNs without normalization too, 24
# blocks deep; the bars are HNOSeg-XS's, set from a prediction written down
# before the first run on the card (PERF.md, Findings).
BARS_NOSEG = {"ratio": 2.0, "abs": 1e-3, "agree": 0.9999}
N_STEP_TIMED = 10


def readings(torch, fast, plain, ref):
    """Distances of the kernel path ``fast`` from the plain path ``plain``
    (both fp32) and from the float64 evaluation ``ref``."""
    return {"kernel_vs_plain": float((fast - plain).abs().max()),
            "kernel_vs_fp64": float((fast.double() - ref).abs().max()),
            "plain_vs_fp64": float((plain.double() - ref).abs().max()),
            "agree": float((fast.argmax(1) == plain.argmax(1))
                           .float().mean()),
            "finite": bool(torch.isfinite(fast).all())}


def failed_bars(r, bars):
    ok = {"finite": r["finite"],
          "agreement": r["agree"] >= bars["agree"],
          "ratio": r["kernel_vs_fp64"] <= bars["ratio"] * r["plain_vs_fp64"]
          + 1e-6,
          "abs": r["kernel_vs_plain"] <= bars["abs"]}
    return [k for k, passed in ok.items() if not passed]


def compare(torch, label, fast, plain, ref, bars, control=False):
    """Print the readings; a sound path must pass every bar, a control
    must fail at least one."""
    r = readings(torch, fast, plain, ref)
    failed = failed_bars(r, bars)
    print(f"{label}: max abs err kernel-vs-plain {r['kernel_vs_plain']:.3e}, "
          f"kernel-vs-fp64 {r['kernel_vs_fp64']:.3e}, plain-vs-fp64 "
          f"{r['plain_vs_fp64']:.3e} (ratio "
          f"{r['kernel_vs_fp64'] / r['plain_vs_fp64']:.3f}); argmax "
          f"agreement {r['agree']:.7f}; bars failed: {failed or 'none'}")
    if control:
        check(failed, f"{label}: the control passed every bar")
    else:
        check(not failed, f"{label}: failed {failed}")


def _tf32(torch, t):
    """``t`` rounded to TF32's 10 mantissa bits (nearest, ties away)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def served_volume(torch, case_dir: Path, dev):
    """Case 0 as the serving flow reads it: 4 modalities, z-scored."""
    from multimodal_3d_image_segmentation_tpu_torch.data import (
        normalize_modalities, read_img)
    x = np.stack([read_img(str(case_dir / f"{m}.nii"))
                  for m in ("t1c", "t1n", "t2f", "t2w")])
    return torch.from_numpy(normalize_modalities(x)[None]).to(dev)


def small_volume(torch):
    return torch.from_numpy(np.random.default_rng(SEED + 2)
                            .standard_normal((1, 4, 32, 30, 21))
                            .astype(np.float32))


def phase_model_hnoseg(torch, state, case_dir: Path, dev):
    """HNOSeg-XS: kernel path against the plain path with the same weights, both held
    to a float64 evaluation of the model, and two controls."""
    header("== model HNOSeg-XS")
    from multimodal_3d_image_segmentation_tpu_torch.models import HNOSegXS

    def build(use_kernels, device, dtype=torch.float32, weights=state):
        m = HNOSegXS(**FLAGSHIP, use_kernels=use_kernels).to(device, dtype)
        m.load_state_dict(weights)
        return m

    def rounded(pick):
        return {k: _tf32(torch, v) if pick(k) else v
                for k, v in state.items()}

    x, xs = served_volume(torch, case_dir, dev), small_volume(torch)
    bars = BARS_HNOSEG
    with torch.inference_mode():
        fast = build(True, dev)(x)
        check(fast.shape == (1, 4) + SHAPE, f"output shape {fast.shape}")
        sum_err = float((fast.sum(1) - 1).abs().max())
        check(sum_err <= 1e-5, f"probabilities sum off 1 by {sum_err}")
        plain = build(False, dev)(x)
        ref = build(False, dev, torch.float64)(x.double())
        torch.cuda.synchronize()
        compare(torch, f"full volume {SHAPE}", fast, plain, ref, bars)
        # controls: conv_in on TF32 operands (input and weight), and the
        # frequency chain on TF32 weights (these feed nothing else on the
        # kernel path)
        del fast
        fast = build(True, dev, weights=rounded(
            lambda k: k == "conv_in.op.weight"))(_tf32(torch, x))
        compare(torch, "control: conv_in operands in TF32", fast, plain, ref,
                bars, control=True)
        del fast
        fast = build(True, dev, weights=rounded(
            lambda k: ".conv_blocks." in k))(x)
        compare(torch, "control: freq_chain weights in TF32", fast, plain,
                ref, bars, control=True)
        del fast, plain, ref

        # small volume: the GPU kernel path against the CPU plain paths
        fast = build(True, dev)(xs.to(dev)).cpu()
        plain = build(False, "cpu")(xs)
        ref = build(False, "cpu", torch.float64)(xs.double())
        compare(torch, "small volume (1,4,32,30,21), GPU kernels vs CPU",
                fast, plain, ref, bars)


def _taps(n_in, n_out, stride, dilation):
    """(output, tap) pairs along one axis whose tap reads a voxel."""
    count = 0
    for o in range(n_out):
        for k in range(3):
            q = o * stride + k - 1
            count += (q >= 0 and q % 2 == 0 and q // 2 < n_in
                      if dilation == 2 else 0 <= q < n_in)
    return count


def conv3_work(args, kw, y):
    """(flops, bytes) a conv3 call needs: valid taps only, each input read
    and each output written once."""
    x, w = args[0], args[1]
    x2, res = kw.get("x2"), kw.get("residual")
    ci, co = w.shape[1], w.shape[0]
    stride, dil = kw.get("stride", 1), kw.get("dilation", 1)
    macs = ci * co * int(np.prod([
        _taps(n, m, stride, dil) for n, m in zip(x.shape[1:4], y.shape[1:4])]))
    moved = nbytes(x, x2, w, args[2], *(kw.get("prologue") or ()), y)
    if res is not None:
        macs += ci * co * int(np.prod(y.shape[1:4]))
        moved += nbytes(*res) + nbytes(y)  # the residual output
    if kw.get("emit_stats"):
        moved += 2 * co * 4 * (2 if res is not None else 1)
    return 2 * macs, moved


def _detached(v):
    if isinstance(v, tuple):
        return tuple(_detached(t) for t in v)
    return v.detach() if hasattr(v, "detach") else v


def record_conv3_calls(torch, model, x, grad=False):
    """Every conv3 call of one kernel-path forward, with its real inputs
    (detached); ``grad``: the forward of a train step, autograd on."""
    from multimodal_3d_image_segmentation_tpu_torch.models import \
        architectures
    calls, real = [], architectures.conv3

    def recording(*args, **kw):
        calls.append((_detached(args), {k: _detached(v)
                                        for k, v in kw.items()}))
        return real(*args, **kw)

    architectures.conv3 = recording
    try:
        if grad:
            model(x)
        else:
            with torch.inference_mode():
                model(x)
    finally:
        architectures.conv3 = real
    return calls


def _describe(args, kw):
    x, w = args[0], args[1]
    opts = [k for k in ("x2", "prologue", "residual") if kw.get(k) is not None]
    opts += [f"{k}2" for k in ("stride", "dilation") if kw.get(k, 1) == 2]
    opts += ["stats"] if kw.get("emit_stats") else []
    return (f"{tuple(x.shape[1:4])} ci {w.shape[1]} co {w.shape[0]} "
            f"{'+'.join(opts) or 'bare'}"
            + (f" act {kw['prologue_act']}" if kw.get("prologue") else ""))


def phase_conv3(torch, kernels, calls):
    """conv3 against its plain version at every call of one V-Net-DS
    forward, each call's launch plan beside its times. Tolerance: 1e-4 of
    the output's largest magnitude (at least 1): the kernel sums up to 27 x
    384 products in another order than cuDNN; TF32 products would miss by
    about 5e-4 of it. The moment sums are held to float64 sums of the
    kernel's own output; a second call must give the same bits and leave
    the inputs untouched. Times are of back-to-back calls (``stream_ms``),
    as a forward pass issues them. The kernel's total over the calls must
    be below ``F.conv3d``'s (checked at the end of the run)."""
    header(f"== conv3 ({len(calls)} calls of one V-Net-DS forward)")
    import torch.nn.functional as F
    import importlib
    from multimodal_3d_image_segmentation_tpu_torch.utils.tower_sweep import \
        stream_ms
    conv3_mod = importlib.import_module(
        "multimodal_3d_image_segmentation_tpu_torch.kernels.conv3")
    # registers, shared memory and spills of each conv3 kernel instance
    log = kernels.library().build_log.splitlines()
    for i, line in enumerate(log):
        if "Compiling entry function" in line and "conv3" in line:
            name = line.split("'")[1] if "'" in line else line
            props = [ln.strip() for ln in log[i + 1:i + 4]
                     if "spill" in ln or "Used" in ln]
            print(f"conv3 build: {name}: {'; '.join(props)}")
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flops": 0,
           "bytes": 0, "max_abs_err": 0.0}
    with torch.inference_mode():
        for i, (args, kw) in enumerate(calls):
            def kern():
                return kernels.conv3(*args, **kw)

            def plain():
                return kernels.conv3_plain(*args, **kw)
            before = kernels.LAUNCHES["conv3"]
            got = kern()
            torch.cuda.synchronize()
            check(kernels.LAUNCHES["conv3"] == before + 1,
                  f"conv3 call {i}: launch count did not move")
            want = plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            n_out = 2 if kw.get("residual") is not None else 1
            err = 0.0
            for g, wt in zip(got[:n_out], want[:n_out]):
                check(g.shape == wt.shape, f"conv3 call {i}: shape")
                e = float((g - wt).abs().max())
                tol = 1e-4 * max(1.0, float(wt.abs().max()))
                check(np.isfinite(e) and e <= tol,
                      f"conv3 call {i}: max abs err {e} > {tol}")
                err = max(err, e)
            for y, st in zip(got[:n_out], got[n_out:]):
                y64 = y.double().reshape(-1, y.shape[-1])
                exact = torch.stack([y64.sum(0), (y64 * y64).sum(0)])
                scale = torch.stack([y64.abs().sum(0), (y64 * y64).sum(0)])
                check(bool(((st.double() - exact).abs()
                            <= 1e-5 * scale).all()),
                      f"conv3 call {i}: moment sums off")
            ins = [t for t in (args[0], kw.get("x2")) if t is not None]
            inputs = [t.clone() for t in ins]
            again = kern()
            again = again if isinstance(again, tuple) else (again,)
            check(all(bool(torch.equal(a, g)) for a, g in zip(again, got)),
                  f"conv3 call {i}: a second run differs")
            check(all(bool(torch.equal(a, b)) for a, b in zip(inputs, ins)),
                  f"conv3 call {i}: an input was written")
            del again, inputs
            plan = dict(zip(conv3_mod.PLAN_FIELDS, conv3_mod.conv3_plan(
                tuple(args[0].shape[1:4]), args[1].shape[1],
                args[1].shape[0], _conv3_mode(kw))))
            # the library yardstick: the conv + bias alone in one call
            xin = args[0] if kw.get("x2") is None else torch.cat(
                [args[0], kw["x2"]], -1)
            xcf = xin.permute(0, 4, 1, 2, 3)
            w, b = args[1], args[2]
            if kw.get("dilation", 1) == 2:
                wt_ = w.flip(2, 3, 4).transpose(0, 1).contiguous()

                def lib():
                    return F.conv_transpose3d(xcf, wt_, b, stride=2,
                                              padding=1, output_padding=1)
            else:
                def lib():
                    return F.conv3d(xcf, w, b, stride=kw.get("stride", 1),
                                    padding=1)
            ms, plain_ms = stream_ms(kern), stream_ms(plain)
            lib_ms = stream_ms(lib)
            flops, moved = conv3_work(args, kw, got[0])
            b_ms, b_by = bound(flops, moved)
            for k, v in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", lib_ms), ("flops", flops),
                         ("bytes", moved)):
                tot[k] += v
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            print(f"conv3[{i}] {_describe(args, kw)}: plan W run "
                  f"{plan['rw']} brick {plan['bd']}x{plan['bh']}x"
                  f"{plan['nrw'] * plan['rw']} co tile {plan['cot']} chunk "
                  f"{plan['ck']} split {plan['split']} ({plan['blocks']} "
                  f"blocks of {plan['threads']} threads, {plan['smem']} B "
                  f"shared); err {err:.2e} kernel {ms:.4f} plain "
                  f"{plain_ms:.4f} library {lib_ms:.4f} bound {b_ms:.4f} ms "
                  f"({b_by}), {flops / ms / 1e9:.2f} TFLOP/s")
    b_ms, b_by = bound(tot["flops"], tot["bytes"])
    print(f"conv3, the {len(calls)} calls of one forward: kernel "
          f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, F.conv3d "
          f"{tot['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
          f"{tot['flops'] / 1e12:.4f} TFLOP, {tot['bytes'] / 1e9:.4f} GB); "
          f"{tot['flops'] / tot['ms'] / 1e9:.2f} TFLOP/s (sums of medians "
          "of 5 CUDA-event runs of 20 back-to-back calls)")
    return {"max_abs_err": tot["max_abs_err"], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": tot["library_ms"]}


# conv3's bf16 instances by compute_dtype: the launch counter
CONV3_MODES = {"bfloat16": "conv3_bf16", "mixed": "conv3_mixed"}
MOMENTS_REL = 1e-5


def _as_tuple(t):
    return t if isinstance(t, tuple) else (t,)


def _conv3_bf16_held(torch, got, want, kw):
    """(passed, largest error, largest share, largest moment error): a
    conv3 bf16 instance's outputs (or a control's) against its twin's: the
    bf16 outputs by ``held_to`` at one ulp plus 1e-5; the fp32 moments
    within ``MOMENTS_REL`` of the sums of |y| and y^2, against the twin's
    (the sums of the fp32 values before the rounding) or, for the moments
    of the rounded outputs (the stride-2 conv's), against float64 sums of
    ``got``'s own outputs (a one-ulp flip between the two moves those)."""
    n_out = 2 if kw.get("residual") is not None else 1
    ok, err, share, mom = True, 0.0, 0.0, 0.0
    for g, w in zip(got[:n_out], want[:n_out]):
        check(g.shape == w.shape and g.dtype == w.dtype == torch.bfloat16,
              f"{tuple(g.shape)} {g.dtype} against {tuple(w.shape)} "
              f"{w.dtype}")
        o, e, _, sh = held_to(torch, g, w, (BF16_ULP, 1e-5))
        ok, err, share = ok and o, max(err, e), max(share, sh)
    for y, st, sw in zip(got[:n_out], got[n_out:], want[n_out:]):
        y64 = y.double().reshape(-1, y.shape[-1])
        scale = torch.stack([y64.abs().sum(0), (y64 * y64).sum(0)])
        ref = (torch.stack([y64.sum(0), (y64 * y64).sum(0)])
               if kw.get("stride", 1) == 2 else sw.double())
        rel = float(((st.double() - ref).abs() / scale).max())
        ok, mom = ok and rel <= MOMENTS_REL, max(mom, rel)
    return ok, err, share, mom


def _conv3_mode(kw):
    """conv3's mode of a call's options: 0 stride 1, 1 stride 2, 2
    dilation 2."""
    return (1 if kw.get("stride", 1) == 2 else
            2 if kw.get("dilation", 1) == 2 else 0)


def phase_conv3_bf16(torch, kernels, calls):
    """conv3's 'bfloat16' and 'mixed' instances against their plain twins
    at every call of one V-Net-DS forward in that mode (``calls``: mode ->
    the recorded calls), in the working type (``_conv3_bf16_held``); a
    second run bit-identical; the twin with the prologue output unrounded
    (the calls with a prologue) and, in 'bfloat16', the twin given the
    call's fp32 weights (the same call of the 'mixed' forward) are controls
    that must fail on every call. Times of back-to-back calls
    (``stream_ms``): the instance, the fp32 instance on the same call (its
    operands widened), the twin and cuDNN's bf16 ``F.conv3d`` (or
    ``F.conv_transpose3d``) + bias; the bound at the bytes the call moves
    and its operations at ``BF16_FLOPS``."""
    header("== conv3 bf16 instances (the calls of one V-Net-DS forward in "
           "'bfloat16' and 'mixed')")
    import torch.nn.functional as F
    from multimodal_3d_image_segmentation_tpu_torch.utils.tower_sweep import \
        stream_ms
    import importlib
    conv3_mod = importlib.import_module(
        "multimodal_3d_image_segmentation_tpu_torch.kernels.conv3")
    # registers, shared memory and spills of each tensor-core instance
    log = kernels.library().build_log.splitlines()
    for i, line in enumerate(log):
        if "Compiling entry function" in line and "conv3_mma" in line:
            props = [ln.strip() for ln in log[i + 1:i + 4]
                     if "spill" in ln or "Used" in ln]
            print(f"conv3 bf16 build: {line.split(chr(39))[1]}: "
                  f"{'; '.join(props)}")
    bf16 = torch.bfloat16
    out = {}
    with torch.inference_mode():
        for mode, mcalls in calls.items():
            name = CONV3_MODES[mode]
            tot = {"ms": 0.0, "fp32_ms": 0.0, "plain_ms": 0.0,
                   "library_ms": 0.0, "flops": 0, "bytes": 0,
                   "max_abs_err": 0.0, "share": 0.0, "moments": 0.0}
            n_ctl, shown = 0, set()
            for i, (args, kw) in enumerate(mcalls):
                def kern():
                    return kernels.conv3(*args, **kw)

                def plain(**extra):
                    return kernels.conv3_plain(*args, **kw, **extra)
                before = kernels.LAUNCHES[name]
                got = _as_tuple(kern())
                torch.cuda.synchronize()
                check(kernels.LAUNCHES[name] == before + 1,
                      f"{name} call {i}: launch count did not move")
                ok, err, share, mom = _conv3_bf16_held(
                    torch, got, _as_tuple(plain()), kw)
                check(ok, f"{name} call {i}: max abs err {err}, share "
                          f"{share}, moments {mom}")
                check(all(bool(torch.equal(a, g)) for a, g in
                          zip(_as_tuple(kern()), got)),
                      f"{name} call {i}: a second run differs")
                controls = []
                if kw.get("prologue") is not None:
                    controls.append(("prologue unrounded", plain(
                        unrounded={"prologue"})))
                if mode == "bfloat16":
                    # the same call of the 'mixed' forward holds the fp32
                    # weights these were rounded from
                    margs, mkw = calls["mixed"][i]
                    wkw = dict(kw)
                    if kw.get("residual") is not None:
                        wkw["residual"] = (mkw["residual"][0],
                                           kw["residual"][1])
                    controls.append(("weights unrounded", kernels.conv3_plain(
                        args[0], margs[1], margs[2], **wkw)))
                for label, ctl in controls:
                    bad, e_c, sh_c, m_c = _conv3_bf16_held(
                        torch, got, _as_tuple(ctl), kw)
                    check(not bad, f"{name} call {i}: control ({label}) "
                                   f"passed")
                    n_ctl += 1
                    if label not in shown:
                        shown.add(label)
                        print(f"{name} call {i} control, {label}: max abs "
                              f"err {e_c:.3e}, share {sh_c:.3e}, moments "
                              f"{m_c:.3e}")
                a32 = tuple(t.float() if torch.is_tensor(t) else t
                            for t in args)
                kw32 = {k: (tuple(t.float() for t in v) if isinstance(v, tuple)
                            else v.float() if torch.is_tensor(v) else v)
                        for k, v in kw.items()}
                xin = args[0] if kw.get("x2") is None else torch.cat(
                    [args[0], kw["x2"]], -1)
                xcf = xin.permute(0, 4, 1, 2, 3)
                w16, b16 = args[1].to(bf16), args[2].to(bf16)
                if kw.get("dilation", 1) == 2:
                    wt16 = w16.flip(2, 3, 4).transpose(0, 1).contiguous()

                    def lib():
                        return F.conv_transpose3d(xcf, wt16, b16, stride=2,
                                                  padding=1,
                                                  output_padding=1)
                else:
                    def lib():
                        return F.conv3d(xcf, w16, b16,
                                        stride=kw.get("stride", 1),
                                        padding=1)
                ms = stream_ms(kern)
                fp32_ms = stream_ms(lambda: kernels.conv3(*a32, **kw32))
                plain_ms, lib_ms = stream_ms(plain), stream_ms(lib)
                flops, moved = conv3_work(args, kw, got[0])
                b_ms, b_by = bound(flops, moved, BF16_FLOPS)
                for k, v in (("ms", ms), ("fp32_ms", fp32_ms),
                             ("plain_ms", plain_ms), ("library_ms", lib_ms),
                             ("flops", flops), ("bytes", moved)):
                    tot[k] += v
                for k, v in (("max_abs_err", err), ("share", share),
                             ("moments", mom)):
                    tot[k] = max(tot[k], v)
                plan = dict(zip(conv3_mod.MMA_PLAN_FIELDS,
                                conv3_mod.conv3_mma_plan(
                                    tuple(args[0].shape[1:4]),
                                    args[1].shape[1], args[1].shape[0],
                                    _conv3_mode(kw),
                                    passes=1 if mode == "bfloat16" else 2,
                                    residual=kw.get("residual") is not None)))
                print(f"{name}[{i}] {_describe(args, kw)}: plan tm "
                      f"{plan['tm']} brick {plan['bd']}x{plan['bh']}x"
                      f"{plan['bw']} warps along N {plan['wn']} chunk "
                      f"{plan['ck']} x {plan['chunks']} a block split "
                      f"{plan['split']} ({plan['blocks']} "
                      f"blocks of {plan['threads']} threads, {plan['smem']} "
                      f"B shared, conflict {plan['conflict']}); err "
                      f"{err:.2e} share {share:.1e} moments {mom:.1e} kernel "
                      f"{ms:.4f} (fp32 instance {fp32_ms:.4f}) plain "
                      f"{plain_ms:.4f} cuDNN bf16 {lib_ms:.4f} bound "
                      f"{b_ms:.4f} ms ({b_by}), {flops / ms / 1e9:.2f} "
                      "TFLOP/s")
            b_ms, b_by = bound(tot["flops"], tot["bytes"], BF16_FLOPS)
            print(f"{name}, the {len(mcalls)} calls of one forward: kernel "
                  f"{tot['ms']:.4f} ms (fp32 instance {tot['fp32_ms']:.4f} "
                  f"ms, {tot['ms'] / tot['fp32_ms']:.3f}x), plain "
                  f"{tot['plain_ms']:.4f} ms, cuDNN bf16 F.conv3d + bias "
                  f"{tot['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by};"
                  f" {tot['flops'] / 1e12:.4f} TFLOP, "
                  f"{tot['bytes'] / 1e9:.4f} GB); largest error "
                  f"{tot['max_abs_err']:.3e}, share {tot['share']:.2e}, "
                  f"moments {tot['moments']:.2e}; {n_ctl} controls failed "
                  "as they must (sums of medians of 5 CUDA-event runs of 20 "
                  "back-to-back calls)")
            out[name] = {"max_abs_err": tot["max_abs_err"], "ms": tot["ms"],
                         "plain_ms": tot["plain_ms"], "bound_ms": b_ms,
                         "bound_by": b_by, "library_ms": tot["library_ms"],
                         "fp32_ms": tot["fp32_ms"],
                         "share_beyond_ulp": tot["share"]}
    return out


def phase_model_mha(torch, state, case_dir: Path, dev):
    """HartleyMHASeg: kernel path against plain path and float64 on a
    served volume (with both tower kernels: tower_block_s covers the ds
    rows on a real path) and on a small one against the CPU; a control with
    tower_block's operands (the volume, z and the weights) rounded to TF32
    must fail the bars."""
    header("== model HartleyMHASeg")
    from multimodal_3d_image_segmentation_tpu_torch import kernels
    from multimodal_3d_image_segmentation_tpu_torch.models import (
        HartleyMHASeg, architectures)

    def build(use_kernels, device, dtype=torch.float32, **kw):
        m = HartleyMHASeg(**MHA, use_kernels=use_kernels, **kw).to(device,
                                                                   dtype)
        m.load_state_dict(state)
        return m

    x = served_volume(torch, case_dir, dev)
    # the tower grid must hold 2 * modes = (16, 24, 24)
    xs = torch.from_numpy(np.random.default_rng(SEED + 4).standard_normal(
        (1, 4, 32, 48, 48)).astype(np.float32))
    bars = BARS_MHA
    with torch.inference_mode():
        fast = build(True, dev)(x)
        check(fast.shape == (1, 4) + SHAPE, f"output shape {fast.shape}")
        sum_err = float((fast.sum(1) - 1).abs().max())
        check(sum_err <= 1e-5, f"probabilities sum off 1 by {sum_err}")
        plain = build(False, dev)(x)
        ref = build(False, dev, torch.float64)(x.double())
        torch.cuda.synchronize()
        compare(torch, f"HartleyMHASeg full volume {SHAPE}", fast, plain,
                ref, bars)
        del fast
        before = kernels.LAUNCHES["tower_block_s"]
        fast = build(True, dev, tower_kernel="block_s")(x)
        check(kernels.LAUNCHES["tower_block_s"] == before + MHA[
            "num_transform_blocks"], "HartleyMHASeg block_s: launches")
        compare(torch, f"HartleyMHASeg tower_kernel='block_s' full volume "
                f"{SHAPE}", fast, plain, ref, bars)
        del fast
        real = architectures.fused_tower_block

        def tf32_tower(x1, z, w_cat, w_cc_t, b_cat, spec, ds_prev=None):
            return real(_tf32(torch, x1), _tf32(torch, z),
                        _tf32(torch, w_cat), _tf32(torch, w_cc_t), b_cat,
                        spec, ds_prev)

        architectures.fused_tower_block = tf32_tower
        try:
            fast = build(True, dev)(x)
        finally:
            architectures.fused_tower_block = real
        compare(torch, "HartleyMHASeg control: tower_block operands in TF32",
                fast, plain, ref, bars, control=True)
        del fast, plain, ref

        fast = build(True, dev)(xs.to(dev)).cpu()
        plain = build(False, "cpu")(xs)
        ref = build(False, "cpu", torch.float64)(xs.double())
        compare(torch, "HartleyMHASeg small volume (1,4,32,48,48), GPU "
                "kernels vs CPU", fast, plain, ref, bars)


def phase_model_noseg(torch, state, transform, case_dir: Path, dev):
    """HNOSeg / FNOSeg: the kernel path on tower_block (the default), on
    tower_block_s and on tower_resident against the plain path and float64
    on a served volume (one float64 evaluation for all), the first also on
    a small one against the CPU; a control with each tower kernel's
    operands (the volume, the spectrum or z, and the weights) rounded to
    TF32 must fail the bars; forward + argmax times of the three tower
    kernels with the input on the card."""
    label = "HNOSeg" if transform == "Hartley" else "FNOSeg"
    header(f"== model {label}")
    from multimodal_3d_image_segmentation_tpu_torch import kernels
    from multimodal_3d_image_segmentation_tpu_torch.models import (
        NeuralOperatorSeg, architectures)
    from multimodal_3d_image_segmentation_tpu_torch.runtime.steps import \
        make_predict_step

    def build(use_kernels, device, dtype=torch.float32, **kw):
        m = NeuralOperatorSeg(**NOSEG, transform_type=transform,
                              use_kernels=use_kernels, **kw).to(device, dtype)
        m.load_state_dict(state)
        return m.eval()

    x, xs = served_volume(torch, case_dir, dev), small_volume(torch)
    bars = BARS_NOSEG
    with torch.inference_mode():
        fast = build(True, dev)(x)
        check(fast.shape == (1, 4) + SHAPE, f"output shape {fast.shape}")
        sum_err = float((fast.sum(1) - 1).abs().max())
        check(sum_err <= 1e-5, f"probabilities sum off 1 by {sum_err}")
        plain = build(False, dev)(x)
        ref = build(False, dev, torch.float64)(x.double())
        torch.cuda.synchronize()
        compare(torch, f"{label} full volume {SHAPE}", fast, plain, ref, bars)
        del fast
        for kernel, name in (("block", "fused_tower_block"),
                             ("block_s", "fused_tower_block_s")):
            if kernel != "block":
                before = kernels.LAUNCHES["tower_block_s"]
                fast = build(True, dev, tower_kernel=kernel)(x)
                check(kernels.LAUNCHES["tower_block_s"] == before + NOSEG[
                    "num_transform_blocks"], f"{label} {kernel}: launches")
                compare(torch, f"{label} tower_kernel={kernel!r} full volume "
                        f"{SHAPE}", fast, plain, ref, bars)
                del fast
            real = getattr(architectures, name)

            def tf32_tower(x1, s, w_cat, w_cc_t, b_cat, spec, ds_prev=None,
                           real=real):
                return real(_tf32(torch, x1), _tf32(torch, s),
                            _tf32(torch, w_cat), _tf32(torch, w_cc_t), b_cat,
                            spec, ds_prev)

            setattr(architectures, name, tf32_tower)
            try:
                fast = build(True, dev, tower_kernel=kernel)(x)
            finally:
                setattr(architectures, name, real)
            compare(torch, f"{label} control: tower_{kernel} operands in "
                    "TF32", fast, plain, ref, bars, control=True)
            del fast
        before = kernels.LAUNCHES["tower_resident"]
        fast = build(True, dev, tower_kernel="resident")(x)
        check(kernels.LAUNCHES["tower_resident"] == before + 1,
              f"{label} resident: launches")
        compare(torch, f"{label} tower_kernel='resident' full volume "
                f"{SHAPE}", fast, plain, ref, bars)
        del fast
        real_r = architectures.resident_tower

        def tf32_resident(x1, ops, wcat, wcc, b, spec):
            return real_r(_tf32(torch, x1), _tf32(torch, ops),
                          _tf32(torch, wcat), _tf32(torch, wcc), b, spec)

        architectures.resident_tower = tf32_resident
        try:
            fast = build(True, dev, tower_kernel="resident")(x)
        finally:
            architectures.resident_tower = real_r
        compare(torch, f"{label} control: tower_resident operands in TF32",
                fast, plain, ref, bars, control=True)
        del fast, plain, ref

        fast = build(True, dev)(xs.to(dev)).cpu()
        plain = build(False, "cpu")(xs)
        ref = build(False, "cpu", torch.float64)(xs.double())
        compare(torch, f"{label} small volume (1,4,32,30,21), GPU kernels vs "
                "CPU", fast, plain, ref, bars)
    steps = {k: make_predict_step(build(True, dev, tower_kernel=k))
             for k in ("block_s", "block", "resident")}
    for k in ("block_s", "block", "resident", "resident", "block",
              "block_s"):
        t = median_ms(torch, lambda: steps[k](x), n=N_STEP_TIMED)
        print(f"{label} forward + argmax, tower_kernel={k!r}: {t:.4f} ms "
              f"(median of {N_STEP_TIMED}, CUDA events, input on the card)")


def phase_model_vnet(torch, state, case_dir: Path, dev):
    """V-Net-DS: kernel path against plain path and float64 on a served
    volume and on a small one against the CPU; a control with conv3's
    operands (inputs and weights) rounded to TF32 must fail the bars."""
    header("== model V-Net-DS")
    from multimodal_3d_image_segmentation_tpu_torch.models import (
        VNetDS, architectures)

    def build(use_kernels, device, dtype=torch.float32):
        m = VNetDS(**VNET, use_kernels=use_kernels).to(device, dtype)
        m.load_state_dict(state)
        return m

    x, xs = served_volume(torch, case_dir, dev), small_volume(torch)
    bars = BARS_VNET
    with torch.inference_mode():
        fast = build(True, dev)(x)
        check(fast.shape == (1, 4) + SHAPE, f"output shape {fast.shape}")
        sum_err = float((fast.sum(1) - 1).abs().max())
        check(sum_err <= 1e-5, f"probabilities sum off 1 by {sum_err}")
        plain = build(False, dev)(x)
        ref = build(False, dev, torch.float64)(x.double())
        torch.cuda.synchronize()
        compare(torch, f"V-Net-DS full volume {SHAPE}", fast, plain, ref,
                bars)
        del fast
        real = architectures.conv3

        def tf32_conv3(x1, w, b, **kw):
            if kw.get("x2") is not None:
                kw["x2"] = _tf32(torch, kw["x2"])
            return real(_tf32(torch, x1), _tf32(torch, w), b, **kw)

        architectures.conv3 = tf32_conv3
        try:
            fast = build(True, dev)(x)
        finally:
            architectures.conv3 = real
        compare(torch, "V-Net-DS control: conv3 operands in TF32", fast,
                plain, ref, bars, control=True)
        del fast, plain, ref

        fast = build(True, dev)(xs.to(dev)).cpu()
        plain = build(False, "cpu")(xs)
        ref = build(False, "cpu", torch.float64)(xs.double())
        compare(torch, "V-Net-DS small volume (1,4,32,30,21), GPU kernels "
                "vs CPU", fast, plain, ref, bars)


# ---------------------------------------------------------------- sharded
# conv3's halo mode: the launch counter of each instance
HALO_NAMES = {"float32": "conv3_halo", "bfloat16": "conv3_halo_bf16",
              "mixed": "conv3_halo_mixed"}
# a first, a middle and a last depth slab
HALO_KEEPS = ((0, 1), (1, 1), (1, 0))


def record_sharded_calls(torch, state, x, dev):
    """instance -> every conv3 call of one V-Net-DS kernel-path forward of
    ``x`` (1, C, D, H, W) in the orientation a depth-sharded forward runs
    it: the image axis it splits (``flat_vnet_shardable``; 155 -> 78
    planes after conv_in at 240x240x155) as depth."""
    from multimodal_3d_image_segmentation_tpu_torch.models import VNetDS
    from multimodal_3d_image_segmentation_tpu_torch.parallel import \
        flat_vnet_shardable
    dim = flat_vnet_shardable(tuple(x.shape[2:]), VNET["num_blocks"], True,
                              N_SHARDED)
    order = (dim,) + tuple(k for k in range(3) if k != dim)
    xp = x.permute(0, 1, *(2 + k for k in order)).contiguous()
    calls = {}
    for mode in ("float32", "bfloat16", "mixed"):
        fast = VNetDS(**VNET, use_kernels=True, compute_dtype=mode,
                      device=dev)
        fast.load_state_dict(state)
        calls[mode] = record_conv3_calls(torch, fast, xp)
        check(len(calls[mode]) == PER_VOLUME_VNET["conv3"],
              f"{mode}: {len(calls[mode])} conv3 calls per forward")
    return calls


def _level01_calls(calls):
    """The recorded calls of one V-Net-DS forward that read a level-0 or
    level-1 volume, as (index, args, kw): the stride-1 and stride-2 convs
    at the first two levels' depths, the up convs from levels 1 and 2."""
    d0 = calls[0][0][0].shape[1]
    d1 = (d0 - 1) // 2 + 1
    d2 = (d1 - 1) // 2 + 1
    return [(i, a, kw) for i, (a, kw) in enumerate(calls)
            if a[0].shape[1] in ((d1, d2) if kw.get("dilation", 1) == 2
                                 else (d0, d1))]


def _halo_slab(torch, t, keep, stride):
    """A depth slab of ``t`` (1, D, H, W, C) with one halo plane at each
    end, as a rank of a depth-sharded forward holds it: D // 2 planes (an
    even count at stride 2, as the schedule guarantees), the first slab
    for keep (0, 1), a middle one for (1, 1), the last for (1, 0); the
    halo planes at the volume's ends are zeros."""
    import torch.nn.functional as F
    D = t.shape[1]
    d = D // 2 // 2 * 2 if stride == 2 else D // 2
    r0 = {(0, 1): 0, (1, 1): (D - d) // 4 * 2, (1, 0): D - d}[keep]
    return F.pad(t, (0, 0, 0, 0, 0, 0, 1, 1))[:, r0:r0 + d + 2].contiguous()


def _halo_call(torch, args, kw, keep):
    """A recorded call as the halo-mode call of one slab (``_halo_slab``)."""
    s = kw.get("stride", 1)
    kw = dict(kw, halo=True, halo_keep=keep)
    if kw.get("x2") is not None:
        kw["x2"] = _halo_slab(torch, kw["x2"], keep, s)
    return (_halo_slab(torch, args[0], keep, s),) + tuple(args[1:]), kw


def _zero_halos(torch, args, kw):
    """The same call with its halo planes zeroed (a control)."""
    def z(t):
        t = t.clone()
        t[:, 0] = 0
        t[:, -1] = 0
        return t
    kw = dict(kw)
    if kw.get("x2") is not None:
        kw["x2"] = z(kw["x2"])
    return (z(args[0]),) + tuple(args[1:]), kw


def _fp32_held(torch, got, want, kw):
    """(passed, largest error): the fp32 bar of ``phase_conv3`` (1e-4 of
    the output's largest magnitude, at least 1; the moment sums within
    1e-5 of float64 sums of the kernel's own output)."""
    n_out = 2 if kw.get("residual") is not None else 1
    ok, err = True, 0.0
    for g, w in zip(got[:n_out], want[:n_out]):
        check(g.shape == w.shape, f"{tuple(g.shape)} != {tuple(w.shape)}")
        e = float((g - w).abs().max())
        ok = ok and np.isfinite(e) and e <= 1e-4 * max(1.0, float(
            w.abs().max()))
        err = max(err, e)
    for y, st in zip(got[:n_out], got[n_out:]):
        y64 = y.double().reshape(-1, y.shape[-1])
        exact = torch.stack([y64.sum(0), (y64 * y64).sum(0)])
        scale = torch.stack([y64.abs().sum(0), (y64 * y64).sum(0)])
        ok = ok and bool(((st.double() - exact).abs() <= 1e-5 * scale).all())
    return ok, err


def _halo_work(args, kw, y):
    """(flops, bytes) of a halo call: the taps that read a kept plane or
    the interior, each input read and each output written once."""
    x, w = args[0], args[1]
    keep = kw["halo_keep"]
    d = x.shape[1] - 2
    stride, dil = kw.get("stride", 1), kw.get("dilation", 1)
    if dil == 2:
        depth = _taps(d + keep[1], y.shape[1], 1, 2)
    else:
        depth = sum(-keep[0] <= o * stride + k - 1 < d + keep[1]
                    for o in range(y.shape[1]) for k in range(3))
    ci, co = w.shape[1], w.shape[0]
    macs = ci * co * depth * int(np.prod([
        _taps(n, m, stride, dil) for n, m in zip(x.shape[2:4],
                                                 y.shape[2:4])]))
    res = kw.get("residual")
    moved = nbytes(x, kw.get("x2"), w, args[2], *(kw.get("prologue") or ()),
                   y)
    if res is not None:
        macs += ci * co * int(np.prod(y.shape[1:4]))
        moved += nbytes(*res) + nbytes(y)
    if kw.get("emit_stats"):
        moved += 2 * co * 4 * (2 if res is not None else 1)
    return 2 * macs, moved


def _halo_library(torch, args, kw):
    """One PyTorch call of the same conv: ``F.conv3d`` + bias over the
    halo'd slab with no depth padding (``F.conv_transpose3d`` over the
    source planes and the next halo for dilation 2)."""
    import torch.nn.functional as F
    xin = args[0] if kw.get("x2") is None else torch.cat(
        [args[0], kw["x2"]], -1)
    xcf = xin.permute(0, 4, 1, 2, 3)
    w, b = args[1], args[2]
    if xin.dtype == torch.bfloat16:
        w, b = w.to(torch.bfloat16), b.to(torch.bfloat16)
    if kw.get("dilation", 1) == 2:
        wt = w.flip(2, 3, 4).transpose(0, 1).contiguous()
        src = xcf[:, :, 1:]
        return lambda: F.conv_transpose3d(src, wt, b, stride=2, padding=1,
                                          output_padding=1)
    return lambda: F.conv3d(xcf, w, b, stride=kw.get("stride", 1),
                            padding=(0, 1, 1))


def phase_conv3_halo(torch, kernels, calls):
    """conv3's halo mode (depth-sharded volumes) and depth-dilated mode on
    the card. ``calls``: instance -> the recorded calls of one V-Net-DS
    forward in it, in the sharded orientation (``record_sharded_calls``).
    Each level-0 and level-1 call (stride 1 with its
    prologue, virtual concat, residual tap and moments, stride 2, dilation
    2) runs on a first, a middle and a last slab (``_halo_slab``) against
    its plain twin: fp32 at ``phase_conv3``'s bar, the bf16 instances at
    ``phase_conv3_bf16``'s with its controls. Two controls must fail on
    every call they apply to: the twin with the kept halo planes zeroed,
    and, where a prologue meets a global end, the twin with that end's
    keep flag forced to 1. The calls of a depth-sharded forward on its
    first rank (the level-0 stride-1 calls on the first slab) are timed
    against the twin, ``F.conv3d`` + bias over the halo'd slab and the
    bound; so is the depth-dilated mode on the up conv's source."""
    header("== conv3 halo mode (the level-0 and level-1 calls of V-Net-DS "
           "in the sharded orientation, on three slabs each) and "
           "dilated_depth")
    from multimodal_3d_image_segmentation_tpu_torch.utils.tower_sweep import \
        stream_ms
    out = {}
    with torch.inference_mode():
        for inst, icalls in calls.items():
            name = HALO_NAMES[inst]
            bf16 = inst != "float32"
            tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flops": 0,
                   "bytes": 0, "max_abs_err": 0.0}
            n_cases = n_ctl = 0
            for i, args0, kw0 in _level01_calls(icalls):
                for keep in HALO_KEEPS:
                    args, kw = _halo_call(torch, args0, kw0, keep)

                    def kern():
                        return kernels.conv3(*args, **kw)

                    def plain(**extra):
                        return kernels.conv3_plain(*args, **{**kw, **extra})
                    before = kernels.LAUNCHES[name]
                    got = _as_tuple(kern())
                    torch.cuda.synchronize()
                    check(kernels.LAUNCHES[name] == before + 1,
                          f"{name} call {i} keep {keep}: launch count did "
                          "not move")
                    want = _as_tuple(plain())
                    if bf16:
                        ok, err, share, mom = _conv3_bf16_held(
                            torch, got, want, kw)
                    else:
                        ok, err = _fp32_held(torch, got, want, kw)
                    check(ok, f"{name} call {i} keep {keep}: max abs err "
                              f"{err}")
                    tot["max_abs_err"] = max(tot["max_abs_err"], err)
                    n_cases += 1
                    # the halo planes the call reads: stride 2 reads only
                    # the first, dilation 2 only the last
                    read = ((True, False) if kw.get("stride", 1) == 2 else
                            (False, True) if kw.get("dilation", 1) == 2
                            else (True, True))
                    controls = []
                    if any(r and k for r, k in zip(read, keep)):
                        za, zk = _zero_halos(torch, args, kw)
                        controls.append(("halo planes zero", _as_tuple(
                            kernels.conv3_plain(*za, **zk))))
                    if kw.get("prologue") is not None and any(
                            r and not k for r, k in zip(read, keep)):
                        controls.append(("keep forced to 1", _as_tuple(
                            plain(halo_keep=(1, 1)))))
                    if bf16 and kw.get("prologue") is not None:
                        controls.append(("prologue unrounded", _as_tuple(
                            plain(unrounded={"prologue"}))))
                    if inst == "bfloat16":
                        # the same call of the 'mixed' forward holds the
                        # fp32 weights these were rounded from
                        _, ma, mk = _level01_calls(calls["mixed"])[
                            [j for j, _, _ in _level01_calls(icalls)].index(i)]
                        wkw = dict(kw)
                        if kw.get("residual") is not None:
                            wkw["residual"] = (mk["residual"][0],
                                               kw["residual"][1])
                        controls.append(("weights unrounded", _as_tuple(
                            kernels.conv3_plain(args[0], ma[1], ma[2],
                                                **wkw))))
                    for label, ctl in controls:
                        bad = (_conv3_bf16_held(torch, got, ctl, kw)[0]
                               if bf16 else
                               _fp32_held(torch, got, ctl, kw)[0])
                        check(not bad, f"{name} call {i} keep {keep}: "
                                       f"control ({label}) passed")
                        n_ctl += 1
                    main_path = (keep == (0, 1) and kw.get("stride", 1) == 1
                                 and kw.get("dilation", 1) == 1
                                 and args0[0].shape[1]
                                 == icalls[0][0][0].shape[1])
                    if not main_path:
                        continue
                    lib = _halo_library(torch, args, kw)
                    ms, plain_ms = stream_ms(kern), stream_ms(plain)
                    lib_ms = stream_ms(lib)
                    flops, moved = _halo_work(args, kw, got[0])
                    b_ms, b_by = bound(flops, moved,
                                       BF16_FLOPS if bf16 else FP32_FLOPS)
                    for k, v in (("ms", ms), ("plain_ms", plain_ms),
                                 ("library_ms", lib_ms), ("flops", flops),
                                 ("bytes", moved)):
                        tot[k] += v
                    print(f"{name}[{i}] {_describe(args, kw)} keep {keep} "
                          f"(a sharded forward's first rank): err "
                          f"{err:.2e} kernel {ms:.4f} plain {plain_ms:.4f} "
                          f"F.conv3d+bias (slab, depth padding 0) "
                          f"{lib_ms:.4f} bound {b_ms:.4f} ms ({b_by})")
            b_ms, b_by = bound(tot["flops"], tot["bytes"],
                               BF16_FLOPS if bf16 else FP32_FLOPS)
            print(f"{name}: {n_cases} calls (the level-0 and level-1 calls "
                  f"on three slabs) held to the twin, largest error "
                  f"{tot['max_abs_err']:.3e}; {n_ctl} controls failed as "
                  f"they must; the first rank's calls of a sharded forward: "
                  f"kernel {tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} "
                  f"ms, F.conv3d + bias {tot['library_ms']:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by}) (sums of medians of 5 CUDA-event "
                  "runs of 20 back-to-back calls)")
            out[name] = {"max_abs_err": tot["max_abs_err"], "ms": tot["ms"],
                         "plain_ms": tot["plain_ms"], "bound_ms": b_ms,
                         "bound_by": b_by, "library_ms": tot["library_ms"]}
            _dilated_depth_case(torch, kernels, inst, icalls)
    return out


def _dilated_depth_case(torch, kernels, inst, icalls):
    """conv3's depth-dilated mode on the first up conv's source volume and
    weights (with and without an ELU prologue) against its twin, timed
    beside ``F.conv3d`` over the materialized dilated volume."""
    import torch.nn.functional as F
    from multimodal_3d_image_segmentation_tpu_torch.utils.tower_sweep import \
        stream_ms
    name = "conv3" + INSTANCES_SUFFIX[inst]
    bf16 = inst != "float32"
    # the last up conv: level 1's volume into level 0
    args, kw = [(a, k) for a, k in icalls if k.get("dilation", 1) == 2][-1]
    x, w, b = args
    n = x.shape[1]
    rng = np.random.default_rng(SEED + 5)
    ci = x.shape[-1]
    pro = tuple(torch.from_numpy(v.astype(np.float32)).to(x.device)
                for v in (rng.standard_normal(ci) * 0.3 + 1,
                          rng.standard_normal(ci) * 0.5))
    for opts in ({}, {"prologue": pro, "prologue_act": "elu"}):
        def kern():
            return kernels.conv3(x, w, b, dilated_depth=n, **opts)

        def plain():
            return kernels.conv3_plain(x, w, b, dilated_depth=n, **opts)
        before = kernels.LAUNCHES[name]
        got = kern()
        torch.cuda.synchronize()
        check(kernels.LAUNCHES[name] == before + 1,
              f"{name} dilated_depth: launch count did not move")
        want = plain()
        check(got.shape == (1, 2 * n) + tuple(x.shape[2:4]) + (w.shape[0],),
              f"dilated_depth output {tuple(got.shape)}")
        if bf16:
            ok, err, _, _ = _conv3_bf16_held(torch, (got,), (want,), {})
        else:
            ok, err = _fp32_held(torch, (got,), (want,), {})
        check(ok, f"{name} dilated_depth {sorted(opts)}: max abs err {err}")
        dil = torch.stack([x, torch.zeros_like(x)], 2).reshape(
            (1, 2 * n) + tuple(x.shape[2:]))
        wl, bl = (w, b) if not bf16 else (w.to(torch.bfloat16),
                                          b.to(torch.bfloat16))
        dcf = dil.permute(0, 4, 1, 2, 3)
        ms, plain_ms = stream_ms(kern), stream_ms(plain)
        lib_ms = stream_ms(lambda: F.conv3d(dcf, wl, bl, padding=1))
        macs = w.shape[0] * w.shape[1] * _taps(n, 2 * n, 1, 2) * int(
            np.prod([_taps(m, m, 1, 1) for m in x.shape[2:4]]))
        b_ms, b_by = bound(2 * macs, nbytes(x, w, b, got, *(
            opts.get("prologue") or ())), BF16_FLOPS if bf16 else FP32_FLOPS)
        print(f"{name} dilated_depth={n} {_describe(args, opts)} -> "
              f"{tuple(got.shape[1:4])}: err {err:.2e} kernel {ms:.4f} plain "
              f"{plain_ms:.4f} F.conv3d over the dilated volume "
              f"{lib_ms:.4f} bound {b_ms:.4f} ms ({b_by})")


INSTANCES_SUFFIX = {"float32": "", "bfloat16": "_bf16", "mixed": "_mixed"}
# the launches of one rank of V-Net-DS depth-sharded over 2 ranks at
# 240x240x155: image axis 2 (78 planes after conv_in) is split, level 0
# is sharded (39 planes a rank) and its two chain convs run the halo mode
PER_VOLUME_VNET_SHARDED = per_volume(conv_in=1, tail_resize=1, conv3=27,
                                     conv3_halo=2)
N_SHARDED = 2


def _sharded_forward(state_path, x_path, out_dir):
    """One rank of a direct depth-sharded V-Net-DS forward on the card
    (``parallel/ranks.py::run_ranks`` starts it): the served volume, then
    the same with every halo exchange replaced by zeros (a control); rank
    0 saves both outputs. Returns the rank's launches, peak memory and
    wall time."""
    import torch
    import torch.distributed as dist
    from multimodal_3d_image_segmentation_tpu_torch import kernels
    from multimodal_3d_image_segmentation_tpu_torch.models import VNetDS
    from multimodal_3d_image_segmentation_tpu_torch.parallel import (
        flat_vnet_shardable, halo)
    rank, n = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    dim = flat_vnet_shardable(SHAPE, VNET["num_blocks"], True, n)
    model = VNetDS(**VNET, use_kernels=True, spatial_shard=(None, n, dim),
                   device=dev)
    model.load_state_dict(torch.load(state_path, map_location=dev))
    x = torch.from_numpy(np.load(x_path)).to(dev)
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    walls = []
    with torch.inference_mode():
        for _ in range(2):
            dist.barrier()
            t0 = time.perf_counter()
            y = model(x)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        launches = {k: v // 2 for k, v in kernels.LAUNCHES.items() if v}
        real = halo.halo_exchange

        def zero_halos(x_local, group=None):
            z = torch.zeros_like(x_local[:, :1])
            return torch.cat([z, x_local, z], 1)
        halo.halo_exchange = zero_halos
        try:
            y_ctl = model(x)
        finally:
            halo.halo_exchange = real
    if rank == 0:
        np.save(Path(out_dir) / "sharded.npy", y.cpu().numpy())
        np.save(Path(out_dir) / "zero_halos.npy", y_ctl.cpu().numpy())
    return {"rank": rank, "dim": dim, "launches": launches,
            "peak_mib": torch.cuda.max_memory_allocated(dev) / MIB,
            "wall_s": walls}


def _sharded_config(work: Path, label: str, list_paths):
    """configs/config_vnet-ds.ini as a file with the run directory, the
    data, the list files, one reader process a rank (the two ranks share
    the host) and ``[parallel] n_data = 1, n_spatial = 2`` set; everything
    else as the file sets it."""
    import re
    text = (REPO / "configs" / "config_vnet-ds.ini").read_text()
    lists = work / f"{label}_lists"
    lists.mkdir()
    for p in map(Path, list_paths):  # <mod>_test.txt -> <mod>_test-0.3.txt
        shutil.copy(p, lists / p.name.replace("_test.txt", "_test-0.3.txt"))
    subs = {"output_dir": repr(str(work / label)),
            "data_dir": repr(str(work / "data") + "/"),
            "list_dir": repr(str(lists)), "num_workers": "1"}
    for key, val in subs.items():
        text, n = re.subn(rf"(?m)^{key} = .*$", f"{key} = {val}", text)
        check(n == 1, f"config_vnet-ds.ini: {key}")
    text += f"\n[parallel]\nn_data = 1\nn_spatial = {N_SHARDED}\n"
    path = work / f"{label}.ini"
    path.write_text(text)
    return path


def start_serve_sharded(torch, work: Path, list_paths, vnet, case_dir: Path,
                        dev):
    """Start V-Net-DS served depth-sharded over 2 ranks on the one card:
    the real entry point, ``torch.distributed.run --standalone
    --nproc-per-node 2 -m ...runtime.inference`` on config_vnet-ds.ini
    with ``[parallel] n_spatial = 2``, fp32, full width, on the served
    cases, and beside it a direct forward over 2 spawned ranks
    (``parallel/ranks.py::run_ranks``) with its zero-halo control. The two
    ranks of each share the card over gloo (NCCL takes one card a rank, so
    NCCL across cards is not exercised here). Both run in the background
    while the script goes on with phases that time nothing;
    ``finish_serve_sharded`` checks them. Returns what it started."""
    header(f"== serve V-Net-DS depth-sharded over {N_SHARDED} ranks "
           "(torch.distributed.run, gloo, one card): started")
    from concurrent.futures import ThreadPoolExecutor
    from multimodal_3d_image_segmentation_tpu_torch.parallel.ranks import \
        run_ranks
    label = "V-Net-DS-sharded"
    (work / label / "model").mkdir(parents=True)
    torch.save(vnet.state_dict(), work / label / "model" / "model.pt")
    ini = _sharded_config(work, label, list_paths)
    torch.cuda.empty_cache()
    log = open(work / f"{label}.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(N_SHARDED), "-m",
         "multimodal_3d_image_segmentation_tpu_torch.runtime.inference",
         str(ini)], cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
        text=True)
    log.close()
    x = served_volume(torch, case_dir, dev)
    np.save(work / "x.npy", x.cpu().numpy())
    torch.save(vnet.state_dict(), work / "state.pt")
    pool = ThreadPoolExecutor(1)
    direct = pool.submit(run_ranks, _sharded_forward, N_SHARDED,
                         work / "ranks", str(work / "state.pt"),
                         str(work / "x.npy"), str(work))
    pool.shutdown(wait=False)
    return {"proc": proc, "direct": direct, "t0": time.perf_counter(),
            "label": label, "x": x}


def stop_serve_sharded(started):
    """Kill the sharded serve if it still runs (a phase between start and
    finish failed); the direct ranks end on their own."""
    if started and started["proc"].poll() is None:
        started["proc"].kill()
        started["proc"].wait()


def finish_serve_sharded(torch, kernels, work: Path, vnet, started):
    """Wait for what ``start_serve_sharded`` started and check it: each
    serving rank's launches (conv3_halo among them), the labels against
    the unsharded serve's (``work / "V-Net-DS"``); the direct forward's
    probabilities within 1e-4 of the unsharded kernel path's and at most
    2x its distance from the float64 model, and the forward with its halo
    exchange replaced by zeros must fail that. Returns the serving ranks'
    summed launches."""
    header(f"== serve V-Net-DS depth-sharded over {N_SHARDED} ranks: "
           "checked")
    from multimodal_3d_image_segmentation_tpu_torch.data import read_img
    from multimodal_3d_image_segmentation_tpu_torch.models import VNetDS
    label, proc = started["label"], started["proc"]
    try:
        proc.wait(timeout=600)
    finally:
        stop_serve_sharded(started)
    wall = time.perf_counter() - started["t0"]
    lines = (work / f"{label}.log").read_text().splitlines()
    for ln in lines:
        if ln.startswith(("torch.distributed:", "rank ")):
            print(ln)
    check(proc.returncode == 0, f"sharded serving exited {proc.returncode}:"
          f"\n" + "\n".join(lines[-40:]))
    ranks = [json.loads(ln.split(": ", 1)[1]) for ln in lines
             if ln.startswith("rank ") and ": {" in ln]
    check(len(ranks) == N_SHARDED, f"{len(ranks)} rank lines in:\n"
          + "\n".join(lines[-40:]))
    launches = {k: 0 for k in kernels.LAUNCHES}
    want = {k: v * N_CASES for k, v in PER_VOLUME_VNET_SHARDED.items() if v}
    for r in ranks:
        check(r["launches"] == want, f"rank {r['rank']} launches "
              f"{r['launches']} != {want}")
        check(r["launches"]["conv3_halo"] > 0, "no conv3_halo launch")
        for k, v in r["launches"].items():
            launches[k] += v
    print(f"sharded serving: {N_SHARDED} ranks, {N_CASES} volumes each; "
          f"done {wall:.2f} s after the direct forward started (two ranks "
          "sharing one card with the direct forward's two and the phases "
          "between: not a speed figure)")
    diff = 0
    for i in range(N_CASES):
        a = read_img(str(work / label / "test" / "images"
                         / f"case_{i}_pred.nii.gz"))
        b = read_img(str(work / "V-Net-DS" / "test" / "images"
                         / f"case_{i}_pred.nii.gz"))
        check(a.shape == SHAPE, f"sharded prediction shape {a.shape}")
        diff += int((a != b).sum())
    share = diff / (N_CASES * int(np.prod(SHAPE)))
    print(f"sharded labels against the unsharded serve's: {diff} of "
          f"{N_CASES * int(np.prod(SHAPE))} voxels differ ({share:.3e}, bar "
          "1e-5)")
    check(share <= 1e-5, f"sharded labels differ on {share:.3e} of voxels")

    # the direct forward, with the zero-halo control
    res = started["direct"].result(timeout=600)
    for r in res:
        print(f"rank {r['rank']} (split image axis {r['dim']}): launches a "
              f"forward {r['launches']}, peak allocated "
              f"{r['peak_mib']:.1f} MiB, forward wall "
              f"{', '.join(f'{w * 1e3:.1f}' for w in r['wall_s'])} ms (two "
              "ranks sharing one card over gloo: not a speed figure)")
        check(r["launches"].get("conv3_halo", 0) == 2,
              f"rank {r['rank']}: conv3_halo launches {r['launches']}")
    sharded = torch.from_numpy(np.load(work / "sharded.npy"))
    control = torch.from_numpy(np.load(work / "zero_halos.npy"))
    x = started["x"]

    def build(use_kernels, dtype=torch.float32):
        m = VNetDS(**VNET, use_kernels=use_kernels).to(x.device, dtype)
        m.load_state_dict(vnet.state_dict())
        return m
    with torch.inference_mode():
        fast = build(True)(x).cpu()
        ref = build(False, torch.float64)(x.double()).cpu()
    d_fast = float((fast.double() - ref).abs().max())
    for name, y, ctl in (("sharded", sharded, False),
                         ("control: halo exchange replaced by zeros",
                          control, True)):
        vs = float((y - fast).abs().max())
        d = float((y.double() - ref).abs().max())
        ok = vs <= 1e-4 and d <= 2 * d_fast + 1e-6 and bool(
            torch.isfinite(y).all())
        print(f"{name} forward: max abs err against the unsharded kernel "
              f"path {vs:.3e} (bar 1e-4), from float64 {d:.3e} against the "
              f"unsharded kernel path's {d_fast:.3e} (ratio "
              f"{d / d_fast:.3f}, bar 2)")
        check(ok != ctl, f"{name}: {'passed' if ctl else 'failed'} the bars")
    return launches


# ---------------------------------------------------------------- train
TRAIN_SHAPE = (120, 120, 78)   # the configs' training size
TRAIN_GRID = (61, 61, 40)      # its grid after conv_in
TRAIN_CASES = {"train": 4, "valid": 2, "test": 2}
RUN_EPOCHS = 1                 # each family's run
# a Function's gradients against autograd through its plain twin on the
# card: fp32 sums over up to 148,840 voxels in another order (conv_in's
# weight, the tail's transposed interpolation), so 1e-5 of each gradient's
# largest magnitude, at least 1; a TF32 product would miss by about 5e-4
GRAD_RTOL = 1e-5
# the whole-model rules for one train step (``utils/train_bars.py``):
# HNOSeg-XS and V-Net-DS hold the loss and each gradient to BARS_TRAIN
# (each tensor's largest error at most 2x the plain path's, plus 1e-6 of
# scale); the towers hold the loss so and each gradient to
# BARS_TRAIN_SELU (its RMS error at most 5x the larger of the plain path's,
# the plain twins path's and their typical level, plus 1e-6 of scale: SELU's
# kink moves gradients by chance factors on any fp32 path), and their
# typical error to 2x the larger of the two paths'. A fault planted in one
# gradient of a passing tower step, a block's w_cc_t columns scaled by
# 1 + PLANTED, must fail.
PLANTED = 0.05
N_TRAIN_TIMED = 10
N_CONV3_BWD_TIMED = 10
MIB = 1024 ** 2


def _backward_case(torch, fused, plain, args, g, n_timed=N_TIMED):
    """One Function's gradients (its kernel forward, its backward) against
    autograd through its plain twin on the same inputs and output
    gradients: (max abs err and bar per gradient, backward ms, the plain
    graph's backward ms)."""
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    y_fused, y_plain = _as_tuple(fused(*leaves)), _as_tuple(plain(*leaves))
    got = torch.autograd.grad(y_fused, leaves, g, retain_graph=True)
    want = torch.autograd.grad(y_plain, leaves, g, retain_graph=True)
    errs = []
    for a, ref in zip(got, want):
        errs.append((float((a - ref).abs().max()),
                     GRAD_RTOL * max(1.0, float(ref.abs().max()))))
    ms = median_ms(torch, lambda: torch.autograd.grad(
        y_fused, leaves, g, retain_graph=True), n=n_timed)
    plain_ms = median_ms(torch, lambda: torch.autograd.grad(
        y_plain, leaves, g, retain_graph=True), n=n_timed)
    return errs, ms, plain_ms


def phase_backward(torch, kernels, dev, vnet_state, resident_state):
    """Each kernel Function's backward on the card (the kernel forward, the
    Function's backward) against autograd through its plain twin, at the
    training shapes, with the backward's time beside the plain graph's:
    conv_in, freq_chain and tail_resize at HNOSeg-XS's shapes; tower_block
    at HartleyMHASeg's, HNOSeg's and FNOSeg's (the 61x61x40 grid);
    tower_block_s at HNOSeg's; tower_resident, HNOSeg's 24-block tower
    with its weights ``resident_state``, with the peak memory of its
    replay; conv3 at every call of one V-Net-DS training forward at
    1x4x120x120x78 (weights ``vnet_state``). Returns kernel -> backward ms
    and the plain graph's."""
    header("== backward")
    from multimodal_3d_image_segmentation_tpu_torch.kernels import \
        tower_block as tb
    from multimodal_3d_image_segmentation_tpu_torch.kernels.conv3 import \
        flat_call
    from multimodal_3d_image_segmentation_tpu_torch.models import (
        NeuralOperatorSeg, VNetDS)
    from multimodal_3d_image_segmentation_tpu_torch.utils.tower_sweep import \
        BLOCK_SHAPES
    rng = np.random.default_rng(SEED + 3)

    def t(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(dev)

    x = t((1, 4) + TRAIN_SHAPE)
    w, b = t((24, 4, 2, 2, 2), 1 / np.sqrt(32)), t((24,), 0.1)
    g_in = t((1,) + TRAIN_GRID + (24,))
    spec, ws = t((1, 20, 28, 28, 24)), [t((24, 24), 1 / np.sqrt(24))
                                        for _ in range(3)]
    logits, g_tail = t((1, 4) + TRAIN_GRID, 3.0), t((1, 4) + TRAIN_SHAPE)
    cases = {  # label -> kernel, fused, plain, inputs, output gradients
        "conv_in": ("conv_in", kernels.conv_in_s2d, kernels.conv_in_plain,
                    (x, w, b), g_in),
        "conv_in_noselu": (
            "conv_in", lambda *a: kernels.conv_in_s2d(*a, apply_selu=False),
            lambda *a: kernels.conv_in_plain(*a, apply_selu=False),
            (x, w, b), g_in),
        "freq_chain": ("freq_chain",
                       lambda s, *w_: kernels.fused_freq_chain(s, list(w_)),
                       lambda s, *w_: kernels.freq_chain_plain(s, list(w_)),
                       (spec, *ws), t(tuple(spec.shape))),
        "tail_resize": (
            "tail_resize",
            lambda a: kernels.fused_tail_softmax(a, TRAIN_SHAPE),
            lambda a: kernels.tail_plain(a, TRAIN_SHAPE), (logits,), g_tail),
    }
    for i, (label, transform, modes, nds) in enumerate(BLOCK_SHAPES):
        bspec = tb.make_tower_spec(transform, TRAIN_GRID, modes, 24,
                                   n_ds=nds)
        with torch.no_grad():
            xb, s, w_cat, w_cc_t, b_cat, ds_prev = _tower_operands(
                torch, tb, dev, bspec, SEED + 20 + i)
            z = tb.d_stage_inverse(s, bspec).contiguous()
        dsp = (ds_prev,) if nds else ()
        g = (t(tuple(xb.shape)), t(tuple(z.shape))) + (
            (t(tuple(ds_prev.shape)),) if nds else ())
        cases[f"tower_block {label}"] = (
            "tower_block",
            lambda *a, s_=bspec: kernels.fused_tower_block(*a[:5], s_,
                                                           *a[5:]),
            lambda *a, s_=bspec: kernels.tower_block_plain(*a[:5], s_,
                                                           *a[5:]),
            (xb, z, w_cat, w_cc_t, b_cat, *dsp), g)
        if label == "HNOSeg":
            cases["tower_block_s HNOSeg"] = (
                "tower_block_s",
                lambda *a, s_=bspec: kernels.fused_tower_block_s(*a, s_),
                lambda *a, s_=bspec: kernels.tower_block_s_plain(*a, s_),
                (xb, s.contiguous(), w_cat, w_cc_t, b_cat),
                (t(tuple(xb.shape)), t(tuple(s.shape))))
            model = NeuralOperatorSeg(**NOSEG, transform_type="Hartley",
                                      device=dev)
            model.load_state_dict(resident_state)
            with torch.no_grad():
                weights = tuple(w_.detach().clone()
                                for w_ in model.resident_operands())
            del model
            cases["tower_resident HNOSeg"] = (
                "tower_resident",
                lambda *a, s_=bspec: kernels.resident_tower(*a, s_),
                lambda *a, s_=bspec: kernels.resident_tower_plain(*a, s_),
                (xb, *weights), t(tuple(xb.shape)))
    results = {}
    for label, (name, fused, plain, args, g) in cases.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        errs, ms, plain_ms = _backward_case(torch, fused, plain, args, g)
        for err, bar in errs:
            check(np.isfinite(err) and err <= bar,
                  f"{label} backward: max abs err {err} > {bar}")
        results.setdefault(name, {"backward_ms": ms,
                                  "backward_plain_ms": plain_ms})
        peak = (f"; peak allocated {torch.cuda.max_memory_allocated(dev) / MIB:.1f}"
                f" MiB (both graphs kept)" if name == "tower_resident"
                else "")
        print(f"{label} backward at {tuple(args[0].shape)}: max abs err per "
              "gradient " + ", ".join(f"{e:.3e} (bar {bb:.3e})"
                                      for e, bb in errs)
              + f"; backward {ms:.4f} ms, autograd through the plain twin "
              f"{plain_ms:.4f} ms (medians of {N_TIMED}, CUDA events){peak}")
    del cases
    torch.cuda.empty_cache()

    # conv3 at every call of one V-Net-DS training forward
    model = VNetDS(**VNET, use_kernels=True, device=dev)
    model.load_state_dict(vnet_state)
    calls = record_conv3_calls(torch, model, t((1, 4) + TRAIN_SHAPE),
                               grad=True)
    del model
    check(len(calls) == PER_VOLUME_VNET["conv3"],
          f"{len(calls)} conv3 calls in a V-Net-DS training forward")
    tot = {"ms": 0.0, "plain_ms": 0.0, "err": 0.0}
    for i, (args, kw) in enumerate(calls):
        tensors, bind = flat_call(*args, **kw)
        with torch.no_grad():
            outs = _as_tuple(kernels.conv3_plain(*args, **kw))
        g = tuple(t(tuple(o.shape)) for o in outs)
        before = kernels.LAUNCHES["conv3"]
        errs, ms, plain_ms = _backward_case(
            torch, bind(kernels.conv3), bind(kernels.conv3_plain), tensors,
            g, N_CONV3_BWD_TIMED)
        check(kernels.LAUNCHES["conv3"] == before + 1,
              f"conv3 call {i}: the kernel forward was not launched once")
        for err, bar in errs:
            check(np.isfinite(err) and err <= bar,
                  f"conv3 call {i} backward: max abs err {err} > {bar}")
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["err"] = max([tot["err"]] + [e / bb for e, bb in errs])
        print(f"conv3[{i}] backward {_describe(args, kw)}: {len(errs)} "
              f"gradients, largest err / bar {max(e / bb for e, bb in errs):.3f}"
              f"; backward {ms:.4f} ms, plain graph {plain_ms:.4f} ms")
    print(f"conv3 backward, the {len(calls)} calls of one V-Net-DS training "
          f"forward at 1x4x{'x'.join(map(str, TRAIN_SHAPE))}: {tot['ms']:.4f}"
          f" ms, autograd through the plain twin {tot['plain_ms']:.4f} ms "
          f"(sums of medians of {N_CONV3_BWD_TIMED}, CUDA events); largest "
          f"err / bar {tot['err']:.3f}")
    results["conv3"] = {"backward_ms": tot["ms"],
                        "backward_plain_ms": tot["plain_ms"]}
    del calls
    torch.cuda.empty_cache()
    return results


def _loss_and_grads(torch, model, x, y1h):
    from multimodal_3d_image_segmentation_tpu_torch.losses import PCCLoss
    model.zero_grad(set_to_none=True)
    loss = PCCLoss()(model(x), y1h)
    loss.backward()
    return loss.detach(), {k: p.grad.detach().clone()
                           for k, p in model.named_parameters()}


def _planted(paths, ref, name, eps):
    """What fails the towers' rules with the kernel path's gradient of
    ``name`` (a block's conv_concat weight) scaled by 1 + ``eps`` in its
    first half of columns, the w_cc_t operand of the tower kernels."""
    from multimodal_3d_image_segmentation_tpu_torch.utils.train_bars import \
        readings, tower_failures
    g = paths["kernel"][name].clone()
    w = g.view(g.shape[0], -1)
    w[:, :g.shape[0]] *= 1 + eps
    return tower_failures(readings(
        dict(paths, kernel={**paths["kernel"], name: g}), ref))


def _tf32_through(torch, t):
    """``t`` rounded to TF32 in the forward pass; the gradient passes
    through unchanged (the exact difference of two nearby floats)."""
    if t is None or not t.requires_grad:
        return None if t is None else _tf32(torch, t)
    return t + (_tf32(torch, t.detach()) - t.detach())


def tf32_conv3(torch, real):
    """conv3 on TF32-rounded operands (input, x2 and weight)."""
    def call(x1, w, b, **kw):
        if kw.get("x2") is not None:
            kw["x2"] = _tf32_through(torch, kw["x2"])
        return real(_tf32_through(torch, x1), _tf32_through(torch, w), b,
                    **kw)
    return call


def tf32_tower_block(torch, real):
    """tower_block on TF32-rounded operands (the volume, z and the
    weights)."""
    def call(x1, z, w_cat, w_cc_t, b_cat, spec, ds_prev=None):
        return real(*(_tf32_through(torch, a) for a in (x1, z, w_cat,
                                                        w_cc_t)),
                    b_cat, spec, ds_prev)
    return call


def _train_batch(torch, dev):
    from multimodal_3d_image_segmentation_tpu_torch.utils.labels import \
        to_categorical
    rng = np.random.default_rng(SEED + 4)
    x = torch.from_numpy(rng.standard_normal((1, 4) + TRAIN_SHAPE)
                         .astype(np.float32)).to(dev)
    y = torch.from_numpy(_labels(rng, TRAIN_SHAPE)[None, None]
                         .astype(np.float32)).to(dev)
    return x, y, to_categorical(y, 4)


def phase_train_step(torch, kernels, label, build, variants, control,
                     selu=False):
    """One full-width train step of a family from the same weights and the
    same seeded batch (1x4x120x120x78) on each kernel path of ``variants``
    ((name, build keywords, launches a step)) and on the plain path: the
    loss and every gradient held to a float64 evaluation (``BARS_TRAIN``;
    with ``selu``, the towers' rules, ``train_bars.tower_failures``,
    against the plain path and the kernel path's plain twins path, which
    must launch no kernel, and a planted single-tensor fault that must fail
    them), the
    launches a step; ``control(step_of)``, the first kernel path on
    TF32-rounded operands, must fail the rules; each path's step time
    (forward, backward, Adamax) and peak memory. ``build(use_kernels,
    dtype, **keywords)`` makes the model with the family's weights."""
    header(f"== train step {label}")
    from multimodal_3d_image_segmentation_tpu_torch.losses import PCCLoss
    from multimodal_3d_image_segmentation_tpu_torch.runtime.steps import \
        make_train_step
    from multimodal_3d_image_segmentation_tpu_torch.utils.train_bars import (
        over_bars, plain_twins, readings, tower_failures, typical)
    dev = torch.device("cuda:0")
    x, y, y1h = _train_batch(torch, dev)

    def gate(r):
        return tower_failures(r) if selu else over_bars(r, "kernel",
                                                        ("plain",))

    def step_of(use_kernels, dtype=torch.float32, inp=x, **kw):
        loss, grads = _loss_and_grads(torch, build(use_kernels, dtype, **kw),
                                      inp.to(dtype), y1h.to(dtype))
        return {"loss": loss, **grads}

    def twins_of(name, **kw):
        kernels.reset_launch_counts()
        with plain_twins():
            twins = step_of(True, **kw)
        torch.cuda.synchronize()
        check(not any(kernels.LAUNCHES.values()), f"{label} {name}: the "
              f"plain twins path launched {dict(kernels.LAUNCHES)}")
        return twins

    def report(r):
        worst = max(r, key=lambda k: r[k]["kernel"]["max"]
                    / max(r[k]["plain"]["max"], 1e-300))
        ratio = r[worst]["kernel"]["max"] / max(r[worst]["plain"]["max"],
                                                1e-300)
        typ = {p: typical(r, p) for p in r["loss"] if p != "scale"}
        return (f"largest error ratio to the plain path's {ratio:.3f} "
                f"({worst}: {r[worst]['kernel']['max']:.3e} / "
                f"{r[worst]['plain']['max']:.3e}, scale "
                f"{r[worst]['scale']:.3e}); typical error "
                + ", ".join(f"{p} {e:.3e}" for p, e in typ.items())
                + f"; tensors over BARS_TRAIN: "
                f"{over_bars(r, 'kernel', ('plain',)) or 'none'}")

    plain = step_of(False)
    ref = step_of(False, dtype=torch.float64)
    first_twins = None
    for name, kw, want in variants:
        kernels.reset_launch_counts()
        fast = step_of(True, **kw)
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        check(launches == want, f"{label} {name} train step launches "
              f"{launches} != {want}")
        paths = {"kernel": fast, "plain": plain}
        if selu:
            paths["twins"] = twins_of(name, **kw)
            first_twins = first_twins or paths["twins"]
        r = readings(paths, ref)
        failed = gate(r)
        print(f"{label} {name} train step at 1x4x"
              f"{'x'.join(map(str, TRAIN_SHAPE))}: launches {launches}; "
              f"loss {float(fast['loss']):.7f} (plain "
              f"{float(plain['loss']):.7f}, float64 {float(ref['loss']):.7f})"
              f"; over the loss and {len(r) - 1} gradients: {report(r)}; "
              f"failing the {'towers' if selu else 'BARS_TRAIN'} rules: "
              f"{failed or 'none'}")
        check(not failed, f"{label} {name} train step failed the bars for "
              f"{failed}")
        if selu and name == variants[0][0]:
            mid = len([k for k in fast if k.endswith(
                "conv_concat.op.weight")]) // 2
            tensor = f"layers.{mid}.conv_concat.op.weight"
            failed = _planted(paths, ref, tensor, PLANTED)
            lo, hi = 0.0, PLANTED
            for _ in range(12):  # the smallest factor the rules fail
                if _planted(paths, ref, tensor, (lo + hi) / 2):
                    hi = (lo + hi) / 2
                else:
                    lo = (lo + hi) / 2
            print(f"{label} planted fault, {tensor}'s w_cc_t columns scaled "
                  f"by {1 + PLANTED}: failing {failed or 'none'}; the rules "
                  f"fail this tensor scaled by 1 + {hi:.2e} and more")
            check(failed, f"{label}: the planted fault passed the rules")
        del fast
    ctrl_label, ctrl = control(step_of)
    paths = {"kernel": ctrl, "plain": plain}
    if selu:
        paths["twins"] = first_twins
    r = readings(paths, ref)
    failed_ctrl = gate(r)
    print(f"{label} control, {ctrl_label}: "
          f"{len(over_bars(r, 'kernel', ('plain',)))} of {len(ref)} tensors "
          f"over BARS_TRAIN; typical error {typical(r, 'kernel'):.3e} "
          f"({typical(r, 'kernel') / max(typical(r, 'plain'), 1e-300):.1f}x "
          f"the plain path's); failing the "
          f"{'towers' if selu else 'BARS_TRAIN'} rules: "
          f"{len(failed_ctrl)} ({', '.join(failed_ctrl[:4])}, ...)")
    check(failed_ctrl, f"{label}: the TF32 control passed the train-step "
          "bars")
    del plain, ref, ctrl, paths, first_twins

    for name, kw, _ in variants + [("plain", None, None)]:
        model = build(kw is not None, torch.float32, **(kw or {}))
        opt = torch.optim.Adamax(model.parameters(), lr=5e-3)
        step = make_train_step(model, opt, None, PCCLoss(), 4)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # the float64 step's blocks, cached
        torch.cuda.reset_peak_memory_stats(dev)
        ms = median_ms(torch, lambda: step(x, y), n=N_TRAIN_TIMED)
        print(f"{label} train step ({name}): {ms:.3f} ms (forward + "
              f"backward + Adamax, median of {N_TRAIN_TIMED} CUDA-event "
              f"steps after 3 warm-ups); peak allocated "
              f"{torch.cuda.max_memory_allocated(dev) / MIB:.1f} MiB, "
              f"reserved {torch.cuda.max_memory_reserved(dev) / MIB:.1f} MiB")
        del model, opt, step
        torch.cuda.empty_cache()


def train_steps(torch, kernels, states, dev):
    """``phase_train_step`` for every family at its config width: HNOSeg-XS
    (control: conv_in's operands in TF32), V-Net-DS (conv3's), and
    HartleyMHASeg, HNOSeg and FNOSeg (tower_block's), HNOSeg also on
    tower_block_s and tower_resident."""
    from multimodal_3d_image_segmentation_tpu_torch.models import (
        HartleyMHASeg, HNOSegXS, NeuralOperatorSeg, VNetDS, architectures)

    def builder(cls, kw, state):
        def build(use_kernels, dtype, weights=state, **extra):
            m = cls(**kw, use_kernels=use_kernels, **extra).to(dev, dtype)
            m.load_state_dict(weights)
            return m
        return build

    def patched(name, wrap):
        def control(step_of):
            real = getattr(architectures, name)
            setattr(architectures, name, wrap(torch, real))
            try:
                return f"{name}'s operands in TF32", step_of(True)
            finally:
                setattr(architectures, name, real)
        return control

    def conv_in_control(step_of):
        rounded = {k: _tf32(torch, v) if k == "conv_in.op.weight" else v
                   for k, v in states["HNOSeg-XS"].items()}
        x = _train_batch(torch, dev)[0]
        return "conv_in operands in TF32", step_of(
            True, inp=_tf32(torch, x), weights=rounded)

    def per_step(per_volume):
        return {k: v for k, v in per_volume.items() if v}

    phase_train_step(
        torch, kernels, "HNOSeg-XS",
        builder(HNOSegXS, FLAGSHIP, states["HNOSeg-XS"]),
        [("kernels", {}, per_step(PER_VOLUME_HNOSEG))], conv_in_control)
    phase_train_step(
        torch, kernels, "V-Net-DS", builder(VNetDS, VNET, states["V-Net-DS"]),
        [("kernels", {}, per_step(PER_VOLUME_VNET))],
        patched("conv3", tf32_conv3))
    phase_train_step(
        torch, kernels, "HartleyMHASeg",
        builder(HartleyMHASeg, MHA, states["HartleyMHASeg"]),
        [("kernels", {}, per_step(PER_VOLUME_MHA))],
        patched("fused_tower_block", tf32_tower_block), selu=True)
    for label, transform in (("HNOSeg", "Hartley"), ("FNOSeg", "Fourier")):
        variants = [("kernels", {}, per_step(PER_VOLUME_NOSEG))]
        if transform == "Hartley":
            variants += [
                ("block_s", {"tower_kernel": "block_s"},
                 per_step(PER_VOLUME_NOSEG_BLOCK_S)),
                ("resident", {"tower_kernel": "resident"},
                 per_step(PER_VOLUME_NOSEG_RESIDENT))]
        phase_train_step(
            torch, kernels, label,
            builder(NeuralOperatorSeg, dict(NOSEG, transform_type=transform),
                    states[label]),
            variants, patched("fused_tower_block", tf32_tower_block),
            selu=True)
        torch.cuda.empty_cache()


def _labels(rng, shape):
    """Nested ellipsoids at a seeded centre and size, labels 0-3."""
    grid = np.ogrid[tuple(map(slice, shape))]
    c = [rng.uniform(0.35, 0.65) * n for n in shape]
    r = np.sqrt(sum(((g - cc) / (rng.uniform(0.2, 0.35) * n)) ** 2
                    for g, cc, n in zip(grid, c, shape)))
    return np.select([r < 0.35, r < 0.7, r < 1.0], [3, 1, 2], 0).astype(
        np.uint8)


def _write_training_cases(root: Path):
    """A BraTS-layout dataset at the training size: 4 modalities and seeded
    labels per case, and list files per split and modality."""
    from multimodal_3d_image_segmentation_tpu_torch.data import write_image
    rng = np.random.default_rng(SEED + 5)
    mods = ["t1c", "t1n", "t2f", "t2w", "seg"]
    paths = {}
    for split, n in TRAIN_CASES.items():
        lists = {m: [] for m in mods}
        for i in range(n):
            case = f"{split}_{i}"
            seg = _labels(rng, TRAIN_SHAPE)
            for m in mods[:4]:
                vol = (rng.standard_normal(TRAIN_SHAPE, dtype=np.float32)
                       + 2.0 + seg)
                write_image(vol, root / case / f"{m}.nii")
                lists[m].append(f"{case}/{m}.nii")
            write_image(seg, root / case / "seg.nii")
            lists["seg"].append(f"{case}/seg.nii")
        paths[split] = []
        for m in mods:
            p = root / f"{m}_{split}.txt"
            p.write_text("\n".join(lists[m]) + "\n")
            paths[split].append(str(p))
    return paths


def phase_run(torch, kernels, work: Path, lists, label, config,
              per_volume, epochs=RUN_EPOCHS):
    """A main path of training: ``runtime/run.py::run`` on ``config``
    (train, test, statistics) on the synthetic training cases, its launch
    counts set to 0 just before and read just after; then run_inference
    on the run directory must give the run's own test labels."""
    header(f"== run {label} (train, test, statistics)")
    from multimodal_3d_image_segmentation_tpu_torch.data import read_img
    from multimodal_3d_image_segmentation_tpu_torch.runtime.config import \
        get_config
    from multimodal_3d_image_segmentation_tpu_torch.runtime.inference import \
        run_inference
    from multimodal_3d_image_segmentation_tpu_torch.runtime.run import run
    from multimodal_3d_image_segmentation_tpu_torch.runtime.train_test \
        import get_losses_from_file

    out_dir = work / f"{label}_run"
    cfg = get_config(str(REPO / "configs" / config))
    cfg["main"]["output_dir"] = str(out_dir)
    cfg["input_lists"]["data_dir"] = str(work / "train_data")
    for split, paths in lists.items():
        cfg["input_lists"][f"data_lists_{split}_paths"] = paths
    cfg["train"]["num_epochs"] = epochs
    print(f"configs/{config} with output_dir, data_dir, the list paths and "
          f"num_epochs = {epochs} overridden; everything else as the file "
          "sets it")

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    run(cfg)
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    tested = TRAIN_CASES["test"]
    forwards = (epochs * (TRAIN_CASES["train"] + TRAIN_CASES["valid"])
                + tested)
    want = {k: v * forwards for k, v in per_volume.items()}
    check(launches == want, f"{label} run launches {launches} != {want} "
          f"({forwards} forwards)")
    print(f"run {label}: {seconds:.2f} s; launches ({forwards} forwards: "
          f"{epochs} epochs of {TRAIN_CASES['train']} train and "
          f"{TRAIN_CASES['valid']} valid cases and {TRAIN_CASES['test']} "
          f"test cases): {launches}")

    test_dir = out_dir / cfg["test"]["output_folder"]
    ids = [f"test_{i}" for i in range(TRAIN_CASES["test"])]
    for f in ["model/model.pt", "model/checkpoint.pt", "stdout.txt",
              "model_summary.txt", f"{cfg['test']['output_folder']}/"
              "results_regional.csv"] + [
            f"{cfg['test']['output_folder']}/images/{i}_pred.nii.gz"
            for i in ids]:
        check((out_dir / f).is_file(), f"{label}: the run did not write {f}")
    train_loss, valid_loss = get_losses_from_file(str(out_dir / "stdout.txt"))
    check(len(train_loss) == len(valid_loss) == epochs
          and np.isfinite(train_loss + valid_loss).all(),
          f"{label} losses {train_loss} / {valid_loss}")
    print(f"{label} train_loss {train_loss}, valid_loss {valid_loss}")
    print((test_dir / "average_results_regional.txt").read_text().strip())

    cfg["test"]["output_folder"] = "served"
    kernels.reset_launch_counts()
    run_inference(cfg)
    served = dict(kernels.LAUNCHES)
    want = {k: v * tested for k, v in per_volume.items()}
    check(served == want, f"{label} run_inference launches {served} != "
          f"{want}")
    for i in ids:
        a = read_img(str(out_dir / "served" / "images" / f"{i}_pred.nii.gz"))
        b = read_img(str(test_dir / "images" / f"{i}_pred.nii.gz"))
        check(a.shape == TRAIN_SHAPE and np.array_equal(a, b),
              f"{label} {i}: run_inference's labels differ from the run's "
              "test")
    print(f"run_inference on the {label} run directory: the same labels for "
          f"the {len(ids)} test cases; launches {served}")
    for k, v in served.items():
        launches[k] += v
    shutil.rmtree(out_dir, ignore_errors=True)
    return launches


RUNS = [  # label, config, launches per forward
    ("HNOSeg-XS", "config_hnoseg_xs.ini", PER_VOLUME_HNOSEG),
    ("V-Net-DS", "config_vnet-ds.ini", PER_VOLUME_VNET),
    ("HartleyMHASeg", "config_hartleymha.ini", PER_VOLUME_MHA),
    ("HNOSeg", "config_hnoseg.ini", PER_VOLUME_NOSEG),
    ("FNOSeg", "config_fnoseg.ini", PER_VOLUME_NOSEG),
]


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script checks the port on a GPU and does not run on CPU")
    sys.path.insert(0, str(REPO))
    from multimodal_3d_image_segmentation_tpu_torch import kernels
    from multimodal_3d_image_segmentation_tpu_torch.models import (
        HartleyMHASeg, HNOSegXS, NeuralOperatorSeg, VNetDS)
    dev = torch.device("cuda:0")

    phase_device(torch)
    phase_build(kernels)
    results = phase_kernels(torch, kernels, dev)
    results.update(phase_kernels_bf16(torch, kernels, dev, results))
    results["tower_block"] = phase_tower_block(torch, kernels, dev)
    results["tower_block_s"] = phase_tower_block_s(torch, kernels, dev)
    results["tower_resident"] = phase_tower_resident(torch, kernels, dev)
    results.update(phase_towers_bf16(torch, kernels, dev))
    (REPO / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="smoke_", dir=REPO / "build"))
    states, sharded = {}, None
    try:
        t0 = time.perf_counter()
        list_paths = _write_cases(work / "data")
        case0 = work / "data" / "case_0"
        print(f"set-up (synthetic cases): {time.perf_counter() - t0:.2f} s")
        gen = torch.Generator().manual_seed(SEED)
        hnoseg = HNOSegXS(**FLAGSHIP, generator=gen)
        launches = phase_serve(
            torch, kernels, work, list_paths, "HNOSeg-XS",
            "config_inference_hnoseg_xs.ini", hnoseg, 28248,
            PER_VOLUME_HNOSEG)
        phase_model_hnoseg(torch, hnoseg.state_dict(), case0, dev)
        states["HNOSeg-XS"] = hnoseg.state_dict()
        served_bf16(torch, kernels, work, list_paths, launches, "HNOSeg-XS",
                    "config_inference_hnoseg_xs.ini", hnoseg, 28248,
                    PER_VOLUME_HNOSEG_BF16, PER_VOLUME_HNOSEG_MIXED)
        phase_gate(torch, dev)

        vnet = VNetDS(**VNET, generator=torch.Generator().manual_seed(SEED))
        fast = VNetDS(**VNET, use_kernels=True, device=dev)
        fast.load_state_dict(vnet.state_dict())
        calls = record_conv3_calls(torch, fast,
                                   served_volume(torch, case0, dev))
        check(len(calls) == PER_VOLUME_VNET["conv3"],
              f"{len(calls)} conv3 calls per forward")
        results["conv3"] = phase_conv3(torch, kernels, calls)
        del calls, fast
        calls = {}
        for mode in CONV3_MODES:
            fast = VNetDS(**VNET, use_kernels=True, compute_dtype=mode,
                          device=dev)
            fast.load_state_dict(vnet.state_dict())
            calls[mode] = record_conv3_calls(
                torch, fast, served_volume(torch, case0, dev))
            check(len(calls[mode]) == PER_VOLUME_VNET["conv3"],
                  f"{mode}: {len(calls[mode])} conv3 calls per forward")
        results.update(phase_conv3_bf16(torch, kernels, calls))
        del calls, fast
        calls = record_sharded_calls(torch, vnet.state_dict(),
                                     served_volume(torch, case0, dev), dev)
        results.update(phase_conv3_halo(torch, kernels, calls))
        del calls
        torch.cuda.empty_cache()
        launches_v = phase_serve(
            torch, kernels, work, list_paths, "V-Net-DS",
            "config_vnet-ds.ini", vnet, 22547764, PER_VOLUME_VNET)
        for k, v in launches_v.items():
            launches[k] += v
        served_bf16(torch, kernels, work, list_paths, launches, "V-Net-DS",
                    "config_vnet-ds.ini", vnet, 22547764,
                    PER_VOLUME_VNET_BF16, PER_VOLUME_VNET_MIXED)
        # the sharded serve runs beside the two phases after it, which
        # time nothing and do not read the launch counts
        sharded = start_serve_sharded(torch, work, list_paths, vnet, case0,
                                      dev)
        phase_gate(torch, dev, "vnetds")
        phase_model_vnet(torch, vnet.state_dict(), case0, dev)
        launches_s = finish_serve_sharded(torch, kernels, work, vnet,
                                          sharded)
        for k, v in launches_s.items():
            launches[k] += v
        states["V-Net-DS"] = vnet.state_dict()
        del vnet
        torch.cuda.empty_cache()

        mha = HartleyMHASeg(**MHA,
                            generator=torch.Generator().manual_seed(SEED))
        launches_m = phase_serve(
            torch, kernels, work, list_paths, "HartleyMHASeg",
            "config_hartleymha.ini", mha, 178532, PER_VOLUME_MHA)
        for k, v in launches_m.items():
            launches[k] += v
        for mode in ("bfloat16", "mixed"):
            served_mode(torch, kernels, work, list_paths, launches,
                        "HartleyMHASeg", "config_hartleymha.ini", mha,
                        178532, mode, "tower_block",
                        MHA["num_transform_blocks"], "block")
        phase_gate(torch, dev, "hartleymha")
        phase_model_mha(torch, mha.state_dict(), case0, dev)
        states["HartleyMHASeg"] = mha.state_dict()
        del mha
        torch.cuda.empty_cache()

        for transform, config, n_params in (
                ("Hartley", "config_hnoseg.ini", 57360),
                ("Fourier", "config_fnoseg.ini", 71184)):
            noseg = NeuralOperatorSeg(
                **NOSEG, transform_type=transform,
                generator=torch.Generator().manual_seed(SEED))
            label = "HNOSeg" if transform == "Hartley" else "FNOSeg"
            variants = [("", PER_VOLUME_NOSEG, None),
                        ("-resident", PER_VOLUME_NOSEG_RESIDENT,
                         {"tower_kernel": "resident"})]
            if transform == "Hartley":
                variants.append(("-block_s", PER_VOLUME_NOSEG_BLOCK_S,
                                 {"tower_kernel": "block_s"}))
            for suffix, per_volume, keys in variants:
                launches_n = phase_serve(
                    torch, kernels, work, list_paths, label + suffix, config,
                    noseg, n_params, per_volume, keys)
                for k, v in launches_n.items():
                    launches[k] += v
            nb = NOSEG["num_transform_blocks"]
            for mode in ("bfloat16", "mixed"):
                for tower, n, kernel in (("tower_block", nb, "block"),
                                         ("tower_block_s", nb, "block_s"),
                                         ("tower_resident", 1, "resident")):
                    served_mode(torch, kernels, work, list_paths, launches,
                                label, config, noseg, n_params, mode, tower,
                                n, kernel)
            phase_gate(torch, dev, label.lower())
            phase_model_noseg(torch, noseg.state_dict(), transform, case0,
                              dev)
            states[label] = noseg.state_dict()
            del noseg
            torch.cuda.empty_cache()

        # training after serving in the same process: the matrices that
        # serving cached under inference mode are saved for backward here
        t_train = time.perf_counter()
        backward = phase_backward(torch, kernels, dev, states["V-Net-DS"],
                                  states["HNOSeg"])
        for name, r in backward.items():
            results[name].update(r)
        train_steps(torch, kernels, states, dev)
        t0 = time.perf_counter()
        lists = _write_training_cases(work / "train_data")
        print(f"set-up (synthetic training cases, {TRAIN_CASES}): "
              f"{time.perf_counter() - t0:.2f} s")
        for label, config, per_volume in RUNS:
            launches_t = phase_run(torch, kernels, work, lists, label, config,
                                   per_volume)
            for k, v in launches_t.items():
                launches[k] += v
        print(f"train phase: {time.perf_counter() - t_train:.2f} s")
    finally:
        stop_serve_sharded(sharded)
        shutil.rmtree(work, ignore_errors=True)
    check("jax" not in sys.modules, "jax was imported")
    # the redesigned conv3 must beat cuDNN over one V-Net-DS forward; the
    # bf16 instances' totals beside cuDNN's bf16 conv (ROADMAP queue 2: not
    # yet below it)
    check(results["conv3"]["ms"] < results["conv3"]["library_ms"],
          f"conv3 {results['conv3']['ms']:.4f} ms is not below F.conv3d's "
          f"{results['conv3']['library_ms']:.4f} ms")
    for name in CONV3_MODES.values():
        r = results[name]
        print(f"{name}: {r['ms']:.4f} ms over the 29 calls against cuDNN's "
              f"bf16 F.conv3d + bias {r['library_ms']:.4f} ms "
              f"({r['ms'] / r['library_ms']:.3f}x; "
              f"{'below' if r['ms'] < r['library_ms'] else 'not below'} it)")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **results[name]}
        for name, src, rep in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
