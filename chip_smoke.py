#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Usage, from the root of a checkout:  python3 chip_smoke.py

Drives the port's seven serving paths once at full width on 4-modality
240x240x155 volumes, batch 1, fp32, random weights from a seed: HNOSeg-XS
(filters 24, blocks [3]*8, modes (10,14,14)), V-Net-DS (base 24, blocks
[1,2,3,3,3], right leg [0..4], 22,547,764 parameters), HartleyMHASeg
(filters 24, 16 blocks, 4 heads, modes (8,12,12), patch 2, deep
supervision, 178,532 parameters), and HNOSeg and FNOSeg (NeuralOperatorSeg:
filters 24, 24 blocks, modes (10,14,14), shared weights, Hartley or
Fourier, 57,360 and 71,184 parameters), the last two on their default
tower kernel ``tower_kernel`` 'block' and on 'resident', HNOSeg also on
'block_s'. It checks them:

  1. device   the card's name and power limit, torch and CUDA versions;
  2. build    compile the CUDA kernels from ``csrc/`` (one nvcc per source,
              all at once, sm_90a);
  3. kernels  conv_in (also at the odd-D/H shape 239x239x155),
              freq_chain, tail_resize, tower_block (at the three shapes
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
  4. serve    ``runtime/inference.py::run_inference`` on 3 synthetic NIfTI
              cases through ``configs/config_inference_hnoseg_xs.ini``; the
              launch counts (reset just before) must be 3 / 24 / 3;
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
  7. serve    run_inference serves the same cases through
              ``configs/config_vnet-ds.ini``; launches (reset just before)
              must be conv_in 3, conv3 87, tail_resize 3;
  8. model    the V-Net-DS kernel path against its plain path and float64,
              on a served volume and on a small volume against the CPU; a
              control with conv3's operands in TF32 must fail the bars;
  9. serve    run_inference serves the same cases through
              ``configs/config_hartleymha.ini``; launches (reset just before)
              must be conv_in 3, tower_block 48, tail_resize 3;
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
              tail_resize 3;
 12. model    for each of the two, the kernel paths on tower_block (the
              default), tower_block_s and tower_resident against the plain
              path and float64 on a served volume, and the first on a
              small volume against the CPU; a control with each tower
              kernel's operands in TF32 must fail the bars; forward +
              argmax times of the three tower kernels.

Every failed check raises, so the exit code is not 0. The script refuses
to run without CUDA. The line before the last is a JSON object with the
kernels' numbers (``launches`` summed over the serving runs; times are
medians of CUDA-event runs, conv3's of back-to-back calls; ``bound_ms`` is
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
N_CASES = 3
N_TIMED = 25
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
]
# each main path's launches per volume
PER_VOLUME_HNOSEG = {"conv_in": 1, "freq_chain": 8, "tail_resize": 1,
                     "conv3": 0, "tower_block": 0, "tower_block_s": 0,
                     "tower_resident": 0}
PER_VOLUME_VNET = {"conv_in": 1, "freq_chain": 0, "tail_resize": 1,
                   "conv3": 29, "tower_block": 0, "tower_block_s": 0,
                   "tower_resident": 0}
PER_VOLUME_MHA = {"conv_in": 1, "freq_chain": 0, "tail_resize": 1,
                  "conv3": 0, "tower_block": 16, "tower_block_s": 0,
                  "tower_resident": 0}
PER_VOLUME_NOSEG = {"conv_in": 1, "freq_chain": 0, "tail_resize": 1,
                    "conv3": 0, "tower_block": 24, "tower_block_s": 0,
                    "tower_resident": 0}
PER_VOLUME_NOSEG_BLOCK_S = {"conv_in": 1, "freq_chain": 0, "tail_resize": 1,
                            "conv3": 0, "tower_block": 0,
                            "tower_block_s": 24, "tower_resident": 0}
PER_VOLUME_NOSEG_RESIDENT = {"conv_in": 1, "freq_chain": 0, "tail_resize": 1,
                             "conv3": 0, "tower_block": 0,
                             "tower_block_s": 0, "tower_resident": 1}


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


def stream_ms(torch, fn, runs=5, inner=20, warmup=3):
    """Median over ``runs`` of the mean time of ``inner`` back-to-back
    calls of ``fn`` (CUDA events around the run): the device time of calls
    issued as a forward pass issues them, without each call's host-side
    start in it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def bound(flops, nbytes):
    """(ms, 'bytes' or 'operations'): the least time on the card."""
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
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


def phase_kernels(torch, kernels, dev):
    """Each HNOSeg-XS kernel against its plain version at the serving
    shapes."""
    header("== kernels")
    import torch.nn.functional as F
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
    cases = {  # kernel, plain, tolerance, bound, library call
        "conv_in": (lambda: kernels.conv_in_s2d(x, w, b),
                    lambda: kernels.conv_in_plain(x, w, b), 1e-5,
                    bound(2 * out_cl * 8 * 4 * 24,
                          nbytes(x, w, b) + out_cl * 24 * 4),
                    lambda: F.conv3d(x, w, b, stride=2, padding=1)),
        "conv_in_odd": (lambda: kernels.conv_in_s2d(x_odd, w, b),
                        lambda: kernels.conv_in_plain(x_odd, w, b), 1e-5,
                        bound(2 * out_odd * 8 * 4 * 24,
                              nbytes(x_odd, w, b) + out_odd * 24 * 4),
                        lambda: F.conv3d(x_odd, w, b, stride=2, padding=1)),
        "freq_chain": (lambda: kernels.fused_freq_chain(spec, ws),
                       lambda: kernels.freq_chain_plain(spec, ws), 1e-5,
                       bound(3 * 2 * rows * 24 * 24,
                             2 * nbytes(spec) + nbytes(*ws)), None),
        "tail_resize": (lambda: kernels.fused_tail_softmax(logits, SHAPE),
                        lambda: kernels.tail_plain(logits, SHAPE), 1e-6,
                        # 7 lerps and the softmax's exp, sum and divide
                        bound(17 * 4 * int(np.prod(SHAPE)),
                              nbytes(logits) + 4 * 4 * int(np.prod(SHAPE))),
                        None),
    }
    results = {}
    with torch.inference_mode():
        for name, (kern, plain, tol, (b_ms, b_by), lib) in cases.items():
            launched = name.removesuffix("_odd")
            before = kernels.LAUNCHES[launched]
            got = kern()
            torch.cuda.synchronize()
            check(kernels.LAUNCHES[launched] == before + 1,
                  f"{name}: launch count did not move")
            want = plain()
            check(got.shape == want.shape,
                  f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
            err = float((got - want).abs().max())
            check(np.isfinite(err) and err <= tol,
                  f"{name}: max abs err {err} > {tol}")
            ms = median_ms(torch, kern)
            plain_ms = median_ms(torch, plain)
            lib_ms = median_ms(torch, lib) if lib is not None else None
            results[name] = {"max_abs_err": err, "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": b_ms,
                             "bound_by": b_by, "library_ms": lib_ms}
            print(f"{name}: out {tuple(got.shape)} max_abs_err {err:.3e} "
                  f"(tol {tol:g})  kernel {ms:.4f} ms  plain {plain_ms:.4f} "
                  f"ms  library {lib_ms if lib_ms is None else round(lib_ms, 4)}"
                  f" ms  bound {b_ms:.4f} ms ({b_by}) (medians of "
                  f"{N_TIMED}, CUDA events)")
            if name == "tail_resize":
                moved = nbytes(logits, got)
                rate = moved / (ms * 1e-3)
                print(f"tail_resize: {rate / 1e9:.1f} GB/s of "
                      f"{moved / 1e6:.1f} MB (logits in, probabilities "
                      f"out), {rate / HBM_BYTES_PER_S:.1%} of 3.35 TB/s")
    return results


def tower_block_work(spec):
    """(flops, bytes) of one tower_block call: x, z and ds_prev read once,
    out, f and ds written once (weights and stage matrices are KB)."""
    d, h, w = spec.sizes
    c, kh, kw, nds = spec.channels, spec.kh, spec.kw, spec.n_ds
    macs = d * (4 * c * kh * kw * w            # inverse W stage
                + h * w * c * 2 * kh           # inverse H stage
                + h * w * c * (2 * c + nds)    # p, q and ds
                + h * w * c * c                # W_cc_t
                + c * w * 2 * kh * h           # forward H stage
                + 4 * c * kh * kw * w)         # forward W stage
    moved = 4 * 2 * (d * h * w * c + d * 2 * c * kh * kw + d * h * w * nds)
    return 2 * macs, moved


def tower_block_s_work(spec, ks):
    """(flops, bytes) of one tower_block_s call: tower_block's operations
    plus the two depth stages (2 KS C KH KW MACs per plane each way); x,
    sy and ds_prev read once, out, s_f and ds written once (no z or f)."""
    d, h, w = spec.sizes
    c, kh, kw, nds = spec.channels, spec.kh, spec.kw, spec.n_ds
    flops = tower_block_work(spec)[0] + 2 * d * 4 * ks * c * kh * kw
    moved = 4 * 2 * (d * h * w * c + ks * c * kh * kw + d * h * w * nds)
    return flops, moved


def tower_resident_work(spec, ks, nb):
    """(flops, bytes) of one tower_resident call of nb blocks: nb
    tower_block_s blocks and nb operator mixes of the packed spectrum (block
    0's entry spectrum, built before the launch, does the forward work that
    the last block skips); x read and out written once, and the weights."""
    c, kh, kw = spec.channels, spec.kh, spec.kw
    pr = 1 if spec.transform == "Hartley" else 2
    mix_macs = pr * ks * c * c * kh * kw
    flops = nb * (tower_block_s_work(spec, ks)[0] + 2 * mix_macs)
    moved = 4 * (2 * int(np.prod(spec.sizes)) * c
                 + nb * (pr * c * c + 3 * c * c + 2 * c))
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
        BLOCK_SHAPES, build_report
    build_report()
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
    print(f"serving {label}: {N_CASES} predictions of {SHAPE}; average "
          f"prediction time {stats['avg_time_s'] * 1e3:.3f} ms/volume (wall "
          f"clock with readback, mean of the {N_CASES - 1} volumes after the "
          f"first), device {stats['avg_device_ms']:.3f} ms (CUDA events); "
          f"peak allocated {stats['peak_mib']:.1f} MiB, peak reserved "
          f"{stats['peak_reserved_mib']:.1f} MiB")
    return launches


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


def record_conv3_calls(torch, model, x):
    """Every conv3 call of one kernel-path forward, with its real inputs."""
    from multimodal_3d_image_segmentation_tpu_torch.models import \
        architectures
    calls, real = [], architectures.conv3

    def recording(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    architectures.conv3 = recording
    try:
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
            mode = (1 if kw.get("stride", 1) == 2 else
                    2 if kw.get("dilation", 1) == 2 else 0)
            plan = dict(zip(conv3_mod.PLAN_FIELDS, conv3_mod.conv3_plan(
                tuple(args[0].shape[1:4]), args[1].shape[1],
                args[1].shape[0], mode)))
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
            ms, plain_ms = stream_ms(torch, kern), stream_ms(torch, plain)
            lib_ms = stream_ms(torch, lib)
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
    results["tower_block"] = phase_tower_block(torch, kernels, dev)
    results["tower_block_s"] = phase_tower_block_s(torch, kernels, dev)
    results["tower_resident"] = phase_tower_resident(torch, kernels, dev)
    (REPO / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="smoke_", dir=REPO / "build"))
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

        vnet = VNetDS(**VNET, generator=torch.Generator().manual_seed(SEED))
        fast = VNetDS(**VNET, use_kernels=True, device=dev)
        fast.load_state_dict(vnet.state_dict())
        calls = record_conv3_calls(torch, fast,
                                   served_volume(torch, case0, dev))
        check(len(calls) == PER_VOLUME_VNET["conv3"],
              f"{len(calls)} conv3 calls per forward")
        results["conv3"] = phase_conv3(torch, kernels, calls)
        del calls, fast
        torch.cuda.empty_cache()
        launches_v = phase_serve(
            torch, kernels, work, list_paths, "V-Net-DS",
            "config_vnet-ds.ini", vnet, 22547764, PER_VOLUME_VNET)
        for k, v in launches_v.items():
            launches[k] += v
        phase_model_vnet(torch, vnet.state_dict(), case0, dev)
        del vnet
        torch.cuda.empty_cache()

        mha = HartleyMHASeg(**MHA,
                            generator=torch.Generator().manual_seed(SEED))
        launches_m = phase_serve(
            torch, kernels, work, list_paths, "HartleyMHASeg",
            "config_hartleymha.ini", mha, 178532, PER_VOLUME_MHA)
        for k, v in launches_m.items():
            launches[k] += v
        phase_model_mha(torch, mha.state_dict(), case0, dev)
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
            phase_model_noseg(torch, noseg.state_dict(), transform, case0,
                              dev)
            del noseg
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    check("jax" not in sys.modules, "jax was imported")
    # the redesigned conv3 must beat cuDNN over one V-Net-DS forward
    check(results["conv3"]["ms"] < results["conv3"]["library_ms"],
          f"conv3 {results['conv3']['ms']:.4f} ms is not below F.conv3d's "
          f"{results['conv3']['library_ms']:.4f} ms")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **results[name]}
        for name, src, rep in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
