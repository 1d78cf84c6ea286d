"""Time the tower kernels and the output tail at the serving shapes on a
GPU, and compare two checkouts' outputs bit for bit.

Usage, from the root of a checkout, on a machine with a CUDA card::

    python -m multimodal_3d_image_segmentation_tpu_torch.utils.tower_sweep \\
        [--save DIR] [--compare DIR]

On seeded random inputs at the 121x121x78 tower grid with C 24, it times
(CUDA events around one call, after 3 warm-up calls, the median of 25):

- ``fused_tower_block`` at the three shapes that serve it: HartleyMHASeg's
  (Hartley, modes (8,12,12), 4 deep-supervision rows), HNOSeg's (Hartley,
  modes (10,14,14)) and FNOSeg's (Fourier, modes (10,14,14), KW 14);
- ``fused_tower_block_s`` at the same three shapes;
- ``resident_tower`` (24 blocks) at HNOSeg's and FNOSeg's shapes, with the
  phase clock's mean per call where the checkout has one;
- ``fused_tail_softmax`` at the serving shape, (1, 4, 121, 121, 78) logits
  to 240 x 240 x 155 probabilities, with its rate against 3.35 TB/s.

``--save DIR`` writes every output there (``torch.save``); ``--compare
DIR`` loads another run's outputs and prints, for each, whether the two
are bit-identical and their largest difference. The same file copied into
another checkout of the port (for example the parent commit's, unpacked
with ``git archive``) times that checkout's kernels on the same inputs, so
that two kernel versions are compared in one call on one card. Prints the
card's name and power limit first, then each tower kernel instance's
registers and spills from the build log. ``chip_smoke.py`` holds each
kernel to its plain version; this script does not.
"""
from __future__ import annotations

import argparse
import subprocess
from pathlib import Path

import numpy as np
import torch

from .. import kernels
from ..kernels import tower_block as tb
from ..kernels import tower_resident as tr
from .profiling import step_ms

GRID = (121, 121, 78)
N_TIMED, N_WARMUP = 25, 3
N_BLOCKS = 24
TAIL_IN, TAIL_OUT = (1, 4) + GRID, (240, 240, 155)
HBM_BYTES_PER_S = 3.35e12
# the shapes that serve tower_block (chip_smoke.py times the same):
# (label, transform, modes, deep-supervision rows)
BLOCK_SHAPES = [("HartleyMHASeg", "Hartley", (8, 12, 12), 4),
                ("HNOSeg", "Hartley", (10, 14, 14), 0),
                ("FNOSeg", "Fourier", (10, 14, 14), 0)]


def median_ms(fn):
    """Median of N_TIMED CUDA-event timings of ``fn`` after N_WARMUP
    calls."""
    return float(np.median(step_ms(lambda _: fn(), None, N_TIMED,
                                   N_WARMUP)))


def build_report():
    """Print the registers, spills and stack of each tower kernel instance
    (tower_block, tower_block_s, tower_resident) from the ``-Xptxas -v``
    log of the kernel library, where this process built it."""
    log = kernels.library().build_log.splitlines()
    if not log:
        print("tower build: the library was reused, no ptxas log")
    for i, line in enumerate(log):
        if "Compiling entry function" not in line:
            continue
        name = line.split("'")[1] if "'" in line else line
        kind = next((k for k in ("tower_resident_kernel",
                                 "tower_block_s_kernel",
                                 "tower_block_kernel") if k in name), None)
        if kind is None:
            continue
        c = "24" if "ILi24E" in name else "8" if "ILi8E" in name else "?"
        props = [ln.split(":", 1)[-1].strip() for ln in log[i + 1:i + 4]
                 if "spill" in ln or "Used" in ln]
        print(f"tower build: {kind.removesuffix('_kernel')} C {c}: "
              f"{'; '.join(props)}")


def _t(rng, shape, dev, scale=1.0):
    a = rng.standard_normal(shape) * scale
    return torch.from_numpy(a.astype(np.float32)).to(dev)


def block_operands(transform, modes, n_ds, seed, dev):
    """x, the packed spectrum s, z = its depth-inverse pre-images, the
    weights and ds_prev of one block at the serving grid."""
    spec = tb.make_tower_spec(transform, GRID, modes, 24, n_ds=n_ds)
    rng = np.random.default_rng(seed)
    c = spec.channels
    x = _t(rng, GRID + (c,), dev)
    ops = [_t(rng, (c, c), dev, 1 / np.sqrt(c))
           for _ in range(1 if transform == "Hartley" else 2)]
    s = tb.spectrum_mix(tb.d_stage_forward(tb.entry_forward_hw(x, spec),
                                           spec), ops, spec).contiguous()
    z = tb.d_stage_inverse(s, spec).contiguous()
    w_cat = _t(rng, (2 * c + n_ds, c), dev, 1 / np.sqrt(c))
    w_cc_t = _t(rng, (c, c), dev, 1 / np.sqrt(c))
    b_cat = _t(rng, (2 * c,), dev, 0.1)
    ds_prev = _t(rng, GRID + (n_ds,), dev) if n_ds else None
    return spec, x, s, z, w_cat, w_cc_t, b_cat, ds_prev


def resident_operands(transform, seed, dev):
    """x and the stacked weights of a 24-block tower (operator weights
    scaled as the SNN init, 1 / sqrt(C))."""
    spec = tb.make_tower_spec(transform, GRID, (10, 14, 14), 24)
    rng = np.random.default_rng(seed)
    c, pr = spec.channels, 1 if transform == "Hartley" else 2
    return spec, (_t(rng, GRID + (c,), dev),
                  _t(rng, (N_BLOCKS, pr, c, c), dev, 1 / np.sqrt(c)),
                  _t(rng, (N_BLOCKS, 2 * c, c), dev, 1 / np.sqrt(c)),
                  _t(rng, (N_BLOCKS, c, c), dev, 1 / np.sqrt(c)),
                  _t(rng, (N_BLOCKS, 2 * c), dev, 0.1))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--save", type=Path, help="write the outputs here")
    ap.add_argument("--compare", type=Path,
                    help="compare with the outputs saved there")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tower_sweep needs a CUDA device")
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(smi[0] if smi else torch.cuda.get_device_name(0))
    build_report()  # builds (or reuses) the library before any timing
    outputs = {}
    with torch.inference_mode():
        for i, (label, transform, modes, n_ds) in enumerate(BLOCK_SHAPES):
            spec, x, s, z, w_cat, w_cc_t, b_cat, ds_prev = block_operands(
                transform, modes, n_ds, 100 + i, dev)
            call = (x, z, w_cat, w_cc_t, b_cat, spec, ds_prev)
            got = kernels.fused_tower_block(*call)
            for name, t in zip(("out", "f", "ds"), got):
                outputs[f"tower_block {label} {name}"] = t
            ms = median_ms(lambda: kernels.fused_tower_block(*call))
            print(f"tower_block {label}: {ms:.4f} ms", flush=True)
            call_s = (x, s, w_cat, w_cc_t, b_cat, spec, ds_prev)
            got = kernels.fused_tower_block_s(*call_s)
            for name, t in zip(("out", "s_f", "ds"), got):
                outputs[f"tower_block_s {label} {name}"] = t
            ms = median_ms(lambda: kernels.fused_tower_block_s(*call_s))
            print(f"tower_block_s {label}: {ms:.4f} ms", flush=True)
            del x, s, z, call, call_s, got
        for i, (label, transform) in enumerate((("HNOSeg", "Hartley"),
                                                ("FNOSeg", "Fourier"))):
            spec, ops = resident_operands(transform, 200 + i, dev)
            outputs[f"tower_resident {label} out"] = kernels.resident_tower(
                *ops, spec)
            tr.phase_ms(reset=True)
            ms = median_ms(lambda: kernels.resident_tower(*ops, spec))
            phases = {k: v / (N_TIMED + N_WARMUP)
                      for k, v in tr.phase_ms(reset=True).items()}
            print(f"tower_resident {label}: {ms:.4f} ms; phases per call "
                  f"(ms): " + ", ".join(f"{k} {v:.4f}"
                                        for k, v in phases.items()),
                  flush=True)
        logits = _t(np.random.default_rng(300), TAIL_IN, dev, 3.0)
        outputs["tail_resize out"] = kernels.fused_tail_softmax(logits,
                                                                TAIL_OUT)
        ms = median_ms(lambda: kernels.fused_tail_softmax(logits, TAIL_OUT))
        moved = 4 * (logits.numel() + TAIL_IN[1] * int(np.prod(TAIL_OUT)))
        rate = moved / (ms * 1e-3)
        print(f"tail_resize {TAIL_IN} -> {TAIL_OUT}: {ms:.4f} ms, "
              f"{rate / 1e9:.1f} GB/s of {moved / 1e6:.1f} MB, "
              f"{rate / HBM_BYTES_PER_S:.1%} of 3.35 TB/s", flush=True)
    if args.save:
        args.save.mkdir(parents=True, exist_ok=True)
        torch.save({k: v.cpu() for k, v in outputs.items()},
                   args.save / "tower_outputs.pt")
    if args.compare:
        other = torch.load(args.compare / "tower_outputs.pt")
        for k, v in outputs.items():
            if k not in other:
                print(f"{k}: not in {args.compare}")
                continue
            v, w = v.cpu(), other[k]
            # bits, so that a NaN equals itself
            same = bool(torch.equal(v.view(torch.int32), w.view(torch.int32)))
            print(f"{k}: bit-identical {same}, max abs diff "
                  f"{float((v - w).abs().max()):.3e}")


if __name__ == "__main__":
    main()
