"""Sweep conv3's launch plans at the 29 calls of one V-Net-DS forward on
a GPU.

Usage, from the root of a checkout, on a machine with a CUDA card::

    python -m multimodal_3d_image_segmentation_tpu_torch.utils.conv3_sweep \\
        [--search] [--json conv3_sweep.json]

Builds V-Net-DS (base 24, blocks [1,2,3,3,3], right leg [0..4]) with
seeded random weights, records every conv3 call of one kernel-path forward
of a seeded random 4x240x240x155 volume with its real inputs, and for each
call holds the planner's plan to ``conv3_plain`` (1e-4 of the output's
largest magnitude) and times it: CUDA events around 20 back-to-back calls,
after 3 warm-up calls, the median of 5 such runs. With ``--search`` it
also searches each distinct call's plan field by field (W run and runs
along W, brick depth and height, channel tile, chunk, split; two rounds),
holding every candidate to the plain version, and prints the best plan
beside the planner's. Prints the card's name and power limit first.

The same file copied into another checkout of the port (for example the
parent commit's, unpacked with ``git archive``) times that checkout's
conv3 at the same 29 calls; without a launch planner there, the rows have
no plan. ``chip_smoke.py`` times ``F.conv3d`` and the plain version beside
the kernel at the same calls.
"""
from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import kernels
from ..models import VNetDS, architectures

# the module (``kernels`` exports the function under the same name)
conv3_mod = importlib.import_module("..kernels.conv3", __package__)

VNET = dict(in_channels=4, out_channels=4, base_num_filters=24,
            num_blocks=[1, 2, 3, 3, 3], right_leg_indexes=[0, 1, 2, 3, 4])
SHAPE = (240, 240, 155)
N_INNER, N_RUNS = 20, 5


def record_calls(model, x):
    """Every conv3 call of one kernel-path forward, with its real inputs."""
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


def call_key(args, kw):
    """(sizes, ci, co, mode) of a recorded call."""
    x, w = args[0], args[1]
    mode = (1 if kw.get("stride", 1) == 2 else
            2 if kw.get("dilation", 1) == 2 else 0)
    return tuple(x.shape[1:4]), w.shape[1], w.shape[0], mode


def describe(args, kw):
    (sizes, ci, co, mode) = call_key(args, kw)
    opts = [k for k in ("x2", "prologue", "residual") if kw.get(k) is not None]
    opts += [("", "stride2", "dilation2")[mode]] if mode else []
    return f"{sizes} ci {ci} co {co} {'+'.join(opts) or 'bare'}"


def with_choice(choice, fn):
    """Run ``fn`` with conv3's plan fields forced to ``choice``."""
    real = conv3_mod.conv3_plan

    def forced(sizes, ci, co, mode, _=None):
        return real(sizes, ci, co, mode, choice)

    conv3_mod.conv3_plan = forced
    try:
        return fn()
    finally:
        conv3_mod.conv3_plan = real


def gpu_ms(fn):
    """Median over N_RUNS of the mean time of N_INNER back-to-back calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(N_RUNS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(N_INNER):
            fn()
        b.record()
        b.synchronize()
        runs.append(a.elapsed_time(b) / N_INNER)
    return float(np.median(runs))


def held(args, kw, choice=None):
    """The kernel's outputs against the plain version's; raises beyond
    1e-4 of the largest magnitude."""
    def kern():
        return kernels.conv3(*args, **kw)
    got = kern() if choice is None else with_choice(choice, kern)
    want = kernels.conv3_plain(*args, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    n_out = 2 if kw.get("residual") is not None else 1
    for g, wt in zip(got[:n_out], want[:n_out]):
        err = float((g - wt).abs().max())
        tol = 1e-4 * max(1.0, float(wt.abs().max()))
        if not (np.isfinite(err) and err <= tol):
            raise RuntimeError(f"conv3 plan {choice}: err {err} > {tol}")


def timed(args, kw, choice=None):
    def kern():
        return kernels.conv3(*args, **kw)
    if choice is None:
        return gpu_ms(kern)
    return with_choice(choice, lambda: gpu_ms(kern))


def plan_fields(args, kw, choice=None):
    if not hasattr(conv3_mod, "conv3_plan"):  # a checkout without a planner
        return {}
    sizes, ci, co, mode = call_key(args, kw)
    plan = conv3_mod.conv3_plan(sizes, ci, co, mode, choice)
    return dict(zip(conv3_mod.PLAN_FIELDS, plan))


def candidates(field, best, ci, co):
    """Alternatives for one group of fields around ``best`` (a list of the
    seven chosen fields)."""
    rw, bd, bh, nrw, cot, ck, split = best
    if field == "run":
        return [[r, bd, bh, n, cot, ck, split] for r in (8, 5)
                for n in (1, 2, 4)]
    if field == "brick":
        return [[rw, d, h, nrw, cot, ck, split] for d in (1, 2, 4, 8)
                for h in (1, 2, 4, 8)]
    if field == "tile":
        tiles = {t for t in (24, 32, 48, 64, 96, 128)
                 if t <= -(-co // 8) * 8 and (co % t == 0 or t >= co)}
        return [[rw, bd, bh, nrw, t, ck, split] for t in sorted(tiles)]
    if field == "chunk":
        return [[rw, bd, bh, nrw, cot, c, split] for c in (4, 8, 16, 24, 32)]
    nchunk = -(-ci // ck)
    splits = sorted({s for s in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48)
                     if s <= nchunk} | {split})
    return [[rw, bd, bh, nrw, cot, ck, s] for s in splits]


def search(args, kw):
    """Field-by-field search from the planner's plan; returns (best
    choice, its ms, trials)."""
    p = plan_fields(args, kw)
    best = [p[k] for k in conv3_mod.PLAN_FIELDS[:7]]
    best_ms = timed(args, kw, best)
    _, ci, co, _ = call_key(args, kw)
    trials = 0
    for _ in range(2):
        for field in ("run", "brick", "tile", "chunk", "split"):
            for cand in candidates(field, best, ci, co):
                if cand == best:
                    continue
                try:
                    plan_fields(args, kw, cand)
                except ValueError:  # no plan (threads, memory, split)
                    continue
                held(args, kw, cand)
                ms = timed(args, kw, cand)
                trials += 1
                if ms < best_ms:
                    best, best_ms = cand, ms
    return best, best_ms, trials


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--search", action="store_true",
                    help="search each distinct call's plan")
    ap.add_argument("--json", default=None, help="write the rows here")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("conv3_sweep: needs a CUDA device")
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(smi[0] if smi else torch.cuda.get_device_name(0), flush=True)
    model = VNetDS(**VNET, use_kernels=True,
                   generator=torch.Generator().manual_seed(0)).to(dev)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 4) + SHAPE, dtype=np.float32)).to(dev)
    calls = record_calls(model, x)
    rows, searched = [], {}
    t0 = time.perf_counter()
    with torch.inference_mode():
        for i, (args, kw) in enumerate(calls):
            held(args, kw)
            ms = timed(args, kw)
            p = plan_fields(args, kw)
            row = {"call": i, "what": describe(args, kw), "ms": ms}
            if p:
                row.update(plan=[p[k] for k in conv3_mod.PLAN_FIELDS[:7]],
                           threads=p["threads"], smem=p["smem"],
                           blocks=p["blocks"], conflict=p["conflict"])
            if opts.search:
                key = describe(args, kw)
                if key not in searched:
                    searched[key] = search(args, kw)
                best, best_ms, trials = searched[key]
                row.update(best=best, best_ms=best_ms, trials=trials)
            rows.append(row)
            print(json.dumps(row), flush=True)
    total = sum(r["ms"] for r in rows)
    line = f"conv3, {len(rows)} calls: planner {total:.4f} ms"
    if opts.search:
        line += f", best found {sum(r['best_ms'] for r in rows):.4f} ms"
    print(f"{line} ({time.perf_counter() - t0:.0f} s)")
    if opts.json:
        Path(opts.json).parent.mkdir(parents=True, exist_ok=True)
        Path(opts.json).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
