"""Sweep conv3's launch plans at the 29 calls of one V-Net-DS forward on
a GPU.

Usage, from the root of a checkout, on a machine with a CUDA card::

    python -m multimodal_3d_image_segmentation_tpu_torch.utils.conv3_sweep \\
        [--instance float32|bfloat16|mixed] [--search] [--library] \\
        [--json conv3_sweep.json] [--save DIR] [--compare DIR]

Builds V-Net-DS (base 24, blocks [1,2,3,3,3], right leg [0..4]) with
seeded random weights in ``--instance``'s compute dtype (default
'float32': the FMA body, ``csrc/conv3.cu``; 'bfloat16' and 'mixed': the
tensor-core body, ``csrc/conv3_mma.cu``), records every conv3 call of one
kernel-path forward of a seeded random 4x240x240x155 volume with its real
inputs, and for each call holds the planner's plan to ``conv3_plain``
(fp32: 1e-4 of the output's largest magnitude; bf16: one bf16 ulp plus
1e-5, at most 1e-3 of the elements more than one ulp apart) and times it:
CUDA events around 20 back-to-back calls, after 3 warm-up calls, the
median of 5 such runs. With ``--search`` it also searches each distinct
call's plan field by field (the FMA body: W run and runs along W, brick
depth and height, channel tile, chunk, split; the tensor-core body: M
tiles a warp, brick, warps along N, chunk and split (the K ranges over
blocks: one, two, one chunk a block and halfway); two rounds, the
tensor-core body's one), holding
every candidate to the plain version, and prints the best plan beside the
planner's. ``--library`` also times one PyTorch call of the same conv +
bias (``F.conv3d`` or ``F.conv_transpose3d``, cuDNN, in the instance's
weight dtype: bf16 in 'bfloat16' and 'mixed') the same way, and both as
``torch.profiler`` device time a call (the kernels of 10 back-to-back
calls), so that a call's host time shows beside its device time. ``--save
DIR`` writes every call's outputs there
(``torch.save``); ``--compare DIR`` loads another run's and checks them bit
for bit. Prints the card's name and power limit first.

The same file copied into another checkout of the port (for example the
parent commit's, unpacked with ``git archive``) times that checkout's
conv3 at the same 29 calls; without a launch planner there, the rows have
no plan. Its ``--save`` and this checkout's ``--compare`` show whether the
two checkouts' kernels give the same bits. ``chip_smoke.py`` times ``F.conv3d`` and the plain version beside
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


# instance -> the plan function and fields of the body it runs
PLAN_API = {"float32": ("conv3_plan", "PLAN_FIELDS"),
            "bfloat16": ("conv3_mma_plan", "MMA_PLAN_FIELDS"),
            "mixed": ("conv3_mma_plan", "MMA_PLAN_FIELDS")}


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


def _instance(args):
    """The instance a recorded call runs (its volume's and weight's
    dtypes)."""
    if args[0].dtype == torch.float32:
        return "float32"
    return "bfloat16" if args[1].dtype == torch.bfloat16 else "mixed"


def with_choice(choice, fn, instance="float32"):
    """Run ``fn`` with the plan fields of ``instance``'s body forced to
    ``choice``."""
    name = PLAN_API[instance][0]
    real = getattr(conv3_mod, name)

    def forced(sizes, ci, co, mode, _=None, **kw):
        return real(sizes, ci, co, mode, choice, **kw)

    setattr(conv3_mod, name, forced)
    try:
        return fn()
    finally:
        setattr(conv3_mod, name, real)


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


def _within(got, want):
    """Whether one output meets its instance's bar (module docstring)."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    if got.dtype != torch.bfloat16:
        return np.isfinite(float(d.max())) and float(d.max()) <= 1e-4 * max(
            1.0, float(w.abs().max()))
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    share = float((d > torch.exp2(torch.floor(torch.log2(mag)) - 7))
                  .float().mean())
    return bool((d <= 2.0 ** -7 * w.abs() + 1e-5).all()) and share <= 1e-3


def held(args, kw, choice=None):
    """The kernel's outputs against the plain version's; raises beyond the
    instance's bar. Returns the kernel's outputs."""
    def kern():
        return kernels.conv3(*args, **kw)
    got = kern() if choice is None else with_choice(choice, kern,
                                                    _instance(args))
    want = kernels.conv3_plain(*args, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    n_out = 2 if kw.get("residual") is not None else 1
    for g, wt in zip(got[:n_out], want[:n_out]):
        if not _within(g, wt):
            err = float((g.float() - wt.float()).abs().max())
            raise RuntimeError(f"conv3 plan {choice}: err {err} beyond the "
                               "bar")
    return got


def timed(args, kw, choice=None):
    def kern():
        return kernels.conv3(*args, **kw)
    if choice is None:
        return gpu_ms(kern)
    return with_choice(choice, lambda: gpu_ms(kern), _instance(args))


def plan_fields(args, kw, choice=None):
    name, fields = PLAN_API[_instance(args)]
    if not hasattr(conv3_mod, name):  # a checkout without that planner
        return {}
    sizes, ci, co, mode = call_key(args, kw)
    extra = {}
    if name == "conv3_mma_plan":  # its blocks follow the weight's passes
        extra["passes"] = 1 if args[1].dtype == torch.bfloat16 else 2
        extra["residual"] = kw.get("residual") is not None
    plan = getattr(conv3_mod, name)(sizes, ci, co, mode, choice, **extra)
    return dict(zip(getattr(conv3_mod, fields), plan))


FIELDS = {"float32": ("run", "brick", "tile", "chunk", "split"),
          "mma": ("chunk", "tm", "brick", "tile")}


def library_call(args, kw):
    """One PyTorch call of the same conv + bias on the call's operands."""
    import torch.nn.functional as F
    xin = args[0] if kw.get("x2") is None else torch.cat([args[0], kw["x2"]],
                                                         -1)
    xcf = xin.permute(0, 4, 1, 2, 3)
    w, b = args[1].to(xin.dtype), args[2].to(xin.dtype)
    if kw.get("dilation", 1) == 2:
        wt = w.flip(2, 3, 4).transpose(0, 1).contiguous()
        return lambda: F.conv_transpose3d(xcf, wt, b, stride=2, padding=1,
                                          output_padding=1)
    return lambda: F.conv3d(xcf, w, b, stride=kw.get("stride", 1), padding=1)


def device_ms(fn, calls=10):
    """``torch.profiler``'s device time a call of ``fn``: every kernel of
    ``calls`` back-to-back calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total
               for e in prof.key_averages()) / calls / 1e3


def candidates(field, best, ci, co):
    """Alternatives for one group of the FMA body's fields around ``best``
    (a list of the seven chosen fields)."""
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


def mma_candidates(field, best, ci, co):
    """The same for the tensor-core body's fields."""
    tm, bd, bh, bw, wn, ck, split = best
    if field == "tm":
        return [[t, bd, bh, bw, wn, ck, split] for t in (2, 4)]
    if field == "brick":
        return [[tm, d, h, w, wn, ck, split] for d in (1, 2, 4, 8)
                for h in (1, 2, 4, 8, 16) for w in (8, 16)]
    if field == "tile":
        return [[tm, bd, bh, bw, n, ck, split]
                for n in range(1, min(4, -(-co // 24)) + 1)]
    # each chunk with the K ranges it allows: one block's (1), one chunk a
    # block's, and the halves and quarters between
    ci8 = -(-ci // 8) * 8
    out = []
    for c in sorted({16, 32, 48, 64, 96, ci8}):
        n = -(-ci // c)
        if c <= 96:
            out += [[tm, bd, bh, bw, wn, c, s]
                    for s in sorted({1, 2, -(-n // 2), n}) if s <= n]
    return out


def search(args, kw):
    """Field-by-field search from the planner's plan; returns (best
    choice, its ms, trials)."""
    p = plan_fields(args, kw)
    best = [p[k] for k in list(p)[:7]]
    best_ms = timed(args, kw, best)
    _, ci, co, _ = call_key(args, kw)
    fma = _instance(args) == "float32"
    trials = 0
    for _ in range(2 if fma else 1):
        for field in FIELDS["float32" if fma else "mma"]:
            for cand in (candidates if fma else mma_candidates)(
                    field, best, ci, co):
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
    ap.add_argument("--instance", default="float32", choices=PLAN_API,
                    help="the compute dtype of the forward whose calls run")
    ap.add_argument("--library", action="store_true",
                    help="time cuDNN's conv + bias beside, and device times")
    ap.add_argument("--search", action="store_true",
                    help="search each distinct call's plan")
    ap.add_argument("--json", default=None, help="write the rows here")
    ap.add_argument("--save", type=Path, help="write the outputs here")
    ap.add_argument("--compare", type=Path,
                    help="compare with the outputs saved there")
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
    if opts.instance != "float32":  # the same weights, another forward
        state = model.state_dict()
        model = VNetDS(**VNET, use_kernels=True,
                       compute_dtype=opts.instance, device=dev)
        model.load_state_dict(state)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 4) + SHAPE, dtype=np.float32)).to(dev)
    calls = record_calls(model, x)
    rows, searched, outputs = [], {}, {}
    t0 = time.perf_counter()
    with torch.inference_mode():
        for i, (args, kw) in enumerate(calls):
            for j, t in enumerate(held(args, kw)):
                outputs[f"call{i}_{j}"] = t.cpu()
            ms = timed(args, kw)
            p = plan_fields(args, kw)
            row = {"call": i, "what": describe(args, kw), "ms": ms}
            if opts.library:
                lib = library_call(args, kw)
                row.update(device_ms=device_ms(lambda: kernels.conv3(*args,
                                                                      **kw)),
                           library_ms=gpu_ms(lib),
                           library_device_ms=device_ms(lib))
            if p:
                row.update(plan=[p[k] for k in list(p)[:7]],
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
    line = (f"conv3 ({opts.instance}), {len(rows)} calls: planner "
            f"{total:.4f} ms")
    if opts.library:
        line += (", device {:.4f} ms; cuDNN {:.4f} ms, device {:.4f} ms"
                 .format(*(sum(r[k] for r in rows) for k in (
                     "device_ms", "library_ms", "library_device_ms"))))
    if opts.search:
        line += f", best found {sum(r['best_ms'] for r in rows):.4f} ms"
    print(f"{line} ({time.perf_counter() - t0:.0f} s)")
    if opts.json:
        Path(opts.json).parent.mkdir(parents=True, exist_ok=True)
        Path(opts.json).write_text(json.dumps(rows, indent=1))
    if opts.save:
        opts.save.mkdir(parents=True, exist_ok=True)
        torch.save(outputs, opts.save / "conv3_outputs.pt")
    if opts.compare:
        other = torch.load(opts.compare / "conv3_outputs.pt")
        same = [k for k in outputs
                if k in other and torch.equal(outputs[k], other[k])]
        print(f"conv3 outputs against {opts.compare}: {len(same)} of "
              f"{len(outputs)} bit for bit the same")
        if len(same) != len(outputs) or set(other) != set(outputs):
            sys.exit("conv3_sweep: the outputs differ")


if __name__ == "__main__":
    main()
