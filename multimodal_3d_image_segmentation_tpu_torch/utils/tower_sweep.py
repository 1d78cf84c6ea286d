"""Time the tower kernels, the output tail, conv_in and freq_chain at the
serving shapes on a GPU, and compare two checkouts' outputs bit for bit.

Usage, from the root of a checkout, on a machine with a CUDA card::

    python -m multimodal_3d_image_segmentation_tpu_torch.utils.tower_sweep \\
        [--save DIR] [--compare DIR]

On seeded random inputs at the 121x121x78 tower grid with C 24, it times
(CUDA events around one call, after 3 warm-up calls, the median of 25):

- ``fused_tower_block`` at the three shapes that serve it: HartleyMHASeg's
  (Hartley, modes (8,12,12), 4 deep-supervision rows), HNOSeg's (Hartley,
  modes (10,14,14)) and FNOSeg's (Fourier, modes (10,14,14), KW 14);
- ``fused_tower_block_s`` at the same three shapes;
- both again in their 'bfloat16' and 'mixed' instances on the bf16
  volume (the weights made outside inference mode, as a model's are), also
  back to back and as ``torch.profiler`` device time (every device event
  of a call), with each kernel's tensor-core phase clock where the
  checkout has one;
- ``resident_tower`` (24 blocks) at HNOSeg's and FNOSeg's shapes, in all
  three instances, with the phase clock's mean per call (and in the bf16
  instances the last block's tensor-core phases) where the checkout has
  them;
- ``fused_tail_softmax`` at the serving shape, (1, 4, 121, 121, 78) logits
  to 240 x 240 x 155 probabilities: fp32 logits, and bf16 logits to fp32
  and to bf16 probabilities, with each one's rate against 3.35 TB/s;
- ``conv_in_s2d`` on a (1, 4, 240, 240, 155) volume with and without the
  SELU and on the odd (1, 4, 239, 239, 155); its bf16 instance on the bf16
  volume with 'bfloat16' weights (bf16 values) and 'mixed' ones (fp32,
  made outside inference mode, as a model's are) and on batch element 1
  of the odd bf16 volume; and ``fused_freq_chain`` on HNOSeg-XS's (1, 20,
  28, 28, 24) spectrum with 3 weights: the tail and these each also back
  to back (the mean of 20 calls between two events, the median of 5 such
  runs), as ``torch.profiler``'s device time per call (the kernel's own
  and all of the call's device work) and as host time per call (the
  host clock around 50 calls that are not waited for), with the phase
  clock of conv_in's bf16 instance and of the tail where the checkout's
  kernels have one (``phase_us``: mean us a band or tile per phase).

``--save DIR`` writes
every output there (``torch.save``); ``--compare DIR`` loads another run's
outputs and prints, for each, whether the two are bit-identical and their
largest difference. The same file copied into another checkout of the port
(for example the parent commit's, unpacked with ``git archive``) times
that checkout's kernels on the same inputs, so that two kernel versions
are compared in one call on one card. Prints the card's name and power
limit first, then each kernel instance's registers and spills from the
build log (tower kernels, with their bf16 and mixed instances, conv_in and
freq_chain). ``chip_smoke.py`` holds
each kernel to its plain version; this script does not.
"""
from __future__ import annotations

import argparse
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from .. import kernels
from ..kernels import conv_in as kci
from ..kernels import tail_resize as ktail
from ..kernels import tower_block as tb
from ..kernels import tower_block_s as tbs
from ..kernels import tower_resident as tr
from .profiling import step_ms

GRID = (121, 121, 78)
N_TIMED, N_WARMUP = 25, 3
N_BLOCKS = 24
TAIL_IN, TAIL_OUT = (1, 4) + GRID, (240, 240, 155)
HBM_BYTES_PER_S = 3.35e12
VOLUME, VOLUME_ODD = (1, 4, 240, 240, 155), (1, 4, 239, 239, 155)
SPECTRUM = (1, 20, 28, 28, 24)  # HNOSeg-XS: modes (10,14,14) packed
N_HOST = 50
# the bf16 instances: (name, the channel-mix weights' dtype, launch suffix)
BF16_MODES = (("bfloat16", torch.bfloat16, "_bf16"),
              ("mixed", torch.float32, "_mixed"))
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


TOWER_KINDS = ("tower_resident_kernel", "tower_block_s_kernel",
               "tower_block_kernel", "tower_block_mma_kernel",
               "tower_block_s_mma_kernel", "tower_resident_mma_kernel")
EDGE_KINDS = ("conv_in_kernel", "conv_in_mma_kernel", "freq_chain_kernel",
              "tail_kernel")


def build_report(kinds=TOWER_KINDS + EDGE_KINDS):
    """Print the registers, spills and stack of each instance of the
    kernels ``kinds`` (by default the tower kernels, conv_in and
    freq_chain; the width is C, conv_in's F) from the ``-Xptxas -v`` log of
    the kernel library, where this process built it."""
    log = kernels.library().build_log.splitlines()
    if not log:
        print("build: the library was reused, no ptxas log")
    for i, line in enumerate(log):
        if "Compiling entry function" not in line:
            continue
        name = line.split("'")[1] if "'" in line else line
        kind = next((k for k in kinds if k in name), None)
        if kind is None:
            continue
        c = "24" if "ILi24E" in name else "8" if "ILi8E" in name else "?"
        props = [ln.split(":", 1)[-1].strip() for ln in log[i + 1:i + 4]
                 if "spill" in ln or "Used" in ln]
        if kind == "tail_kernel":  # <C, logits' type, probabilities' type>
            print(f"build: {name.split('tail_kernel')[-1][:40]}: "
                  f"{'; '.join(props)}")
            continue
        # the tensor-core bodies' instances: <C, passes> (conv_in's <F, C,
        # parts>); the FMA body's:
        # <C> (fp32), or <C, volume type, weight type> in a checkout whose
        # FMA body still has bf16 instances
        if kind.endswith("_mma_kernel"):
            inst = " bf16" if "ELi1EE" in name else " mixed"
        else:
            inst = ("" if "__nv_bfloat16" not in name else
                    " mixed" if "__nv_bfloat16fE" in name else " bf16")
        print(f"build: {kind.removesuffix('_kernel')}{inst} width {c}: "
              f"{'; '.join(props)}")


def stream_ms(fn, runs=5, inner=20):
    """Median over ``runs`` of the mean time of ``inner`` back-to-back
    calls of ``fn`` (CUDA events around each run), after N_WARMUP calls:
    the device time of calls issued as a forward pass issues them, without
    each call's host-side start in it."""
    for _ in range(N_WARMUP):
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


def device_ms(fn, kernel, calls=20):
    """``torch.profiler``'s device time per call of ``fn``, in ms, over
    ``calls`` back-to-back calls: (the kernels whose name holds ``kernel``,
    every device event of the calls)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.time_range.end - e.time_range.start for e in dev)
    own = sum(e.time_range.end - e.time_range.start for e in dev
              if kernel in e.name)
    return own / 1e3 / calls, total / 1e3 / calls


def host_us(fn, calls=N_HOST):
    """Host time per call of ``fn`` in us: the host clock around ``calls``
    calls that are not waited for (the launch queue does not fill)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def edge_calls(dev):
    """(label, kernel name, call, phase clock or None) of conv_in (fp32
    and bf16 instances) and freq_chain on seeded inputs at the serving
    shapes."""
    rng = np.random.default_rng(400)
    x = _t(rng, VOLUME, dev)
    x_odd = _t(rng, VOLUME_ODD, dev)
    w = _t(rng, (24, 4, 2, 2, 2), dev, 1 / np.sqrt(32))
    b = _t(rng, (24,), dev, 0.1)
    spec = _t(rng, SPECTRUM, dev)
    ws = [_t(rng, (24, 24), dev, 1 / np.sqrt(24)) for _ in range(3)]
    xb = x.to(torch.bfloat16)
    # batch element 1 of two: 8 bytes past a 16-byte boundary
    xb_odd = torch.cat([x_odd, x_odd.flip(2)]).to(torch.bfloat16)[1:]
    # 'bfloat16''s weights are bf16 values (in fp32), 'mixed''s fp32
    wb, = kept_weights(torch.float32, w.to(torch.bfloat16).float())
    wm, = kept_weights(torch.float32, w)
    clock = getattr(kci, "phase_us", None)
    return [
        ("conv_in", "conv_in_kernel", lambda: kernels.conv_in_s2d(x, w, b),
         None),
        ("conv_in odd", "conv_in_kernel",
         lambda: kernels.conv_in_s2d(x_odd, w, b), None),
        ("conv_in no SELU", "conv_in_kernel",
         lambda: kernels.conv_in_s2d(x, w, b, apply_selu=False), None),
        ("conv_in_bf16", "conv_in",
         lambda: kernels.conv_in_s2d(xb, wb, b), clock),
        ("conv_in_mixed", "conv_in",
         lambda: kernels.conv_in_s2d(xb, wm, b), clock),
        ("conv_in_bf16 odd", "conv_in",
         lambda: kernels.conv_in_s2d(xb_odd, wb, b), clock),
        ("freq_chain", "freq_chain_kernel",
         lambda: kernels.fused_freq_chain(spec, ws), None),
    ]


def _clock_text(clock, call):
    """A persistent kernel's phase clock after one more ``call`` (``clock``:
    the module's ``phase_us``; "" where the checkout has none)."""
    if clock is None:
        return ""
    call()
    phases, span, resident, grid = clock()
    return ("; phase clock, us an item: " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases.items()) +
        f"; span {span:.1f} us, a block resident {resident:.1f} us, "
        f"grid {grid}")


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


def kept_weights(dtype, *ws):
    """``ws`` in ``dtype`` as normal tensors, made outside inference mode as
    a model's parameters are, so that a kernel keeps its packed forms of
    them from call to call."""
    with torch.inference_mode(False):
        return tuple(w.clone().to(dtype) for w in ws)


def _bf16_block_calls(label, spec, x, s, z, w_cat, w_cc_t, b_cat, ds_prev,
                      outputs):
    """tower_block and tower_block_s in both bf16 instances at one shape:
    each output saved, each timed a call, back to back and as device
    time, each kernel's tensor-core phase clock printed where the checkout
    has one."""
    xb = x.to(torch.bfloat16)
    for mode, wd, suffix in BF16_MODES:
        wc, wcc = kept_weights(wd, w_cat, w_cc_t)
        for name, fused, spectrum, outs in (
                ("tower_block", kernels.fused_tower_block, z,
                 ("out", "f", "ds")),
                ("tower_block_s", kernels.fused_tower_block_s, s,
                 ("out", "s_f", "ds"))):
            call = (xb, spectrum, wc, wcc, b_cat, spec, ds_prev)

            def run():
                return fused(*call)
            for oname, t in zip(outs, run()):
                outputs[f"{name}{suffix} {label} {oname}"] = t
            ms, s_ms = median_ms(run), stream_ms(run)
            _, dev_ms = device_ms(run, name)
            clock = ""
            mod = tb if name == "tower_block" else tbs
            if hasattr(mod, "mma_phase_us"):
                run()
                phases, span, _ = mod.mma_phase_us(spec)
                clock = "; phase clock, us a block: " + ", ".join(
                    f"{k} {v:.2f}" for k, v in phases.items()) + (
                    f"; span {span:.1f} us")
            print(f"{name}{suffix} {label}: {ms:.4f} ms a call, "
                  f"{s_ms:.4f} back to back, device {dev_ms:.4f}{clock}",
                  flush=True)


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
            _bf16_block_calls(label, spec, x, s, z, w_cat, w_cc_t, b_cat,
                              ds_prev, outputs)
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
            xb = ops[0].to(torch.bfloat16)
            for mode, wd, suffix in BF16_MODES:
                wb = (ops[1],) + kept_weights(wd, ops[2], ops[3]) + (ops[4],)
                outputs[f"tower_resident{suffix} {label} out"] = \
                    kernels.resident_tower(xb, *wb, spec)
                tr.phase_ms(reset=True)
                ms = median_ms(lambda: kernels.resident_tower(xb, *wb, spec))
                phases = {k: v / (N_TIMED + N_WARMUP)
                          for k, v in tr.phase_ms(reset=True).items()}
                clock = ""
                if hasattr(tr, "mma_phase_us"):
                    body, _, _ = tr.mma_phase_us(spec)
                    clock = "; the last block's body, us an item: " + (
                        ", ".join(f"{k} {v:.2f}" for k, v in body.items()))
                print(f"tower_resident{suffix} {label}: {ms:.4f} ms; phases "
                      f"per call (ms): " + ", ".join(
                          f"{k} {v:.4f}" for k, v in phases.items()) + clock,
                      flush=True)
        logits = _t(np.random.default_rng(300), TAIL_IN, dev, 3.0)
        lb = logits.to(torch.bfloat16)
        clock = getattr(ktail, "phase_us", None)
        for label, lg, out_dtype in (
                ("tail_resize", logits, None),
                ("tail_resize_bf16", lb, None),
                ("tail_resize_bf16 bf16", lb, torch.bfloat16)):
            def call(lg=lg, out_dtype=out_dtype):
                return kernels.fused_tail_softmax(lg, TAIL_OUT, out_dtype)
            got = outputs[f"{label} out"] = call()
            ms, s_ms = median_ms(call), stream_ms(call)
            own, _ = device_ms(call, "tail_kernel")
            moved = lg.numel() * lg.element_size() + got.numel() * \
                got.element_size()
            print(f"{label} {TAIL_IN} -> {TAIL_OUT}: {ms:.4f} ms a call, "
                  f"{s_ms:.4f} ms back to back, profiler device time "
                  f"{own:.4f} ms, {moved / (s_ms * 1e-3) / 1e9:.1f} GB/s "
                  f"of {moved / 1e6:.1f} MB back to back, "
                  f"{moved / (s_ms * 1e-3) / HBM_BYTES_PER_S:.1%} of 3.35 "
                  f"TB/s{_clock_text(clock, call)}", flush=True)
        for label, kernel, call, clock in edge_calls(dev):
            outputs[f"{label} out"] = call()
            ms, s_ms = median_ms(call), stream_ms(call)
            own, total = device_ms(call, kernel)
            print(f"{label}: {ms:.4f} ms a call, {s_ms:.4f} ms back to "
                  f"back, profiler device time {own:.4f} ms ({kernel}) of "
                  f"{total:.4f} ms (every device event of a call), host "
                  f"{host_us(call):.1f} us a call"
                  f"{_clock_text(clock, call)}", flush=True)
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
            bits = torch.int16 if v.element_size() == 2 else torch.int32
            same = v.dtype == w.dtype and bool(torch.equal(v.view(bits),
                                                           w.view(bits)))
            print(f"{k}: bit-identical {same}, max abs diff "
                  f"{float((v.float() - w.float()).abs().max()):.3e}")


if __name__ == "__main__":
    main()
