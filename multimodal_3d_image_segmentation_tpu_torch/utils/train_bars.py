"""The whole-model rules for one train step, and the tower families'
readings against them.

``readings`` and ``over_bars`` are the rules ``chip_smoke.py`` holds
every family's train step to. Each tensor (the loss, then each
parameter's gradient) of the path under test must be at most
``bars["ratio"]`` times as far from a float64 evaluation as the reference
fp32 paths, plus ``bars["slack"]`` times the tensor's largest float64
magnitude (its scale):

  * ``BARS_TRAIN``, each tensor's largest error against the module path's
    (``use_kernels=False``): HNOSeg-XS, V-Net-DS, and the towers' loss;
  * ``BARS_TRAIN_SELU``, each gradient's RMS error against the larger of
    the module path's and the plain twins path's, and of their typical
    error level (``typical``) times the tensor's scale: the towers'
    gradients. SELU's slope jumps from 1.0507 to 1.7581 at 0: where an
    fp32 path puts a pre-activation on the other side of 0 than float64,
    that voxel's gradient term moves by 0.7 of itself, and every gradient
    upstream with it. Each fp32 path has such voxels at places of chance,
    so any two fp32 paths of these 16- and 24-block towers differ by
    chance factors per tensor; the ratio is the largest this script's
    readings on the card need for a path against the other two, with a
    margin.

Usage::

    python -m multimodal_3d_image_segmentation_tpu_torch.utils.train_bars \
        [--seed N] [--size D H W] [--cpu] [--out FILE]

One PCC-loss step of HartleyMHASeg (tower_block), HNOSeg (tower_block,
tower_block_s, tower_resident) and FNOSeg (tower_block) at their serving
widths (``profiling.MODELS``), weights and batch made from ``--seed``, at
``--size`` (default 120x120x78, the configs' training size), on the card
unless ``--cpu`` is given. Each is evaluated on four paths: the module
path in float64 and in fp32 ("plain"), the kernel path's formulation with
each kernel wrapper replaced by its plain twin ("twins": no kernel, the
same backward replays) and the kernel path ("kernel"; on the CPU the same
as "twins", so left out). Prints each path's typical error; per path,
the tensors over ``BARS_TRAIN`` against the plain path and what fails
``tower_failures`` against the other paths; and the ratio each path
needs against the others for ``BARS_TRAIN_SELU`` to hold. ``--out``
writes every tensor's readings as JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch

from .. import kernels
from ..losses import PCCLoss
from ..models import architectures
from ..utils.labels import to_categorical
from .profiling import MODELS, TRAIN_SIZE

__all__ = ["BARS_TRAIN", "BARS_TRAIN_SELU", "readings", "typical",
           "over_bars", "tower_failures", "plain_twins"]

BARS_TRAIN = {"ratio": 2.0, "slack": 1e-6}
# 3.85 is the largest ratio a path needed against the other two in the
# readings of PERF.md section 6 (3 seeds, 5 tower paths, 3 fp32 paths)
BARS_TRAIN_SELU = {"ratio": 5.0, "slack": 1e-6}

# the kernel wrappers the models call, and their plain twins
_TWINS = {"conv_in_s2d": kernels.conv_in_plain,
          "fused_tail_softmax": kernels.tail_plain,
          "fused_tower_block": kernels.tower_block_plain,
          "fused_tower_block_s": kernels.tower_block_s_plain,
          "resident_tower": kernels.resident_tower_plain}

FAMILIES = (("HartleyMHASeg", "hartleymha", None),
            ("HNOSeg", "hnoseg", "block"),
            ("HNOSeg", "hnoseg", "block_s"),
            ("HNOSeg", "hnoseg", "resident"),
            ("FNOSeg", "fnoseg", "block"))


def readings(paths, ref):
    """Per tensor of ``ref`` (name -> float64 tensor): its float64 scale
    (largest magnitude) and, for each path of ``paths`` (path -> name ->
    tensor), its largest ("max") and RMS ("rms") distance from ``ref``
    and whether it is finite."""
    out = {}
    for k, r in ref.items():
        out[k] = {"scale": float(r.abs().max())}
        for p, g in paths.items():
            d = g[k].double() - r
            out[k][p] = {"max": float(d.abs().max()),
                         "rms": float(d.square().mean().sqrt()),
                         "finite": bool(torch.isfinite(g[k]).all())}
    return out


def typical(r, path):
    """The RMS over the gradients (every tensor but the loss) of
    ``path``'s RMS error over each tensor's scale."""
    return float(np.sqrt(np.mean([
        (v[path]["rms"] / max(v["scale"], 1e-300)) ** 2
        for k, v in r.items() if k != "loss"])))


def _level(v, refs, metric, floor):
    return max([v[p][metric] for p in refs] + [floor * v["scale"]])


def over_bars(r, test, refs, metric="max", bars=BARS_TRAIN, floor=False):
    """The tensors of readings ``r`` whose distance ``metric`` on path
    ``test`` is not finite or misses ``bars`` against the largest of paths
    ``refs`` (with ``floor``, and of their ``typical`` level times the
    tensor's scale)."""
    level = max(typical(r, p) for p in refs) if floor else 0.0
    return [k for k, v in r.items()
            if not (v[test]["finite"] and v[test][metric] <= bars["ratio"]
                    * _level(v, refs, metric, level)
                    + bars["slack"] * v["scale"])]


def tower_failures(r, test="kernel", refs=("plain", "twins")):
    """What fails the towers' rules on path ``test`` of readings ``r``:
    the loss against ``BARS_TRAIN`` and the plain path, each gradient
    against ``BARS_TRAIN_SELU`` and ``refs``, and "gradients (typical)"
    where ``test``'s typical error misses ``BARS_TRAIN`` against the
    largest of ``refs``'."""
    grads = {k: v for k, v in r.items() if k != "loss"}
    failed = over_bars({"loss": r["loss"]}, test, ("plain",))
    failed += over_bars(grads, test, refs, "rms", BARS_TRAIN_SELU,
                        floor=True)
    if typical(r, test) > BARS_TRAIN["ratio"] * max(
            typical(r, p) for p in refs) + BARS_TRAIN["slack"]:
        failed.append("gradients (typical)")
    return failed


def needed_ratio(r, test, refs):
    """The smallest ratio for which ``test`` meets ``BARS_TRAIN_SELU``'s
    rule against ``refs`` on every gradient of ``r``."""
    grads = {k: v for k, v in r.items() if k != "loss"}
    level = max(typical(grads, p) for p in refs)
    return max((v[test]["rms"] - BARS_TRAIN_SELU["slack"] * v["scale"])
               / _level(v, refs, "rms", level) for v in grads.values())


@contextlib.contextmanager
def plain_twins(module=architectures, twins=None):
    """The models of ``module`` call each kernel wrapper's plain twin
    instead (``twins``, name -> function; default the towers' families')."""
    twins = _TWINS if twins is None else twins
    real = {name: getattr(module, name) for name in twins}
    try:
        for name, twin in twins.items():
            setattr(module, name, twin)
        yield
    finally:
        for name, fn in real.items():
            setattr(module, name, fn)


def _step(model, x, y1h):
    loss = PCCLoss()(model(x), y1h)
    loss.backward()
    return {"loss": loss.detach(),
            **{k: p.grad for k, p in model.named_parameters()}}


def family_readings(key, tower_kernel, seed, size, dev):
    cls, kw = MODELS[key]
    if tower_kernel is not None:
        kw = dict(kw, tower_kernel=tower_kernel)
    state = cls(**kw, generator=torch.Generator().manual_seed(seed)
                ).state_dict()
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((1, 4) + size)
                         .astype(np.float32)).to(dev)
    y1h = to_categorical(torch.from_numpy(rng.integers(
        0, 4, (1, 1) + size).astype(np.float32)).to(dev), 4)
    paths = {"fp64": (False, torch.float64, contextlib.nullcontext),
             "plain": (False, torch.float32, contextlib.nullcontext),
             "twins": (True, torch.float32, plain_twins)}
    if dev.type == "cuda":
        paths["kernel"] = (True, torch.float32, contextlib.nullcontext)
    grads = {}
    for name, (use_kernels, dtype, ctx) in paths.items():
        model = cls(**kw, use_kernels=use_kernels).to(dev, dtype)
        model.load_state_dict(state)
        with ctx():
            grads[name] = _step(model, x.to(dtype), y1h.to(dtype))
        del model
    return readings(grads, grads.pop("fp64"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--size", type=int, nargs=3, default=TRAIN_SIZE)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernel wrappers' plain "
                         "versions) instead of the card")
    ap.add_argument("--out", help="write every tensor's readings here")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("train_bars needs a CUDA device, or --cpu")
    dev = torch.device("cpu" if args.cpu else "cuda:0")
    size, out = tuple(args.size), {}
    for label, key, tower_kernel in FAMILIES:
        name = f"{label} {tower_kernel or 'block'}"
        r = out[name] = family_readings(key, tower_kernel, args.seed, size,
                                        dev)
        paths = [p for p in ("plain", "twins", "kernel") if p in r["loss"]]
        print(f"{name} seed {args.seed} {size}: typical error "
              + ", ".join(f"{p} {typical(r, p):.3e}" for p in paths),
              flush=True)
        for p in paths[1:]:
            refs = [q for q in paths if q != p]
            print(f"  {p}: over BARS_TRAIN against plain "
                  f"{over_bars(r, p, ('plain',))}; failing the towers' "
                  f"rules against {refs}: {tower_failures(r, p, refs)}",
                  flush=True)
        print("  ratio each path needs against the others: " + ", ".join(
            f"{p} {needed_ratio(r, p, [q for q in paths if q != p]):.3f}"
            for p in paths), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"seed": args.seed, "size": size, "readings": out}, f)


if __name__ == "__main__":
    main()
