"""The trained-network precision gate of the serving modes, the port of
``tools/bench_precision.py``, for HNOSeg-XS, V-Net-DS and the tower
families.

Usage::

    python -m multimodal_3d_image_segmentation_tpu_torch.utils.precision_gate \\
        [--family hnosegxs|vnetds|hartleymha|hnoseg|fnoseg] [--cpu] \\
        [--out FILE] [--steps N] [--seed N] [--train-size D H W] \\
        [--eval-size D H W]

The protocol is the reference's: train a family at its full width (by
default the flagship HNOSeg-XS: filters 24, blocks [3]*8, modes
(10,14,14); ``--family`` takes V-Net-DS, HartleyMHASeg, HNOSeg or FNOSeg
at the widths of ``configs/config_vnet-ds.ini``,
``config_hartleymha.ini``, ``config_hnoseg.ini`` and
``config_fnoseg.ini``) for 400 steps of Adamax (lr 5e-3, cosine warm
restarts to 1e-3, PCC loss) on 6 synthetic blob volumes at 1x4x120x120x78,
then evaluate the same weights zero-shot on 3 held-out volumes at
240x240x155 under each serving mode, and report per-class Dice, its delta
from the fp32 oracle and the argmax agreement with it. The oracle is the
fp32 plain path (``use_kernels=False``, TF32 off); the modes are the fp32,
'bfloat16' and 'mixed' kernel paths (the tower families on each of their
tower kernels: HNOSeg on ``block``, ``block_s`` and ``resident``,
HartleyMHASeg and FNOSeg on their default ``block``; a tower path's name
ends in its kernel) and the 'bfloat16' and 'mixed' plain paths. The
reference's Dice bar is |delta| <= 1e-3 on every class: it is reported as
met or missed and decides nothing here (the port's default stays fp32).

What fails the gate (``failures`` in the result, exit code 1):
  * the oracle has not learned every class (mean Dice <= 0.2 on one, as
    the reference flags it);
  * in 'bfloat16' or 'mixed', a kernel path breaks the rule against
    that mode's twins path on some volume. The twins path is the kernel
    path's own formulation with each kernel wrapper replaced by its plain
    twin (PyTorch ops that round where the kernel rounds; no launch), a
    witness that does not involve the kernels. The rule: the kernel
    path's largest distance from a float64 evaluation of the model at
    most ``RATIO`` times the twins path's, and the share of voxels whose
    argmax differs from the twins path's at most ``RATIO`` times the
    share by which a second sound evaluation of the same formulation
    differs from it (each plus 1e-6): the twins64 path, whose twins sum
    in float64 before they round. That share is the floor bf16 rounding
    sets: any change to the bf16 roundings, even a rare one-ulp flip,
    moves the argmax of a share of voxels above the fp32 rule's
    1 - ``AGREE`` (PERF.md, section 6);
  * the control, the 'bfloat16' kernel path (a tower's on ``block``) with
    conv_in's and the chains', the tower blocks' channel-mix or V-Net-DS's
    k=3 conv weights rounded to 4 mantissa bits (16 times bf16's
    rounding), passes that rule.
Reported, met or missed: the fp32 kernel path's whole-model rule taken
literally against the mode's plain path (``use_kernels=False``, which
rounds at other places): largest distance from float64 at most ``RATIO``
times the plain path's, argmax agreement at least ``AGREE``, for the
kernel and the twins paths; and the probe, the twins path with the
per-stage rounding of its kernel's twin left out (HNOSeg-XS: the chain
rounded once at its end; the towers: the tower blocks' z, y, t and F
operands unrounded; V-Net-DS: conv3's prologue output unrounded), against
the rule (``chip_smoke.py`` checks the roundings at the kernel).

It also reports, for the trained network, the largest activation magnitude
after conv_in, conv1 and each block (V-Net-DS: after conv_in and in each
encoder and decoder section; fp32 plain path, first volume), and
the fp32 kernel path's distances from the plain path and from float64,
with whether an absolute 1e-4 bar on the kernel path against the plain
path would hold. It runs on the card unless ``--cpu`` is given (without
CUDA it raises), and never writes the JAX package's
``BENCH_PRECISION.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from ..device import resolve_device
from ..losses import pcc_loss
from ..models import (HartleyMHASeg, HNOSegXS, NeuralOperatorSeg, VNetDS,
                      architectures, hnosegxs)
from ..runtime.optim import build_optimizer, build_schedule
from ..runtime.steps import make_train_step
from . import train_bars

__all__ = ["blob_volume", "make_dataset", "dice_per_class", "train",
           "evaluate", "run_gate", "main", "plain_twins", "references",
           "modes_of", "MODES", "CONTROL", "PROBE", "FAMILIES"]

TRAIN_SHAPE = (120, 120, 78)
EVAL_SHAPE = (240, 240, 155)
N_TRAIN = 6
N_EVAL = 3
STEPS = 400
FLAGSHIP = dict(in_channels=4, out_channels=4, filters=24,
                num_transform_blocks=[3] * 8, num_modes=(10, 14, 14))
# the configs' widths (configs/config_hartleymha.ini, config_hnoseg.ini,
# config_fnoseg.ini)
MHA = dict(in_channels=4, out_channels=4, filters=24, num_transform_blocks=16,
           num_heads=4, num_modes=(8, 12, 12), patch_size=2)
NOSEG = dict(in_channels=4, out_channels=4, filters=24,
             num_transform_blocks=24, num_modes=(10, 14, 14))
# configs/config_vnet-ds.ini's widths (22,547,764 parameters)
VNET = dict(in_channels=4, out_channels=4, base_num_filters=24,
            num_blocks=[1, 2, 3, 3, 3], right_leg_indexes=[0, 1, 2, 3, 4])
# family: (model class, its widths, the tower kernels its kernel paths run
# on, None for HNOSeg-XS and V-Net-DS)
FAMILIES = {
    "hnosegxs": (HNOSegXS, FLAGSHIP, None),
    "vnetds": (VNetDS, VNET, None),
    "hartleymha": (HartleyMHASeg, MHA, ("block",)),
    "hnoseg": (NeuralOperatorSeg, dict(NOSEG, transform_type="Hartley"),
               ("block", "block_s", "resident")),
    "fnoseg": (NeuralOperatorSeg, dict(NOSEG, transform_type="Fourier"),
               ("block",)),
}
# HNOSeg-XS's paths, name: (use_kernels, compute_dtype, twins: None, "fp32"
# or "fp64"); the first is the oracle (a tower family's: ``modes_of``)
MODES = {
    "fp32_plain": (False, "float32", None),
    "fp32_kernels": (True, "float32", None),
    "bf16_kernels": (True, "bfloat16", None),
    "bf16_twins": (True, "bfloat16", "fp32"),
    "bf16_twins64": (True, "bfloat16", "fp64"),
    "bf16_plain": (False, "bfloat16", None),
    "mixed_kernels": (True, "mixed", None),
    "mixed_twins": (True, "mixed", "fp32"),
    "mixed_twins64": (True, "mixed", "fp64"),
    "mixed_plain": (False, "mixed", None),
}
# the bf16 kernel path with conv_in's and the chains' (a tower's: the
# blocks' channel-mix) weights rounded to CONTROL_BITS mantissa bits: it
# must break the rule
CONTROL = "control_weights_4bit"
CONTROL_BITS = 4
# the bf16 twins path with its kernel twin's per-stage rounding left out:
# reported
PROBE = "probe_chain_rounded_once"
PROBE_TOWER = "probe_operands_unrounded"
PROBE_VNET = "probe_prologue_unrounded"
DICE_BAR = 1e-3
LEARNED = 0.2
RATIO = 2.0
AGREE = 0.9999
ABS_BAR = 1e-4


def blob_volume(rng: np.random.Generator, shape: Sequence[int]):
    """A 4-modality volume of 3 blobs with 3 nested foreground classes,
    their geometry in normalized coordinates (so that low- and
    high-resolution draws agree) and each class keyed by an intensity."""
    zz, yy, xx = np.meshgrid(*[np.linspace(0, 1, s) for s in shape],
                             indexing="ij")
    seg = np.zeros(shape, np.int32)
    for _ in range(3):
        c = rng.uniform(0.22, 0.78, 3)
        r = rng.uniform(0.12, 0.22)
        d2 = ((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2)
        seg[d2 < r ** 2] = 1
        seg[d2 < (0.72 * r) ** 2] = 2
        seg[d2 < (0.45 * r) ** 2] = 3
    x = np.stack([seg * 2.0 + rng.standard_normal(shape) * 0.5,
                  -seg + rng.standard_normal(shape) * 0.5,
                  (seg == 2) * 3.0 + rng.standard_normal(shape) * 0.5,
                  (seg == 3) * 3.0 + rng.standard_normal(shape) * 0.5]
                 ).astype(np.float32)
    return x, seg


def make_dataset(seed: int, n: int, shape: Sequence[int]):
    """``n`` blob volumes from ``seed``: (n, 4, *shape) fp32, (n, *shape)
    int32 labels."""
    rng = np.random.default_rng(seed)
    xs, ys = zip(*(blob_volume(rng, shape) for _ in range(n)))
    return np.stack(xs), np.stack(ys)


def dice_per_class(pred: np.ndarray, true: np.ndarray, n_classes: int = 4):
    """Dice of the foreground classes 1 .. n_classes - 1 (NaN where a class
    is in neither volume)."""
    out = []
    for lab in range(1, n_classes):
        inter = np.count_nonzero((pred == lab) & (true == lab))
        denom = (np.count_nonzero(pred == lab)
                 + np.count_nonzero(true == lab))
        out.append(2 * inter / denom if denom else float("nan"))
    return out


def modes_of(family: str) -> Dict[str, tuple]:
    """A family's paths, name: (use_kernels, compute_dtype, twins: None,
    "fp32" or "fp64", tower kernel or None); the first is the oracle.
    HNOSeg-XS's are ``MODES``; a tower family's kernel, twins and twins64
    paths run on each of its tower kernels, named with it."""
    kernels_of = FAMILIES[family][2]
    if kernels_of is None:
        return {name: spec + (None,) for name, spec in MODES.items()}
    out = {"fp32_plain": (False, "float32", None, None)}
    out.update({f"fp32_kernels_{k}": (True, "float32", None, k)
                for k in kernels_of})
    for mode, cd in (("bf16", "bfloat16"), ("mixed", "mixed")):
        for k in kernels_of:
            out.update({f"{mode}_kernels_{k}": (True, cd, None, k),
                        f"{mode}_twins_{k}": (True, cd, "fp32", k),
                        f"{mode}_twins64_{k}": (True, cd, "fp64", k)})
        out[f"{mode}_plain"] = (False, cd, None, None)
    return out


def _probe(family: str) -> str:
    return _TWINS_OF[_kind(family)][3]


def _kind(family: str) -> str:
    """Which twins a family's kernel paths take: "hnosegxs", "vnetds" or
    "tower"."""
    return family if family in ("hnosegxs", "vnetds") else "tower"


def train(device: torch.device, steps: int = STEPS,
          shape: Sequence[int] = TRAIN_SHAPE, n_train: int = N_TRAIN,
          seed: int = 0, family: str = "hnosegxs"):
    """Train ``family`` at its full width, fp32, on its kernel path (the
    port's training path; the towers on ``block``); returns (state dict,
    loss history every 50 steps, seconds)."""
    xs, ys = make_dataset(1, n_train, shape)
    fracs = [float(np.mean(ys == c)) for c in range(4)]
    if not all(f > 1e-4 for f in fracs):
        raise ValueError(f"a class rasterized away at {tuple(shape)}: "
                         f"class fractions {fracs}")
    cls, widths, _ = FAMILIES[family]
    model = cls(**widths, use_kernels=True,
                generator=torch.Generator().manual_seed(seed), device=device)
    optimizer = build_optimizer({"optimizer_name": "Adamax", "lr": 5e-3},
                                model.parameters())
    scheduler = build_schedule(
        optimizer, {"scheduler_name": "CosineAnnealingWarmRestarts",
                    "eta_min": 1e-3}, 5e-3, n_train, steps // n_train)
    step = make_train_step(model, optimizer, scheduler, pcc_loss, 4)
    x = torch.from_numpy(xs).to(device)
    y = torch.from_numpy(ys[:, None]).to(device)
    history = []
    t0 = time.perf_counter()
    for i in range(steps):
        j = i % n_train
        loss = step(x[j:j + 1], y[j:j + 1])
        if i % 50 == 0 or i == steps - 1:
            history.append(float(loss))
    return model.state_dict(), history, time.perf_counter() - t0


def _model(state, use_kernels: bool, compute_dtype: str,
           device: torch.device, dtype=torch.float32,
           family: str = "hnosegxs", tower_kernel: Optional[str] = None):
    cls, widths, _ = FAMILIES[family]
    kw = {} if tower_kernel is None else {"tower_kernel": tower_kernel}
    m = cls(**widths, use_kernels=use_kernels, compute_dtype=compute_dtype,
            **kw).to(device, dtype)
    m.load_state_dict(state)
    return m.eval()


def _rounded(state, bits: int = CONTROL_BITS, family: str = "hnosegxs"):
    """``state`` with conv_in's weight and the chains' (HNOSeg-XS), the
    tower blocks' channel-mix weights (conv_branch, conv_concat) or
    V-Net-DS's k=3 conv weights (conv3's: the chains', the down and the up
    convs') rounded to ``bits`` mantissa bits (nearest, ties away)."""
    drop = 23 - bits
    out = dict(state)
    for k, v in state.items():
        if family == "vnetds":
            pick = v.dim() == 5 and tuple(v.shape[2:]) == (3, 3, 3)
        else:
            pick = k == "conv_in.op.weight" or ".conv_blocks." in k or (
                k.startswith("layers.") and k.endswith(".weight")
                and (".conv_branch." in k or ".conv_concat." in k))
        if pick:
            b = v.contiguous().view(torch.int32)
            out[k] = ((b + (1 << (drop - 1))) & ~((1 << drop) - 1)).view(
                torch.float32)
    return out


def _chain_rounded_once(x: torch.Tensor, weights) -> torch.Tensor:
    """The chain in fp32 with one rounding to the rows' dtype at its end
    (the probe of the per-stage rounding)."""
    y = x.float()
    for w in weights:
        y = torch.selu(F.linear(y, w.float()) + y)
    return y.to(x.dtype)


def _conv_in64(x, weight, bias, apply_selu=True):
    """conv_in's twin summing in float64, rounded to the input's dtype."""
    return kernels.conv_in_plain(x, weight.double(), bias.double(),
                                 apply_selu)


def _chain64(x: torch.Tensor, weights) -> torch.Tensor:
    """The chain with each stage in float64, rounded to the rows' dtype."""
    for w in weights:
        y = x.double()
        x = torch.selu(F.linear(y, w.double()) + y).to(x.dtype)
    return x


def _tail64(x, sizes, out_dtype=None):
    """The tail's twin in float64, cast to ``out_dtype`` (default fp32)."""
    return kernels.tail_plain(x.double(), sizes).to(
        out_dtype or torch.float32)


_TWINS = {"conv_in_s2d": kernels.conv_in_plain,
          "fused_freq_chain": kernels.freq_chain_plain,
          "fused_tail_softmax": kernels.tail_plain}
_TWINS64 = {"conv_in_s2d": _conv_in64, "fused_freq_chain": _chain64,
            "fused_tail_softmax": _tail64}
_F64 = dict(acc=torch.float64)
# the tower families' wrappers (models/architectures.py) and their twins
_TOWER_TWINS = train_bars._TWINS
_TOWER_TWINS64 = {
    "conv_in_s2d": _conv_in64, "fused_tail_softmax": _tail64,
    "fused_tower_block": functools.partial(kernels.tower_block_plain,
                                           **_F64),
    "fused_tower_block_s": functools.partial(kernels.tower_block_s_plain,
                                             **_F64),
    "resident_tower": functools.partial(kernels.resident_tower_plain,
                                        **_F64)}
# the probe's: the tower blocks' intermediate operands unrounded
_UNROUNDED = frozenset({"sy", "z", "y", "t", "F"})
# V-Net-DS's wrappers (models/architectures.py) and their twins
_VNET_TWINS = {"conv_in_s2d": kernels.conv_in_plain,
               "fused_tail_softmax": kernels.tail_plain,
               "conv3": kernels.conv3_plain}
_VNET_TWINS64 = {"conv_in_s2d": _conv_in64, "fused_tail_softmax": _tail64,
                 "conv3": functools.partial(kernels.conv3_plain, **_F64)}
# kind: (the module whose wrappers the twins replace, twins, twins64, the
# probe's name, its twins)
_TWINS_OF = {
    "hnosegxs": (hnosegxs, _TWINS, _TWINS64, PROBE,
                 dict(_TWINS, fused_freq_chain=_chain_rounded_once)),
    "tower": (architectures, _TOWER_TWINS, _TOWER_TWINS64, PROBE_TOWER,
              dict(_TOWER_TWINS, **{
                  name: functools.partial(_TOWER_TWINS[name],
                                          unrounded=_UNROUNDED)
                  for name in ("fused_tower_block", "fused_tower_block_s")})),
    "vnetds": (architectures, _VNET_TWINS, _VNET_TWINS64, PROBE_VNET,
               dict(_VNET_TWINS, conv3=functools.partial(
                   kernels.conv3_plain, unrounded={"prologue"}))),
}


def plain_twins(twins=None, family: str = "hnosegxs"):
    """``family``'s model calls each kernel wrapper's plain twin instead
    (``twins``, name -> function, default the family's)."""
    module, default = _TWINS_OF[_kind(family)][:2]
    return train_bars.plain_twins(module, twins or default)


def _activations(model, x: torch.Tensor) -> Dict[str, float]:
    """The largest magnitude after conv_in, conv1 and each block
    (V-Net-DS: after conv_in and any conv of each encoder and decoder
    section)."""
    seen, hooks = {}, []
    if isinstance(model, VNetDS):
        named = [("conv_in", model.conv_in)] + [
            (f"{side}_{i}", m)
            for side, layers in (("encode", model.encode_layers),
                                 ("decode", model.decode_layers))
            for i, sec in enumerate(layers) for m in sec]
    else:
        named = [("conv_in", model.conv_in), ("conv1", model.conv1)] + [
            (f"layers_{i}", b) for i, b in enumerate(model.layers)]
    for name, mod in named:
        hooks.append(mod.register_forward_hook(
            lambda _m, _a, out, name=name: seen.__setitem__(
                name, max(seen.get(name, 0.0), float(out.abs().max())))))
    try:
        model(x)
    finally:
        for h in hooks:
            h.remove()
    return seen


def _agree(pred: torch.Tensor, probs: torch.Tensor) -> float:
    """The share of voxels where ``pred`` is the argmax of ``probs``."""
    return float((pred == probs.argmax(1)).float().mean())


def _parts(name: str):
    """(mode, kind, tower kernel or None) of a path name: "bf16_kernels" or
    "bf16_kernels_block" -> ("bf16", "kernels", None or "block"); the
    control and the probes are 'bfloat16' paths."""
    if name in (CONTROL, PROBE, PROBE_TOWER, PROBE_VNET):
        return "bf16", name, None
    parts = name.split("_", 2)
    return parts[0], parts[1], parts[2] if len(parts) > 2 else None


def _default_suffix(family: str) -> str:
    """The name suffix of a family's first tower kernel ("" for HNOSeg-XS):
    the control's and the probe's."""
    kernels_of = FAMILIES[family][2]
    return "" if kernels_of is None else f"_{kernels_of[0]}"


def references(name: str, family: str = "hnosegxs") -> Dict[str, str]:
    """The paths ``name`` is compared with, by role: "plain" (the mode's
    plain path) and "twins" (the mode's twins path on the same tower
    kernel)."""
    if name in (CONTROL, PROBE, PROBE_TOWER, PROBE_VNET):
        return {"twins": f"bf16_twins{_default_suffix(family)}"}
    mode, kind, kernel = _parts(name)
    sfx = "" if kernel is None else f"_{kernel}"
    if kind == "plain":
        return {}
    if kind == "twins64":
        return {"twins": f"{mode}_twins{sfx}"}
    refs = {"plain": f"{mode}_plain"}
    if kind == "kernels" and mode != "fp32":
        refs["twins"] = f"{mode}_twins{sfx}"
    return refs


def evaluate(state, device: torch.device, shape: Sequence[int] = EVAL_SHAPE,
             n_eval: int = N_EVAL, family: str = "hnosegxs") -> Dict:
    """Every path on the held-out volumes: per-volume Dice and argmax,
    distances from float64, and the readings against ``references``."""
    xs, ys = make_dataset(99, n_eval, shape)  # held-out geometry
    _, tw, tw64, probe, probe_twins = _TWINS_OF[_kind(family)]
    twins = {None: contextlib.nullcontext,
             "fp32": lambda: plain_twins(tw, family),
             "fp64": lambda: plain_twins(tw64, family)}
    # name: (model, the context it runs in)
    paths = {name: (_model(state, k, cd, device, family=family,
                           tower_kernel=tk), twins[t])
             for name, (k, cd, t, tk) in modes_of(family).items()}
    sfx = _default_suffix(family)
    paths[CONTROL] = (_model(_rounded(state, family=family), True,
                             "bfloat16", device, family=family,
                             tower_kernel=sfx[1:] or None),
                      contextlib.nullcontext)
    paths[probe] = (paths[f"bf16_twins{sfx}"][0],
                    lambda: plain_twins(probe_twins, family))
    ref_model = _model(state, False, "float32", device, torch.float64,
                       family=family)
    out = {name: {"dice": [], "vs_fp64": [], "agree_oracle": [],
                  **{f"{f}_{role}": [] for role in references(name, family)
                     for f in ("max_abs_vs", "agree")}}
           for name in paths}
    with torch.inference_mode():
        for i in range(n_eval):
            x = torch.from_numpy(xs[i:i + 1]).to(device)
            if i == 0:
                activations = _activations(paths["fp32_plain"][0], x)
            ref = ref_model(x.double())
            probs = {}
            for name, (model, ctx) in paths.items():
                before = sum(kernels.LAUNCHES.values())
                with ctx():
                    probs[name] = model(x)
                if (ctx is not contextlib.nullcontext
                        and sum(kernels.LAUNCHES.values()) != before):
                    raise RuntimeError(f"{name} launched a kernel")
            for name, p in probs.items():
                pred = p.argmax(1)
                r = out[name]
                r["dice"].append(dice_per_class(pred[0].cpu().numpy(),
                                                ys[i]))
                r["vs_fp64"].append(float((p.double() - ref).abs().max()))
                r["agree_oracle"].append(_agree(pred,
                                                probs["fp32_plain"]))
                for role, other in references(name, family).items():
                    q = probs[other]
                    r[f"max_abs_vs_{role}"].append(float(
                        (p.float() - q.float()).abs().max()))
                    r[f"agree_{role}"].append(_agree(pred, q))
            del probs, ref
    out["activations_fp32"] = activations
    return out


def _floor(twins: str) -> str:
    """The twins64 path of a twins path: the rule's floor."""
    return twins.replace("_twins", "_twins64", 1)


def _broken(r: Dict, ev: Dict, name: str, family: str):
    """Volumes on which readings ``r`` of path ``name`` break the rule
    against its twins path (module docstring)."""
    other = references(name, family)["twins"]
    twins, floor = ev[other], ev[_floor(other)]
    return [i for i, (k, t, a, f) in enumerate(zip(
        r["vs_fp64"], twins["vs_fp64"], r["agree_twins"],
        floor["agree_twins"]))
        if k > RATIO * t + 1e-6 or 1 - a > RATIO * (1 - f) + 1e-6]


def _literal(r: Dict, plain: Dict):
    """Volumes on which readings ``r`` break the literal whole-model rule
    against the plain path's readings ``plain``: largest distance from
    float64 above ``RATIO`` times the plain path's, or argmax agreement
    with it below ``AGREE``."""
    return [i for i, (k, p, a) in enumerate(zip(
        r["vs_fp64"], plain["vs_fp64"], r["agree_plain"]))
        if k > RATIO * p + 1e-6 or a < AGREE]


def _summary(ev: Dict, family: str = "hnosegxs") -> Dict:
    """Per-path means, deltas and rules, and the gate's failures."""
    res, failures = {}, []
    oracle = np.nanmean(np.asarray(ev["fp32_plain"]["dice"]), axis=0)
    for name in list(modes_of(family)) + [CONTROL, _probe(family)]:
        r = ev[name]
        refs = references(name, family)
        mean = np.nanmean(np.asarray(r["dice"]), axis=0)
        rec = {"per_class_dice_mean": [float(v) for v in mean],
               "max_abs_vs_fp64": max(r["vs_fp64"]),
               "argmax_agreement_vs_oracle": min(r["agree_oracle"])}
        if name == "fp32_plain":
            rec["all_classes_learned"] = bool(np.all(oracle > LEARNED))
            if not rec["all_classes_learned"]:
                failures.append(f"the oracle has not learned every class "
                                f"(mean Dice {rec['per_class_dice_mean']}, "
                                f"bar > {LEARNED})")
        else:
            delta = mean - oracle
            rec["dice_delta_vs_oracle"] = [float(v) for v in delta]
            rec["dice_bar_met"] = bool(np.all(np.abs(delta) <= DICE_BAR))
        for role, other in refs.items():
            rec.update({
                f"{role}_path": other,
                f"max_abs_vs_{role}": max(r[f"max_abs_vs_{role}"]),
                f"argmax_agreement_vs_{role}": min(r[f"agree_{role}"]),
                f"vs_fp64_ratio_{role}": max(
                    k / p if p > 0 else float("inf")
                    for k, p in zip(r["vs_fp64"], ev[other]["vs_fp64"]))})
        if "plain" in refs:
            rec["literal_rule_vs_plain_broken_on"] = _literal(
                r, ev[refs["plain"]])
        if "twins" in refs and _parts(name)[1] != "twins64":
            broken = _broken(r, ev, name, family)
            floor = ev[_floor(refs["twins"])]["agree_twins"]
            rec["rule_broken_vs_twins_on"] = broken
            rec["argmax_disagreement_ratio_twins"] = max(
                (1 - a) / (1 - f) if f < 1 else
                (0.0 if a == 1 else float("inf"))
                for a, f in zip(r["agree_twins"], floor))
            if name == CONTROL and not broken:
                failures.append(f"{CONTROL} passed the rule")
            elif _parts(name)[1] == "kernels" and broken:
                failures.append(
                    f"{name} breaks the rule against {refs['twins']} on "
                    f"volumes {broken}: largest distance from float64 "
                    f"{r['vs_fp64']} against {RATIO} x "
                    f"{ev[refs['twins']]['vs_fp64']}, argmax agreement "
                    f"{r['agree_twins']} against the twins paths' "
                    f"{ev[_floor(refs['twins'])]['agree_twins']}")
        res[name] = rec
    fp32 = res[f"fp32_kernels{_default_suffix(family)}"]
    res["fp32_abs_1e-4_bar_holds"] = fp32["max_abs_vs_plain"] <= ABS_BAR
    res["activations_fp32"] = ev["activations_fp32"]
    res["failures"] = failures
    return res


def run_gate(device: torch.device, steps: int = STEPS,
             train_shape: Sequence[int] = TRAIN_SHAPE,
             eval_shape: Sequence[int] = EVAL_SHAPE, n_train: int = N_TRAIN,
             n_eval: int = N_EVAL, seed: int = 0, log=print,
             family: str = "hnosegxs") -> Dict:
    """Train ``family`` (initial weights from ``seed``), evaluate every
    mode zero-shot, and judge: the result dict (``failures`` empty where
    the gate passes)."""
    state, history, train_s = train(device, steps, train_shape, n_train,
                                    seed, family)
    log(f"{family}: trained {steps} steps at {tuple(train_shape)} on "
        f"{n_train} volumes in {train_s:.2f} s; loss every 50 steps "
        f"{history}")
    t0 = time.perf_counter()
    ev = evaluate(state, device, eval_shape, n_eval, family)
    res = _summary(ev, family)
    res.update(family=family, train_shape=list(train_shape),
               eval_shape=list(eval_shape), steps=steps, n_train=n_train,
               n_eval=n_eval, seed=seed, train_loss_history=history,
               train_seconds=train_s,
               eval_seconds=time.perf_counter() - t0, device=str(device),
               protocol="tools/bench_precision.py's: train at train_shape, "
                        "zero-shot eval of the same weights at eval_shape; "
                        f"Dice bar |delta| <= {DICE_BAR} (reported)")
    for name in list(modes_of(family)) + [CONTROL, _probe(family)]:
        log(f"{name}: {json.dumps(res[name])}")
    log(f"activations (largest magnitude, fp32 plain path): "
        f"{json.dumps(res['activations_fp32'])}")
    fp32 = res[f"fp32_kernels{_default_suffix(family)}"]
    log(f"fp32 kernel path: {fp32['max_abs_vs_plain']:.3e} "
        f"from the plain path, {fp32['max_abs_vs_fp64']:.3e} "
        f"from float64 (plain path {res['fp32_plain']['max_abs_vs_fp64']:.3e});"
        f" an absolute {ABS_BAR:g} bar against the plain path "
        f"{'holds' if res['fp32_abs_1e-4_bar_holds'] else 'does not hold'}")
    log(f"gate failures: {res['failures'] or 'none'}")
    return res


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--family", choices=list(FAMILIES), default="hnosegxs",
                    help="the family to train and gate")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernel paths run their plain "
                         "twins there)")
    ap.add_argument("--out", help="write the result JSON here")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the initial weights")
    ap.add_argument("--train-size", type=int, nargs=3,
                    default=list(TRAIN_SHAPE))
    ap.add_argument("--eval-size", type=int, nargs=3,
                    default=list(EVAL_SHAPE))
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    res = run_gate(device, args.steps, args.train_size, args.eval_size,
                   seed=args.seed, family=args.family)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 1 if res["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
