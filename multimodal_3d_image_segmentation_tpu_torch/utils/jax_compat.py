"""Convert parameters of the JAX package to the port's weights, without
importing jax.

``state_dict_from_jax(params)`` takes the flax parameter tree as nested
dicts of numpy arrays (what ``jax.device_get(params)`` gives) and returns a
torch state dict in the upstream reference's key names and layouts, equal
to what ``multimodal_3d_image_segmentation_tpu/utils/torch_compat.py::
export_reference_state_dict`` emits, for the module families the port
covers:

  * flax module names -> dotted paths: ``layers_3`` -> ``layers.3``,
    ``conv_blocks_1`` -> ``conv_blocks.1``, ``conv`` -> ``op``, ``norm``
    -> ``normalization``; V-Net-DS's sections (``num_blocks`` and
    ``use_residual`` of the model set the indices): ``encode_i_conv_j``
    -> ``encode_layers.i.j``, ``encode_i_residual`` -> ``encode_layers.i.
    <nb>``, ``encode_i_down`` -> ``encode_layers.i.<nb + residual>``,
    ``decode_i_up`` -> ``decode_layers.i.0``, ``decode_i_conv_j`` ->
    ``decode_layers.i.<j + 1>``, ``decode_i_residual`` ->
    ``decode_layers.i.<nb + 1>``;
  * conv kernels: flax (*k, I, O) -> torch (O, I, *k), leaf ``weight``;
    transposed-conv kernels (modules named ``*_up``) -> torch (I, O, *k);
  * GroupNorm ``scale`` -> ``weight``; biases, operator weights (``weight``,
    ``weight_real``, ``weight_imag``) and the HartleyMHA projections
    (``weight_query``, ``weight_key``, ``weight_value``, ``weight_out``):
    unchanged. The deep-supervision
    ``conv_ds/conv`` is a 1x1 conv like any other (``conv_ds.op``).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

__all__ = ["state_dict_from_jax"]

_INDEXED = re.compile(r"(layers|conv_blocks)_(\d+)")
_VNET = re.compile(r"(encode|decode)_(\d+)_(conv_(\d+)|residual|down|up)")
_RENAME = {"conv": "op", "norm": "normalization"}
# unchanged leaves: spectral-operator weights (Hartley's, Fourier's real
# pair) and HartleyMHA's projections
_WEIGHTS = ("weight", "weight_real", "weight_imag", "weight_query",
            "weight_key", "weight_value", "weight_out")


def _segment(seg: str, num_blocks: Optional[Sequence[int]],
             use_residual: bool) -> str:
    m = _INDEXED.fullmatch(seg)
    if m:
        return f"{m.group(1)}.{m.group(2)}"
    m = _VNET.fullmatch(seg)
    if m:
        if num_blocks is None:
            raise ValueError(f"{seg}: V-Net-DS parameters need the model's "
                             "num_blocks")
        side, i, what = m.group(1), int(m.group(2)), m.group(3)
        nb = int(num_blocks[i])
        dec = int(side == "decode")
        if m.group(4) is not None:
            idx = int(m.group(4)) + dec
        elif what == "residual":
            idx = nb + dec
        elif what == "down":
            idx = nb + int(bool(use_residual))
        else:  # up
            idx = 0
        return f"{side}_layers.{i}.{idx}"
    return _RENAME.get(seg, seg)


def state_dict_from_jax(params: Mapping[str, Any],
                        num_blocks: Optional[Sequence[int]] = None,
                        use_residual: bool = True
                        ) -> Dict[str, torch.Tensor]:
    """flax params tree (numpy leaves) -> reference-layout torch state dict
    (CPU fp32 tensors). ``num_blocks`` and ``use_residual`` are the
    V-Net-DS model's (needed only for its trees)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, path, up):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, path + (_segment(k, num_blocks, use_residual),),
                     up or k.endswith("_up"))
                continue
            w = np.array(v, np.float32)  # a writable copy
            if k == "kernel":
                nd = w.ndim
                lead = (nd - 2, nd - 1) if up else (nd - 1, nd - 2)
                w = w.transpose(lead + tuple(range(nd - 2)))
                leaf = "weight"
            elif k == "scale":
                leaf = "weight"
            elif k in _WEIGHTS or (k == "bias" and ("kernel" in tree
                                                    or "scale" in tree)):
                leaf = k
            else:
                raise ValueError(f"parameter {'/'.join(path + (k,))} has no "
                                 "counterpart in the port")
            key = ".".join(path + (leaf,))
            if key in out:
                raise ValueError(f"duplicate reference key {key!r}")
            out[key] = torch.from_numpy(np.ascontiguousarray(w))

    walk(params, (), False)
    return out
