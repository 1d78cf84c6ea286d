"""Convert parameters of the JAX package to the port's weights, without
importing jax.

``state_dict_from_jax(params)`` takes the flax parameter tree as nested
dicts of numpy arrays (what ``jax.device_get(params)`` gives) and returns a
torch state dict in the upstream reference's key names and layouts, equal
to what ``multimodal_3d_image_segmentation_tpu/utils/torch_compat.py::
export_reference_state_dict`` emits, for the module families the port
covers:

  * flax module names -> dotted paths: ``layers_3`` -> ``layers.3``,
    ``conv_blocks_1`` -> ``conv_blocks.1``, ``conv`` -> ``op``;
  * conv kernels: flax (*k, I, O) -> torch (O, I, *k), leaf ``weight``;
  * conv biases (sibling ``kernel``) and operator weights: unchanged.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["state_dict_from_jax"]

_INDEXED = re.compile(r"(layers|conv_blocks)_(\d+)")


def _segment(seg: str) -> str:
    m = _INDEXED.fullmatch(seg)
    if m:
        return f"{m.group(1)}.{m.group(2)}"
    return "op" if seg == "conv" else seg


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax params tree (numpy leaves) -> reference-layout torch state dict
    (CPU fp32 tensors)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, path + (_segment(k),))
                continue
            w = np.array(v, np.float32)  # a writable copy
            if k == "kernel":
                nd = w.ndim
                w = w.transpose((nd - 1, nd - 2) + tuple(range(nd - 2)))
                leaf = "weight"
            elif k == "weight" or (k == "bias" and "kernel" in tree):
                leaf = k
            else:
                raise ValueError(f"parameter {'/'.join(path + (k,))} has no "
                                 "counterpart in the port")
            key = ".".join(path + (leaf,))
            if key in out:
                raise ValueError(f"duplicate reference key {key!r}")
            out[key] = torch.from_numpy(np.ascontiguousarray(w))

    walk(params, ())
    return out
