"""Checkpoint and resume, the port of
``multimodal_3d_image_segmentation_tpu/runtime/checkpoint.py``.

As the upstream reference (``experiments/train_test.py:262-286``):

  * ``model/checkpoint.pt``: the model, optimizer and scheduler states
    with ``epoch``, ``min_loss`` and ``best_epoch``, written every
    ``checkpoint_epoch`` epochs and on each new best;
  * ``model/model.pt``: the best weights alone, a state dict under the
    reference's torch names, which ``runtime/inference.py::load_weights``
    reads.

Both are written to a temporary file and renamed, so a crash mid-write
leaves the previous file whole. ``load_weights`` reads a run directory's
weights for testing and serving: ``model.pt``, or else the JAX package's
``model.msgpack``. Writing the JAX package's
``model.msgpack`` is not ported (ROADMAP, Open items 1, item 7).
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from .. import not_ported
from ..utils.jax_compat import state_dict_from_jax
from ..utils.msgpack_params import read_msgpack_params

__all__ = ["save_checkpoint", "load_checkpoint", "save_model",
           "load_weights"]


def _atomic_save(obj, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _host(state):
    return {k: v.detach().cpu() for k, v in state.items()}


def save_model(path: str, model: torch.nn.Module) -> None:
    """The weights alone, on the host."""
    _atomic_save(_host(model.state_dict()), path)


def save_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer, scheduler,
                    epoch: int, min_loss: float,
                    best_epoch: Optional[int]) -> None:
    _atomic_save({"model": _host(model.state_dict()),
                  "optimizer": optimizer.state_dict(),
                  "scheduler": (None if scheduler is None
                                else scheduler.state_dict()),
                  "epoch": int(epoch), "min_loss": float(min_loss),
                  "best_epoch": best_epoch}, path)


def load_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer, scheduler
                    ) -> Tuple[int, float, Optional[int]]:
    """Restore the states in place; returns (epoch, min_loss,
    best_epoch)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(ckpt["model"], strict=True)
    optimizer.load_state_dict(ckpt["optimizer"])
    if scheduler is not None and ckpt["scheduler"] is not None:
        scheduler.load_state_dict(ckpt["scheduler"])
    return ckpt["epoch"], ckpt["min_loss"], ckpt["best_epoch"]


def load_weights(model_dir: str, model: torch.nn.Module):
    """The state dict in ``model_dir``: ``model.pt`` where it exists, else
    the JAX package's ``model.msgpack`` converted for ``model`` (V-Net-DS
    needs its ``num_blocks`` and ``use_residual``). The JAX package's
    sharded Orbax export (a ``model.msgpack.orbax`` directory) raises
    ``NotImplementedError``; a directory with neither file raises
    ``FileNotFoundError``."""
    pt = os.path.join(model_dir, "model.pt")
    mp = os.path.join(model_dir, "model.msgpack")
    if os.path.exists(pt):
        return torch.load(pt, map_location="cpu", weights_only=True)
    if os.path.exists(mp):
        return state_dict_from_jax(
            read_msgpack_params(mp), getattr(model, "num_blocks", None),
            getattr(model, "use_residual", True))
    if os.path.isdir(os.path.abspath(mp) + ".orbax"):
        not_ported("the sharded Orbax weights export (model.msgpack.orbax)",
                   7)
    raise FileNotFoundError(f"{model_dir} holds neither model.pt nor "
                            "model.msgpack")
