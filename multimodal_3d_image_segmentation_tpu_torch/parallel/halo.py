"""Depth sharding of the k=3 conv, the port of
``multimodal_3d_image_segmentation_tpu/parallel/halo.py``.

A volume (1, D, H, W, C) is split along depth into ``n`` contiguous slabs
of d = D / n planes, one per rank of a process group. A k=3 stencil needs
one plane of each neighbouring slab, so before each conv every rank sends
its first and last planes and receives its neighbours':

  * ``halo_exchange`` turns the local (1, d, H, W, C) slab into (1, d + 2,
    H, W, C), with exact zeros at the global ends (the SAME conv's zero
    padding);
  * ``conv3_sharded`` runs ``conv3`` in its halo mode on that slab (the
    hand-written kernel on the card) and all-reduces the moment sums, so a
    following GroupNorm is the single-volume one.

The collectives are ``all_gather`` and ``all_reduce``, which NCCL and gloo
both take. gloo carries no CUDA tensor through ``all_gather``, so with
gloo a CUDA tensor is copied to the host, exchanged there and copied back
(``_on_host``): the two boundary planes of a halo exchange, a moment sum,
or the slab of a ``gather_planes``. NCCL exchanges on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..kernels.conv3 import conv3

__all__ = ["all_gather", "all_reduce", "halo_exchange", "halo_keep",
           "conv3_sharded"]


def _on_host(t: torch.Tensor, group) -> bool:
    """Whether ``t`` crosses ``group`` through host memory: a CUDA tensor
    under gloo, which has no CUDA all_gather."""
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """(n, *t.shape): every rank's ``t`` in rank order."""
    n = dist.get_world_size(group)
    src = t.contiguous()
    if _on_host(src, group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts).to(t.device)


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``t`` (a new tensor; ``t`` is untouched)."""
    src = t.detach().clone().contiguous()
    host = _on_host(src, group)
    if host:
        src = src.cpu()
    dist.all_reduce(src, group=group)
    return src.to(t.device) if host else src


def halo_keep(rank: int, n: int) -> Tuple[int, int]:
    """The keep flags of rank ``rank``'s halo planes: 0 at a global end of
    the volume, where the exchanged plane stands for the zero padding."""
    return int(rank > 0), int(rank < n - 1)


def halo_exchange(x_local: torch.Tensor, group=None) -> torch.Tensor:
    """(1, d, H, W, C) slab -> (1, d + 2, H, W, C): the previous rank's
    last plane, the slab, the next rank's first plane (zeros at the global
    ends). One ``all_gather`` of every rank's (first, last) pair."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    pairs = all_gather(torch.stack([x_local[:, 0], x_local[:, -1]], 1),
                       group)                     # (n, 1, 2, H, W, C)
    zero = torch.zeros_like(x_local[:, :1])
    prev = pairs[r - 1, :, 1:2] if r > 0 else zero
    nxt = pairs[r + 1, :, 0:1] if r < n - 1 else zero
    return torch.cat([prev, x_local, nxt], dim=1)


def conv3_sharded(x_local: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor, *, x2: Optional[torch.Tensor] = None,
                  group=None, emit_stats: bool = False, **opts):
    """``conv3`` of a depth-sharded volume: this rank's slab ``x_local``
    (1, d, H, W, c1) (and ``x2``'s), every rank holding d planes in rank
    order. Exchanges the halos, runs conv3's halo mode with this rank's
    keep flags, and all-reduces the moment sums over ``group``. ``opts``
    are conv3's (prologue, prologue_act, residual, stride, dilation).

    Returns conv3's outputs for this rank's output planes (stride 2: d / 2
    for an even d, the global decimation; dilation 2: 2d), with the moment
    sums of the whole volume."""
    n = dist.get_world_size(group)
    keep = halo_keep(dist.get_rank(group), n)
    out = conv3(halo_exchange(x_local, group), weight, bias,
                x2=None if x2 is None else halo_exchange(x2, group),
                emit_stats=emit_stats, halo=True, halo_keep=keep, **opts)
    if not emit_stats:
        return out
    n_vol = 2 if opts.get("residual") is not None else 1
    outs = list(out)
    return tuple(outs[:n_vol] + [all_reduce(s, group)
                                 for s in outs[n_vol:]])
