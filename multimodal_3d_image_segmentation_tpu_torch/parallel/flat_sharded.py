"""Whole-model depth sharding of V-Net-DS's kernel path, the port of
``multimodal_3d_image_segmentation_tpu/parallel/flat_sharded.py``.

``parallel/halo.py`` shards one conv; this module shards the whole
kernel-path forward (``VNetDS(spatial_shard=...)``):

  * ``ShardCtx``: what the forward threads through its levels: the
    process group, the halo exchange, the moment all-reduce, and the moves
    between a sharded and a replicated level (``gather_planes``,
    ``local_slab``). ``dim`` chooses the image axis that is split: the k=3
    stencils are isotropic, so the forward is equivariant under a
    permutation of the image axes once the conv weights' spatial axes are
    permuted along. At BraTS' 240x240x155 the first two axes give 121
    planes after conv_in (odd), the third 78.
  * ``shard_schedule``: the static plan of which levels run sharded. A
    level is sharded when every level above is, its depth divides over the
    ranks with at least 2 planes each, and the level above it held an even
    number of planes per rank (the stride-2 conv's local decimation is
    then the global one). The first level that fails runs replicated on
    every rank, as do all below it.
  * ``flat_vnet_shardable``: the image axis that shards the most levels
    (level 0 at least) at an image size, or None.

The input volume and the weights are replicated, and so is the output:
the entry conv runs on every rank and each rank then keeps its slab; the
head gathers the small ``out_channels`` volume before the resize.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from . import halo as _halo

__all__ = ["ShardCtx", "shard_schedule", "flat_vnet_shardable"]


class ShardCtx:
    """The depth-shard context of a forward over ``group`` (None: the
    default group) of ``n`` ranks, split along image axis ``dim``. Local
    tensors are channels-last (1, d, H, W, C) slabs of the permuted volume
    (``permute``), rank r holding planes [r d, (r + 1) d)."""

    def __init__(self, group, n: int, dim: int = 0):
        if not dist.is_initialized():
            raise RuntimeError("spatial_shard needs an initialized "
                               "torch.distributed process group "
                               "(parallel/multihost.py)")
        self.group, self.n, self.dim = group, int(n), int(dim)
        if dist.get_world_size(group) != self.n:
            raise ValueError(f"spatial_shard n={n} but the process group "
                             f"has {dist.get_world_size(group)} ranks")
        if self.dim not in (0, 1, 2):
            raise ValueError(f"spatial_shard dim must be 0, 1 or 2, got "
                             f"{dim}")
        self.rank = dist.get_rank(group)
        # image axes in the order the forward sees them, and back
        self.sperm = (self.dim,) + tuple(k for k in range(3) if k != dim)
        self.sperm_inv = tuple(self.sperm.index(k) for k in range(3))

    def permute(self, x_cf: torch.Tensor, inverse: bool = False
                ) -> torch.Tensor:
        """A (B, C, *spatial) tensor (a volume, or a conv weight in torch's
        (co, ci, kd, kh, kw) layout) with its spatial axes permuted so that
        image axis ``dim`` comes first (``inverse``: back)."""
        p = self.sperm_inv if inverse else self.sperm
        if p == (0, 1, 2):
            return x_cf
        return x_cf.permute(0, 1, *(2 + k for k in p)).contiguous()

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        return _halo.all_reduce(t, self.group)

    def gather_planes(self, x_local: torch.Tensor) -> torch.Tensor:
        """This rank's slab -> the whole (1, n d, H, W, C) volume on every
        rank."""
        parts = _halo.all_gather(x_local, self.group)  # (n, 1, d, H, W, C)
        return torch.cat(list(parts), dim=1)

    def local_slab(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated (1, D, H, W, C) volume -> this rank's slab."""
        d = x.shape[1] // self.n
        return x[:, self.rank * d:(self.rank + 1) * d].contiguous()


def shard_schedule(d0: int, num_sections: int, n: int) -> List[bool]:
    """Which levels run sharded (module docstring), for an entry depth
    ``d0`` (after conv_in) and the forward's ceil-halving of depths."""
    sharded = []
    d, ok = int(d0), True
    for _ in range(num_sections):
        ok = ok and d % n == 0 and d // n >= 2
        sharded.append(ok)
        ok = ok and (d // n) % 2 == 0
        d = (d - 1) // 2 + 1
    return sharded


def flat_vnet_shardable(image_size: Sequence[int], num_blocks,
                        use_resize: bool, n: int) -> Optional[int]:
    """The image axis whose schedule shards the most levels (level 0 at
    least) over ``n`` ranks, or None (also for a 0-block section, which
    has no chain conv for the residual tap to ride)."""
    if n <= 1 or len(image_size) != 3:
        return None
    if any(int(b) < 1 for b in num_blocks):
        return None
    best_dim, best = None, 0
    for dim in range(3):
        d_img = int(image_size[dim])
        d0 = d_img // 2 + 1 if use_resize else d_img
        sched = shard_schedule(d0, len(num_blocks), n)
        if sched[0] and sum(sched) > best:
            best_dim, best = dim, sum(sched)
    return best_dim
