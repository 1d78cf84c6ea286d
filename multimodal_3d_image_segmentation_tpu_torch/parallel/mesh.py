"""The (data, spatial) process layout, the port of
``multimodal_3d_image_segmentation_tpu/parallel/mesh.py``.

The JAX package lays its devices out as a 2D mesh: a ``data`` axis of
batch parallelism and a ``spatial`` axis that splits one volume. Here the
ranks of ``torch.distributed`` take that place. The port serves the
spatial axis over every rank of the default process group
(``parallel/flat_sharded.py``); a data axis above 1 (data parallelism,
DDP) is not ported yet, so the layout is the one number ``n_spatial``.
"""
from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from .. import not_ported

__all__ = ["make_mesh"]


def make_mesh(n_data: Optional[int] = None, n_spatial: int = 1) -> int:
    """Check the (data, spatial) layout against the ranks of the default
    process group (one rank when ``torch.distributed`` is not initialized)
    and return ``n_spatial``. ``n_data`` defaults to ranks // n_spatial;
    only 1 is served."""
    ranks = dist.get_world_size() if dist.is_initialized() else 1
    n_spatial = int(n_spatial)
    if n_spatial < 1 or ranks % n_spatial:
        raise ValueError(f"n_spatial={n_spatial} does not divide the "
                         f"{ranks} rank(s)")
    if n_data is None:
        n_data = ranks // n_spatial
    if int(n_data) != 1:
        not_ported(f"[parallel] n_data = {n_data} (data parallelism)", 15)
    if n_spatial != ranks:
        raise ValueError(f"[parallel] n_spatial = {n_spatial} needs as many "
                         f"ranks; the process group has {ranks} (start "
                         f"them with torch.distributed.run --nproc-per-node "
                         f"{n_spatial})")
    return n_spatial
