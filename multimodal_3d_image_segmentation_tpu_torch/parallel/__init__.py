"""Depth-sharded serving over ``torch.distributed``, the port of
``multimodal_3d_image_segmentation_tpu/parallel/``: the process layout
(``mesh.py``), the process-group set-up (``multihost.py``), the sharded
k=3 conv (``halo.py``) and the sharded V-Net-DS (``flat_sharded.py``);
``ranks.py`` runs a function on the ranks of a gloo process group."""
from .flat_sharded import (ShardCtx, flat_vnet_shardable,  # noqa: F401
                           shard_schedule)
from .halo import conv3_sharded, halo_exchange  # noqa: F401
from .mesh import make_mesh  # noqa: F401
from .multihost import initialize  # noqa: F401
