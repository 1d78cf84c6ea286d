"""What one rank of the port's sharding tests runs
(``parallel/ranks.py::run_ranks`` calls these by name in its spawned
processes, which inherit ``sys.path``). No JAX here: the ranks import only
the port."""
import numpy as np
import torch
import torch.distributed as dist


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def sharded_conv3_case(x, w, b, opts: dict, x2=None):
    """``conv3_sharded`` of this rank's slab of the whole volume ``x`` (and
    ``x2``; numpy, channels-last), with ``opts`` (tensor options as numpy);
    returns the whole volumes gathered (numpy) and the moment sums."""
    from multimodal_3d_image_segmentation_tpu_torch.parallel import (
        ShardCtx, conv3_sharded)
    n, r = dist.get_world_size(), dist.get_rank()
    d = x.shape[1] // n
    kw = {k: (tuple(_t(a) for a in v) if isinstance(v, tuple) else v)
          for k, v in opts.items()}
    out = conv3_sharded(_t(x[:, r * d:(r + 1) * d]), _t(w), _t(b),
                        x2=None if x2 is None else _t(x2[:, r * d:(r + 1) * d]),
                        **kw)
    out = out if isinstance(out, tuple) else (out,)
    n_vol = 2 if opts.get("residual") is not None else 1
    ctx = ShardCtx(None, n)
    return ([ctx.gather_planes(t).numpy() for t in out[:n_vol]]
            + [t.numpy() for t in out[n_vol:]])


def sharded_vnet_case(model_kw: dict, state: dict, x, dim: int):
    """A V-Net-DS (``model_kw``, weights ``state`` as numpy) on the kernel
    path, depth-sharded over the default group along image axis ``dim``,
    on the volume ``x``; returns the probabilities (numpy)."""
    from multimodal_3d_image_segmentation_tpu_torch.models import VNetDS
    model = VNetDS(**model_kw, use_kernels=True,
                   spatial_shard=(None, dist.get_world_size(), dim))
    model.load_state_dict({k: _t(v) for k, v in state.items()})
    with torch.no_grad():
        return model(_t(x)).numpy()


def serve(config_path: str):
    """``runtime/inference.py::run_inference`` of a config file on this
    rank (its ``[parallel]`` section shards it over the group)."""
    from multimodal_3d_image_segmentation_tpu_torch.runtime.config import \
        get_config
    from multimodal_3d_image_segmentation_tpu_torch.runtime.inference import \
        run_inference
    return run_inference(get_config(config_path))
