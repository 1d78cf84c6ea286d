"""Device selection and the fp32 precision policy.

The reference's fp32 contract is exact fp32 arithmetic in every matrix
product (``ops/spectral.py`` PRECISION, HIGHEST by default). On the GPU
two PyTorch defaults would break it: cuDNN convolutions run in TF32 unless
told otherwise, and ``allow_tf32`` on matmuls is one flag away. Both are
pinned off here, once, when the module is imported; every module of the
port that does arithmetic imports this one.

The reference's serving knob ``transform_precision`` takes 'highest'
(bf16x6 on the TPU, fp32-exact) or 'high' (bf16x3). The port maps both to
exact fp32, which is at least as strict as either. 'default' (one bf16
pass) has no fp32-exact meaning and raises: faster modes wait for the
trained-network Dice gate (ROADMAP, Constraints).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "check_transform_precision",
           "TRANSFORM_PRECISIONS"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TRANSFORM_PRECISIONS = ("high", "highest")


def check_transform_precision(mode: str) -> None:
    """Accept the fp32 transform-precision names that map to exact fp32."""
    if mode not in TRANSFORM_PRECISIONS:
        raise ValueError(
            f"transform_precision {mode!r} is not served by the port: "
            f"{TRANSFORM_PRECISIONS} both run exact fp32; faster modes wait "
            f"for the Dice gate (ROADMAP Open items 1, item 12)")


def resolve_device(visible_devices: Optional[Union[str, int, torch.device]]
                   = None) -> torch.device:
    """``[main] visible_devices`` -> ``cuda:<i>``. The CPU serves only when
    the caller asks for it: ``'cpu'`` or ``torch.device('cpu')``. Without
    CUDA any other value raises, so a run meant for the card never falls
    back to the CPU unnoticed. A malformed or out-of-range index raises."""
    if isinstance(visible_devices, torch.device):
        if visible_devices.type == "cpu":
            return visible_devices
        visible_devices = visible_devices.index
    if str(visible_devices).strip().lower() == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"visible_devices={visible_devices!r} needs CUDA, which is not "
            "available; set visible_devices = 'cpu' to run on the CPU")
    idx = 0 if visible_devices is None else int(str(visible_devices).strip())
    if not 0 <= idx < torch.cuda.device_count():
        raise ValueError(f"visible_devices={idx} out of range for "
                         f"{torch.cuda.device_count()} CUDA device(s)")
    return torch.device(f"cuda:{idx}")
