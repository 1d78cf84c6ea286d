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
pass on fp32 activations) raises (ROADMAP item 12).

The bf16 modes are opt-in per model, never a process-wide default:
``[model] compute_dtype = 'bfloat16'`` or ``'mixed'`` (HNOSeg-XS,
HartleyMHASeg, HNOSeg and FNOSeg, serving only;
``ops/spectral.compute_dtypes``). Their bf16 products accumulate in
fp32: cuBLAS's reduced-precision bf16 reductions are pinned off here too.
The trained-network Dice gate (``utils/precision_gate.py``) reports how far
each mode is from the fp32 oracle; the default stays exact fp32.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "check_transform_precision",
           "TRANSFORM_PRECISIONS"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

TRANSFORM_PRECISIONS = ("high", "highest")


def check_transform_precision(mode: str) -> None:
    """Accept the fp32 transform-precision names that map to exact fp32."""
    if mode not in TRANSFORM_PRECISIONS:
        raise ValueError(
            f"transform_precision {mode!r} is not served by the port: "
            f"{TRANSFORM_PRECISIONS} both run exact fp32; 'default' is not "
            f"ported yet (ROADMAP Open items 1, item 12); bf16 serving is "
            f"[model] compute_dtype")


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
