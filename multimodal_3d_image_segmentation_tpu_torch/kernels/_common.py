"""SELU constants of the CUDA kernels (``csrc/common.cuh`` carries the same
values), the port of ``multimodal_3d_image_segmentation_tpu/kernels/
_common.py``. They are PyTorch's and JAX's SELU constants, so the plain
versions use ``torch.selu`` itself. Also the rule by which the kernels with
a 'bfloat16' and a 'mixed' instance (conv3 and the tower kernels) pick one
from their operands' dtypes."""
import torch

SELU_SCALE = 1.0507009873554804934193349852946
SELU_ALPHA = 1.6732632423543772848170429916717


def instance(x: torch.Tensor, w: torch.Tensor) -> str:
    """The instance of a volume ``x`` and weights ``w``: 'float32' (both
    fp32, or float64 on the CPU), 'bfloat16' (both bf16) or 'mixed' (x bf16,
    w fp32)."""
    wide = (torch.float32, torch.float64)
    if x.dtype in wide and w.dtype in wide:
        return "float32"
    if x.dtype == torch.bfloat16 and w.dtype in (torch.bfloat16,
                                                 torch.float32):
        return "bfloat16" if w.dtype == torch.bfloat16 else "mixed"
    raise TypeError(f"the kernels take x and the weights float32, both "
                    f"bfloat16, or x bfloat16 with float32 weights; got "
                    f"{x.dtype} and {w.dtype}")
