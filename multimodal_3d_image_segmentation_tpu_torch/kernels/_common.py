"""SELU constants of the CUDA kernels (``csrc/common.cuh`` carries the same
values), the port of ``multimodal_3d_image_segmentation_tpu/kernels/
_common.py``. They are PyTorch's and JAX's SELU constants, so the plain
versions use ``torch.selu`` itself."""

SELU_SCALE = 1.0507009873554804934193349852946
SELU_ALPHA = 1.6732632423543772848170429916717
