"""PyTorch + CUDA port of the serving paths of HNOSeg-XS, V-Net-DS,
HartleyMHASeg and NeuralOperatorSeg (HNOSeg / FNOSeg).

Mirrors the module layout of :mod:`multimodal_3d_image_segmentation_tpu`
(the JAX/Pallas reference) so each counterpart is found under the same
relative path. The port imports ``torch`` and never ``jax``, nor any
module of the reference package: its host side (``data/``: NIfTI IO, the
test-split flow, normalization) is its own.

Kernels written by hand for Hopper (``csrc/*.cu``) replace the Pallas
kernels on the serving paths: the fused input conv (``kernels/conv_in.py``),
the frequency-resident chain (``kernels/freq_chain.py``), the fused
resize + softmax output tail (``kernels/tail_resize.py``), the k=3 conv
(``kernels/conv3.py``) and the fused tower blocks (``kernels/tower_block.py``,
``kernels/tower_block_s.py``). Each wrapper runs its plain PyTorch version
for CPU tensors and launches its CUDA kernel for CUDA tensors.
"""

__version__ = "0.1.0"


def not_ported(what: str, roadmap_item: int):
    """Raise for an option of the reference that the port does not cover
    yet, naming the ROADMAP queue item (Open items, section 1) that ports
    it."""
    raise NotImplementedError(
        f"{what}: not ported yet (ROADMAP.md, Open items 1, item "
        f"{roadmap_item})")
