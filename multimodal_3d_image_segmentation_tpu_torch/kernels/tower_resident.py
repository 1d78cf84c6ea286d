"""The whole NeuralOperatorSeg tower in one launch, the port of
``multimodal_3d_image_segmentation_tpu/kernels/tower_resident.py``.

The tower of B shared-weight blocks (HNOSeg, FNOSeg) from the volume x
(D, H, W, C) to its output: the spectrum of block 0 is block 0's operator
(``spectrum_mix_s``) on the entry spectrum of x (``entry_spectrum_s``);
then each block b is ``tower_block_s`` on (x, s), and block b + 1's
operator mixes the block's folded spectrum into the next s.

``resident_tower`` launches the CUDA kernel (``csrc/tower_resident.cu``)
on CUDA tensors: one cooperative persistent launch for all B blocks, with
grid-wide barriers between a block's z phase (each plane's depth-inverse
pre-image formed once, into a scratch tensor), its body, its depth pass
and the next operator. ``resident_tower_plain`` is the same tower in torch ops (the
reference's ``_reference_chain``, on the resident spectrum). Block 0's
spectrum is built in torch ops before the launch, as the TPU kernel's
caller builds it in XLA (``_prep_s0``). The TPU kernel's lane-padded
(D, C, W*HL) bf16 layout exists only for the TPU: here the volume is the
port's channels-last fp32 (D, H, W, C), and the weights stay fp32 (the TPU
kernel rounds them to bf16). Forward only, as the TPU kernel's backward is
a replay of the reference chain.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .tower_block import (_TILE_W, TowerSpec, check_kernel_spec,
                          spectrum_rows)
from .tower_block_s import (MAX_SPECTRUM_ROWS, _kernel_mats_s,
                            entry_spectrum_s, spectrum_mix_s,
                            tower_block_s_plain)

__all__ = ["resident_tower", "resident_tower_plain", "occupancy",
           "resident_grid", "phase_ms", "PHASES", "z_scratch_shape"]

# the kernel's phases, as phase_ms reports them
PHASES = ("body", "depth", "mix", "last_body", "z")


def resident_tower_plain(x, op_stack, wcat_stack, wcc_stack, b_stack,
                         spec: TowerSpec) -> torch.Tensor:
    """The tower in torch ops: the kernel's oracle and CPU path."""
    s = spectrum_mix_s(entry_spectrum_s(x, spec), op_stack[0], spec)
    for b in range(op_stack.shape[0]):
        x, s_f = tower_block_s_plain(x, s, wcat_stack[b], wcc_stack[b],
                                     b_stack[b], spec)
        if b + 1 < op_stack.shape[0]:
            s = spectrum_mix_s(s_f, op_stack[b + 1], spec)
    return x


def occupancy(spec: TowerSpec):
    """(blocks per SM, registers per thread) of the kernel at ``spec``'s
    channels and modes, as the CUDA runtime reports them."""
    return _build.occupancy("m3seg_tower_resident_occupancy", spec.channels,
                            spec.kh, spec.kw)


def resident_grid(spec: TowerSpec) -> int:
    """Blocks of the persistent grid on the current device: blocks per SM
    times the SM count, as the launch computes it."""
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    return occupancy(spec)[0] * props.multi_processor_count


def z_scratch_shape(spec: TowerSpec):
    """(D, 2, C, KH, KW): the scratch that the kernel's z phase writes each
    plane's depth-inverse pre-image into, once per tower block, and its
    depth pass each plane's tile-summed spectrum."""
    d = spec.sizes[0]
    return (d, 2, spec.channels, spec.kh, spec.kw)


def phase_ms(reset: bool = False) -> dict:
    """Device time in ms of the kernel's phases, summed over its launches
    since the last reset: the block bodies with their forward stages (all
    but the last block's), the depth pass, the operator mix, the last
    block's body, and the z phases (every block's z formed from its
    spectrum). Block 0 reads the card's globaltimer after each grid
    barrier. Waits for the device; ``reset`` sets the sums to 0."""
    buf = (ctypes.c_ulonglong * len(PHASES))()
    _build.call("m3seg_tower_resident_phase_ns",
                ctypes.cast(buf, ctypes.c_void_p), int(reset))
    return {k: v / 1e6 for k, v in zip(PHASES, buf)}


def _check_operands(spec: TowerSpec, x, op_stack, wcat_stack, wcc_stack,
                    b_stack):
    if spec.n_ds:
        raise ValueError(f"the resident tower has no deep supervision "
                         f"(spec.n_ds={spec.n_ds})")
    d, h, w = spec.sizes
    c = spec.channels
    nb = op_stack.shape[0] if op_stack.dim() else 0
    pr = 1 if spec.transform == "Hartley" else 2
    want = {"x": (x, (d, h, w, c)), "op_stack": (op_stack, (nb, pr, c, c)),
            "wcat_stack": (wcat_stack, (nb, 2 * c, c)),
            "wcc_stack": (wcc_stack, (nb, c, c)),
            "b_stack": (b_stack, (nb, 2 * c))}
    if nb < 1:
        raise ValueError("op_stack holds no block")
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{name} must be float32 (or float64 on the "
                            f"CPU), got {t.dtype}")
    return want


def resident_tower(x, op_stack, wcat_stack, wcc_stack, b_stack,
                   spec: TowerSpec) -> torch.Tensor:
    """The whole tower of B blocks in one launch.

    Args:
        x: (D, H, W, C) block-0 input, channels-last per plane; not written.
        op_stack: (B, PR, C, C) operator weights, (O, I) layout: PR = 1
            for Hartley (weight), 2 for Fourier (weight_real,
            weight_imag).
        wcat_stack: (B, 2C, C) stacked [conv_branch ; conv_concat-x].
        wcc_stack: (B, C, C) conv_concat matrices of the mixed branch.
        b_stack: (B, 2C) stacked [conv-branch bias or zeros ; conv_concat
            bias].
        spec: ``make_tower_spec``'s description; ``spec.n_ds`` must be 0.

    Returns:
        The tower's output (D, H, W, C). A CPU tensor runs
        ``resident_tower_plain``; a CUDA tensor launches the kernel (fp32,
        contiguous, C in ``SUPPORTED_CHANNELS``, KH at most ``MAX_KH``,
        KS at most ``MAX_SPECTRUM_ROWS``) or raises. Forward only.
    """
    ops = _check_operands(spec, x, op_stack, wcat_stack, wcc_stack, b_stack)
    if x.device.type == "cpu":
        return resident_tower_plain(x, op_stack, wcat_stack, wcc_stack,
                                    b_stack, spec)
    for name, (t, shape) in ops.items():
        _build.check_cuda_input(name, t, x.device, len(shape))
    _build.check_forward_only(*(t for t, _ in ops.values()))
    d, h, w = spec.sizes
    c, kh, kw = spec.channels, spec.kh, spec.kw
    ks, nb = spectrum_rows(spec), op_stack.shape[0]
    check_kernel_spec(spec, "tower_resident")
    if ks > MAX_SPECTRUM_ROWS:
        raise ValueError(f"KS={ks} spectrum rows > {MAX_SPECTRUM_ROWS}")
    # block 0's spectrum; the kernel overwrites it with each next block's
    s_cur = spectrum_mix_s(entry_spectrum_s(x, spec), op_stack[0],
                           spec).contiguous()
    out = torch.empty_like(x)
    tmp = torch.empty_like(x) if nb > 1 else None
    ng = c * kh * kw
    partial = torch.empty(d * -(-w // _TILE_W) * 2 * ng + ks * ng,
                          dtype=torch.float32, device=x.device)
    z = torch.empty(z_scratch_shape(spec), dtype=torch.float32,
                    device=x.device)
    mats = _kernel_mats_s(spec, x.device)
    _build.launch("tower_resident", "m3seg_tower_resident", x.device,
                  x.data_ptr(), s_cur.data_ptr(), op_stack.data_ptr(),
                  wcat_stack.data_ptr(), wcc_stack.data_ptr(),
                  b_stack.data_ptr(), mats.data_ptr(), out.data_ptr(),
                  tmp.data_ptr() if tmp is not None else None,
                  partial.data_ptr(), z.data_ptr(), d, h, w, c, kh, kw, ks,
                  nb, int(spec.transform == "Fourier"))
    return out
