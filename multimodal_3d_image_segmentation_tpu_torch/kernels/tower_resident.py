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
(D, C, W*HL) layout exists only for the TPU: here the volume is the port's
channels-last (D, H, W, C). The instances are tower_block_s's
(``tower_block.instance`` of x and wcat_stack): fp32; 'bfloat16' (bf16
volume and body weights, the TPU kernel's bf16 serving class); 'mixed'
(bf16 volume, fp32 weights). The fp32 instance runs tower_block's FMA
body in its phase 1; 'bfloat16' and 'mixed' run its tensor-core body
(``csrc/tower_block_mma.cuh``, blocks of 512 threads, one an SM) on the
packed stage matrices (``tower_block.mma_mats``) and one stack of packed
weights (``tower_block.mma_weight_stack``). The operator weights and the
spectra stay fp32 in all three, and block 0's entry spectrum is computed
at the body weights' dtype, as the model's block_s path computes it, so
each instance gives its tower_block_s blocks' bits. The backward, as the
TPU kernel's, is a replay of the reference chain (``resident_tower_plain``)
under autograd.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .tower_block import (_BF16, INSTANCES, MMA_PARTS, TowerSpec,
                          check_cuda_operands, check_kernel_spec, instance,
                          mma_mats, mma_phase_us as _mma_phase_us,
                          mma_weight_stack, spectrum_rows)
from .tower_block_s import (MAX_SPECTRUM_ROWS, _kernel_mats_s,
                            entry_spectrum_s, partial_floats,
                            spectrum_mix_s, tower_block_s_plain)

__all__ = ["resident_tower", "resident_tower_plain", "occupancy",
           "resident_grid", "phase_ms", "PHASES", "z_scratch_shape",
           "mma_phase_us"]

# the kernel's phases, as phase_ms reports them
PHASES = ("body", "depth", "mix", "last_body", "z")


def _entry(x, op_stack, wcat_stack, spec: TowerSpec) -> torch.Tensor:
    """Block 0's spectrum: its operator on the entry spectrum of x,
    computed at the body weights' dtype for a bf16 x."""
    island = wcat_stack.dtype if x.dtype == _BF16 else None
    return spectrum_mix_s(entry_spectrum_s(x, spec, island), op_stack[0],
                          spec)


def resident_tower_plain(x, op_stack, wcat_stack, wcc_stack, b_stack,
                         spec: TowerSpec,
                         acc: torch.dtype = torch.float32) -> torch.Tensor:
    """The tower in torch ops: the kernel's oracle and CPU path (a bf16 x:
    its instance's twin, the blocks summing in ``acc``)."""
    s = _entry(x, op_stack, wcat_stack, spec)
    kw = {} if x.dtype != _BF16 else {"acc": acc}
    for b in range(op_stack.shape[0]):
        x, s_f = tower_block_s_plain(x, s, wcat_stack[b], wcc_stack[b],
                                     b_stack[b], spec, **kw)
        if b + 1 < op_stack.shape[0]:
            s = spectrum_mix_s(s_f, op_stack[b + 1], spec)
    return x


def occupancy(spec: TowerSpec, inst: str = "float32"):
    """(blocks per SM, registers per thread) of the kernel's instance
    ``inst`` at ``spec``'s channels, H and modes, as the CUDA runtime
    reports them."""
    return _build.occupancy("m3seg_tower_resident_occupancy", spec.channels,
                            spec.sizes[1], spec.kh, spec.kw,
                            INSTANCES[inst][0])


def resident_grid(spec: TowerSpec, inst: str = "float32") -> int:
    """Blocks of the persistent grid on the current device: blocks per SM
    times the SM count, as the launch computes it."""
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    return occupancy(spec, inst)[0] * props.multi_processor_count


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


def mma_phase_us(spec: TowerSpec):
    """The tensor-core body's phase clock of this kernel's last 'bfloat16'
    or 'mixed' launch at ``spec``: its last tower block's items, which stop
    at out, so the first two of ``tower_block.MMA_PHASES`` (inverse W,
    inverse H and tail); as ``tower_block.mma_phase_us`` otherwise
    (tower_resident.cu keeps its own clock)."""
    return _mma_phase_us(spec, "m3seg_tower_resident_mma_phase_ns", 2)


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
    instance(x, wcat_stack)
    if (wcc_stack.dtype == _BF16) != (wcat_stack.dtype == _BF16):
        raise TypeError(f"wcc_stack is {wcc_stack.dtype}, wcat_stack "
                        f"{wcat_stack.dtype}")
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if (name not in ("x", "wcat_stack", "wcc_stack")
                and t.dtype not in (torch.float32, torch.float64)):
            raise TypeError(f"{name} must be float32 (or float64 on the "
                            f"CPU), got {t.dtype}")
    return want


def _resident_forward(x, op_stack, wcat_stack, wcc_stack, b_stack,
                      spec: TowerSpec):
    """The kernel on CUDA tensors, ``resident_tower_plain`` on CPU ones
    (the operands' shapes and dtypes already checked)."""
    if x.device.type == "cpu":
        return resident_tower_plain(x, op_stack, wcat_stack, wcc_stack,
                                    b_stack, spec)
    inst = instance(x, wcat_stack)
    check_cuda_operands(x, (("x", x), ("op_stack", op_stack),
                            ("wcat_stack", wcat_stack),
                            ("wcc_stack", wcc_stack), ("b_stack", b_stack)),
                        inst)
    d, h, w = spec.sizes
    c, kh, kw = spec.channels, spec.kh, spec.kw
    ks, nb = spectrum_rows(spec), op_stack.shape[0]
    check_kernel_spec(spec, "tower_resident", inst)
    if ks > MAX_SPECTRUM_ROWS:
        raise ValueError(f"KS={ks} spectrum rows > {MAX_SPECTRUM_ROWS}")
    # block 0's spectrum; the kernel overwrites it with each next block's
    s_cur = _entry(x, op_stack, wcat_stack, spec).contiguous()
    out = torch.empty_like(x)
    tmp = torch.empty_like(x) if nb > 1 else None
    partial = torch.empty(partial_floats(spec, inst, "tower_resident"),
                          dtype=torch.float32, device=x.device)
    z = torch.empty(z_scratch_shape(spec), dtype=torch.float32,
                    device=x.device)
    # mi and mf for the z and depth phases; the bf16 instances' body reads
    # its packed stage matrices and weight stacks, alive until the launch
    mats = _kernel_mats_s(spec, x.device, inst == "bfloat16")
    if inst == "float32":
        mma, wcat, wcc = None, wcat_stack, wcc_stack
    else:
        mma = mma_mats(spec, x.device, MMA_PARTS[inst])
        wcat, wcc = mma_weight_stack(wcat_stack, wcc_stack)
    mode, suffix = INSTANCES[inst]
    _build.launch("tower_resident" + suffix, "m3seg_tower_resident", x.device,
                  x.data_ptr(), s_cur.data_ptr(), op_stack.data_ptr(),
                  wcat.data_ptr(), wcc.data_ptr(), b_stack.data_ptr(),
                  mats.data_ptr(), mma.data_ptr() if mma is not None else None,
                  out.data_ptr(), tmp.data_ptr() if tmp is not None else None,
                  partial.data_ptr(), z.data_ptr(), d, h, w, c, kh, kw, ks,
                  nb, int(spec.transform == "Fourier"), mode)
    return out


class _ResidentTower(torch.autograd.Function):
    """The tower's forward (the kernel, or its plain twin on the CPU); the
    backward is the reference's ``_resident_bwd``: a replay of the whole
    ``resident_tower_plain`` under autograd, which keeps every block's
    intermediates until the gradients are formed."""

    @staticmethod
    def forward(ctx, x, op_stack, wcat_stack, wcc_stack, b_stack, spec):
        ctx.spec = spec
        ctx.save_for_backward(x, op_stack, wcat_stack, wcc_stack, b_stack)
        return _resident_forward(x, op_stack, wcat_stack, wcc_stack,
                                 b_stack, spec)

    @staticmethod
    def backward(ctx, g):
        got = _build.replay_grads(
            lambda *a: resident_tower_plain(*a, ctx.spec),
            ctx.saved_tensors, ctx.needs_input_grad[:5], (g,))
        return (*got, None)


def resident_tower(x, op_stack, wcat_stack, wcc_stack, b_stack,
                   spec: TowerSpec) -> torch.Tensor:
    """The whole tower of B blocks in one launch.

    Args:
        x: (D, H, W, C) block-0 input, channels-last per plane; not
            written. fp32, or bf16 ('bfloat16' and 'mixed').
        op_stack: (B, PR, C, C) fp32 operator weights, (O, I) layout:
            PR = 1 for Hartley (weight), 2 for Fourier (weight_real,
            weight_imag).
        wcat_stack: (B, 2C, C) stacked [conv_branch ; conv_concat-x]; fp32,
            or bf16 with a bf16 x ('bfloat16').
        wcc_stack: (B, C, C) conv_concat matrices of the mixed branch, in
            wcat_stack's dtype.
        b_stack: (B, 2C) fp32 stacked [conv-branch bias or zeros ;
            conv_concat bias].
        spec: ``make_tower_spec``'s description; ``spec.n_ds`` must be 0.

    Returns:
        The tower's output (D, H, W, C) in x's dtype. A CPU tensor runs
        ``resident_tower_plain``; a CUDA tensor launches the kernel's
        instance (contiguous, C in ``SUPPORTED_CHANNELS``, KH at most
        ``MAX_KH``, KS at most ``MAX_SPECTRUM_ROWS``) or raises.
        Differentiable: the backward replays ``resident_tower_plain``.
    """
    ops = _check_operands(spec, x, op_stack, wcat_stack, wcc_stack, b_stack)
    args = (x, op_stack, wcat_stack, wcc_stack, b_stack)
    if _build.needs_grad(*(t for t, _ in ops.values())):
        return _ResidentTower.apply(*args, spec)
    return _resident_forward(*args, spec)
