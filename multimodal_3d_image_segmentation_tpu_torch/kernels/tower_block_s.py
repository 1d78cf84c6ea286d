"""Fused tower block with the depth stages inside the kernel, the port of
``multimodal_3d_image_segmentation_tpu/kernels/tower_block_s.py``.

Between blocks the tower carries one small resident packed spectrum
(KS, C, KH, KW) fp32 (Hartley: KS = KD, real; Fourier: KS = 2 * KD,
[re; im]) instead of per-plane spectra. One block, per depth plane d::

    z[d]  = sum_s mi[d, :, s] * sy[s]           inverse depth stage
    out[d], f[d] (, ds[d]) = the tower_block body on (x[d], z[d])
    s_f   = sum_d sum_q mf[d, q, :] * f[d, q]   forward depth stage

``fused_tower_block_s`` launches the CUDA kernel (``csrc/tower_block_s.cu``)
on CUDA tensors: z and f never cross device memory. ``tower_block_s_plain``
is the same block in torch ops (the reference's ``_block_reference_s``: the
depth-inverse einsum, ``tower_block_plain``, ``d_stage_forward``). Between
kernels the operator mixes the resident spectrum (``spectrum_mix_s``); the
tower's entry is ``entry_spectrum_s``. Under autograd the block is a
``torch.autograd.Function`` whose backward is the reference's
``_fused_bwd_s``: a replay of ``tower_block_s_plain``.

The specs and matrices are ``kernels/tower_block.py``'s: the port has no
lane padding, so ``make_tower_spec_s`` is ``make_tower_spec``, and the
depth matrices mi = ``d_inv`` and mf = ``d_fwd`` are (D, 2, KS), one row
per plane. The instances are tower_block's (``instance``); the resident
spectrum sy and s_f stay fp32 in all three. In 'bfloat16' the depth
stages' operands are bf16 values too, as the TPU kernel's two depth dots
take them: sy, mi, f and mf are rounded to bf16 and the sums stay fp32.
The fp32 instance runs tower_block's FMA body on tiles of 8 columns; the
'bfloat16' and 'mixed' instances run its tensor-core body
(``csrc/tower_block_mma.cuh``) on tiles of 16, on the stage matrices and
weights packed as tower_block packs them (``mma_mats``, ``mma_weights``),
between the same z pass, tile sum and depth pass. The TPU kernel's probe
of a Mosaic miscompile (``_hw_probe_ok``) has no counterpart here:
``chip_smoke.py`` holds the kernel against the plain version on the card.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from . import _build
from .tower_block import (_BF16, INSTANCES, MAX_DS_ROWS, MMA_PARTS,
                          MMA_TILE_W, _TILE_W, TowerSpec, _buffer,
                          _check_operands, _kernel_mats, _operands,
                          _plain_mats, _spec_mats, _stage,
                          _tower_block_plain_bf16, check_cuda_operands,
                          check_kernel_spec, d_stage_forward,
                          entry_forward_hw, instance, make_tower_spec,
                          mma_mats, mma_phase_us as _mma_phase_us,
                          mma_weights, spectrum_mix, spectrum_rows,
                          tower_block_plain)

__all__ = ["make_tower_spec_s", "fused_tower_block_s", "tower_block_s_plain",
           "spectrum_mix_s", "entry_spectrum_s", "occupancy", "tile_width",
           "partial_floats", "mma_phase_us", "MAX_SPECTRUM_ROWS"]

MAX_SPECTRUM_ROWS = 64  # csrc/tower_spectrum.cuh kMaxKS
_DEPTH_ROWS = 4         # csrc/tower_spectrum.cuh kDepthRows

make_tower_spec_s = make_tower_spec
# the resident spectrum has d_stage_forward's (KS, C, KH, KW) layout
spectrum_mix_s = spectrum_mix


def entry_spectrum_s(x: torch.Tensor, spec: TowerSpec,
                     island: Optional[torch.dtype] = None) -> torch.Tensor:
    """Tower entry: the forward H/W stages of the volume (D, H, W, C) in
    the island dtype ``island`` (default x's), then the depth stage in
    fp32 at least, straight to the resident spectrum (KS, C, KH, KW)."""
    return d_stage_forward(entry_forward_hw(x, spec, island), spec)


def tower_block_s_plain(x, sy, w_cat, w_cc_t, b_cat, spec: TowerSpec,
                        ds_prev: Optional[torch.Tensor] = None,
                        acc: torch.dtype = torch.float32,
                        unrounded=frozenset()):
    """The block in torch ops: the kernel's oracle and CPU path. A bf16 x
    runs the twin of its instance (``tower_block_plain``), summing in
    ``acc``, with the depth stages' operands sy and f rounded as the kernel
    rounds them ('bfloat16'); ``unrounded`` leaves out roundings of
    ("sy",) + ``tower_block.ROUNDINGS`` (the controls)."""
    if x.dtype == _BF16:
        rounded = w_cat.dtype == _BF16
        op_sy, op_f = (_operands(rounded and k not in unrounded, acc)
                       for k in ("sy", "f"))
        mats = _plain_mats(spec, x.device, rounded, acc)
        z = torch.einsum("dqk,kcxy->dqcxy", mats("d_inv"), op_sy(sy))
        res = _tower_block_plain_bf16(x, z, w_cat, w_cc_t, b_cat, spec,
                                      ds_prev, acc, unrounded)
        s_f = torch.einsum("dqcxy,dqk->kcxy", op_f(res[1]), mats("d_fwd"))
        return (res[0], s_f.float()) + tuple(res[2:])
    mi = _stage(spec, "d_inv", x.device, x.dtype)
    z = torch.einsum("dqk,kcxy->dqcxy", mi, sy.to(x.dtype))
    res = tower_block_plain(x, z, w_cat, w_cc_t, b_cat, spec, ds_prev)
    return (res[0], d_stage_forward(res[1], spec)) + tuple(res[2:])


def _pack_depth_rows(mf: np.ndarray) -> np.ndarray:
    """mf (D, 2, KS) as the depth pass reads it: (ceil(KS / 4), D, 2, 4),
    four spectrum rows of a plane and component as one float4, the rows
    past KS zero."""
    d, _, ks = mf.shape
    n = -(-ks // _DEPTH_ROWS)
    padded = np.zeros((d, 2, n * _DEPTH_ROWS), np.float32)
    padded[:, :, :ks] = mf
    return padded.reshape(d, 2, n, _DEPTH_ROWS).transpose(2, 0, 1, 3)


@functools.lru_cache(maxsize=None)
def _kernel_mats_s(spec: TowerSpec, device: torch.device,
                   rounded: bool = False) -> torch.Tensor:
    """tower_block's stage-matrix buffer followed by mi (D, 2, KS) and mf
    packed by ``_pack_depth_rows``, fp32 (bf16-rounded values where
    ``rounded``), packed once per spec and device."""
    m = _spec_mats(spec)
    depth = _buffer([np.asarray(m["d_inv"], np.float32),
                     _pack_depth_rows(np.asarray(m["d_fwd"], np.float32))],
                    device, rounded)
    with torch.inference_mode(False):  # see ops/spectral.py::_stage_tensor
        return torch.cat([_kernel_mats(spec, device, rounded), depth])


def tile_width(inst: str) -> int:
    """Columns of W a block of the tower bodies takes in instance ``inst``:
    the FMA body's 8 ('float32'), the tensor-core body's 16."""
    return _TILE_W if inst == "float32" else MMA_TILE_W


def partial_floats(spec: TowerSpec, inst: str,
                   kernel: str = "tower_block_s") -> int:
    """fp32 floats of the ``partial`` scratch of ``kernel`` in instance
    ``inst``: one partial spectrum (2, C, KH, KW) per plane and W tile of
    ``tile_width(inst)`` columns, then tower_block_s's z and f (D, 2, C,
    KH, KW) or tower_resident's folded spectrum s_f (KS, C, KH, KW)."""
    d, _, w = spec.sizes
    ng = spec.channels * spec.kh * spec.kw
    tiles = d * -(-w // tile_width(inst)) * 2 * ng
    if kernel == "tower_block_s":
        return tiles + d * 2 * ng
    if kernel == "tower_resident":
        return tiles + spectrum_rows(spec) * ng
    raise ValueError(f"no partial scratch for {kernel!r}")


def occupancy(spec: TowerSpec, inst: str = "float32"):
    """(blocks per SM, registers per thread) of the kernel's instance
    ``inst`` at ``spec``'s channels, H, modes and ds rows, as the CUDA
    runtime reports them."""
    return _build.occupancy("m3seg_tower_block_s_occupancy", spec.channels,
                            spec.sizes[1], spec.kh, spec.kw, spec.n_ds,
                            INSTANCES[inst][0])


def mma_phase_us(spec: TowerSpec):
    """The tensor-core body's phase clock of this kernel's last
    'bfloat16' or 'mixed' launch at ``spec`` (``tower_block.mma_phase_us``;
    tower_block_s.cu keeps its own clock)."""
    return _mma_phase_us(spec, "m3seg_tower_block_s_phase_ns")


def _tower_block_s_forward(x, sy, w_cat, w_cc_t, b_cat, spec: TowerSpec,
                           ds_prev):
    """The kernel on CUDA tensors, ``tower_block_s_plain`` on CPU ones (the
    operands' shapes and dtypes already checked)."""
    if x.device.type == "cpu":
        return tower_block_s_plain(x, sy, w_cat, w_cc_t, b_cat, spec,
                                   ds_prev)
    ks = spectrum_rows(spec)
    d, h, w = spec.sizes
    c, kh, kw, n_ds = spec.channels, spec.kh, spec.kw, spec.n_ds
    inst = instance(x, w_cat)
    check_cuda_operands(x, (("x", x), ("sy", sy), ("w_cat", w_cat),
                            ("w_cc_t", w_cc_t), ("b_cat", b_cat),
                            ("ds_prev", ds_prev)), inst)
    check_kernel_spec(spec, "tower_block_s", inst)
    if n_ds > MAX_DS_ROWS:
        raise ValueError(f"n_ds={n_ds} > {MAX_DS_ROWS}")
    if ks > MAX_SPECTRUM_ROWS:
        raise ValueError(f"KS={ks} spectrum rows > {MAX_SPECTRUM_ROWS}")
    out = torch.empty_like(x)
    s_f = torch.empty((ks, c, kh, kw), dtype=torch.float32, device=x.device)
    ds = (torch.empty((d, h, w, n_ds), dtype=torch.float32, device=x.device)
          if n_ds else None)
    # per (plane, W-tile) partial spectra, then each plane's z, which the
    # tile sum overwrites with f: the passes after the body fold them into
    # s_f through the depth forward stage in a fixed order
    partial = torch.empty(partial_floats(spec, inst), dtype=torch.float32,
                          device=x.device)
    # mi and mf for the passes; the bf16 instances' body reads its packed
    # stage matrices and weights, alive until the launch
    mats = _kernel_mats_s(spec, x.device, inst == "bfloat16")
    if inst == "float32":
        mma, wcat, wcc = None, w_cat, w_cc_t
    else:
        mma = mma_mats(spec, x.device, MMA_PARTS[inst])
        wcat, wcc = mma_weights(w_cat, w_cc_t)
    mode, suffix = INSTANCES[inst]
    _build.launch("tower_block_s" + suffix, "m3seg_tower_block_s", x.device,
                  x.data_ptr(), sy.data_ptr(), wcat.data_ptr(),
                  wcc.data_ptr(), b_cat.data_ptr(), mats.data_ptr(),
                  mma.data_ptr() if mma is not None else None,
                  ds_prev.data_ptr() if n_ds else None, out.data_ptr(),
                  s_f.data_ptr(), ds.data_ptr() if n_ds else None,
                  partial.data_ptr(), d, h, w, c, kh, kw, n_ds, ks, mode)
    return (out, s_f, ds) if n_ds else (out, s_f)


class _TowerBlockS(torch.autograd.Function):
    """The block's forward (the kernel, or its plain twin on the CPU); the
    backward is the reference's ``_fused_bwd_s``: a replay of
    ``tower_block_s_plain`` under autograd, the gradient of the resident
    spectrum sy included. ds_prev's gradient is the ds cotangent, as in
    ``tower_block._TowerBlock``."""

    @staticmethod
    def forward(ctx, x, sy, w_cat, w_cc_t, b_cat, ds_prev, spec):
        ctx.spec = spec
        ctx.set_materialize_grads(False)  # s_f after the last block: None
        ctx.save_for_backward(x, sy, w_cat, w_cc_t, b_cat)
        return _tower_block_s_forward(x, sy, w_cat, w_cc_t, b_cat, spec,
                                      ds_prev)

    @staticmethod
    def backward(ctx, *grads):
        spec = ctx.spec
        zero = ctx.saved_tensors[0].new_zeros(()) if spec.n_ds else None
        got = _build.replay_grads(
            lambda *a: tower_block_s_plain(*a, spec, zero),
            ctx.saved_tensors, ctx.needs_input_grad[:5], grads)
        g_ds = grads[2] if spec.n_ds and ctx.needs_input_grad[5] else None
        return (*got, g_ds, None)


def fused_tower_block_s(x, sy, w_cat, w_cc_t, b_cat, spec: TowerSpec,
                        ds_prev: Optional[torch.Tensor] = None):
    """One fused tower block on the resident spectrum: (x, sy) -> (out,
    s_f[, ds]).

    Args:
        x: (D, H, W, C) block input, channels-last per plane; fp32 or bf16.
        sy: (KS, C, KH, KW) fp32 resident spectrum after the block's
            operator (``spectrum_mix_s`` of the previous s_f, or of
            ``entry_spectrum_s`` for the first block).
        w_cat, w_cc_t, b_cat, spec, ds_prev: as ``fused_tower_block``.

    Returns:
        out (D, H, W, C) in x's dtype; s_f (KS, C, KH, KW) fp32, the
        packed spectrum of out; and, when ``spec.n_ds``, ds = ds_prev + the
        bias-free deep-supervision projection of x, fp32. A CPU tensor runs
        ``tower_block_s_plain``; a CUDA tensor launches the kernel's
        instance (``instance``; contiguous, C in ``SUPPORTED_CHANNELS``)
        or raises.
        Differentiable: the backward replays ``tower_block_s_plain``.
    """
    ops = _check_operands(spec, x, w_cat, w_cc_t, b_cat, ds_prev,
                          sy=(sy, (spectrum_rows(spec), spec.channels,
                                   spec.kh, spec.kw)))
    if _build.needs_grad(*(t for t, _ in ops.values())):
        return _TowerBlockS.apply(x, sy, w_cat, w_cc_t, b_cat, ds_prev, spec)
    return _tower_block_s_forward(x, sy, w_cat, w_cc_t, b_cat, spec,
                                  ds_prev)
