"""The tower kernels' tensor-core body ('bfloat16' and 'mixed',
``csrc/tower_block_mma.cuh``) emulated in torch ops from its packed
matrices, for the CPU tests of the three kernels that run it
(``tests/test_torch_tower_mma.py``: tower_block;
``tests/test_torch_tower_mma_s.py``: tower_block_s and tower_resident).

The emulation follows the kernel's arithmetic: each product in k steps of
16 (a last one of 8 where K is not a multiple of 16), each step's sum in
fp32 (in 'mixed' the leading parts' product and the smaller parts'
products apart) and the steps added in order; operands rounded to bf16
where the kernel rounds them ('bfloat16': z, y, t, F), or split into three
bf16 parts ('mixed'); the partial spectra of the W tiles summed in tile
order. tower_block_s's passes around the body: the z pass over s
ascending, the tile sum rounded to bf16 values in 'bfloat16', the depth
pass over 8 plane groups in plane order and the groups in group order.
It differs from the kernels in the order of the sums inside a k step, in
fmaf against a multiply and an add, and in SELU's last ulps (torch's
expm1 here).
"""
import numpy as np
import torch

from multimodal_3d_image_segmentation_tpu_torch.kernels import \
    tower_block as tb
from multimodal_3d_image_segmentation_tpu_torch.kernels import \
    tower_block_s as tbs
from multimodal_3d_image_segmentation_tpu_torch.kernels import \
    tower_resident as tr

BF16 = torch.bfloat16
BF16_ULP = 2.0 ** -7
CPU = torch.device("cpu")
TW = tb.MMA_TILE_W
DEPTH_GROUPS = 8  # csrc/tower_spectrum.cuh kDepthGroups


def _unpack_a(f, m, k):
    """A fragments (M/16, K/16, 8, 4, 2, 2, 2) -> the (m, k) matrix."""
    mt, ks = f.shape[:2]
    return f.permute(0, 5, 2, 1, 4, 3, 6).reshape(16 * mt, 16 * ks)[:m, :k]


def _unpack_b(f, k, n):
    """B fragments (K/16, N/8, 8, 4, 2, 2) -> the (k, n) matrix."""
    ks, nt = f.shape[:2]
    return f.permute(0, 4, 3, 5, 1, 2).reshape(16 * ks, 8 * nt)[:k, :n]


def _stage_parts(spec, passes):
    """The packed stage-matrix buffer split back into its four parts:
    [tile][pass] inverse W A (2TW, 2kwp); [pass] inverse H A (16 nht,
    kih); [pass] forward H A (2KH, 16 nht); [tile][pass] forward W B (2TW,
    2kwp); the C side's sizes (``mma_mats`` in ``tower_block_mma.cuh``)."""
    g = tb.mma_geom(spec)
    ksw, ksih, ntf = 2 * g.kwp // 16, -(-g.kih // 16), 2 * g.kwp // 8
    hp, kh = 16 * g.nht, spec.kh
    sizes = [g.n_tiles * passes * 2 * ksw * 256,
             passes * g.nht * ksih * 256, passes * g.mth * g.nht * 256,
             g.n_tiles * passes * 2 * ntf * 128]
    buf = tb.mma_mats(spec, CPU, passes)
    assert buf.dtype == BF16 and buf.numel() == sum(sizes)
    iw, ih, fh, fw = torch.split(buf, sizes)
    iw = iw.view(g.n_tiles, passes, 2, ksw, 8, 4, 2, 2, 2)
    ih = ih.view(passes, g.nht, ksih, 8, 4, 2, 2, 2)
    fh = fh.view(passes, g.mth, g.nht, 8, 4, 2, 2, 2)
    fw = fw.view(g.n_tiles, passes, 2, ntf, 8, 4, 2, 2)
    return ([[_unpack_a(p, 2 * TW, 2 * g.kwp).float() for p in t]
             for t in iw],
            [_unpack_a(p, hp, g.kih).float() for p in ih],
            [_unpack_a(p, 2 * kh, hp).float() for p in fh],
            [[_unpack_b(p, 2 * TW, 2 * g.kwp).float() for p in t]
             for t in fw])


def _split(v, passes):
    """An fp32 operand's parts: rounded to bf16, or its three parts (each
    the rounding of what the parts before leave)."""
    parts = []
    for _ in range(passes):
        parts.append(v.to(BF16).float())
        v = v - parts[-1]
    return parts


def _mm(a, b):
    """sum over the terms a_i @ b_j with i + j below the larger number of
    parts, batched, in k steps of 16 along the contraction (the last of 8
    where K is not a multiple of 16), each step's leading term (i = j = 0)
    and its other terms summed in fp32 apart and added in order."""
    k = a[0].shape[-1]
    n = max(len(a), len(b))
    terms = [(i, j) for i in range(len(a)) for j in range(len(b))
             if 0 < i + j < n]
    out = 0.0
    for k0 in range(0, k, 16):
        out = out + a[0][..., k0:k0 + 16] @ b[0][..., k0:k0 + 16, :]
        if terms:
            out = out + sum(a[i][..., k0:k0 + 16] @ b[j][..., k0:k0 + 16, :]
                            for i, j in terms)
    return out


def _emulate(x, z, w_cat, w_cc_t, b_cat, spec, ds_prev):
    """The tensor-core body's formulation in torch ops from its packed
    matrices: (out bf16, f bf16 or fp32[, ds])."""
    passes = tb.MMA_PARTS["bfloat16" if w_cat.dtype == BF16 else "mixed"]
    d, h, w = spec.sizes
    c, kh, kw, n_ds = spec.channels, spec.kh, spec.kw, spec.n_ds
    g = tb.mma_geom(spec)
    hp = 16 * g.nht
    iw, ih, fh, fw = _stage_parts(spec, passes)
    wcat_f, wcc_f = tb.mma_weights(w_cat, w_cc_t)
    wcat = [_unpack_b(p, c, 2 * c + n_ds).float() for p in wcat_f]
    wcc = [_unpack_b(p, c, c).float() for p in wcc_f]
    # z rows (c, k) x [re j | im j], each part padded to kwp
    zr = torch.zeros(d, c * kh, 2 * g.kwp)
    zr[..., :kw] = z[:, 0].reshape(d, c * kh, kw)
    zr[..., g.kwp:g.kwp + kw] = z[:, 1].reshape(d, c * kh, kw)
    zt = [p.transpose(1, 2) for p in _split(zr, passes)]
    bias = b_cat.float()
    out = torch.zeros(d, h, w, c)
    f = 0.0
    for t in range(g.n_tiles):
        w0, nw = t * TW, min(TW, w - t * TW)
        # inverse W: (d, 2TW, C KH) -> y[d][w][(part, k)][c], padded to kih
        y = _mm([a[None] for a in iw[t]], zt)
        y = y.reshape(d, 2, TW, c, kh).permute(0, 2, 1, 4, 3).reshape(
            d, TW, 2 * kh, c)
        y = torch.nn.functional.pad(y, (0, 0, 0, g.kih - 2 * kh))
        y1 = _mm([a[None, None] for a in ih], _split(y, passes))
        y1 = y1[:, :nw, :h].permute(0, 2, 1, 3)              # (d, h, nw, c)
        xt = x.float()[:, :, w0:w0 + nw]
        pq = _mm([xt], [p[None, None] for p in wcat])
        tt = torch.selu(y1 + (pq[..., :c] + bias[:c]))
        s = _mm(_split(tt, passes), [p[None, None] for p in wcc])
        o = torch.selu(s + (pq[..., c:2 * c] + bias[c:])).to(BF16).float()
        out[:, :, w0:w0 + nw] = o
        if n_ds:
            ds_t = ds_prev[:, :, w0:w0 + nw] + pq[..., 2 * c:]
            ds = ds_t if t == 0 else torch.cat([ds, ds_t], 2)
        # forward H per column: (d, nw, 2KH, C), rows past H zero
        ob = torch.zeros(d, TW, hp, c)
        ob[:, :nw, :h] = o.permute(0, 2, 1, 3)
        big_f = _mm([a[None, None] for a in fh], [ob])       # (d, TW, 2KH, C)
        big_f = big_f.reshape(d, TW, 2, kh, c).permute(0, 4, 3, 2, 1)
        big_f = big_f.reshape(d, c * kh, 2 * TW)  # [(c, k)][(part, w)]
        part = _mm(_split(big_f, passes), [b[None] for b in fw[t]])
        part = part.reshape(d, c, kh, 2, g.kwp)[..., :kw].permute(
            0, 3, 1, 2, 4)
        f = f + part                                         # in tile order
    f = f.to(BF16) if passes == 1 else f
    out = out.to(BF16)
    return (out, f, ds) if n_ds else (out, f)


def _twin_held(got, want):
    """``chip_smoke.py``'s ``_tower_tol`` bars, output by output."""
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        gf, wf = g.float(), w.float()
        d, scale = (gf - wf).abs(), float(wf.abs().max())
        if g.dtype == torch.float32:
            assert float(d.max()) <= 1e-4 * scale, (float(d.max()), scale)
            continue
        atol = 1e-5 + BF16_ULP * max(1.0, scale)
        assert float((d - BF16_ULP * wf.abs()).max()) <= atol
        mag = torch.maximum(gf.abs(), wf.abs()).clamp_min(2.0 ** -126)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        assert float((d > ulp + 1e-5).float().mean()) <= 1e-3


def emulate_block_s(x, sy, w_cat, w_cc_t, b_cat, spec, ds_prev=None):
    """tower_block_s's bf16 instances in torch ops: the z pass, the
    tensor-core body (``_emulate``), the tile sum and the depth pass, as
    the module docstring says: (out bf16, s_f fp32[, ds])."""
    rounded = w_cat.dtype == BF16

    def op(t):
        t = t.float()
        return t.to(BF16).float() if rounded else t
    m = tb._spec_mats(spec)
    mi, mf = (op(torch.from_numpy(np.asarray(m[k], np.float32)))
              for k in ("d_inv", "d_fwd"))               # (D, 2, KS)
    s = op(sy)
    d, ks = spec.sizes[0], s.shape[0]
    z = torch.zeros((d, 2) + tuple(s.shape[1:]))
    for k in range(ks):                                  # s ascending
        z = z + mi[:, :, k, None, None, None] * s[k]
    res = _emulate(x, z, w_cat, w_cc_t, b_cat, spec, ds_prev)
    f = res[1].float()                   # tile sums, bf16 values or fp32
    per = -(-d // DEPTH_GROUPS)
    s_f = torch.zeros_like(s)
    for g in range(DEPTH_GROUPS):
        acc = torch.zeros_like(s)
        for p in range(g * per, min(d, (g + 1) * per)):
            acc = acc + mf[p, 1, :, None, None, None] * f[p, 1]
            acc = acc + mf[p, 0, :, None, None, None] * f[p, 0]
        s_f = s_f + acc
    return (res[0], s_f) + tuple(res[2:])


def emulate_resident(x, op_stack, wcat_stack, wcc_stack, b_stack, spec):
    """tower_resident's bf16 instances: block 0's entry spectrum as the
    wrapper builds it, then ``emulate_block_s`` block by block with the
    operator mix between them (fp32, as the kernel's phase 3)."""
    s = tr._entry(x, op_stack, wcat_stack, spec)
    nb = op_stack.shape[0]
    for b in range(nb):
        x, s_f = emulate_block_s(x, s, wcat_stack[b], wcc_stack[b],
                                 b_stack[b], spec)
        if b + 1 < nb:
            s = tbs.spectrum_mix_s(s_f, op_stack[b + 1], spec)
    return x
