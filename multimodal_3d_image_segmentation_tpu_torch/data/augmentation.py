"""Random affine augmentation (host side, numpy), the port's own copy of
``multimodal_3d_image_segmentation_tpu/data/augmentation.py``.

Re-design of the reference ``ImageTransform``
(``experiments/data_io/dataset.py:63-244``): per-axis rotation, fractional
shift, isotropic zoom, per-axis random flips, probability gate — all
applied with NEAREST-neighbor interpolation so the same transform is valid
for images and integer label maps.

The reference resamples through SimpleITK with the transform matrix built
in (x, y, z) coordinates and offset-centered at size/2 + 0.5; ITK's
resampler evaluates input_index = A @ output_index + t on the identity-
spacing grid, rounds half-up, and treats continuous indices in
[-0.5, size - 0.5) as inside. We permute the (x, y, z) matrix into the
array's (z, y, x) index order and resample each channel with exactly those
semantics as a numpy gather (the JAX package's native C++ resampler
rounds the same way and is not ported). No ITK dependency.

The random draw order matches the reference exactly (binomial gate,
rotation, shift, zoom, flips), so a given seed produces the same
augmentation sequence.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


__all__ = ["ImageTransform", "apply_transform", "flip_axis",
           "transform_matrix_offset_center"]


def transform_matrix_offset_center(matrix: np.ndarray,
                                   img_size: Sequence[int]) -> np.ndarray:
    """Re-center an (n+1)x(n+1) homogeneous matrix at size/2 + 0.5
    (reference ``experiments/data_io/dataset.py:195-202``)."""
    offset = np.array(img_size) / 2.0 + 0.5
    offset_matrix = np.eye(matrix.shape[0])
    offset_matrix[:-1, -1] = offset
    reset_matrix = np.eye(matrix.shape[0])
    reset_matrix[:-1, -1] = -offset
    return offset_matrix @ matrix @ reset_matrix


def apply_transform(x: np.ndarray, transform_matrix: np.ndarray,
                    cval: float) -> np.ndarray:
    """Apply an affine transform (in (x, y, z) coordinates) to a
    channel-first array with nearest-neighbor interpolation."""
    nd = x.ndim - 1
    img_size_xyz = x.shape[1:][::-1]
    m = transform_matrix_offset_center(transform_matrix, img_size_xyz)
    a_xyz = m[:-1, :-1]
    t_xyz = m[:-1, -1]

    # permute (x, y, z) coords into the array's (z, y, x) index order
    perm = np.arange(nd)[::-1]
    a = a_xyz[np.ix_(perm, perm)]
    t = t_xyz[perm]

    # ITK-convention rounding: half up, inside on [-0.5, size - 0.5)
    shape = x.shape[1:]
    idx = np.indices(shape).reshape(nd, -1)
    src = a @ idx + t[:, None]
    si = np.floor(src + 0.5).astype(np.int64)
    inside = np.ones(si.shape[1], dtype=bool)
    for d in range(nd):
        inside &= (si[d] >= 0) & (si[d] < shape[d])
    si_cl = np.minimum(np.maximum(si, 0),
                       np.array(shape)[:, None] - 1)
    flat = np.ravel_multi_index(tuple(si_cl), shape)
    out = []
    for ch in x:
        vals = ch.reshape(-1)[flat]
        vals = np.where(inside, vals, np.asarray(cval, ch.dtype))
        out.append(vals.reshape(shape).astype(ch.dtype))
    return np.stack(out)


def flip_axis(x: np.ndarray, axis: int) -> np.ndarray:
    return np.flip(x, axis)


class ImageTransform:
    """Random affine augmentation for (C, H, W) or (C, D, H, W) arrays.

    Args mirror the reference (``experiments/data_io/dataset.py:63-93``):
        rotation_range: scalar (2D) or length-3 list (3D, per depth/height/
            width axis), degrees.
        shift_range: per-axis fraction of the size.
        zoom_range: (lo, hi) isotropic zoom.
        flip: per-axis booleans enabling random flips.
        cval: fill value outside the boundary.
        augmentation_probability: per-sample gate.
        seed: RNG seed.
    """

    def __init__(self, rotation_range=None, shift_range=None, zoom_range=None,
                 flip=None, cval=0.0, augmentation_probability=1.0, seed=None):
        self.rotation_range = rotation_range
        self.shift_range = shift_range
        self.zoom_range = zoom_range
        self.flip = flip
        self.cval = cval
        self.augmentation_probability = augmentation_probability
        self.rng = np.random.default_rng(seed)

    def __call__(self, x, y=None):
        img_size_axis = np.arange(x.ndim)[1:]

        if self.rng.binomial(1, self.augmentation_probability):
            theta = None
            if self.rotation_range is not None:
                if np.isscalar(self.rotation_range):
                    assert x.ndim == 3
                    theta = (np.pi / 180 * self.rng.uniform(
                        -self.rotation_range, self.rotation_range)
                        if self.rotation_range else 0)
                else:
                    assert len(self.rotation_range) == 3
                    theta = [np.pi / 180 * self.rng.uniform(-r, r) if r else 0
                             for r in self.rotation_range]

            shift = None
            if self.shift_range is not None:
                assert len(self.shift_range) == x.ndim - 1
                shift = [self.rng.uniform(-s, s) * x.shape[img_size_axis[i]]
                         if s else 0
                         for i, s in enumerate(self.shift_range)]

            zoom = None
            if self.zoom_range is not None:
                zoom = self.rng.uniform(self.zoom_range[0],
                                        self.zoom_range[1])

            transform_matrix = None

            if theta is not None:
                if np.isscalar(theta) and theta != 0:
                    transform_matrix = np.array(
                        [[np.cos(theta), -np.sin(theta), 0],
                         [np.sin(theta), np.cos(theta), 0],
                         [0, 0, 1]])
                elif not np.isscalar(theta) and any(t != 0 for t in theta):
                    # angles reversed to (x, y, z) order before composing,
                    # exactly as the reference
                    # (``experiments/data_io/dataset.py:147-161``)
                    t0, t1, t2 = theta[::-1]
                    cd, sd = np.cos(t0), np.sin(t0)
                    ch, sh = np.cos(t1), np.sin(t1)
                    cw, sw = np.cos(t2), np.sin(t2)
                    transform_matrix = np.array(
                        [[ch * cw, -cd * sw + sd * sh * cw,
                          sd * sw + cd * sh * cw, 0],
                         [ch * sw, cd * cw + sd * sh * sw,
                          -sd * cw + cd * sh * sw, 0],
                         [-sh, sd * ch, cd * ch, 0],
                         [0, 0, 0, 1]])

            if shift is not None and any(s != 0 for s in shift):
                shift_matrix = np.eye(x.ndim)
                shift_matrix[:-1, -1] = np.asarray(shift[::-1])  # (x, y, z)
                transform_matrix = (shift_matrix if transform_matrix is None
                                    else shift_matrix @ transform_matrix)

            if zoom is not None and zoom != 1:
                zoom_matrix = np.eye(x.ndim)
                zoom_matrix[:-1, :-1] = np.eye(x.ndim - 1) * zoom
                transform_matrix = (zoom_matrix if transform_matrix is None
                                    else zoom_matrix @ transform_matrix)

            if transform_matrix is not None:
                x = apply_transform(x, transform_matrix, self.cval)
                if y is not None:
                    y = apply_transform(y, transform_matrix, self.cval)

            if self.flip is not None:
                assert len(self.flip) == x.ndim - 1
                for i, fp in enumerate(self.flip):
                    if fp and self.rng.random() < 0.5:
                        x = flip_axis(x, img_size_axis[i])
                        if y is not None:
                            y = flip_axis(y, img_size_axis[i])

        if y is None:
            return np.ascontiguousarray(x)
        return np.ascontiguousarray(x), np.ascontiguousarray(y)
