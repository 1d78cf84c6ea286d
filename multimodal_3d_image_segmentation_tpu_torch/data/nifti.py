"""NIfTI-1 reader/writer in numpy, the port of
``multimodal_3d_image_segmentation_tpu/data/nifti.py``.

Arrays are in (z, y, x) index order (``sitk.GetArrayFromImage``), origins
in (x, y, z) with ITK's LPS convention, and the writer emits the same
header as the reference package (LPS->RAS sign flips on the affine), so
files written by either package read back the same in both. Decompression
is Python's ``gzip``; the reference's native zlib plane is not ported. The
writer compresses at zlib's default level 6, not gzip's 9: a 240x240x155
label map of a noisy prediction takes several times less host time for
a file a few percent larger, with the same content.
"""
from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["read_img", "read_shape", "read_spacing", "write_image"]

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _open(filename, mode="rb"):
    if str(filename).endswith(".gz"):
        return gzip.open(filename, mode, compresslevel=6)
    return open(filename, mode)


def _byte_order(raw, filename) -> str:
    if len(raw) < 348:
        raise ValueError(f"{filename}: too short for a NIfTI-1 file")
    if struct.unpack_from("<i", raw, 0)[0] == 348:
        return "<"
    if struct.unpack_from(">i", raw, 0)[0] == 348:
        return ">"
    raise ValueError(f"{filename}: not a NIfTI-1 file")


def _shape_xyz(raw, bo, filename) -> Tuple[int, ...]:
    dim = struct.unpack_from(bo + "8h", raw, 40)
    if not 1 <= dim[0] <= 7:
        raise ValueError(f"{filename}: bad ndim {dim[0]}")
    shape = tuple(int(d) for d in dim[1:1 + dim[0]])
    while len(shape) > 3 and shape[-1] == 1:  # e.g. 4D with T=1
        shape = shape[:-1]
    return shape


def read_img(filename) -> np.ndarray:
    """Read a .nii / .nii.gz volume as float32 in (z, y, x) order."""
    with _open(filename) as f:
        raw = f.read()
    bo = _byte_order(raw, filename)
    if bytes(raw[344:348]) not in (b"n+1\x00", b"ni1\x00", b"n+2\x00"):
        raise ValueError(f"{filename}: bad NIfTI magic {raw[344:348]!r}")
    shape = _shape_xyz(raw, bo, filename)
    datatype = struct.unpack_from(bo + "h", raw, 70)[0]
    if datatype not in _DTYPES:
        raise ValueError(f"{filename}: unsupported datatype code {datatype}")
    vox_offset = int(struct.unpack_from(bo + "f", raw, 108)[0])
    slope, inter = struct.unpack_from(bo + "2f", raw, 112)
    data = np.frombuffer(raw, dtype=np.dtype(_DTYPES[datatype])
                         .newbyteorder(bo), count=int(np.prod(shape)),
                         offset=vox_offset)
    # NIfTI stores x fastest: a C-order reshape to (z, y, x)
    arr = data.reshape(shape[::-1])
    if slope not in (0.0, 1.0) or (slope == 1.0 and inter != 0.0):
        arr = arr * slope + inter
    return arr.astype(np.float32)


def read_shape(filename) -> Tuple[int, ...]:
    """Volume shape in (z, y, x) from the header alone."""
    with _open(filename) as f:
        raw = f.read(352)
    return _shape_xyz(raw, _byte_order(raw, filename), filename)[::-1]


def read_spacing(filename) -> Tuple[float, ...]:
    """Voxel spacing in (x, y, z) from the header alone, as
    ``sitk.ReadImage(fn).GetSpacing()`` gives it (a zero pixdim reads
    1.0)."""
    with _open(filename) as f:
        raw = f.read(352)
    bo = _byte_order(raw, filename)
    n = min(len(_shape_xyz(raw, bo, filename)), 3)
    pixdim = struct.unpack_from(bo + "8f", raw, 76)
    return tuple(float(abs(p)) if p != 0 else 1.0 for p in pixdim[1:1 + n])


def write_image(array: np.ndarray, filename,
                spacing: Optional[Sequence[float]] = None,
                origin: Optional[Sequence[float]] = None) -> None:
    """Write a 2D or 3D (z, y, x) array to .nii / .nii.gz; ``origin`` is
    (x, y, z) as sitk's ``SetOrigin`` takes it."""
    arr = np.asarray(array)
    if arr.dtype == np.bool_:
        arr = arr.astype(np.uint8)
    if arr.dtype not in _DTYPE_CODES:
        arr = arr.astype(np.float32)
    ndim = arr.ndim
    if not 2 <= ndim <= 3:
        raise ValueError(f"writer takes 2D/3D volumes, got {arr.shape}")
    spacing3 = (tuple(float(s) for s in (spacing or (1.0,) * ndim))
                + (1.0,) * 3)[:3]
    origin3 = (tuple(float(o) for o in (origin or (0.0,) * ndim))
               + (0.0,) * 3)[:3]

    header = bytearray(352)
    struct.pack_into("<i", header, 0, 348)
    struct.pack_into("<8h", header, 40,
                     *([ndim] + list(arr.shape[::-1]) + [1] * (7 - ndim)))
    struct.pack_into("<h", header, 70, _DTYPE_CODES[arr.dtype])
    struct.pack_into("<h", header, 72, arr.dtype.itemsize * 8)
    struct.pack_into("<8f", header, 76, 1.0, *spacing3, 0.0, 0.0, 0.0, 0.0)
    struct.pack_into("<f", header, 108, 352.0)  # vox_offset
    struct.pack_into("<f", header, 112, 1.0)    # scl_slope
    struct.pack_into("<h", header, 252, 1)      # qform_code
    struct.pack_into("<h", header, 254, 1)      # sform_code
    # quaternion (b, c, d) = (0, 0, 1) encodes diag(-1, -1, 1)
    struct.pack_into("<3f", header, 256, 0.0, 0.0, 1.0)
    struct.pack_into("<3f", header, 268,
                     -origin3[0], -origin3[1], origin3[2])
    struct.pack_into("<4f", header, 280, -spacing3[0], 0.0, 0.0, -origin3[0])
    struct.pack_into("<4f", header, 296, 0.0, -spacing3[1], 0.0, -origin3[1])
    struct.pack_into("<4f", header, 312, 0.0, 0.0, spacing3[2], origin3[2])
    header[344:348] = b"n+1\x00"

    os.makedirs(os.path.dirname(os.fspath(filename)) or ".", exist_ok=True)
    with _open(filename, "wb") as f:
        f.write(bytes(header) + np.ascontiguousarray(arr).tobytes())
