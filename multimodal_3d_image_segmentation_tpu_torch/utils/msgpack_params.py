"""Read the JAX package's weights export, ``model/model.msgpack``, without
flax, jax or the ``msgpack`` package.

``runtime/checkpoint.py::save_params`` of the JAX package writes the flax
parameter tree with ``flax.serialization.msgpack_serialize``: nested maps
with str keys, and the leaves as msgpack ext types of flax's own layout:

  * ext 1, an ndarray: the msgpack array (shape, dtype name, raw C-order
    bytes);
  * ext 2, a Python complex: the msgpack array (real, imag);
  * ext 3, a numpy scalar: an ndarray of shape () as in ext 1.

Arrays above 1 GiB are split by flax into a map marked
``__msgpack_chunked_array__`` (shape and chunks as maps keyed "0", "1",
...); they are joined back here. ``read_msgpack_params(path)`` returns the
tree as nested dicts of numpy arrays, what ``utils/jax_compat.py::
state_dict_from_jax`` takes.
"""
from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np

__all__ = ["unpack", "read_msgpack_params"]

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """A msgpack decoder over one buffer (the spec's formats; ext types are
    decoded as flax's)."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def sint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big", signed=True)

    def value(self) -> Any:
        b = self.uint(1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):  # bin 8 / 16 / 32
            return bytes(self.take(self.uint(1 << (b - 0xC4))))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8 / 16 / 32
            n = self.uint(1 << (b - 0xC7))
            return self.ext(self.sint(1), n)
        if b == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= b <= 0xCF:  # uint 8 .. 64
            return self.uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:  # int 8 .. 64
            return self.sint(1 << (b - 0xD0))
        if 0xD4 <= b <= 0xD8:  # fixext 1 .. 16
            return self.ext(self.sint(1), 1 << (b - 0xD4))
        if 0xD9 <= b <= 0xDB:  # str 8 / 16 / 32
            return self.str(self.uint(1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):  # array 16 / 32
            return self.array(self.uint(2 if b == 0xDC else 4))
        if b in (0xDE, 0xDF):  # map 16 / 32
            return self.map(self.uint(2 if b == 0xDE else 4))
        raise ValueError(f"msgpack: unknown format byte {b:#04x}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, code: int, n: int) -> Any:
        data = bytes(self.take(n))
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            arr = _ndarray(data)
            return arr if code == _EXT_NDARRAY else arr[()]
        if code == _EXT_COMPLEX:
            re, im = unpack(data)
            return complex(re, im)
        raise ValueError(f"msgpack: ext type {code} is not flax's")


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype, buf = unpack(data)
    if isinstance(dtype, bytes):
        dtype = dtype.decode()
    if dtype == "bfloat16":
        raise ValueError("bfloat16 leaves: numpy has no bfloat16 (the "
                         "port serves fp32 weights)")
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED) is True:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def unpack(data: bytes) -> Any:
    """Decode one msgpack object (flax's ext types as numpy arrays,
    complex numbers and numpy scalars)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("msgpack: trailing bytes after the object")
    return out


def read_msgpack_params(path: str) -> Dict[str, Any]:
    """The parameter tree in ``path`` (``flax.serialization.to_bytes`` /
    the JAX package's ``save_params``) as nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        tree = _unchunk(unpack(f.read()))
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: not a parameter tree")
    return tree
