"""The port's reader of the JAX package's weights export
(``utils/msgpack_params.py``) against flax's own serialization, on the
CPU.

The JAX package writes ``model/model.msgpack`` with
``flax.serialization.msgpack_serialize``; the port decodes it without
flax, jax or the ``msgpack`` package. Every leaf must come back with the
same dtype, shape and bits, and the tree must load into the port's model
through ``state_dict_from_jax``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from multimodal_3d_image_segmentation_tpu import models as jmodels
from multimodal_3d_image_segmentation_tpu_torch.models import (HNOSegXS,
                                                               VNetDS)
from multimodal_3d_image_segmentation_tpu_torch.utils.jax_compat import \
    state_dict_from_jax
from multimodal_3d_image_segmentation_tpu_torch.utils.msgpack_params import (
    read_msgpack_params, unpack)

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

FAMILIES = {
    "V-Net-DS": (jmodels.VNetDS, VNetDS, dict(
        in_channels=2, out_channels=3, base_num_filters=4,
        num_blocks=[1, 2, 2], right_leg_indexes=[0, 1, 2])),
    "HNOSeg-XS": (jmodels.HNOSegXS, HNOSegXS, dict(
        in_channels=2, out_channels=3, filters=8,
        num_transform_blocks=[2, 2], num_modes=(3, 4, 4))),
}


def _params(family):
    jcls, _, kw = FAMILIES[family]
    x = jnp.zeros((1, kw["in_channels"], 16, 16, 12))
    return jax.device_get(jcls(**kw).init(jax.random.PRNGKey(0), x)
                          ["params"])


def _assert_same_tree(got, want):
    assert isinstance(got, dict) and set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_same_tree(got[k], v)
        else:
            v = np.asarray(v)
            assert got[k].dtype == v.dtype and got[k].shape == v.shape
            np.testing.assert_array_equal(got[k], v)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_reader_matches_flax(tmp_path, family):
    """flax's ``to_bytes`` of JAX params, read back: the same tree as
    flax's ``msgpack_restore``, loadable into the port's model."""
    params = _params(family)
    path = tmp_path / "model.msgpack"
    path.write_bytes(serialization.to_bytes(params))
    got = read_msgpack_params(str(path))
    _assert_same_tree(got, serialization.msgpack_restore(path.read_bytes()))
    _, tcls, kw = FAMILIES[family]
    model = tcls(**kw)
    if tcls is VNetDS:
        state = state_dict_from_jax(got, kw["num_blocks"])
    else:
        state = state_dict_from_jax(got)
    model.load_state_dict(state, strict=True)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_reader_matches_the_msgpack_package(family):
    """The same bytes through the ``msgpack`` package with flax's ext
    decoding (the package is optional: the port never imports it)."""
    msgpack = pytest.importorskip("msgpack")
    data = serialization.to_bytes(_params(family))

    def ext_hook(code, payload):
        shape, dtype, buf = msgpack.unpackb(payload, raw=True)
        return np.frombuffer(buf, np.dtype(dtype.decode())).reshape(shape)

    _assert_same_tree(unpack(data),
                      msgpack.unpackb(data, ext_hook=ext_hook, raw=False))


def test_reader_decodes_every_format(tmp_path, monkeypatch):
    """Scalars, strings, nesting, flax's complex and numpy-scalar ext
    types, and arrays that flax splits into chunks."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"ints": [0, 1, 127, 128, 255, 65536, 2 ** 40, -1, -32, -33,
                     -200, -(2 ** 20), -(2 ** 40)],
            "floats": [0.5, -1e300], "flags": [True, False, None],
            "text": "x" * 40, "long": "y" * 300,
            "complex": 1.5 - 2.0j, "scalar": np.float32(3.25),
            "big": np.arange(100, dtype=np.float32).reshape(10, 10),
            "wide": {str(i): np.int16(i) for i in range(20)},
            "empty": np.zeros((0, 3), np.float64)}
    data = serialization.msgpack_serialize(tree)
    want = serialization.msgpack_restore(data)
    got = unpack(data)
    assert got["big"]["__msgpack_chunked_array__"] is True  # as flax wrote
    for k in ("ints", "floats", "flags", "text", "long", "complex"):
        assert got[k] == want[k] == tree[k]
    assert got["scalar"] == np.float32(3.25)
    assert got["scalar"].dtype == np.float32
    assert [got["wide"][str(i)] for i in range(20)] == list(range(20))
    assert got["empty"].shape == (0, 3)
    path = tmp_path / "chunked.msgpack"
    path.write_bytes(data)
    np.testing.assert_array_equal(read_msgpack_params(str(path))["big"],
                                  tree["big"])
    with pytest.raises(ValueError, match="truncated"):
        unpack(data[:-3])
