"""The port's host data plane (``data/``) against the JAX package's.

Files written by either package must read back bit for bit in both, the
z-score must agree with the reference's (native or numpy) within 1e-6
(float32 rounding of the same float64 statistics), and the test flow must
yield the same batches.
"""
from functools import partial

import numpy as np
import pytest

from multimodal_3d_image_segmentation_tpu.data import dataset as jdataset
from multimodal_3d_image_segmentation_tpu.data import nifti as jnifti
from multimodal_3d_image_segmentation_tpu.data import normalization as jnorm
from multimodal_3d_image_segmentation_tpu_torch.data import (
    InputData, normalize_modalities, read_img, read_shape, write_image)


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32])
@pytest.mark.parametrize("shape", [(5, 6, 7), (6, 9)])
def test_nifti_round_trips_with_jax(tmp_path, suffix, dtype, shape):
    rng = np.random.default_rng(0)
    vol = (rng.standard_normal(shape) * 50).astype(dtype)
    mine, theirs = tmp_path / f"a{suffix}", tmp_path / f"b{suffix}"
    write_image(vol, mine, origin=(0, -5, 0)[:len(shape)])
    jnifti.write_image(vol, theirs, origin=(0, -5, 0)[:len(shape)])
    for p in (mine, theirs):
        got = read_img(p)
        assert got.dtype == np.float32 and got.shape == shape
        np.testing.assert_array_equal(got, vol.astype(np.float32))
        np.testing.assert_array_equal(jnifti.read_img(p), got)
        assert read_shape(p) == jnifti.read_shape(p) == shape
    raw = [np.frombuffer(jnifti._read_raw(p), np.uint8)
           for p in (mine, theirs)]
    np.testing.assert_array_equal(raw[0], raw[1])  # same header, payload


@pytest.mark.parametrize("mask_val,clip_val", [
    (None, None), (0, None), (0, (-1.0, 4.0))])
def test_normalize_matches_jax(mask_val, clip_val):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 8, 9, 10)) * 2 + 5).astype(np.float32)
    x[:, :2] = 0  # a masked background slab
    x[2] = 7.0    # a constant modality: std taken as 1
    got = normalize_modalities(x, mask_val=mask_val, clip_val=clip_val)
    want = jnorm.normalize_modalities(x, mask_val=mask_val,
                                      clip_val=clip_val)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_test_flow_matches_jax(tmp_path, num_workers):
    rng = np.random.default_rng(2)
    lists = [[], [], []]
    for i in range(3):
        for m, dt in enumerate((np.float32, np.float32, np.uint8)):
            p = str(tmp_path / f"case{i}" / f"m{m}.nii.gz")
            vol = rng.integers(0, 4, (6, 5, 4)) if dt == np.uint8 else \
                rng.standard_normal((6, 5, 4)) + 2
            write_image(vol.astype(dt), p)
            lists[m].append(p)
    kw = dict(data_lists_test=lists, idx_x_modalities=[0, 1],
              idx_y_modalities=[2], batch_size=1, num_workers=num_workers)
    mine = InputData(reader=read_img, x_processing=partial(
        normalize_modalities, mask_val=0), **kw)
    theirs = jdataset.InputData(reader=jnifti.read_img, x_processing=partial(
        jnorm.normalize_modalities, mask_val=0), **kw)
    assert mine.get_test_image_size() == theirs.get_test_image_size()
    assert mine.get_test_num_batches() == theirs.get_test_num_batches() == 3
    flows = [mine.get_test_flow(), theirs.get_test_flow()]
    try:
        batches = [list(f) for f in flows]
    finally:
        for f in flows:
            f.close()
    assert len(batches[0]) == len(batches[1]) == 3
    for (x, y), (xj, yj) in zip(*batches):
        assert x.shape == (1, 2, 6, 5, 4) and y.shape == (1, 1, 6, 5, 4)
        np.testing.assert_allclose(x, xj, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(y, yj)
