"""The port's augmentation and training / validation flows against the
JAX package's, on the CPU: for the same seed they give the same arrays,
bit for bit. The port resamples with the JAX package's numpy gather; the
JAX package uses its native C++ resampler where that is built, which
agrees with the gather on the configs' transforms but rounds a few
half-way source coordinates the other way on a general affine
(``test_apply_transform_matches_jax``)."""
from functools import partial

import numpy as np
import pytest

from multimodal_3d_image_segmentation_tpu.data import augmentation as jaug
from multimodal_3d_image_segmentation_tpu.data import dataset as jdataset
from multimodal_3d_image_segmentation_tpu.data import nifti as jnifti
from multimodal_3d_image_segmentation_tpu.data import normalization as jnorm
from multimodal_3d_image_segmentation_tpu_torch.data import (
    InputData, normalize_modalities, read_img, write_image)
from multimodal_3d_image_segmentation_tpu_torch.data import augmentation

# the configs' [augmentation] section, and one with flips
AUGMENT = dict(rotation_range=[30, 0, 0], shift_range=[0.2, 0.2, 0.2],
               zoom_range=[0.8, 1.2], augmentation_probability=0.8)
AUGMENT_FLIP = dict(rotation_range=[10, 20, 30], shift_range=[0.1, 0, 0.3],
                    zoom_range=[0.9, 1.1], flip=[True, True, False],
                    cval=-1.0, augmentation_probability=1.0)


@pytest.mark.parametrize("kwargs", [AUGMENT, AUGMENT_FLIP])
def test_image_transform_matches_jax(kwargs):
    rng = np.random.default_rng(0)
    mine = augmentation.ImageTransform(**kwargs, seed=7)
    theirs = jaug.ImageTransform(**kwargs, seed=7)
    for _ in range(6):
        x = rng.standard_normal((2, 11, 9, 8)).astype(np.float32)
        y = rng.integers(0, 4, (1, 11, 9, 8)).astype(np.float32)
        got, want = mine(x, y), theirs(x, y)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.flags.c_contiguous
            np.testing.assert_array_equal(a, b)
    x = rng.standard_normal((1, 9, 10)).astype(np.float32)
    np.testing.assert_array_equal(
        augmentation.ImageTransform(rotation_range=25, seed=3)(x),
        jaug.ImageTransform(rotation_range=25, seed=3)(x))


def test_apply_transform_matches_jax(monkeypatch):
    """Against the JAX package's numpy gather (its native resampler off):
    bit for bit on a general affine."""
    from multimodal_3d_image_segmentation_tpu.data import native
    monkeypatch.setattr(native, "available", lambda: False)
    x = np.random.default_rng(1).standard_normal((3, 12, 10, 7)).astype(
        np.float32)
    m = np.eye(4)
    m[:3, :3] = [[0.9, -0.3, 0.1], [0.3, 0.95, 0.0], [0.0, 0.1, 1.1]]
    m[:3, 3] = [1.5, -2.0, 0.5]
    np.testing.assert_array_equal(augmentation.apply_transform(x, m, 0.0),
                                  jaug.apply_transform(x, m, 0.0))


def _lists(root, n, seed):
    rng = np.random.default_rng(seed)
    lists = [[], [], []]
    for i in range(n):
        for m in range(3):
            p = str(root / f"case{i}" / f"m{m}.nii.gz")
            vol = (rng.integers(0, 4, (8, 7, 6)).astype(np.uint8) if m == 2
                   else (rng.standard_normal((8, 7, 6)) + 2).astype(
                       np.float32))
            write_image(vol, p)
            lists[m].append(p)
    return lists


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("num_workers", [0, 2])
def test_train_and_valid_flows_match_jax(tmp_path, num_workers, normalize):
    """Two epochs of the shuffled, augmented training flow and one of the
    validation flow, from one pool each, as a training run reads them."""
    train, valid = _lists(tmp_path / "t", 5, 1), _lists(tmp_path / "v", 2, 2)
    kw = dict(data_lists_train=train, data_lists_valid=valid,
              idx_x_modalities=[0, 1], idx_y_modalities=[2], batch_size=2,
              num_workers=num_workers, transform_kwargs=dict(AUGMENT,
                                                             seed=5),
              seed=11)
    mine = InputData(reader=read_img, x_processing=partial(
        normalize_modalities, mask_val=0) if normalize else None, **kw)
    theirs = jdataset.InputData(
        reader=jnifti.read_img, x_processing=partial(
            jnorm.normalize_modalities, mask_val=0) if normalize else None,
        **kw)
    assert mine.get_train_num_batches() == theirs.get_train_num_batches() \
        == 3
    assert mine.get_valid_num_batches() == 1
    assert mine.get_train_image_size() == theirs.get_train_image_size()
    flows = [mine.get_train_flow(), theirs.get_train_flow(),
             mine.get_valid_flow(), theirs.get_valid_flow()]
    try:
        got = [[list(flows[i]) for _ in range(2)] for i in (0, 1)]
        got += [list(flows[2]), list(flows[3])]
    finally:
        for f in flows:
            f.close()
    for epoch_mine, epoch_theirs in zip(got[0], got[1]):
        assert [x.shape for x, _ in epoch_mine] == \
            [(2, 2, 8, 7, 6), (2, 2, 8, 7, 6), (1, 2, 8, 7, 6)]
        for (x, y), (xj, yj) in zip(epoch_mine, epoch_theirs):
            np.testing.assert_array_equal(x, xj)
            np.testing.assert_array_equal(y, yj)
    # the second epoch is shuffled and augmented anew
    assert not np.array_equal(got[0][0][0][0], got[0][1][0][0])
    for (x, y), (xj, yj) in zip(got[2], got[3]):
        np.testing.assert_array_equal(x, xj)
        np.testing.assert_array_equal(y, yj)
