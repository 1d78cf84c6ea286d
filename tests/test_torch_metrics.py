"""The port's copies of ``metrics.py`` and ``surfels.py`` against the JAX
package's, on the CPU: the same per-sample numbers, and the same
``results*.csv`` and ``average_results*.txt`` files byte for byte (the
port writes the TSV with the ``csv`` module, the JAX package with
pandas)."""
import numpy as np
import pytest

from multimodal_3d_image_segmentation_tpu import metrics as jmetrics
from multimodal_3d_image_segmentation_tpu import surfels as jsurfels
from multimodal_3d_image_segmentation_tpu_torch import metrics, surfels
from multimodal_3d_image_segmentation_tpu_torch.data import (
    read_spacing, write_image)
from multimodal_3d_image_segmentation_tpu.data import nifti as jnifti


def _blobs(rng, shape, n_labels=4):
    """A label volume of nested ellipsoids with seeded centres and radii,
    plus speckle: regions with surfaces, as tumours have."""
    grid = np.ogrid[tuple(map(slice, shape))]
    c = [rng.uniform(0.35, 0.65) * n for n in shape]
    r = np.sqrt(sum(((g - cc) / (rng.uniform(0.2, 0.35) * n)) ** 2
                    for g, cc, n in zip(grid, c, shape)))
    y = np.select([r < 0.35, r < 0.7, r < 1.0], [3, 1, 2], 0)
    speckle = rng.random(shape) < 0.02
    y[speckle] = rng.integers(0, n_labels, int(speckle.sum()))
    return y.astype(np.uint8)


def _cases(root, n=3, shape=(14, 12, 10), spacing=(1.0, 1.2, 2.0)):
    rng = np.random.default_rng(0)
    y_true, y_pred, files = [], [], []
    for i in range(n):
        t = _blobs(rng, shape)
        p = _blobs(rng, shape) if i else np.zeros_like(t)  # an empty pred
        fn = str(root / f"case{i}" / "seg.nii.gz")
        write_image(t, fn, spacing=spacing)
        y_true.append(t)
        y_pred.append(p)
        files.append(fn)
    return y_true, y_pred, files


def test_read_spacing_matches_jax(tmp_path):
    fn = str(tmp_path / "a.nii.gz")
    write_image(np.zeros((4, 5, 6), np.uint8), fn, spacing=(0.5, 1.25, 3.0))
    assert read_spacing(fn) == jnifti.read_image(fn).spacing \
        == (0.5, 1.25, 3.0)


@pytest.mark.parametrize("region_labels,region_names", [
    ([[0], [1, 2, 3], [1, 3], [3]],
     ["background", "whole tumor", "tumor core", "enhancing tumor"]),
    (None, None),           # each label its own region, names made up
])
def test_statistics_regional_matches_jax(tmp_path, region_labels,
                                         region_names):
    y_true, y_pred, files = _cases(tmp_path / "data")
    outs = {}
    for name, mod in (("port", metrics), ("jax", jmetrics)):
        out_dir = tmp_path / name
        out_dir.mkdir()
        outs[name] = mod.statistics_regional(
            y_true, y_pred, files, str(out_dir), region_names,
            region_labels, is_print=False, use_surface_dice=True,
            use_hd95=True)
    assert list(outs["port"]) == list(outs["jax"]) == \
        ["dice", "surface_dice", "hd95"]
    for k in outs["jax"]:
        np.testing.assert_array_equal(outs["port"][k], outs["jax"][k])
    assert np.isinf(outs["port"]["hd95"][0, 1:]).all()  # the empty pred
    for f in ("results_regional.csv", "average_results_regional.txt"):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f


def test_statistics_regional_pool_matches_serial(tmp_path):
    y_true, y_pred, files = _cases(tmp_path / "data", n=2)
    kw = dict(region_names=["bg", "fg"], region_labels=[[0], [1, 2, 3]],
              is_print=False, use_surface_dice=True, use_hd95=False)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    serial = metrics.statistics_regional(y_true, y_pred, files,
                                         str(tmp_path / "a"), **kw)
    pooled = metrics.statistics_regional(y_true, y_pred, files,
                                         str(tmp_path / "b"), nproc=2, **kw)
    for k in serial:
        np.testing.assert_array_equal(serial[k], pooled[k])


def test_surface_distances_match_jax():
    rng = np.random.default_rng(3)
    a = _blobs(rng, (12, 13, 11)) > 0
    b = _blobs(rng, (12, 13, 11)) > 1
    spacing = (2.0, 1.0, 0.7)
    got = surfels.compute_surface_distances_subvoxel(a, b, spacing)
    want = jsurfels.compute_surface_distances_subvoxel(a, b, spacing)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(
        surfels.neighbour_code_to_surface_area(spacing),
        jsurfels.neighbour_code_to_surface_area(spacing))
