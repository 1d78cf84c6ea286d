"""Evaluation metrics: regional Dice, surface Dice, robust Hausdorff (HD95),
the port's own copy of ``multimodal_3d_image_segmentation_tpu/metrics.py``.

Re-design of reference ``experiments/metrics.py:22-176``. The reference
delegates surface distances to DeepMind's ``surface-distance`` package; here
they are implemented natively:

  * default ``method='subvoxel'``: marching-cubes surfel construction
    (``surfels.py``) — every 2x2x2 cell crossed by the boundary carries an
    area-weighted surface element, distances are measured between the
    surfel grids with the exact anisotropic Euclidean distance transform,
    and surface Dice / robust Hausdorff are surfel-area weighted. This is
    the same surface model as the package the reference calls (Nikolov et
    al.), so published surface-Dice/HD95 protocols are reproduced;
  * ``method='voxel'``: the classic border-voxel estimator (mask XOR its
    erosion, unweighted distances), kept as a cheap fallback (MedPy-style).

HD95 keeps the reference's ``binary_opening`` prediction denoising
(``experiments/metrics.py:158-163``); surface-Dice tolerance stays
``mean(spacing)`` (``experiments/metrics.py:151-155``).

Output artifacts (``results_regional.csv`` TSV, ``average_results_regional
.txt`` masked mean/std) are format-compatible with the reference; the TSV
is written with the ``csv`` module as pandas' ``to_csv`` writes it (six
decimals, an empty field for NaN, a last "End" row of empty fields).
"""
from __future__ import annotations

import csv
import itertools
import os
from collections import defaultdict
from functools import partial
import multiprocessing
from typing import Optional, Sequence

import numpy as np
import scipy.ndimage

from .data.nifti import read_spacing
from .surfels import compute_surface_distances_subvoxel

__all__ = ["dice_binary", "surface_dice_binary", "hd95_binary",
           "get_labels_union", "compute_regional_metrics",
           "statistics_regional", "compute_surface_distances",
           "compute_surface_dice_at_tolerance", "compute_robust_hausdorff"]


def _border(mask: np.ndarray) -> np.ndarray:
    """Surface voxels: mask minus its erosion (6/4-connectivity)."""
    if not mask.any():
        return mask
    structure = scipy.ndimage.generate_binary_structure(mask.ndim, 1)
    eroded = scipy.ndimage.binary_erosion(mask, structure=structure,
                                          border_value=0)
    return mask & ~eroded


def compute_surface_distances(mask_gt: np.ndarray, mask_pred: np.ndarray,
                              spacing_mm: Sequence[float],
                              method: str = "subvoxel"):
    """Surface-to-surface distance distributions between two binary masks.

    ``method='subvoxel'`` (default): marching-cubes surfels — returns
    ``distances_gt_to_pred`` / ``distances_pred_to_gt`` sorted ascending
    plus aligned ``surfel_areas_gt`` / ``surfel_areas_pred`` weights, the
    contract of the ``surface-distance`` package the reference uses.
    ``method='voxel'``: border-voxel distances, no area weights.
    """
    if method == "subvoxel":
        return compute_surface_distances_subvoxel(mask_gt, mask_pred,
                                                  spacing_mm)
    if method != "voxel":
        raise ValueError(f"unknown surface-distance method: {method!r}")
    border_gt = _border(mask_gt.astype(bool))
    border_pred = _border(mask_pred.astype(bool))

    spacing = tuple(float(s) for s in spacing_mm)

    if border_pred.any():
        dt_pred = scipy.ndimage.distance_transform_edt(
            ~border_pred, sampling=spacing)
        d_gt_to_pred = dt_pred[border_gt]
    else:
        d_gt_to_pred = np.full(int(border_gt.sum()), np.inf)

    if border_gt.any():
        dt_gt = scipy.ndimage.distance_transform_edt(
            ~border_gt, sampling=spacing)
        d_pred_to_gt = dt_gt[border_pred]
    else:
        d_pred_to_gt = np.full(int(border_pred.sum()), np.inf)

    return {"distances_gt_to_pred": np.asarray(d_gt_to_pred),
            "distances_pred_to_gt": np.asarray(d_pred_to_gt)}


def compute_surface_dice_at_tolerance(surface_distances, tolerance_mm):
    """Fraction of the combined surface within tolerance of the other
    surface — surfel-area weighted when the distances carry areas
    (subvoxel method), per-voxel otherwise."""
    d_g2p = surface_distances["distances_gt_to_pred"]
    d_p2g = surface_distances["distances_pred_to_gt"]
    a_gt = surface_distances.get("surfel_areas_gt")
    a_pred = surface_distances.get("surfel_areas_pred")
    if a_gt is None:
        a_gt = np.ones_like(d_g2p)
        a_pred = np.ones_like(d_p2g)
    total = a_gt.sum() + a_pred.sum()
    if total == 0:
        return np.nan
    overlap = (a_gt[d_g2p <= tolerance_mm].sum()
               + a_pred[d_p2g <= tolerance_mm].sum())
    return overlap / total


def _weighted_percentile(distances, weights, percentile):
    """Distance below which ``percentile`` % of the surface (by weight)
    lies; distances must be sorted ascending with aligned weights."""
    if len(distances) == 0:
        return np.inf
    cum = np.cumsum(weights)
    cum = cum / cum[-1]
    idx = int(np.searchsorted(cum, percentile / 100.0))
    return float(distances[min(idx, len(distances) - 1)])


def compute_robust_hausdorff(surface_distances, percentile):
    d_g2p = surface_distances["distances_gt_to_pred"]
    d_p2g = surface_distances["distances_pred_to_gt"]
    a_gt = surface_distances.get("surfel_areas_gt")
    a_pred = surface_distances.get("surfel_areas_pred")
    if len(d_g2p) == 0 or len(d_p2g) == 0:
        return np.inf
    if a_gt is not None:
        return max(_weighted_percentile(d_g2p, a_gt, percentile),
                   _weighted_percentile(d_p2g, a_pred, percentile))
    return max(np.percentile(d_g2p, percentile),
               np.percentile(d_p2g, percentile))


def dice_binary(y_true_bin, y_pred_bin):
    """Binary Dice; NaN when the label is absent from the ground truth
    (reference ``experiments/metrics.py:142-148``)."""
    intersection = np.count_nonzero(y_true_bin & y_pred_bin)
    t = np.count_nonzero(y_true_bin)
    p = np.count_nonzero(y_pred_bin)
    if t == 0:
        return np.nan
    return 2 * intersection / (t + p)


def surface_dice_binary(y_true_bin, y_pred_bin, spacing):
    """Surface Dice at tolerance = mean(spacing)
    (reference ``experiments/metrics.py:151-155``)."""
    if np.count_nonzero(y_true_bin) == 0:
        return np.nan
    dist = compute_surface_distances(y_true_bin, y_pred_bin, spacing)
    return compute_surface_dice_at_tolerance(dist, np.mean(spacing))


def hd95_binary(y_true_bin, y_pred_bin, spacing):
    """HD95 with morphological-opening denoising of the prediction
    (reference ``experiments/metrics.py:158-163``)."""
    if np.count_nonzero(y_true_bin) == 0:
        return np.nan
    y_pred_bin = scipy.ndimage.binary_opening(y_pred_bin)
    dist = compute_surface_distances(y_true_bin, y_pred_bin, spacing)
    return compute_robust_hausdorff(dist, 95)


def get_labels_union(y, target_labels):
    """Boolean mask for a region = union of labels
    (reference ``experiments/metrics.py:166-176``)."""
    if np.isscalar(target_labels):
        target_labels = [target_labels]
    output = None
    for lab in target_labels:
        output = (y == lab) if output is None else (output | (y == lab))
    return output


def compute_regional_metrics(y_true, y_pred, spacing=None, labels=None,
                             use_surface_dice=True, use_hd95=True):
    """All metrics for one (sample, region) pair
    (reference ``experiments/metrics.py:22-50``)."""
    assert y_true.shape == y_pred.shape
    outputs = {}
    y_true_bin = get_labels_union(y_true, labels)
    y_pred_bin = get_labels_union(y_pred, labels)
    outputs["dice"] = dice_binary(y_true_bin, y_pred_bin)
    if use_surface_dice:
        outputs["surface_dice"] = surface_dice_binary(
            y_true_bin, y_pred_bin, spacing)
    if use_hd95:
        outputs["hd95"] = hd95_binary(y_true_bin, y_pred_bin, spacing)
    return outputs


def compute_sample_metrics(y_true, y_pred, spacing, region_labels,
                           use_surface_dice=True, use_hd95=True):
    """All regions' metrics for one sample: one list entry (metric dict)
    per region, in ``region_labels`` order. Module-level so pool workers
    can unpickle it."""
    return [compute_regional_metrics(y_true, y_pred, spacing, labs,
                                     use_surface_dice, use_hd95)
            for labs in region_labels]


def _csv_float(v) -> str:
    """A metric as pandas' ``to_csv(float_format="%.6f")`` writes it."""
    return "" if np.isnan(v) else "%.6f" % v


def statistics_regional(y_true, y_pred, y_list_test, output_dir,
                        region_names=None, region_labels=None, is_print=True,
                        suffix="_regional", use_surface_dice=True,
                        use_hd95=True, nproc: Optional[int] = None):
    """Per-sample per-region metrics; TSV + masked mean/std text outputs
    (reference ``experiments/metrics.py:53-139``)."""
    if region_labels is None:
        region_labels = list(itertools.chain.from_iterable(
            [np.unique(yt) for yt in y_true]))
        region_labels = np.unique(region_labels)
        print("Warning: as region_labels is not provided, "
              "each label is treated as a region.")

    if region_names is None:
        region_names = [f"Label {str(lab)}" for lab in region_labels]
        print(f"Warning: as region_names is not provided, "
              f"{region_names} are used.")

    assert len(region_names) == len(region_labels)

    spacing = [None] * len(y_true)
    if use_surface_dice or use_hd95:
        # sitk GetSpacing()[::-1] == (z, y, x) order
        spacing = [read_spacing(fn)[::-1] for fn in y_list_test]
        print("Spacings are obtained from image files.")

    metrics_all = defaultdict(list)
    # ONE pool, per-SAMPLE tasks (all regions computed in the task): each
    # multi-hundred-MB volume pair crosses the spawn-pool pipe exactly
    # once instead of once per region, and spawn workers pay interpreter
    # startup once (reference pools per sample too,
    # ``experiments/metrics.py:97-104``)
    partial_fn = partial(compute_sample_metrics,
                         region_labels=region_labels,
                         use_surface_dice=use_surface_dice,
                         use_hd95=use_hd95)
    tasks = list(zip(y_true, y_pred, spacing))
    if nproc:  # nproc in (None, 0) -> serial
        # spawn: fork() in a threaded process risks deadlock
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(processes=nproc) as pool:
            results = pool.starmap(partial_fn, tasks)
    else:
        results = [partial_fn(*t) for t in tasks]
    for r in range(len(region_labels)):
        metrics = defaultdict(list)
        for res in results:
            for k, v in res[r].items():
                metrics[k].append(v)
        for k, v in metrics.items():
            metrics_all[k].append(np.array(v)[:, None])

    metrics_all = {k: np.concatenate(v, axis=1) for k, v in metrics_all.items()}
    num_labels = metrics_all["dice"].shape[1]
    ids = [fn.split("/")[-2] for fn in y_list_test]
    columns = [metrics_all[k][:, i] for k in metrics_all
               for i in range(num_labels)]
    header = ["ID"] + [" ".join(tmp) for tmp in itertools.product(
        list(metrics_all.keys()), region_names)]
    output_file = os.path.join(output_dir, f"results{suffix}.csv")
    with open(output_file, "w", newline="") as f:
        writer = csv.writer(f, delimiter="\t", lineterminator="\n")
        writer.writerow(header)
        for row, pid in enumerate(ids):
            writer.writerow([pid] + [_csv_float(c[row]) for c in columns])
        writer.writerow(["End"] + [""] * len(columns))

    with open(os.path.join(output_dir, f"average_results{suffix}.txt"),
              "w") as f:
        print(f"region_names: {region_names}", file=f)
    if is_print:
        print()
        print(f"region_names: {region_names}")
    for k, v in metrics_all.items():
        scores = np.ma.array(v, mask=np.isnan(v) | np.isinf(v))
        mean = list(scores.mean(0).filled(np.nan))
        std = list(scores.std(0).filled(np.nan))
        with open(os.path.join(output_dir, f"average_results{suffix}.txt"),
                  "a") as f:
            print(f"{k}_mean: {mean}", file=f)
            print(f"{k}_std: {std}", file=f)
        if is_print:
            print(f"{k}_mean: {mean}")
            print(f"{k}_std: {std}")

    return metrics_all
