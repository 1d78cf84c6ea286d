"""Subvoxel surface-element (surfel) construction for surface metrics,
the port's own copy of ``multimodal_3d_image_segmentation_tpu/surfels.py``.

Replaces the border-voxel estimator with the marching-cubes-based surfel
model used by DeepMind's ``surface-distance`` package (the backend of the
reference's surface metrics, ``experiments/metrics.py:16,151-163``):

  * every 2x2x2 voxel neighborhood ("cell", centered on a voxel corner)
    gets an 8-bit occupancy code;
  * a cell crossed by the mask boundary carries a piece of the isosurface —
    the marching-cubes polygon with vertices at cut-edge midpoints — whose
    area (under the anisotropic voxel spacing) is read from a 256-entry
    lookup table;
  * surface distances are measured between cell-center grids weighted by
    these surfel areas, instead of counting whole border voxels.

The lookup table is built constructively at import time (not transcribed):
for each occupancy code the surface polygons are assembled by pairing the
cut edges of every cube face around maximal runs of inside corners (the
classic marching-cubes connectivity; on ambiguous faces this separates the
inside corners), stitched into closed loops, and fan-triangulated about
the loop centroid. The construction is exactly rotation-equivariant, which
the test suite checks over all 24 cube rotations x 256 codes, along with
closed-form areas for plane/edge/corner configurations.

Cell-grid alignment: cell (i, j, k) covers voxels (i-1..i, j-1..j, k-1..k)
of the zero-padded mask, i.e. cell centers live on the voxel-corner grid.
Both masks use the same grid, so grid offset cancels in all distances.
"""
from __future__ import annotations

from functools import lru_cache
from itertools import product

import numpy as np
import scipy.ndimage

__all__ = ["neighbour_code_to_surface_area", "surfel_map",
           "compute_surface_distances_subvoxel"]

# Corner c = (i, j, k) over (d, h, w) in {0, 1}^3, enumerated so that the
# occupancy code matches a correlation with the kernel
# [[[128, 64], [32, 16]], [[8, 4], [2, 1]]]: bit weight = 128 >> index.
_CORNERS = [np.array(c) for c in product((0, 1), repeat=3)]
_CORNER_INDEX = {tuple(c): n for n, c in enumerate(_CORNERS)}

# The 12 cube edges as corner-index pairs (differ in exactly one coord).
_EDGES = [(a, b) for a in range(8) for b in range(a + 1, 8)
          if np.sum(np.abs(_CORNERS[a] - _CORNERS[b])) == 1]
_EDGE_INDEX = {frozenset(e): n for n, e in enumerate(_EDGES)}
_EDGE_MIDPOINTS = np.array([(_CORNERS[a] + _CORNERS[b]) / 2.0
                            for a, b in _EDGES])


def _face_rings():
    """The 6 faces as cyclic corner rings (consecutive ring entries are
    cube-edge neighbors)."""
    rings = []
    for axis in range(3):
        for val in (0, 1):
            # corners on this face, ordered around the face perimeter
            others = [a for a in range(3) if a != axis]
            ring = []
            for u, v in [(0, 0), (0, 1), (1, 1), (1, 0)]:
                c = [0, 0, 0]
                c[axis] = val
                c[others[0]], c[others[1]] = u, v
                ring.append(_CORNER_INDEX[tuple(c)])
            rings.append(ring)
    return rings


_FACES = _face_rings()


def _polygon_loops(inside):
    """Surface polygons of one cell as loops of cut-edge indices.

    ``inside``: boolean per corner index. Each face contributes one
    boundary segment per maximal cyclic run of inside corners (pairing the
    two cut edges that bound the run); every cut cube edge belongs to two
    faces, so segments chain into closed loops.
    """
    segments = []  # pairs of cut-edge indices
    for ring in _FACES:
        vals = [inside[c] for c in ring]
        if all(vals) or not any(vals):
            continue
        # maximal cyclic runs of inside corners -> one segment each
        n = 4
        starts = [i for i in range(n) if vals[i] and not vals[i - 1]]
        for s in starts:
            e = s
            while vals[(e + 1) % n]:
                e += 1
            cut_in = _EDGE_INDEX[frozenset((ring[s % n], ring[(s - 1) % n]))]
            cut_out = _EDGE_INDEX[frozenset((ring[e % n],
                                             ring[(e + 1) % n]))]
            segments.append((cut_in, cut_out))

    # stitch segments (2-regular graph on cut edges) into loops
    adj = {}
    for a, b in segments:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, []).append(a)
    loops, seen = [], set()
    for start in adj:
        if start in seen:
            continue
        loop, prev, cur = [start], None, start
        seen.add(start)
        while True:
            nxt = [x for x in adj[cur] if x != prev]
            # len 2 can occur when both neighbors equal prev (2-cycles)
            nxt = nxt[0] if nxt else adj[cur][0]
            if nxt == start:
                break
            loop.append(nxt)
            seen.add(nxt)
            prev, cur = cur, nxt
        loops.append(loop)
    return loops


def _code_area(code, spacing):
    """Total surfel area of one occupancy code under a voxel spacing."""
    inside = [(code >> (7 - c)) & 1 == 1 for c in range(8)]
    area = 0.0
    for loop in _polygon_loops(inside):
        verts = _EDGE_MIDPOINTS[loop] * spacing
        centroid = verts.mean(axis=0)
        v = verts - centroid
        for i in range(len(verts)):
            area += 0.5 * np.linalg.norm(np.cross(v[i],
                                                  v[(i + 1) % len(verts)]))
    return area


@lru_cache(maxsize=32)
def neighbour_code_to_surface_area(spacing_mm):
    """256-entry table: occupancy code -> surfel area (mm^2) for cells of
    the given (d, h, w) voxel spacing."""
    spacing = np.asarray(spacing_mm, np.float64)
    return np.array([_code_area(code, spacing) for code in range(256)])


def _cell_codes(mask):
    """Occupancy code of every 2x2x2 cell of the zero-padded mask; output
    shape = mask.shape + 1 per axis (cell centers on the corner grid)."""
    m = np.pad(mask.astype(np.uint8), 1)
    out_shape = tuple(s + 1 for s in mask.shape)
    code = np.zeros(out_shape, np.int16)
    for c, corner in enumerate(_CORNERS):
        i, j, k = corner
        view = m[i:i + out_shape[0], j:j + out_shape[1], k:k + out_shape[2]]
        code += view.astype(np.int16) << (7 - c)
    return code


# --- 2D (marching squares): boundary LENGTH instead of surface area -----

_CORNERS_2D = [np.array(c) for c in product((0, 1), repeat=2)]
# ring order around the 2x2 cell (consecutive entries are edge neighbors)
_RING_2D = [0, 1, 3, 2]   # (0,0) -> (0,1) -> (1,1) -> (1,0)


def _code_length_2d(code, spacing):
    """Boundary length of one 2x2 occupancy code under (h, w) spacing:
    marching-squares segments with vertices at cut-edge midpoints; on the
    ambiguous diagonal codes the inside corners are separated (the same
    convention as the 3D faces)."""
    inside = [(code >> (3 - c)) & 1 == 1 for c in range(4)]
    vals = [inside[c] for c in _RING_2D]
    if all(vals) or not any(vals):
        return 0.0
    n = 4
    length = 0.0
    starts = [i for i in range(n) if vals[i] and not vals[i - 1]]
    for s in starts:
        e = s
        while vals[(e + 1) % n]:
            e += 1
        a1, b1 = _RING_2D[s % n], _RING_2D[(s - 1) % n]
        a2, b2 = _RING_2D[e % n], _RING_2D[(e + 1) % n]
        m1 = (_CORNERS_2D[a1] + _CORNERS_2D[b1]) / 2.0
        m2 = (_CORNERS_2D[a2] + _CORNERS_2D[b2]) / 2.0
        length += float(np.linalg.norm((m1 - m2) * spacing))
    return length


@lru_cache(maxsize=32)
def neighbour_code_to_surface_length(spacing_mm):
    """16-entry table: 2x2 occupancy code -> boundary length (mm)."""
    spacing = np.asarray(spacing_mm, np.float64)
    return np.array([_code_length_2d(code, spacing) for code in range(16)])


def _cell_codes_2d(mask):
    m = np.pad(mask.astype(np.uint8), 1)
    out_shape = tuple(s + 1 for s in mask.shape)
    code = np.zeros(out_shape, np.int16)
    for c, corner in enumerate(_CORNERS_2D):
        i, j = corner
        view = m[i:i + out_shape[0], j:j + out_shape[1]]
        code += view.astype(np.int16) << (3 - c)
    return code


def surfel_map(mask, spacing_mm):
    """Per-cell surfel weights on the corner grid; zero off-surface.
    3D masks: marching-cubes areas (mm^2); 2D: marching-squares boundary
    lengths (mm)."""
    spacing = tuple(float(s) for s in spacing_mm)
    if mask.ndim == 2:
        return neighbour_code_to_surface_length(spacing)[
            _cell_codes_2d(mask)]
    table = neighbour_code_to_surface_area(spacing)
    return table[_cell_codes(mask)]


def _bbox_slices(mask, margin=1):
    nz = np.nonzero(mask)
    return tuple(slice(max(int(i.min()) - margin, 0),
                       min(int(i.max()) + margin + 1, s))
                 for i, s in zip(nz, mask.shape))


def compute_surface_distances_subvoxel(mask_gt, mask_pred, spacing_mm):
    """Area-weighted surface distances between two binary masks.

    Returns dict with ``distances_gt_to_pred`` / ``distances_pred_to_gt``
    (mm, sorted ascending) and the aligned ``surfel_areas_gt`` /
    ``surfel_areas_pred`` (mm^2) — the same contract as the
    ``surface-distance`` package the reference calls
    (``experiments/metrics.py:16``).
    """
    mask_gt = np.ascontiguousarray(mask_gt, dtype=bool)
    mask_pred = np.ascontiguousarray(mask_pred, dtype=bool)
    spacing = tuple(float(s) for s in spacing_mm)

    union = mask_gt | mask_pred
    if union.any():  # crop to the joint bounding box: EDT cost
        sl = _bbox_slices(union)
        mask_gt, mask_pred = mask_gt[sl], mask_pred[sl]

    areas_gt = surfel_map(mask_gt, spacing)
    areas_pred = surfel_map(mask_pred, spacing)
    borders_gt = areas_gt > 0
    borders_pred = areas_pred > 0

    def one_way(borders_from, areas_from, borders_to):
        a = areas_from[borders_from]
        if not borders_to.any():
            return np.full(a.shape, np.inf), a
        dt = scipy.ndimage.distance_transform_edt(~borders_to,
                                                  sampling=spacing)
        d = dt[borders_from]
        order = np.argsort(d, kind="stable")
        return d[order], a[order]

    d_g2p, a_gt = one_way(borders_gt, areas_gt, borders_pred)
    d_p2g, a_pred = one_way(borders_pred, areas_pred, borders_gt)
    return {"distances_gt_to_pred": d_g2p,
            "distances_pred_to_gt": d_p2g,
            "surfel_areas_gt": a_gt,
            "surfel_areas_pred": a_pred}
