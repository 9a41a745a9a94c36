"""Deterministic direction sampling (icosahedral sphere refinement).

The port's own numpy copy of ``catgrasp_tpu.core.sampling``.

Replacement for ``Utils.py:293-391`` (hinter_sampling).  The output feeds
grasp-pose augmentation as a static constant table, so plain numpy is the
right tool — it runs once at setup, never inside jit.
"""
from __future__ import annotations

import math

import numpy as np


def icosphere_directions(min_n_pts: int, radius: float = 1.0) -> np.ndarray:
    """Points on a view sphere by subdividing an icosahedron.

    Same refinement scheme as the reference's ``hinter_sampling``
    (``Utils.py:293``), without the azimuth re-ordering (order is irrelevant
    to every downstream consumer, which either masks by z or subsamples
    randomly).
    """
    a, b, c = 0.0, 1.0, (1.0 + math.sqrt(5.0)) / 2.0
    pts = [
        (-b, c, a), (b, c, a), (-b, -c, a), (b, -c, a), (a, -b, c), (a, b, c),
        (a, -b, -c), (a, b, -c), (c, a, -b), (c, a, b), (-c, a, -b), (-c, a, b),
    ]
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9),
        (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2),
        (3, 2, 6), (3, 6, 8), (3, 8, 9), (4, 9, 5), (2, 4, 11), (6, 2, 10),
        (8, 6, 7), (9, 8, 1),
    ]
    pts = [list(p) for p in pts]
    while len(pts) < min_n_pts:
        edge_pt_map = {}
        faces_new = []
        for face in faces:
            pt_inds = list(face)
            for i in range(3):
                edge = (face[i], face[(i + 1) % 3])
                edge = (min(edge), max(edge))
                if edge not in edge_pt_map:
                    pt_new_id = len(pts)
                    edge_pt_map[edge] = pt_new_id
                    pt_new = 0.5 * (np.array(pts[edge[0]]) + np.array(pts[edge[1]]))
                    pts.append(pt_new.tolist())
                pt_inds.append(edge_pt_map[edge])
            faces_new += [
                (pt_inds[0], pt_inds[3], pt_inds[5]),
                (pt_inds[3], pt_inds[1], pt_inds[4]),
                (pt_inds[3], pt_inds[4], pt_inds[5]),
                (pt_inds[5], pt_inds[4], pt_inds[2]),
            ]
        faces = faces_new

    pts = np.array(pts, dtype=np.float64)
    pts *= radius / np.linalg.norm(pts, axis=1, keepdims=True)
    return pts.astype(np.float32)


def cone_directions(min_n_pts: int, half_angle_deg: float, axis: np.ndarray | None = None) -> np.ndarray:
    """Icosphere directions within ``half_angle_deg`` of +z, then rotated so
    the cone axis is ``axis`` (default +x, matching the grasp sampler's
    convention of approach = +x; see ``grasp_sampler.py:165-170``).
    """
    sphere = icosphere_directions(min_n_pts)
    keep = sphere[:, 2] >= np.cos(np.deg2rad(half_angle_deg))
    dirs = sphere[keep]
    if axis is None:
        axis = np.array([1.0, 0.0, 0.0])
    # Rotate +z to axis: the reference uses Ry(90°) to map z->x
    # (grasp_sampler.py:169-170).
    axis = axis / np.linalg.norm(axis)
    z = np.array([0.0, 0.0, 1.0])
    v = np.cross(z, axis)
    s = np.linalg.norm(v)
    c = float(z @ axis)
    if s < 1e-9:
        R = np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
    else:
        vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
        R = np.eye(3) + vx + vx @ vx * (1 - c) / (s**2)
    return (dirs @ R.T).astype(np.float32)
