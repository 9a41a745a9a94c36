"""Broadphase-free collision manager (``catgrasp_tpu/geom/collision_manager.py``
in PyTorch), the analog of the reference's FCL ``CollisionManager``.

Every registered mesh carries a baked SDF grid and a set of surface points,
and a pair test moves one body's points into the other's grid and looks up
its SDF (both directions where both are meshes).  A point cloud is a point
set tested against every mesh's SDF.  The grids and the points live on the
manager's device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import transforms as tf
from ..device import resolve_device
from . import sdf as sdflib


@dataclass
class _Body:
    name: str
    kind: str  # "mesh" | "cloud"
    T: np.ndarray
    grid: sdflib.SdfGrid | None = None
    points: torch.Tensor | None = None  # local-frame surface / cloud points


class CollisionManager:
    """Register meshes and clouds, set their poses, ask for distances and
    collisions (snake_case of the reference's ``CollisionManager``).

    >>> cm = CollisionManager(device="cpu")
    >>> cm.register_mesh("nut", V, F)
    >>> cm.register_cloud("scan", pts)
    >>> cm.set_transform("nut", T)
    >>> cm.is_any_collision()
    """

    def __init__(self, dims: int = 48, n_surf: int = 512, device=None):
        self.dims = dims
        self.n_surf = n_surf
        self.device = resolve_device(device)
        self.bodies: dict[str, _Body] = {}

    def register_mesh(self, name: str, vertices: np.ndarray, faces: np.ndarray,
                      T: np.ndarray | None = None):
        """A watertight mesh: its grid is baked at ``dims`` a side."""
        grid = sdflib.bake_sdf(np.asarray(vertices, np.float32), np.asarray(faces),
                               dims=self.dims, device=self.device)
        pts = _sample_surface(np.asarray(vertices, np.float32), np.asarray(faces), self.n_surf)
        self.bodies[name] = _Body(name, "mesh", _eye_if(T), grid,
                                  torch.from_numpy(pts).to(self.device))

    def register_cloud(self, name: str, points: np.ndarray, resolution: float = 1e-3,
                       T: np.ndarray | None = None):
        """A point cloud; ``resolution`` (the reference's octree leaf size)
        has no SDF analog: the points are used as they are."""
        del resolution
        self.bodies[name] = _Body(name, "cloud", _eye_if(T), points=torch.as_tensor(
            np.asarray(points, np.float32), device=self.device))

    def set_transform(self, name: str, T: np.ndarray):
        self.bodies[name].T = np.asarray(T, np.float64)

    def min_distance_pair(self, name_a: str, name_b: str) -> float:
        """Minimum signed distance between bodies a and b (negative =
        penetration).  At least one of the two must be a mesh."""
        a, b = self.bodies[name_a], self.bodies[name_b]
        best = np.inf
        if a.kind == "mesh":
            best = min(best, self._pts_vs_grid(b, a))
        if b.kind == "mesh":
            best = min(best, self._pts_vs_grid(a, b))
        if not np.isfinite(best):
            raise ValueError(f"no mesh in pair ({name_a}, {name_b})")
        return best

    def in_collision(self, name_a: str, name_b: str, margin: float = 0.0) -> bool:
        return self.min_distance_pair(name_a, name_b) < margin

    def is_any_collision(self, margin: float = 0.0) -> bool:
        """Any pair in collision; two clouds are never tested against each
        other."""
        names = list(self.bodies)
        for i in range(len(names)):
            for j in range(i + 1, len(names)):
                a, b = self.bodies[names[i]], self.bodies[names[j]]
                if a.kind == "cloud" and b.kind == "cloud":
                    continue
                if self.in_collision(names[i], names[j], margin):
                    return True
        return False

    def _pts_vs_grid(self, pts_body: _Body, grid_body: _Body) -> float:
        """The least SDF value of ``pts_body``'s points in ``grid_body``'s
        grid, both at their poses."""
        def pose(T):
            return torch.as_tensor(np.asarray(T, np.float32), device=self.device)

        w = tf.transform_points(pose(pts_body.T), pts_body.points)
        local = tf.transform_points(tf.pose_inverse(pose(grid_body.T)), w)
        g = grid_body.grid
        return float(torch.amin(sdflib.query(g.values, g.lower, g.spacing, local)))


def _eye_if(T):
    return np.eye(4) if T is None else np.asarray(T, np.float64)


def _sample_surface(V: np.ndarray, F: np.ndarray, n: int) -> np.ndarray:
    """Area-weighted surface samples and up to n/4 vertices (so thin
    features are not missed), drawn on the host at registration with numpy's
    rng seeded 0, draw for draw as the JAX package."""
    rng = np.random.default_rng(0)
    tri = V[F]
    area = np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=-1)
    idx = rng.choice(len(F), n, p=area / area.sum())
    u, v = rng.uniform(size=(2, n)).astype(np.float32)
    flip = u + v > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    t = tri[idx]
    pts = t[:, 0] + u[:, None] * (t[:, 1] - t[:, 0]) + v[:, None] * (t[:, 2] - t[:, 0])
    return np.concatenate([pts, V[rng.choice(len(V), min(len(V), n // 4))]])
