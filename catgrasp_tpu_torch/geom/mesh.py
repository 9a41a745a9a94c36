"""Minimal triangle-mesh container + OBJ I/O + surface sampling.

The port's own numpy copy of ``catgrasp_tpu.geom.mesh``: a mesh is just
``(vertices, faces)`` numpy arrays; the heavy geometry (collision,
rendering) runs on the GPU from tensors built out of these arrays.
Surface sampling draws from a numpy ``Generator`` in the same order as the
JAX package, so both build bit-identical shape libraries from one seed.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np


@dataclass
class TriMesh:
    vertices: np.ndarray  # (V, 3) float32
    faces: np.ndarray  # (F, 3) int32

    def __post_init__(self):
        self.vertices = np.ascontiguousarray(self.vertices, dtype=np.float32)
        self.faces = np.ascontiguousarray(self.faces, dtype=np.int32)

    # -- basic props -------------------------------------------------------
    @property
    def bounds(self) -> np.ndarray:
        return np.stack([self.vertices.min(axis=0), self.vertices.max(axis=0)])

    @property
    def extents(self) -> np.ndarray:
        b = self.bounds
        return b[1] - b[0]

    @property
    def triangles(self) -> np.ndarray:
        return self.vertices[self.faces]  # (F, 3, 3)

    def face_areas(self) -> np.ndarray:
        t = self.triangles
        return 0.5 * np.linalg.norm(np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]), axis=-1)

    def face_normals(self) -> np.ndarray:
        t = self.triangles
        n = np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
        return n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-15)

    def transformed(self, T: np.ndarray) -> "TriMesh":
        v = self.vertices @ T[:3, :3].T + T[:3, 3]
        return replace(self, vertices=v.astype(np.float32))

    def scaled(self, s) -> "TriMesh":
        s = np.asarray(s, dtype=np.float32)
        return replace(self, vertices=(self.vertices * s).astype(np.float32))

    # -- sampling ----------------------------------------------------------
    def sample_surface(self, n: int, rng: np.random.Generator | None = None,
                       return_normals: bool = False):
        """Area-weighted uniform surface samples (replacement for
        ``trimesh.sample.sample_surface_even`` used at
        ``generate_grasp.py:86``).
        """
        rng = rng or np.random.default_rng(0)
        areas = self.face_areas()
        probs = areas / max(areas.sum(), 1e-12)
        fid = rng.choice(len(self.faces), size=n, p=probs)
        t = self.triangles[fid]
        u = rng.random((n, 1)).astype(np.float32)
        v = rng.random((n, 1)).astype(np.float32)
        flip = (u + v) > 1.0
        u = np.where(flip, 1.0 - u, u)
        v = np.where(flip, 1.0 - v, v)
        pts = t[:, 0] + u * (t[:, 1] - t[:, 0]) + v * (t[:, 2] - t[:, 0])
        if return_normals:
            normals = self.face_normals()[fid]
            return pts.astype(np.float32), normals.astype(np.float32)
        return pts.astype(np.float32)

    # -- combination -------------------------------------------------------
    @staticmethod
    def concatenate(meshes: list["TriMesh"]) -> "TriMesh":
        verts, faces, off = [], [], 0
        for m in meshes:
            verts.append(m.vertices)
            faces.append(m.faces + off)
            off += len(m.vertices)
        return TriMesh(np.concatenate(verts), np.concatenate(faces))

    # -- I/O -----------------------------------------------------------------
    def export_obj(self, path: str) -> None:
        with open(path, "w") as f:
            for v in self.vertices:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
            for face in self.faces + 1:
                f.write(f"f {face[0]} {face[1]} {face[2]}\n")

    @staticmethod
    def load_obj(path: str) -> "TriMesh":
        verts, faces = [], []
        with open(path) as f:
            for line in f:
                if line.startswith("v "):
                    verts.append([float(x) for x in line.split()[1:4]])
                elif line.startswith("f "):
                    idx = [tok.split("/")[0] for tok in line.split()[1:]]
                    idx = [int(i) - 1 for i in idx]
                    # fan-triangulate polygons
                    for k in range(1, len(idx) - 1):
                        faces.append([idx[0], idx[k], idx[k + 1]])
        return TriMesh(np.array(verts, dtype=np.float32), np.array(faces, dtype=np.int32))
