"""Simulation data model (``catgrasp_tpu/sim/types.py`` in PyTorch).

A scene is ``SceneState`` (dynamic) + ``SceneParams`` (per-body constants)
over a shared ``ShapeLib`` (per-shape geometry): small dataclasses of
tensors that all live on one device.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from ..device import resolve_device
from ..geom import csg as csglib
from ..geom import sdf as sdflib
from ..geom.mesh import TriMesh

DENSITY = 7800.0  # steel-ish; reference objects are industrial metal parts


@dataclass
class ShapeLib:
    """Library of K shapes (unit scale).  The contact engine and renderer
    evaluate geometry through the stacked analytic CSG trees, or through
    baked SDF grids (the arbitrary-mesh path) where the library has them.
    Per-body uniform scale applies at query time via φ_s(x) = s·φ(x/s)."""

    csg: csglib.CsgShape  # stacked, leading K axis
    surf_pts: torch.Tensor  # (K, P, 3) contact sample points, body frame
    surf_normals: torch.Tensor  # (K, P, 3)
    volume: torch.Tensor  # (K,)
    inertia_unit: torch.Tensor  # (K, 3) diagonal inertia at unit scale, unit density
    radius: torch.Tensor  # (K,) bounding radius (broadphase)
    bounds: torch.Tensor  # (K, 2, 3) unit-scale AABB (NUNOCS normalization)
    sdf_values: torch.Tensor | None = None  # (K, D, D, D) baked grids, if any
    sdf_lower: torch.Tensor | None = None  # (K, 3)
    sdf_spacing: torch.Tensor | None = None  # (K,)

    @property
    def num_shapes(self):
        return self.surf_pts.shape[0]

    @property
    def device(self) -> torch.device:
        return self.surf_pts.device


def build_shape_lib(meshes: list[TriMesh], csg_shapes: list[csglib.CsgShape] | None = None,
                    dims: int = 40, n_surf: int = 64, padding: float = 0.003,
                    seed: int = 0, bake_grids: bool = False, device=None) -> ShapeLib:
    """Build a ShapeLib from meshes (+ matching CSG trees).

    The host-side arithmetic is the JAX package's numpy code, draw for draw,
    so both packages build identical libraries from one seed.  If
    ``csg_shapes`` is None, CSG trees are auto-fit as each mesh's bounding
    box.  With ``bake_grids``, each mesh is also baked on the device into a
    ``dims``-cubed SDF grid (``padding`` around its bounding box) for the
    grid narrowphase and the grid render."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    grids, pts, nrm, vols, inert, rad = [], [], [], [], [], []
    if csg_shapes is None:
        csg_shapes = []
        for m in meshes:
            b = m.bounds
            csg_shapes.append(csglib.csg_box(b[1] - b[0], center=(b[1] + b[0]) / 2))
    for m in meshes:
        if bake_grids:
            grids.append(sdflib.bake_sdf(m.vertices, m.faces, dims=dims, padding=padding,
                                         device=dev))
        p, n = m.sample_surface(n_surf, rng, return_normals=True)
        pts.append(p)
        nrm.append(n)
        # volume via divergence theorem over triangles
        t = m.triangles
        vol = float(np.abs(np.einsum("fi,fi->f", t[:, 0], np.cross(t[:, 1], t[:, 2])).sum() / 6.0))
        vols.append(vol)
        # diagonal inertia from surface-sample second moments, scaled 3/5
        # toward solid-body values
        c = p.mean(axis=0)
        q = p - c
        sec = (q**2).mean(axis=0) * 0.6
        inert.append(np.array([sec[1] + sec[2], sec[0] + sec[2], sec[0] + sec[1]]) * vol)
        rad.append(float(np.linalg.norm(m.vertices, axis=1).max()))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return ShapeLib(
        csg=csglib.stack_shapes(csg_shapes).to(dev),
        surf_pts=t(np.stack(pts)),
        surf_normals=t(np.stack(nrm)),
        volume=t(np.array(vols, dtype=np.float32)),
        inertia_unit=t(np.stack(inert).astype(np.float32)),
        radius=t(np.array(rad, dtype=np.float32)),
        bounds=t(np.stack([m.bounds for m in meshes]).astype(np.float32)),
        sdf_values=torch.stack([g.values for g in grids]) if grids else None,
        sdf_lower=torch.stack([g.lower for g in grids]) if grids else None,
        sdf_spacing=torch.stack([g.spacing for g in grids]) if grids else None,
    )


@dataclass
class SceneParams:
    """Per-body constants of one scene (N = max bodies, fixed), or of a
    batch of scenes: every field may carry leading scene axes (B, N, ...)."""

    shape_id: torch.Tensor  # (..., N) int64
    scale: torch.Tensor  # (..., N) float
    mass: torch.Tensor  # (..., N)
    inertia: torch.Tensor  # (..., N, 3) diagonal, body frame
    friction: torch.Tensor  # (..., N)

    def replace(self, **kw) -> "SceneParams":
        return replace(self, **kw)

    @staticmethod
    def create(lib: ShapeLib, shape_id, scale=None, friction: float = 0.9,
               density: float = DENSITY) -> "SceneParams":
        # friction default = the reference's pile-object lateralFriction 0.9
        dev = lib.device
        shape_id = torch.as_tensor(shape_id, device=dev).long()
        scale = (torch.ones(shape_id.shape, device=dev) if scale is None
                 else torch.as_tensor(scale, dtype=torch.float32, device=dev))
        s2 = scale * scale
        vol = lib.volume[shape_id] * (s2 * scale)
        mass = vol * density
        inertia = lib.inertia_unit[shape_id] * (s2 * s2 * scale)[..., None] * density
        return SceneParams(
            shape_id=shape_id,
            scale=scale,
            mass=mass,
            inertia=inertia,
            friction=torch.full(shape_id.shape, friction, device=dev),
        )


@dataclass
class SceneState:
    """Dynamic state of one scene, or of a batch of scenes: every field may
    carry leading scene axes (B, N, ...), which the JAX package gets from
    ``vmap``."""

    pos: torch.Tensor  # (..., N, 3)
    quat: torch.Tensor  # (..., N, 4) wxyz
    linvel: torch.Tensor  # (..., N, 3)
    angvel: torch.Tensor  # (..., N, 3) world frame
    active: torch.Tensor  # (..., N) bool — inactive bodies are ignored entirely

    def replace(self, **kw) -> "SceneState":
        return replace(self, **kw)

    @staticmethod
    def create(n: int, device=None) -> "SceneState":
        dev = resolve_device(device)
        quat = torch.zeros((n, 4), device=dev)
        quat[:, 0] = 1.0
        return SceneState(
            pos=torch.zeros((n, 3), device=dev),
            quat=quat,
            linvel=torch.zeros((n, 3), device=dev),
            angvel=torch.zeros((n, 3), device=dev),
            active=torch.zeros((n,), dtype=torch.bool, device=dev),
        )


def stack_scenes(scenes: list):
    """Stack one-scene ``SceneState``s (or ``SceneParams``) into a batch with
    a leading scene axis."""
    cls = type(scenes[0])
    return cls(**{f.name: torch.stack([getattr(s, f.name) for s in scenes])
                  for f in fields(cls)})


def as_batch(scene):
    """A one-scene ``SceneState`` or ``SceneParams`` as a batch of one
    (views of its tensors)."""
    return type(scene)(**{f.name: getattr(scene, f.name)[None] for f in fields(scene)})


def index_scenes(batch, idx):
    """Scene ``idx`` (an int, a slice or an index tensor) of a batched
    ``SceneState`` or ``SceneParams``."""
    return type(batch)(**{f.name: getattr(batch, f.name)[idx] for f in fields(batch)})
