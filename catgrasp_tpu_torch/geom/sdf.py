"""Signed-distance grids (``catgrasp_tpu/geom/sdf.py`` in PyTorch): the
bake of a watertight mesh into a uniform grid, and trilinear lookups.

The bake computes exact point-triangle distances and signs them with
generalized winding numbers, which stays correct for unions of overlapping
watertight parts where ray parity breaks.  It runs on the device of the
caller, in chunks of grid points that bound its memory.

This is plain PyTorch on the device by design: the JAX package computes the
bake, the lookups and the grid narrowphase and march built on them as XLA
code, not as Pallas kernels, so there is no hand-written kernel to port.

``query_shapes`` and ``query_and_grad_shapes`` look up a library of stacked
grids (K, D, D, D) with a shape index per point, so the engine and the
renderer evaluate every (point, body) pair of a scene in one gather.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..device import constant, resolve_device

# (grid point, triangle) pairs a chunk of the bake evaluates at once: the
# chunk's temporaries are a few dozen float tensors of this many elements
BAKE_PAIRS_PER_CHUNK = 1 << 22


@dataclass
class SdfGrid:
    """Uniform signed-distance grid.  ``values[i,j,k]`` is the signed
    distance at ``lower + (i,j,k)*spacing`` (negative inside)."""

    values: torch.Tensor  # (N, N, N) float32
    lower: torch.Tensor  # (3,) float32 world coords of voxel (0,0,0)
    spacing: torch.Tensor  # () float32

    @property
    def dims(self):
        return tuple(self.values.shape)


# ---------------------------------------------------------------------------
# Bake
# ---------------------------------------------------------------------------


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.sum(u * v, dim=-1)


def _point_tri_dist_sq(p: torch.Tensor, a, b, c) -> torch.Tensor:
    """Squared distance from points p (M, 3) to triangles (F, 3): (M, F).
    Branch-free Ericson region test."""
    ab = b - a  # (F,3)
    ac = c - a
    ap = p[:, None, :] - a[None]  # (M,F,3)
    bp = p[:, None, :] - b[None]
    cp = p[:, None, :] - c[None]
    d1, d2 = _dot(ab, ap), _dot(ac, ap)
    d3, d4 = _dot(ab, bp), _dot(ac, bp)
    d5, d6 = _dot(ab, cp), _dot(ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    on_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)

    eps = 1e-20

    def safe(den):
        return torch.where(torch.abs(den) < eps, eps, den)

    v_ab = d1 / safe(d1 - d3)
    w_ac = d2 / safe(d2 - d6)
    w_bc = (d4 - d3) / safe((d4 - d3) + (d5 - d6))
    denom = safe(va + vb + vc)
    v_in = vb / denom
    w_in = vc / denom

    cp_ab = a[None] + torch.clamp(v_ab, 0.0, 1.0)[..., None] * ab[None]
    cp_ac = a[None] + torch.clamp(w_ac, 0.0, 1.0)[..., None] * ac[None]
    cp_bc = b[None] + torch.clamp(w_bc, 0.0, 1.0)[..., None] * (c - b)[None]
    cp_in = a[None] + v_in[..., None] * ab[None] + w_in[..., None] * ac[None]

    closest = cp_in
    closest = torch.where(on_bc[..., None], cp_bc, closest)
    closest = torch.where(on_ac[..., None], cp_ac, closest)
    closest = torch.where(on_ab[..., None], cp_ab, closest)
    closest = torch.where(in_c[..., None], c[None].expand_as(closest), closest)
    closest = torch.where(in_b[..., None], b[None].expand_as(closest), closest)
    closest = torch.where(in_a[..., None], a[None].expand_as(closest), closest)
    d = p[:, None, :] - closest
    return torch.sum(d * d, dim=-1)


def _winding_number(p: torch.Tensor, a, b, c) -> torch.Tensor:
    """Generalized winding number of points p (M, 3) with respect to the
    closed surface of triangles (a, b, c each (F, 3)), by the van Oosterom
    and Strackee solid angle."""
    av = a[None] - p[:, None, :]
    bv = b[None] - p[:, None, :]
    cv = c[None] - p[:, None, :]
    la = torch.sqrt(_dot(av, av))
    lb = torch.sqrt(_dot(bv, bv))
    lc = torch.sqrt(_dot(cv, cv))
    det = _dot(av, torch.linalg.cross(bv, cv, dim=-1))
    denom = la * lb * lc + _dot(av, bv) * lc + _dot(bv, cv) * la + _dot(cv, av) * lb
    omega = 2.0 * torch.atan2(det, denom)
    return torch.sum(omega, dim=-1) / (4.0 * math.pi)


def _sdf_points(pts: torch.Tensor, tris: torch.Tensor, chunk: int | None = None) -> torch.Tensor:
    """Signed distance of points (M, 3) to a closed triangle soup (F, 3, 3),
    ``chunk`` points at a time (by default as many as keep a chunk's
    (point, triangle) pairs within ``BAKE_PAIRS_PER_CHUNK``)."""
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    if chunk is None:
        chunk = max(1, BAKE_PAIRS_PER_CHUNK // max(tris.shape[0], 1))
    out = []
    for s in range(0, pts.shape[0], chunk):
        q = pts[s:s + chunk]
        dist = torch.sqrt(torch.amin(_point_tri_dist_sq(q, a, b, c), dim=-1))
        sign = torch.where(_winding_number(q, a, b, c) > 0.5, -1.0, 1.0)
        out.append(dist * sign)
    return torch.cat(out) if out else pts.new_zeros((0,))


def grid_points(lower: torch.Tensor, spacing, dims) -> torch.Tensor:
    """The (prod(dims), 3) world points of a grid, index order i, j, k."""
    dev = lower.device
    ii, jj, kk = torch.meshgrid(*(torch.arange(n, device=dev) for n in dims), indexing="ij")
    idx = torch.stack([ii, jj, kk], dim=-1).reshape(-1, 3).to(torch.float32)
    return lower[None] + idx * spacing


def bake_sdf(vertices: np.ndarray, faces: np.ndarray, dims: int = 48,
             padding: float = 0.004, chunk: int | None = None, device=None) -> SdfGrid:
    """Voxelize a watertight mesh (or union of watertight parts) into an
    :class:`SdfGrid` on ``device``.  The grid is cubic (``dims`` a side),
    centred on the padded bounding box, so the grids of a library stack
    into one (K, N, N, N) tensor."""
    dev = resolve_device(device)
    v = torch.as_tensor(np.asarray(vertices, np.float32), device=dev)
    f = torch.as_tensor(np.asarray(faces, np.int64), device=dev)
    tris = v[f]  # (F,3,3)
    lo = torch.amin(v, dim=0) - padding
    hi = torch.amax(v, dim=0) + padding
    spacing = torch.amax(hi - lo) / (dims - 1)
    center = (lo + hi) / 2
    half = spacing * (dims - 1) / 2
    lower = center - half
    pts = grid_points(lower, spacing, (dims, dims, dims))
    vals = _sdf_points(pts, tris, chunk=chunk).reshape(dims, dims, dims)
    return SdfGrid(values=vals, lower=lower, spacing=spacing)


# ---------------------------------------------------------------------------
# Query
# ---------------------------------------------------------------------------


def _corners(values: torch.Tensor, lower: torch.Tensor, spacing: torch.Tensor,
             shape_id, pts: torch.Tensor):
    """The 8 corner values around each point (..., 3) in the grids
    ``values`` (K, D0, D1, D2), grid ``shape_id`` (broadcast against the
    points' leading axes), with ``lower`` (..., 3) and ``spacing`` (...) of
    that grid: (v000, v100, v010, v110, v001, v101, v011, v111), the
    fractions (..., 3) and the vector from the clamped to the true point
    (..., 3)."""
    dims_i = values.shape[1:]
    dims = constant(tuple(float(n) for n in dims_i), torch.float32, pts.device)
    g = (pts - lower) / spacing[..., None]
    g_cl = torch.minimum(torch.clamp(g, min=0.0), dims - 1.000001)
    i0 = torch.floor(g_cl).to(torch.int64)
    i0 = torch.minimum(i0, constant(tuple(n - 2 for n in dims_i), torch.int64, pts.device))
    frac = g_cl - i0
    flat = values.reshape(-1)
    base = (torch.as_tensor(shape_id, device=pts.device) * (dims_i[0] * dims_i[1] * dims_i[2])
            + (i0[..., 0] * dims_i[1] + i0[..., 1]) * dims_i[2] + i0[..., 2])
    sx, sy = dims_i[1] * dims_i[2], dims_i[2]
    corners = [flat[base + dx * sx + dy * sy + dz]
               for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
    return corners, frac, (g - g_cl) * spacing[..., None]


def _lerp3(corners, frac):
    v000, v100, v010, v110, v001, v101, v011, v111 = corners
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    c00 = v000 * (1 - fx) + v100 * fx
    c10 = v010 * (1 - fx) + v110 * fx
    c01 = v001 * (1 - fx) + v101 * fx
    c11 = v011 * (1 - fx) + v111 * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz, (c00, c10, c01, c11, c0, c1)


def query_shapes(values: torch.Tensor, lowers: torch.Tensor, spacings: torch.Tensor,
                 shape_id, pts: torch.Tensor) -> torch.Tensor:
    """Trilinear signed distance of points (..., 3) in the stacked grids
    ``values`` (K, N, N, N), grid ``shape_id`` (an int or a tensor that
    broadcasts against the points' leading axes).  Outside its grid a point
    reads the boundary value plus its Euclidean distance to the grid box, a
    conservative exterior estimate, so far points never read as colliding."""
    sid = torch.as_tensor(shape_id, device=pts.device)
    corners, frac, out_vec = _corners(values, lowers[sid], spacings[sid], sid, pts)
    val, _ = _lerp3(corners, frac)
    return val + torch.sqrt(torch.sum(out_vec * out_vec, dim=-1))


def query(grid_values: torch.Tensor, lower: torch.Tensor, spacing: torch.Tensor,
          pts: torch.Tensor) -> torch.Tensor:
    """Trilinear lookup in one grid (N, N, N), batched over points (..., 3);
    see :func:`query_shapes`."""
    return query_shapes(grid_values[None], lower[None], torch.reshape(spacing, (1,)), 0, pts)


def query_and_grad_shapes(values: torch.Tensor, lowers: torch.Tensor, spacings: torch.Tensor,
                          shape_id, pts: torch.Tensor):
    """Trilinear value AND analytic gradient from one 8-corner fetch in the
    stacked grids (see :func:`query_shapes`): (phi (...,), unit normal
    (..., 3)).  Outside the grid the boundary value gets the Euclidean push
    of :func:`query_shapes` and its direction joins the gradient."""
    sid = torch.as_tensor(shape_id, device=pts.device)
    spacing = spacings[sid]
    corners, frac, out_vec = _corners(values, lowers[sid], spacing, sid, pts)
    val, (c00, c10, c01, c11, c0, c1) = _lerp3(corners, frac)
    v000, v100, v010, v110, v001, v101, v011, v111 = corners
    fy, fz = frac[..., 1], frac[..., 2]
    dx = (((v100 - v000) * (1 - fy) + (v110 - v010) * fy) * (1 - fz)
          + ((v101 - v001) * (1 - fy) + (v111 - v011) * fy) * fz)
    dy = (c10 - c00) * (1 - fz) + (c11 - c01) * fz
    dz = c1 - c0
    grad_in = torch.stack([dx, dy, dz], dim=-1) / spacing[..., None]
    out_d = torch.sqrt(torch.sum(out_vec * out_vec, dim=-1))[..., None]
    n = grad_in + out_vec / (out_d + 1e-9) * (out_d > 0)
    n = n / (torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True)) + 1e-9)
    return val + out_d[..., 0], n


def query_and_grad(grid_values: torch.Tensor, lower: torch.Tensor, spacing: torch.Tensor,
                   pts: torch.Tensor):
    """:func:`query_and_grad_shapes` in one grid (N, N, N)."""
    return query_and_grad_shapes(grid_values[None], lower[None], torch.reshape(spacing, (1,)),
                                 0, pts)


def grad(grid_values: torch.Tensor, lower: torch.Tensor, spacing: torch.Tensor,
         pts: torch.Tensor, eps: float | None = None) -> torch.Tensor:
    """SDF gradient (outward normal direction) by central differences."""
    e = spacing * 0.5 if eps is None else torch.as_tensor(eps, dtype=torch.float32,
                                                           device=pts.device)
    eye = torch.eye(3, device=pts.device)
    g = torch.stack([query(grid_values, lower, spacing, pts + eye[k] * e)
                     - query(grid_values, lower, spacing, pts - eye[k] * e)
                     for k in range(3)], dim=-1) / (2 * e)
    return g / (torch.sqrt(torch.sum(g * g, dim=-1, keepdim=True)) + 1e-9)


def mesh_sdf_points(pts: torch.Tensor, vertices, faces, chunk: int | None = None) -> torch.Tensor:
    """Direct (no grid) signed distance of points (M, 3) to a mesh: the
    exact oracle that bake + query are checked against."""
    v = torch.as_tensor(np.asarray(vertices, np.float32), device=pts.device)
    tris = v[torch.as_tensor(np.asarray(faces, np.int64), device=pts.device)]
    return _sdf_points(pts, tris, chunk=chunk)
