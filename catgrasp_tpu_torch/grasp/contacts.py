"""Legacy dexnet surface-window and curvature features
(``catgrasp_tpu/grasp/contacts.py`` in PyTorch).

The reference imports these window features but never calls them (grasp
quality comes from the perturbation rollouts), so the module is kept for
API completeness and offline analysis.  Every function broadcasts over
leading contact axes where JAX ``vmap``s:

* the first tangent axis is the closed form of the reference's in-plane
  rotation search: the projection of the object x axis on the tangent plane
  (the y axis where the plane is perpendicular to x);
* the contact search along the projection direction is a fixed-count
  sampled first zero crossing of the trilinear SDF;
* the bilateral window filter is a fixed 5x5 Gaussian range x spatial
  kernel.

Projection windows default to the inward normal; no-contact cells read
``NO_CONTACT_DIST``, out-of-grid cells -1e-2 in the SDF window.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import transforms as tf
from ..device import constant
from ..geom import sdf as sdflib

NO_CONTACT_DIST = 0.2
WIN_DIST_LIM = 0.02


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(tf.norm(v, keepdim=True), min=1e-12)


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.sum(u * v, dim=-1, keepdim=True)


def tangent_frame(normal: torch.Tensor, direction: torch.Tensor | None = None,
                  align_axes: bool = True):
    """Right-handed contact frame (direction, t1, t2) of normals (..., 3).

    ``direction`` defaults to the inward normal and is flipped inward if it
    points along the outward normal.  With ``align_axes`` the first tangent
    is the in-plane direction closest to the object x axis, else a stable
    perpendicular (the cross product with the axis least aligned with the
    direction)."""
    n = _unit(normal)
    d = -n if direction is None else direction
    d = torch.where(_dot(n, d) > 0, -d, d)
    d = _unit(d)
    if align_axes:
        ex = constant((1.0, 0.0, 0.0), d.dtype, d.device)
        ey = constant((0.0, 1.0, 0.0), d.dtype, d.device)
        px = ex - _dot(ex, d) * d
        py = ey - _dot(ey, d) * d
        t1 = torch.where(tf.norm(px, keepdim=True) < 1e-6, py, px)
    else:
        eye = torch.eye(3, dtype=d.dtype, device=d.device)
        t1 = tf.cross(eye[torch.argmin(torch.abs(d), dim=-1)], d)
    t1 = _unit(t1)
    return d, t1, tf.cross(d, t1)


def _window_grid(point, t1, t2, width, num_steps, cell_centered):
    """Window coordinates (S, S) x2 and cells (..., S, S, 3) on the tangent
    plane at ``point``."""
    if cell_centered:
        res = width / num_steps
        s = torch.linspace(-width / 2 + res / 2, width / 2 - res / 2, num_steps,
                           device=point.device)
    else:
        s = torch.linspace(-width / 2, width / 2, num_steps, device=point.device)
    c1, c2 = torch.meshgrid(s, s, indexing="ij")
    locs = (point[..., None, None, :] + c1[..., None] * t1[..., None, None, :]
            + c2[..., None] * t2[..., None, None, :])
    return c1, c2, locs


def _in_bounds(grid: sdflib.SdfGrid, pts: torch.Tensor) -> torch.Tensor:
    g = (pts - grid.lower) / grid.spacing
    dims = torch.tensor(grid.values.shape, dtype=torch.float32, device=pts.device)
    return torch.all((g >= 0) & (g <= dims - 1), dim=-1)


def _query(grid: sdflib.SdfGrid, pts: torch.Tensor) -> torch.Tensor:
    return sdflib.query(grid.values, grid.lower, grid.spacing, pts)


def surface_window_sdf(grid: sdflib.SdfGrid, point: torch.Tensor, normal: torch.Tensor,
                       width: float = 1e-2, num_steps: int = 21) -> torch.Tensor:
    """(..., S, S) windows of SDF values on the tangent plane of each contact
    (point, normal) (..., 3); out-of-grid cells read -1e-2."""
    _, t1, t2 = tangent_frame(normal)
    _, _, locs = _window_grid(point, t1, t2, width, num_steps, False)
    return torch.where(_in_bounds(grid, locs), _query(grid, locs), -1e-2)


def _first_crossing(phis: torch.Tensor, ts: torch.Tensor):
    """t of the first +→- SDF sign change along sampled rays (..., K),
    linearly interpolated: (found, t*)."""
    a, b = phis[..., :-1], phis[..., 1:]
    crossing = (a >= 0) & (b < 0)
    found = torch.any(crossing, dim=-1)
    i = torch.argmax(crossing.to(torch.uint8), dim=-1, keepdim=True)  # the first
    a_i, b_i = torch.gather(a, -1, i)[..., 0], torch.gather(b, -1, i)[..., 0]
    frac = a_i / torch.clamp(a_i - b_i, min=1e-12)
    return found, ts[i[..., 0]] + frac * (ts[i[..., 0] + 1] - ts[i[..., 0]])


def surface_window_projection(grid: sdflib.SdfGrid, point: torch.Tensor, normal: torch.Tensor,
                              width: float = 1e-2, num_steps: int = 21,
                              max_projection: float = 0.1, back_up: float = 0.0,
                              num_samples: int = 64, align_pca: bool = True,
                              filter_sigma_range: float = 0.1,
                              filter_sigma_spatial: float = 1.0) -> torch.Tensor:
    """(..., S, S) orthographic depth windows: the signed distance from each
    contact's tangent plane to the surface along the inward normal, per
    window cell; no-contact cells read ``NO_CONTACT_DIST``.

    ``align_pca`` recomputes the window in the basis of the SHOT-weighted
    covariance's principal axis and turns it 180 degrees so that the right
    half is the nearer one."""
    d, t1, t2 = tangent_frame(normal)
    ts = torch.linspace(0.0, max_projection + back_up, num_samples, device=point.device)

    def project(u1, u2):
        c1, c2, locs = _window_grid(point, u1, u2, width, num_steps, True)
        dd = d[..., None, None, :]
        rays = (locs - back_up * dd)[..., None, :] + ts[:, None] * dd[..., None, :]
        found, t = _first_crossing(_query(grid, rays), ts)
        proj = torch.clamp(t - back_up, -max_projection, max_projection)
        ok = found & _in_bounds(grid, locs)
        window = torch.where(ok, proj, NO_CONTACT_DIST)
        # SHOT-weighted covariance of the found contact points around the
        # centre contact
        w = torch.where(ok, width / math.sqrt(2.0) - torch.sqrt(c1 ** 2 + c2 ** 2), 0.0)
        diff = (locs + t[..., None] * dd) - point[..., None, None, :]
        cov = torch.einsum("...ij,...ijk,...ijl->...kl", w, diff, diff)
        cov = cov / torch.clamp(torch.sum(w, dim=(-2, -1)), min=1e-12)[..., None, None]
        # transposed: the window's x runs along its columns
        return window.transpose(-1, -2), cov

    window, cov = project(t1, t2)
    if align_pca:
        _, vecs = torch.linalg.eigh(cov)
        pa = vecs[..., :, -1]  # principal axis (largest eigenvalue)
        pa = torch.where(torch.abs(_dot(pa, d)) > 0.999, vecs[..., :, -2], pa)
        u1 = _unit(_dot(pa, t1) * t1 + _dot(pa, t2) * t2)
        window, _ = project(u1, tf.cross(d, u1))
        h = num_steps // 2
        flip = torch.mean(window[..., :, :h], dim=(-2, -1)) \
            > torch.mean(window[..., :, h:], dim=(-2, -1))
        window = torch.where(flip[..., None, None], torch.rot90(window, 2, dims=(-2, -1)),
                             window)
    if filter_sigma_range > 0 and filter_sigma_spatial > 0:
        window = bilateral_filter(window, filter_sigma_range, filter_sigma_spatial)
    return window


def bilateral_filter(img: torch.Tensor, sigma_range: float, sigma_spatial: float,
                     radius: int = 2) -> torch.Tensor:
    """Fixed (2r+1)^2 bilateral filter of windows (..., S, S), wrapping at
    the edges, applied to the windows shifted to be non-negative."""
    shift = torch.amin(img, dim=(-2, -1), keepdim=True)
    x = img - shift
    acc = torch.zeros_like(x)
    norm = torch.zeros_like(x)
    for di in range(-radius, radius + 1):
        for dj in range(-radius, radius + 1):
            sh = torch.roll(x, (di, dj), dims=(-2, -1))
            w = torch.exp(-(di * di + dj * dj) / (2.0 * sigma_spatial ** 2)
                          - (sh - x) ** 2 / (2.0 * sigma_range ** 2))
            acc = acc + w * sh
            norm = norm + w
    return acc / torch.clamp(norm, min=1e-12) + shift


class SurfaceWindow(NamedTuple):
    """A depth window and its differential features, each with the
    windows' leading axes."""
    proj_win: torch.Tensor  # (..., S, S)
    grad_x: torch.Tensor
    grad_y: torch.Tensor
    hess_x: torch.Tensor  # (..., 2, S, S): d/dx and d/dy of grad_x
    hess_y: torch.Tensor
    gauss_curvature: torch.Tensor

    def asarray(self, proj_win_weight=0.0, grad_x_weight=0.0, grad_y_weight=0.0,
                curvature_weight=0.0) -> torch.Tensor:
        """The weighted features of one window as one vector."""
        return torch.cat([proj_win_weight * self.proj_win.ravel(),
                          grad_x_weight * self.grad_x.ravel(),
                          grad_y_weight * self.grad_y.ravel(),
                          curvature_weight * self.gauss_curvature.ravel()])


def window_features(window: torch.Tensor, res: float) -> SurfaceWindow:
    """Gradients, Hessian rows and Gauss curvature of depth windows (...,
    S, S), a Monge patch z = f(x, y): K = (f_xx f_yy - f_xy^2) /
    (1 + f_x^2 + f_y^2)^2."""
    def grads(f):
        return torch.gradient(f, spacing=res, dim=(-2, -1))

    gx, gy = grads(window)
    hxx, hxy = grads(gx)
    hyx, hyy = grads(gy)
    K = (hxx * hyy - hxy * hyx) / (1.0 + gx ** 2 + gy ** 2) ** 2
    return SurfaceWindow(window, gx, gy, torch.stack([hxx, hxy], dim=-3),
                         torch.stack([hyx, hyy], dim=-3), K)


def surface_windows_batch(grid: sdflib.SdfGrid, points: torch.Tensor, normals: torch.Tensor,
                          width: float = 1e-2, num_steps: int = 21, **kw) -> SurfaceWindow:
    """The windows and features of contacts (C, 3) x2: a SurfaceWindow with a
    leading C axis."""
    w = surface_window_projection(grid, points, normals, width, num_steps, **kw)
    return window_features(w, width / num_steps)
