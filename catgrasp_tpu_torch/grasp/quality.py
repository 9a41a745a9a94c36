"""Analytic grasp quality: friction cones and the Ferrari-Canny wrench
metric (``catgrasp_tpu/grasp/quality.py`` in PyTorch).

Oracle mode of the eval loop has no trained quality net, so it ranks grasps
by :func:`parallel_jaw_quality`: the finger-contact model scored with a
lower bound of the Ferrari-Canny L1 metric, the radius of the largest
origin-centred ball inside the convex hull of the contact cone-edge
wrenches, taken as the minimum of the hull's support function over a fixed
table of 256 directions in wrench space.

The table is data, not randomness: the JAX package draws it as
``jax.random.normal(PRNGKey(0), (256, 6))`` on every call, a stream torch
cannot reproduce, so the port carries that draw as ``quality_dirs.npy``
(float32, before normalisation) beside this module.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..core import transforms as tf

DIRS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "quality_dirs.npy")
_GRASPS_PER_CHUNK = 16  # bounds the (grasps, directions, wrenches) support tensor


def wrench_directions(device) -> torch.Tensor:
    """The (256, 6) unit directions in wrench space the metric is taken on."""
    u = torch.from_numpy(np.load(DIRS_FILE)).to(device)
    return u / (tf.norm(u, keepdim=True) + 1e-12)


def friction_cone_edges(normals: torch.Tensor, mu: float, n_edges: int = 8) -> torch.Tensor:
    """Discretize the friction cone at each contact into force edges:
    inward normals (..., C, 3) -> (..., C, n_edges, 3) unit forces on the
    cone boundary."""
    dev = normals.device
    n = normals / (tf.norm(normals, keepdim=True) + 1e-12)
    a = torch.where(torch.abs(n[..., :1]) < 0.9, torch.tensor([1.0, 0.0, 0.0], device=dev),
                    torch.tensor([0.0, 1.0, 0.0], device=dev))
    t1 = tf.cross(n, a)
    t1 = t1 / (tf.norm(t1, keepdim=True) + 1e-12)
    t2 = tf.cross(n, t1)
    ang = torch.arange(n_edges, dtype=torch.float32, device=dev) * (2 * math.pi / n_edges)
    tang = (torch.cos(ang)[:, None] * t1[..., None, :]
            + torch.sin(ang)[:, None] * t2[..., None, :])  # (..., C, E, 3)
    e = n[..., None, :] + mu * tang
    return e / (tf.norm(e, keepdim=True) + 1e-12)


def contact_wrenches(points: torch.Tensor, normals: torch.Tensor, mu: float,
                     n_edges: int = 8, soft_fingers: bool = True) -> torch.Tensor:
    """Cone-edge wrenches of contact sets: points/normals (..., C, 3) ->
    (..., C*n_edges [+ 2C], 6).  Points are about the object centroid,
    normals inward; torques are scaled by 1/max||p|| over ALL the points;
    ``soft_fingers`` adds ±normal torsional wrenches."""
    forces = friction_cone_edges(normals, mu, n_edges)  # (..., C, E, 3)
    torque_scale = 1.0 / (torch.amax(tf.norm(points), dim=-1) + 1e-9)  # (...)
    ts = torque_scale[..., None, None, None]
    torques = tf.cross(points[..., :, None, :].expand(forces.shape), forces) * ts
    w = torch.cat([forces, torques], dim=-1).reshape(points.shape[:-2] + (-1, 6))
    if soft_fingers:
        n = normals / (tf.norm(normals, keepdim=True) + 1e-12)
        tor = mu * torque_scale[..., None, None] * n
        zeros = torch.zeros_like(n)
        w = torch.cat([w, torch.cat([zeros, tor], dim=-1), torch.cat([zeros, -tor], dim=-1)],
                      dim=-2)
    return w


def epsilon_quality(points: torch.Tensor, normals: torch.Tensor, mask: torch.Tensor,
                    mu: float = 0.5, n_edges: int = 8, soft_fingers: bool = True) -> torch.Tensor:
    """Ferrari-Canny L1 lower bound of contact sets (..., C, 3) with validity
    masks (..., C): Q = max(0, min_u max_j w_j.u) over the direction table,
    0 without force closure (fewer than 2 contacts)."""
    w = contact_wrenches(points, normals, mu, n_edges, soft_fingers)
    wmask = mask.repeat_interleave(n_edges, dim=-1)
    if soft_fingers:
        wmask = torch.cat([wmask, mask, mask], dim=-1)
    dirs = wrench_directions(points.device)  # (U, 6)
    s = torch.einsum("ud,...wd->...uw", dirs, w)
    s = torch.where(wmask[..., None, :], s, float("-inf"))
    q = torch.amin(torch.amax(s, dim=-1), dim=-1)
    q = torch.where(torch.sum(mask, dim=-1) >= 2, q, -1.0)
    return torch.clamp(q, min=0.0)


def _parallel_jaw_quality(cloud, grasps, spec, mu, surface_tol):
    dev = cloud.device
    R, t = grasps[:, :3, :3], grasps[:, :3, 3]
    pg = (cloud[None] - t[:, None, :]) @ R  # (G, C, 3), grasp frame
    inside_x = (pg[..., 0] > 0.0) & (pg[..., 0] < spec.finger_len)
    inside_z = torch.abs(pg[..., 2]) < spec.finger_depth / 2
    between = inside_x & inside_z & (torch.abs(pg[..., 1]) < spec.max_width / 2)
    y = torch.where(between, pg[..., 1], 0.0)
    w_hi = torch.amax(torch.where(between, y, -1e9), dim=-1, keepdim=True)
    w_lo = torch.amin(torch.where(between, y, 1e9), dim=-1, keepdim=True)
    m_pos = between & (pg[..., 1] > w_hi - surface_tol)
    m_neg = between & (pg[..., 1] < w_lo + surface_tol)
    contacts = m_pos | m_neg
    n_contacts = torch.sum(contacts, dim=-1)
    c = torch.sum(torch.where(contacts[..., None], pg, 0.0), dim=-2) \
        / torch.clamp(n_contacts, min=1)[:, None]
    n_in = torch.where(m_pos[..., None], torch.tensor([0.0, -1.0, 0.0], device=dev),
                       torch.tensor([0.0, 1.0, 0.0], device=dev))
    q = epsilon_quality(pg - c[:, None, :], n_in, contacts, mu=mu)
    ok = m_pos.any(dim=-1) & m_neg.any(dim=-1) & (n_contacts >= 4)
    # engagement: how deep the contact patch sits toward the palm (palm at
    # x=0, tips at finger_len); tip-held objects shake loose
    fl = spec.finger_len
    depth = (fl - torch.amin(torch.where(contacts, pg[..., 0], fl), dim=-1)) / fl
    q = q * (0.4 + 0.6 * torch.clamp(depth, 0.0, 1.0))
    return torch.where(ok, q, 0.0)


def parallel_jaw_quality(cloud: torch.Tensor, normals: torch.Tensor, grasps: torch.Tensor,
                         spec, n_pts: int = 512, mu: float = 0.5,
                         surface_tol: float = 0.004) -> torch.Tensor:
    """Analytic grasp-quality proxy of parallel-jaw grasps (G, 4, 4) on an
    object cloud (C, 3) -> (G,).

    For each grasp: the first ``n_pts`` cloud points in the grasp frame,
    the closing width from the y-extent of the points inside the closing
    region, the points each finger would touch as contacts (inward normals
    -/+ the closing axis), scored with the Ferrari-Canny lower bound about
    the contact centroid and weighted by how deep the contacts sit.  Zero
    when a finger touches nothing.  ``normals`` is accepted for the JAX
    signature; the contact model does not read it."""
    cloud = cloud[:n_pts]
    out = [_parallel_jaw_quality(cloud, grasps[s:s + _GRASPS_PER_CHUNK], spec, mu, surface_tol)
           for s in range(0, grasps.shape[0], _GRASPS_PER_CHUNK)]
    if not out:
        return torch.zeros((0,), device=cloud.device)
    return torch.cat(out)
