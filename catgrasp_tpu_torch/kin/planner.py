"""Arm motion planning: batched collision checking + RRT-connect
(``catgrasp_tpu/kin/planner.py`` in PyTorch).

The tree bookkeeping (tiny, sequential) stays on the host; every collision
query is a batch of configurations checked on the device: the arm's links
as capsules against the scene point cloud.  The host draws from
``np.random.default_rng(seed)`` in the same calls and order as the JAX
planner, so given the same collision answers both plan the same path.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from . import iiwa

LINK_RADII = np.array([0.09, 0.07, 0.06, 0.05], dtype=np.float32)  # S-E, E-W, W-F, tool


def arm_capsule_points(q: torch.Tensor, n_per_link: int = 6):
    """Capsule axis sample points along the arm for configs q (..., 7):
    returns (..., L, 3) points and per-point radius (L,)."""
    T_S, T_E, T_W, T_F = iiwa.fk_frames(q)
    anchors = torch.stack([torch.zeros_like(T_S[..., :3, 3]), T_S[..., :3, 3],
                           T_E[..., :3, 3], T_W[..., :3, 3], T_F[..., :3, 3]],
                          dim=-2)  # (..., 5, 3)
    a = anchors[..., :-1, :]
    b = anchors[..., 1:, :]
    ts = (torch.arange(n_per_link, dtype=q.dtype, device=q.device) + 0.5) / n_per_link
    pts = a[..., :, None, :] * (1 - ts[:, None]) + b[..., :, None, :] * ts[:, None]
    radii = torch.as_tensor(LINK_RADII, device=q.device).repeat_interleave(n_per_link)
    return pts.reshape(pts.shape[:-3] + (-1, 3)), radii


def configs_collide(qs: torch.Tensor, obstacle_pts: torch.Tensor,
                    obstacle_mask: torch.Tensor, floor_z: float = 0.0) -> torch.Tensor:
    """Batched collision check: (B, 7) configs vs obstacle cloud (C, 3) in
    the robot base frame -> (B,) bool."""
    pts, radii = arm_capsule_points(qs)  # (B, L, 3)
    d2 = torch.sum((pts[:, :, None, :] - obstacle_pts[None, None]) ** 2, dim=-1)
    d2 = torch.where(obstacle_mask[None, None], d2, float("inf"))
    hit_cloud = torch.any(d2 < (radii[None, :, None] ** 2), dim=2).any(dim=1)
    hit_floor = torch.any(pts[..., 2] < floor_z + radii[None, :] * 0.5, dim=1)
    return hit_cloud | hit_floor


def _interp(a, b, n):
    ts = np.linspace(0.0, 1.0, n)[:, None]
    return a[None] * (1 - ts) + b[None] * ts


class RRTConnect:
    """Host-side RRT-connect over device-batched collision checks, with
    shortcut smoothing."""

    def __init__(self, obstacle_pts: np.ndarray, obstacle_mask: np.ndarray | None = None,
                 step: float = 0.2, n_check: int = 8, seed: int = 0,
                 floor_z: float = -0.05, device=None):
        self.device = resolve_device(device)
        self.obs = torch.as_tensor(np.asarray(obstacle_pts, np.float32), device=self.device)
        m = np.ones(len(obstacle_pts), bool) if obstacle_mask is None else obstacle_mask
        self.mask = torch.as_tensor(np.asarray(m), device=self.device)
        self.step = step
        self.n_check = n_check
        self.floor_z = floor_z
        self.rng = np.random.default_rng(seed)

    def _free(self, qs: np.ndarray) -> np.ndarray:
        q = torch.as_tensor(np.asarray(qs, np.float32), device=self.device)
        return ~configs_collide(q, self.obs, self.mask, self.floor_z).cpu().numpy()

    def edge_free(self, a: np.ndarray, b: np.ndarray) -> bool:
        return bool(self._free(_interp(a, b, self.n_check)).all())

    def plan(self, q_start: np.ndarray, q_goal: np.ndarray, max_iter: int = 200,
             smooth_iter: int = 30):
        """Returns a waypoint path (list of q) or None."""
        q_start = np.asarray(q_start, np.float32)
        q_goal = np.asarray(q_goal, np.float32)
        if not self._free(np.stack([q_start, q_goal])).all():
            return None
        if self.edge_free(q_start, q_goal):  # direct path
            return self._smooth([q_start, q_goal], smooth_iter)

        trees = [{0: (q_start, -1)}, {0: (q_goal, -1)}]

        def nearest(tree, q):
            ks = list(tree.keys())
            qs = np.stack([tree[k][0] for k in ks])
            i = int(np.argmin(np.linalg.norm(qs - q, axis=1)))
            return ks[i]

        def extend(tree, q_rand):
            k = nearest(tree, q_rand)
            q_near = tree[k][0]
            d = q_rand - q_near
            dist = np.linalg.norm(d)
            q_new = q_rand if dist <= self.step else q_near + d / dist * self.step
            if self.edge_free(q_near, q_new):
                nk = len(tree)
                tree[nk] = (q_new, k)
                return nk, q_new
            return None, None

        limits = iiwa.JOINT_LIMITS
        for _ in range(max_iter):
            q_rand = self.rng.uniform(-limits, limits).astype(np.float32)
            ka, q_new = extend(trees[0], q_rand)
            if ka is not None:
                kb, q_conn = extend(trees[1], q_new)
                if kb is not None and np.allclose(q_conn, q_new, atol=1e-6) or (
                        kb is not None and self.edge_free(q_conn, q_new)):
                    path_a = self._trace(trees[0], ka)[::-1]
                    path_b = self._trace(trees[1], kb)
                    return self._smooth(path_a + path_b, smooth_iter)
            trees = trees[::-1]  # alternate
        return None

    @staticmethod
    def _trace(tree, k):
        out = []
        while k != -1:
            q, k = tree[k]
            out.append(q)
        return out

    def _smooth(self, path, iters):
        """Shortcut smoothing."""
        path = list(path)
        for _ in range(iters):
            if len(path) <= 2:
                break
            i, j = sorted(self.rng.choice(len(path), 2, replace=False))
            if j - i < 2:
                continue
            if self.edge_free(path[i], path[j]):
                path = path[: i + 1] + path[j:]
        return path


def plan_cartesian_waypoints(poses: np.ndarray, q_seed: np.ndarray | None = None,
                             n_psi: int = 32, device=None):
    """IK along a Cartesian pose path with continuity preference: each
    waypoint takes its valid solution nearest the previous one.  Returns
    (qs (W,7), ok)."""
    dev = resolve_device(device)
    qs_all, valid_all = iiwa.ik_batch(
        torch.as_tensor(np.asarray(poses, np.float32), device=dev), n_psi)
    qs_all = qs_all.cpu().numpy()
    valid_all = valid_all.cpu().numpy()
    out = []
    prev = np.zeros(7, np.float32) if q_seed is None else np.asarray(q_seed)
    for w in range(len(poses)):
        cand = qs_all[w][valid_all[w]]
        if len(cand) == 0:
            return None, False
        d = np.linalg.norm(cand - prev, axis=1)
        prev = cand[int(np.argmin(d))]
        out.append(prev)
    return np.stack(out), True
