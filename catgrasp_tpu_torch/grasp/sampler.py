"""Grasp samplers (``catgrasp_tpu/grasp/sampler.py`` in PyTorch).

* :class:`PointConeGraspSampler`: pick surface points, build a Darboux
  frame from each neighborhood's normal covariance, augment with sphere
  directions within a 60° cone x in-plane rolls x approach depths, then run
  the batched pose filter.  The whole candidate tensor (points x dirs x
  rolls x depths) is built in one pass.
* :class:`NocsTransferGraspSampler`: map a canonical grasp codebook through
  the estimated NUNOCS pose, expanded by the category's symmetries, and
  filter.
* :class:`CombinedGraspSampler`: several samplers' outputs concatenated.

Both samplers can center the object between the fingers
(``center_ob_between_gripper``): the cone sampler shifts each candidate
along its closing axis before the filter, the NOCS sampler zeroes its
codebook's lateral object offsets.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core import transforms as tf
from ..core.sampling import cone_directions
from .filter import filter_grasp_poses
from .gripper import Gripper


def _smallest_eigvecs(cov: torch.Tensor) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue of each symmetric 3x3 (M,3,3).

    Runs LAPACK ``ssyevd`` (lower triangle, after symmetrizing) on the host —
    the routine the JAX reference uses on the CPU — because on a flat patch
    the covariance's smallest eigenvalue is (nearly) double and the basis
    chosen for it is the solver's own: another solver (cuSOLVER, MKL) picks
    another grasp roll.  M is the sample count (<= 64 on the eval path), so
    the host round trip costs microseconds."""
    from scipy.linalg import lapack

    sym = ((cov + cov.transpose(1, 2)) / 2).detach().cpu().numpy()
    out = np.empty((sym.shape[0], 3), np.float32)
    for i, a in enumerate(sym):
        _, v, info = lapack.ssyevd(a, compute_v=1, lower=1)
        if info != 0:
            raise RuntimeError(f"ssyevd failed with info={info}")
        out[i] = v[:, 0]
    return torch.from_numpy(out).to(cov.device)


def darboux_frames(points: torch.Tensor, normals: torch.Tensor,
                   sample_ids: torch.Tensor, r_ball) -> torch.Tensor:
    """Grasp reference frame per sampled surface point: (M, 3, 3) with
    columns [approach, major, minor].

    approach = -normal; minor = smallest-eigenvalue direction of the
    neighborhood normal covariance Σ n nᵀ (within r_ball), orthogonalized
    against the approach; major = minor x approach."""
    p_sel = points[sample_ids]
    n_sel = normals[sample_ids]
    d2 = torch.sum((p_sel[:, None, :] - points[None]) ** 2, dim=-1)  # (M,N)
    w = (d2 <= r_ball * r_ball).to(points.dtype)
    Mcov = torch.einsum("mn,ni,nj->mij", w, normals, normals)
    minor = _smallest_eigvecs(Mcov)

    approach = -n_sel
    approach = approach / (tf.norm(approach, keepdim=True) + 1e-12)
    proj = torch.sum(approach * minor, dim=-1, keepdim=True) * approach
    minor = minor - proj
    minor = minor / (tf.norm(minor, keepdim=True) + 1e-12)
    major = tf.cross(minor, approach)
    major = major / (tf.norm(major, keepdim=True) + 1e-12)
    return torch.stack([approach, major, minor], dim=-1)


def augment_grasp_poses(R0: torch.Tensor, surface_pts: torch.Tensor,
                        sphere_dirs: torch.Tensor, init_bite: float,
                        hand_depth: float, approach_step: float,
                        n_dirs: int, n_inplane: int = 6, n_depths: int = 0) -> torch.Tensor:
    """Candidate pose tensor from base frames: (M, 1 + n_dirs*n_inplane,
    n_depths, 4, 4) flattened to (M * R * D, 4, 4).  Rotations are R0 plus
    R0 @ R_sphere(dir) @ R_inplane(k*180°/n); centers walk the approach axis
    so the fingertip plane goes from init_bite short of the surface point
    to hand_depth past it."""
    dev = R0.device
    if n_depths == 0:
        n_depths = max(int(np.floor(hand_depth / approach_step)), 1)

    ex = torch.tensor([1.0, 0.0, 0.0], device=dev).expand(sphere_dirs.shape)
    R_sph = tf.direction_vec_to_rotation(sphere_dirs, ex)  # (n_dirs,3,3)
    rolls = torch.arange(n_inplane, dtype=torch.float32, device=dev) * (math.pi / n_inplane)
    cr, sr = torch.cos(rolls), torch.sin(rolls)
    R_roll = torch.zeros((n_inplane, 3, 3), device=dev)
    R_roll[:, 0, 0] = 1.0
    R_roll[:, 1, 1] = cr
    R_roll[:, 1, 2] = -sr
    R_roll[:, 2, 1] = sr
    R_roll[:, 2, 2] = cr

    R_aug = torch.einsum("dij,rjk->drik", R_sph, R_roll).reshape(-1, 3, 3)
    Rs = torch.einsum("mij,ajk->maik", R0, R_aug)  # (M, A, 3, 3)
    Rs = torch.cat([R0[:, None], Rs], dim=1)  # + identity augment

    # the grasp-frame origin is the finger ROOT (tips at +hand_depth)
    depths = (init_bite - hand_depth) \
        + torch.arange(n_depths, dtype=torch.float32, device=dev) * approach_step
    approach = Rs[..., :, 0]  # (M, A+1, 3)
    centers = (surface_pts[:, None, None, :]
               + approach[:, :, None, :] * depths[None, None, :, None])
    R_full = Rs[:, :, None].expand(centers.shape[:-1] + (3, 3))
    return tf.pose_from_rt(R_full, centers).reshape(-1, 4, 4)


@dataclass
class PointConeGraspSampler:
    """Surface-point cone sampler."""

    gripper: Gripper
    max_num_samples: int = 100
    n_sphere_dir: int = 30
    approach_step: float = 0.003
    n_inplane: int = 6
    cone_half_angle: float = 60.0

    def draw_ids(self, points: torch.Tensor, generator: torch.Generator):
        """(sample_ids, sub_ids): the surface points to sample, and the
        subsample that estimates the cloud resolution — both drawn without
        replacement."""
        n = points.shape[0]
        perm_a = torch.randperm(n, generator=generator, device=generator.device)
        perm_b = torch.randperm(n, generator=generator, device=generator.device)
        return (perm_a[: min(self.max_num_samples, n)].to(points.device),
                perm_b[: min(128, n)].to(points.device))

    def sample_grasp_poses(self, points, normals, generator: torch.Generator,
                           r_ball=None):
        """Candidate poses (object/camera frame of ``points``), unfiltered."""
        points = torch.as_tensor(points, dtype=torch.float32)
        normals = torch.as_tensor(normals, dtype=torch.float32, device=points.device)
        sample_ids, sub_ids = self.draw_ids(points, generator)
        if r_ball is None:
            # cloud resolution * 3: median nearest-neighbor distance on a
            # subsample; jnp.median's midpoint rule, (lo + hi) * 0.5
            sub = points[sub_ids]
            d2 = torch.sum((sub[:, None] - points[None]) ** 2, dim=-1)
            d2 = torch.where(d2 < 1e-12, float("inf"), d2)
            nn = torch.sort(torch.sqrt(torch.amin(d2, dim=-1))).values
            k = nn.shape[0]
            r_ball = 3.0 * ((nn[(k - 1) // 2] + nn[k // 2]) * 0.5)

        R0 = darboux_frames(points, normals, sample_ids, r_ball)
        dirs = cone_directions(max(self.n_sphere_dir * 4, 100), self.cone_half_angle)
        if len(dirs) > self.n_sphere_dir:
            idx = np.random.default_rng(0).choice(len(dirs), self.n_sphere_dir, replace=False)
            dirs = dirs[idx]
        return augment_grasp_poses(
            R0, points[sample_ids], torch.from_numpy(dirs).to(points.device),
            float(self.gripper.init_bite), float(self.gripper.hand_depth),
            float(self.approach_step), n_dirs=len(dirs), n_inplane=self.n_inplane,
        )

    def sample_grasps(self, points, normals, background_cloud, background_mask,
                      generator: torch.Generator, cam_in_world=None, nocs_pose=None,
                      filter_ik=True, center_ob_between_gripper=False, **filter_kw):
        """Sample + augment (+ center the object between the fingers) +
        filter.  Returns (poses (K,4,4) in camera frame, valid mask, stats)
        with static K."""
        pts = torch.as_tensor(points, dtype=torch.float32)
        dev = pts.device
        poses = self.sample_grasp_poses(pts, normals, generator)
        if center_ob_between_gripper:
            poses = center_object_between_fingers(poses, pts)
        eye = torch.eye(4, device=dev)
        nocs_pose = eye if nocs_pose is None else torch.as_tensor(
            nocs_pose, dtype=torch.float32, device=dev)
        cam_in_world = eye if cam_in_world is None else torch.as_tensor(
            cam_in_world, dtype=torch.float32, device=dev)
        bg = torch.as_tensor(background_cloud, dtype=torch.float32, device=dev)
        return filter_grasp_poses(
            poses, eye[None], nocs_pose, cam_in_world,
            torch.as_tensor(self.gripper.ee_in_grasp, device=dev),
            pts.contiguous(), bg.contiguous(),
            torch.ones(pts.shape[0], dtype=torch.bool, device=dev),
            torch.as_tensor(background_mask, device=dev),
            spec=self.gripper.spec, filter_ik=filter_ik, **filter_kw,
        )


CENTER_CHUNK = 4096  # grasps a pass: bounds the (chunk, C, 3) grasp-frame cloud


def center_object_between_fingers(poses: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Shift each grasp (K, 4, 4) along its closing axis so the object cloud
    (C, 3) is centered between the fingers, ``CENTER_CHUNK`` grasps a pass."""
    out = poses.clone()
    for i in range(0, poses.shape[0], CENTER_CHUNK):
        T = poses[i:i + CENTER_CHUNK]
        pts_g = tf.transform_points(tf.pose_inverse(T), points)  # (chunk, C, 3)
        c = (torch.amax(pts_g[..., 1], dim=-1) + torch.amin(pts_g[..., 1], dim=-1)) / 2
        out[i:i + CENTER_CHUNK, :3, 3] = T[:, :3, 3] + T[:, :3, 1] * c[:, None]
    return out


@dataclass
class NocsTransferGraspSampler:
    """Map the canonical grasp codebook into the scene via the estimated 9D
    NUNOCS pose."""

    gripper: Gripper
    canonical_grasps: np.ndarray  # (K, 4, 4) grasp poses in canonical frame
    canonical_scores: np.ndarray  # (K,) perturbation scores
    score_larger_than: float = 0.0
    max_n_grasp: int | None = None
    center_ob_between_gripper: bool = False

    def __post_init__(self):
        """Keep the grasps scored at least ``score_larger_than``, the best
        ``max_n_grasp`` of them; with ``center_ob_between_gripper``, zero
        each kept grasp's object-in-grasp offset along the closing axis."""
        keep = self.canonical_scores >= self.score_larger_than
        g, s = self.canonical_grasps[keep], self.canonical_scores[keep]
        if self.max_n_grasp is not None and len(g) > self.max_n_grasp:
            order = np.argsort(-s)[: self.max_n_grasp]
            g, s = g[order], s[order]
        if self.center_ob_between_gripper:
            for i in range(len(g)):
                ob_in_grasp = np.linalg.inv(g[i])
                ob_in_grasp[1, 3] = 0.0
                g[i] = np.linalg.inv(ob_in_grasp)
        self.canonical_grasps, self.canonical_scores = g, s

    def sample_grasps(self, nocs_pose, symmetry_tfs, background_cloud, background_mask,
                      collision_cloud, collision_mask, cam_in_world=None,
                      filter_ik=True, filter_approach=False, **filter_kw):
        """The codebook x symmetries, filtered: (poses (K*S, 4, 4) in camera
        frame, valid mask, stats), on the device of ``nocs_pose``."""
        nocs_pose = torch.as_tensor(nocs_pose, dtype=torch.float32)
        dev = nocs_pose.device

        def t(x, dtype=torch.float32):
            return torch.as_tensor(x, dtype=dtype, device=dev)

        cam_in_world = torch.eye(4, device=dev) if cam_in_world is None else t(cam_in_world)
        return filter_grasp_poses(
            t(self.canonical_grasps), t(symmetry_tfs), nocs_pose, cam_in_world,
            t(self.gripper.ee_in_grasp), t(collision_cloud).contiguous(),
            t(background_cloud).contiguous(), t(collision_mask, torch.bool),
            t(background_mask, torch.bool), spec=self.gripper.spec, filter_ik=filter_ik,
            filter_approach=filter_approach, **filter_kw,
        )


@dataclass
class CombinedGraspSampler:
    """Several samplers of one kind called with the same arguments: (the
    concatenated poses, the concatenated valid masks, the list of their
    stats)."""

    samplers: list

    def sample_grasps(self, **kwargs):
        outs = [s.sample_grasps(**kwargs) for s in self.samplers]
        poses = torch.cat([o[0] for o in outs])
        valid = torch.cat([o[1] for o in outs])
        return poses, valid, [o[2] for o in outs]
