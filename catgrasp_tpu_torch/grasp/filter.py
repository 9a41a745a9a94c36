"""Batched grasp-pose filter (``catgrasp_tpu/grasp/filter.py`` in PyTorch).

Per candidate pose x symmetry: approach-direction gate, IK-feasibility
gate, then the collision gate — the scene clouds moved into each grasp
frame and tested against the gripper's analytic boxes for 7 lateral offsets
(reference search order 0, +1, -1, +2, -2, +3, -3 mm) and, with
``adjust_depth``, 4 approach depths.  The collision gate is kernel K1
(``ops.collision.box_hits_depths``): two launches a call, one for the open
gripper against the collision cloud and one for the closing volume against
the background cloud, each answering every depth (a depth shifts the boxes
+x) from one pass over its cloud.  All stages produce masks over a fixed (G*S)
candidate axis; callers compact on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import transforms as tf
from ..kin import iiwa
from ..ops import collision
from ..sim.env_grasp import GripperSpec, closing_channel_mask

ADJUST_OFFSETS = np.array([0.0, 1e-3, -1e-3, 2e-3, -2e-3, 3e-3, -3e-3], dtype=np.float32)
# approach-depth adjust extension (deepest collision-free engagement wins)
DEPTH_OFFSETS = np.array([0.0, 1e-3, 2e-3, 3e-3], dtype=np.float32)


def _static_open_boxes(spec: GripperSpec, depth: float = 0.0) -> tuple:
    """Open-gripper finger/palm boxes; ``depth`` shifts them +x, which equals
    testing the grasp pushed deeper by ``depth`` along the approach."""
    t = spec.finger_thickness
    cy = spec.max_width / 2 + t / 2
    centers = ((spec.finger_len / 2 + depth, cy, 0.0),
               (spec.finger_len / 2 + depth, -cy, 0.0),
               (-spec.palm_depth / 2 + depth, 0.0, 0.0))
    halves = ((spec.finger_len / 2, t / 2, spec.finger_depth / 2),
              (spec.finger_len / 2, t / 2, spec.finger_depth / 2),
              (spec.palm_depth / 2, spec.max_width / 2 + t + 0.01,
               spec.finger_depth / 2 + 0.01))
    return collision.as_static_boxes(centers, halves)


def _static_enclosed_box(spec: GripperSpec, depth: float = 0.0) -> tuple:
    """Between-fingers closing volume, bounded by the finger inner faces:
    anything non-target inside the gap the fingers close through -> reject."""
    center = ((spec.finger_len / 2 + depth, 0.0, 0.0),)
    half = ((spec.finger_len / 2, spec.max_width / 2, spec.finger_depth / 2),)
    return collision.as_static_boxes(center, half)


def filter_grasp_poses(
    grasp_poses: torch.Tensor,  # (G, 4, 4) in canonical frame
    symmetry_tfs: torch.Tensor,  # (S, 4, 4)
    nocs_pose: torch.Tensor,  # (4, 4) canonical->camera (may carry scale)
    cam_in_world: torch.Tensor,  # (4, 4)
    ee_in_grasp: torch.Tensor,  # (4, 4)
    collision_cloud: torch.Tensor,  # (C1, 3) cam frame — open-gripper test
    background_cloud: torch.Tensor,  # (C2, 3) cam frame — enclosed-volume test
    collision_mask: torch.Tensor,  # (C1,) bool valid points
    background_mask: torch.Tensor,  # (C2,) bool
    spec: GripperSpec = GripperSpec(),
    filter_approach: bool = True,
    filter_ik: bool = True,
    adjust: bool = True,
    adjust_depth: bool = False,
    margin: float = 5e-4,
    n_psi: int = 16,
):
    """Returns (poses_out (G*S, 4, 4) in CAMERA frame, valid (G*S,), stats).

    Candidate layout: grasp-major, symmetry-minor."""
    G = grasp_poses.shape[0]
    S = symmetry_tfs.shape[0]
    dev = grasp_poses.device

    # --- symmetry expansion + frame normalization --------------------------
    T = torch.einsum("sij,gjk->gsik", symmetry_tfs, grasp_poses)
    T = torch.einsum("ij,gsjk->gsik", nocs_pose, T).reshape(G * S, 4, 4)
    # normalize rotation columns (nocs_pose may carry per-axis scale)
    R = T[:, :3, :3]
    R = R / (torch.sqrt(torch.sum(R * R, dim=1, keepdim=True)) + 1e-12)
    T = torch.cat([torch.cat([R, T[:, :3, 3:]], dim=2), T[:, 3:, :]], dim=1)

    valid = torch.ones((G * S,), dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    stats = {}

    # --- approach direction faces camera (+z in cam frame) -----------------
    if filter_approach:
        approach_ok = T[:, 2, 0] >= 0.0
        stats["n_approach_dir_rej"] = torch.sum(valid & ~approach_ok)
        valid &= approach_ok
    else:
        stats["n_approach_dir_rej"] = zero

    # --- IK feasibility -----------------------------------------------------
    if filter_ik:
        ee_in_base = cam_in_world @ T @ ee_in_grasp
        feas = iiwa.ik_feasible(ee_in_base, n_psi)
        stats["n_ik_rej"] = torch.sum(valid & ~feas)
        valid &= feas
    else:
        stats["n_ik_rej"] = zero

    # --- collision: clouds in grasp frame vs analytic gripper boxes (K1) ---
    offsets = ADJUST_OFFSETS if adjust else ADJUST_OFFSETS[:1]
    depths = DEPTH_OFFSETS if adjust_depth else DEPTH_OFFSETS[:1]
    off_static = tuple(float(o) for o in offsets)
    depth_static = tuple(float(d) for d in depths)
    T_inv = collision.pose_inverse_batch(T).contiguous()
    hit_open = collision.box_hits_depths(
        T_inv, collision_cloud, collision_mask,
        _static_open_boxes(spec), off_static, depth_static, margin)
    hit_enc = collision.box_hits_depths(
        T_inv, background_cloud, background_mask,
        _static_enclosed_box(spec), off_static, depth_static, margin)
    free = ~(hit_open | hit_enc)  # (GS, D, A)

    # selection: deepest collision-free engagement wins; within a depth, the
    # reference's lateral search order (first free)
    D = free.shape[1]
    any_free_d = torch.any(free, dim=-1)  # (GS, D)
    d_idx = (D - 1) - torch.argmax(torch.flip(any_free_d, dims=[-1]).to(torch.uint8), dim=-1)
    oh_d = torch.arange(D, device=dev)[None] == d_idx[:, None]
    free_sel = torch.any(free & oh_d[..., None], dim=1)  # (GS, A)
    any_free = torch.any(free_sel, dim=-1)
    first = torch.argmax(free_sel.to(torch.uint8), dim=-1)
    dy = torch.as_tensor(offsets, device=dev)[first]
    dx = torch.sum(torch.as_tensor(depths, device=dev) * oh_d, dim=-1)
    shift = T[:, :3, 1] * dy[:, None] + T[:, :3, 0] * dx[:, None]
    t_new = T[:, :3, 3] + torch.where(any_free[:, None], shift, 0.0)
    T = torch.cat([torch.cat([T[:, :3, :3], t_new[:, :, None]], dim=2), T[:, 3:, :]], dim=1)
    stats["n_collision_rej"] = torch.sum(valid & ~any_free)
    valid &= any_free

    return T, valid, stats


def compact_valid(poses, valid) -> np.ndarray:
    """The masked candidate set on the host (compacted on the device first
    when given tensors, so only the valid poses are copied)."""
    if isinstance(poses, torch.Tensor):
        return poses[torch.as_tensor(valid, device=poses.device)].cpu().numpy()
    return np.asarray(poses)[np.asarray(valid)]


def engagement_depth(points: torch.Tensor, grasp_poses: torch.Tensor,
                     spec: GripperSpec = GripperSpec()) -> torch.Tensor:
    """How deeply each grasp engages the target: (C, 3), (K, 4, 4) -> (K,)
    in [0, 1].  0 = object only at the fingertip plane (tip-engagement
    holds slip under gravity), 1 = object reaches the finger roots.  The
    depth is read at the 3rd-smallest in-channel x (out-of-channel points
    at the fingertip plane), so 1-2 flying pixels at an object's edge
    cannot fake engagement; with fewer than 3 points it is 0."""
    fl = spec.finger_len
    if points.shape[0] < 3:
        return torch.zeros(grasp_poses.shape[0], dtype=points.dtype, device=points.device)
    pts_g = tf.transform_points(tf.pose_inverse(grasp_poses), points)  # (K, C, 3)
    in_chan = closing_channel_mask(pts_g, spec)
    x = torch.where(in_chan, pts_g[..., 0], fl)
    third = torch.kthvalue(x, 3, dim=-1).values
    return torch.clamp((fl - third) / fl, 0.0, 1.0)
