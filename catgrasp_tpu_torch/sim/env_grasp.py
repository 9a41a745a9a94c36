"""Parallel-jaw gripper geometry (``catgrasp_tpu/sim/env_grasp.py``).

The gripper lives in the GRASP frame: +x approach, ±y closing.  Only the
geometry the grasp filter needs is ported so far; the closing law and the
grasp rollout come with the pick-and-place half.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class GripperSpec:
    """Parallel-jaw geometry in the grasp frame (static hyperparams)."""

    max_width: float = 0.05
    finger_len: float = 0.045
    finger_thickness: float = 0.012
    finger_depth: float = 0.02
    palm_depth: float = 0.03
    max_force: float = 100.0
    close_speed: float = 0.3  # m/s of opening decrease
    max_squeeze_pen: float = 0.002

    @property
    def hand_depth(self):
        return self.finger_len

    @property
    def init_bite(self):
        return -0.005


def closing_channel_mask(pts_g, spec: GripperSpec, y_slack: float = 1e-3):
    """Points (in the GRASP frame) inside the channel the fingers close
    through: |y| within the jaw opening, |z| within the finger depth, x
    between the palm bound (``init_bite``) and the fingertip plane.  Works on
    numpy arrays and tensors alike (elementwise ops only)."""
    return ((abs(pts_g[:, 1]) <= spec.max_width / 2 + y_slack)
            & (abs(pts_g[:, 2]) <= spec.finger_depth / 2)
            & (pts_g[:, 0] <= spec.finger_len)
            & (pts_g[:, 0] >= spec.init_bite))


def finger_boxes(width: torch.Tensor, spec: GripperSpec, center=0.0):
    """Centers/halves (grasp frame) of [finger+, finger-, palm] boxes for a
    given opening ``width`` whose midline sits at y=``center``.  The palm is
    rigid on the wrist and does not ride the finger midline."""
    width = torch.as_tensor(width, dtype=torch.float32)
    t = spec.finger_thickness
    center = torch.as_tensor(center, dtype=torch.float32, device=width.device) \
        + torch.zeros_like(width)
    cy_pos = center + width / 2 + t / 2
    cy_neg = center - (width / 2 + t / 2)
    zero = torch.zeros_like(width)
    centers = torch.stack(
        [
            torch.stack([torch.full_like(width, spec.finger_len / 2), cy_pos, zero], -1),
            torch.stack([torch.full_like(width, spec.finger_len / 2), cy_neg, zero], -1),
            torch.stack([torch.full_like(width, -spec.palm_depth / 2), zero, zero], -1),
        ],
        dim=-2,
    )  # (..., 3 boxes, 3)
    halves = torch.tensor(
        [
            [spec.finger_len / 2, t / 2, spec.finger_depth / 2],
            [spec.finger_len / 2, t / 2, spec.finger_depth / 2],
            [spec.palm_depth / 2, spec.max_width / 2 + t + 0.01, spec.finger_depth / 2 + 0.01],
        ],
        device=width.device,
    )
    return centers, halves.expand(centers.shape)
