"""Gripper model (``catgrasp_tpu/grasp/gripper.py``): parameters, frames and
meshes from one parametric model.  Asset import/export (``load``/``save``)
is not ported yet.

Frames: grasp frame +x = approach (palm -> fingertips), ±y = closing axis.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..geom.mesh import TriMesh
from ..geom.primitives import parallel_jaw_gripper
from ..sim.env_grasp import GripperSpec


@dataclass
class Gripper:
    spec: GripperSpec
    mesh_open: TriMesh  # full open gripper, grasp frame
    mesh_enclosed: TriMesh  # swept closing volume, grasp frame
    params: dict
    # transform from flange (arm end-effector) to grasp frame: flange +z ==
    # grasp +x, offset behind the palm
    ee_in_grasp: np.ndarray = field(default=None)

    @property
    def hand_depth(self) -> float:
        return self.spec.finger_len

    @property
    def init_bite(self) -> float:
        return self.spec.init_bite

    @property
    def max_width(self) -> float:
        return self.spec.max_width

    @staticmethod
    def default(**overrides) -> "Gripper":
        spec = GripperSpec(**overrides) if overrides else GripperSpec()
        mesh_open, mesh_enclosed, params = parallel_jaw_gripper(
            max_width=spec.max_width, finger_len=spec.finger_len,
            finger_thickness=spec.finger_thickness, finger_depth=spec.finger_depth,
            palm_depth=spec.palm_depth,
        )
        ee = np.eye(4, dtype=np.float32)
        # R maps flange z->grasp x, flange x->grasp y, flange y->grasp z
        ee[:3, :3] = np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]], dtype=np.float32).T
        # flange->finger-root distance: gripper body (~0.10 m) + coupling
        ee[:3, 3] = [-spec.palm_depth - 0.09, 0, 0]
        return Gripper(spec=spec, mesh_open=mesh_open, mesh_enclosed=mesh_enclosed,
                       params=params, ee_in_grasp=ee)
