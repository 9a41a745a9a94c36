"""Gripper model (``catgrasp_tpu/grasp/gripper.py``): parameters, frames,
meshes and collision boxes from one parametric model, and the reference's
gripper asset directories (``load``/``save``).

Frames: grasp frame +x = approach (palm -> fingertips), ±y = closing axis;
the gripper base frame is the palm's back plane, and ``T_grasp_gripper``
maps between them.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..geom.mesh import TriMesh
from ..geom.primitives import box, parallel_jaw_gripper
from ..sim.env_grasp import GripperSpec, finger_boxes


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

    def get_grasp_pose_in_gripper_base(self) -> np.ndarray:
        """The grasp frame in the gripper base (palm back) frame."""
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = self.spec.palm_depth  # the grasp origin sits palm_depth ahead
        return T

    def open_boxes(self, device=None):
        """(centers (3, 3), halves (3, 3)) of the open gripper's boxes in the
        grasp frame, [finger+, finger-, palm], on ``device``."""
        return finger_boxes(torch.tensor(self.spec.max_width, device=resolve_device(device)),
                            self.spec)

    def enclosed_box(self, device=None):
        """(center (3,), half (3,)) of the swept closing volume between the
        fingers, on ``device``."""
        s, dev = self.spec, resolve_device(device)
        center = torch.tensor([s.finger_len / 2, 0.0, 0.0], device=dev)
        half = torch.tensor([s.finger_len / 2, s.max_width / 2 + s.finger_thickness,
                             s.finger_depth / 2], device=dev)
        return center, half

    def save_grasp_pose_mesh(self, grasp_pose: np.ndarray, path: str) -> None:
        """Write the open-gripper mesh moved to ``grasp_pose`` as an OBJ."""
        self.mesh_open.transformed(np.asarray(grasp_pose)).export_obj(path)

    @staticmethod
    def load(gripper_dir: str) -> "Gripper":
        """Load a reference-format gripper asset directory:

          gripper_air_tight.obj            open-gripper mesh (gripper base frame)
          gripper_enclosed_air_tight.obj   swept closing volume
          finger1.obj                      one finger (box extents -> spec)
          params.json                      scalar params (max_width, ...)
          T_grasp_gripper.tf               autolab RigidTransform text format

        The ``GripperSpec`` comes from the finger mesh's extents in the
        grasp frame, so the engine's boxes and the filter run unchanged on
        imported assets."""
        d = gripper_dir
        mesh_open = TriMesh.load_obj(os.path.join(d, "gripper_air_tight.obj"))
        mesh_enc = TriMesh.load_obj(os.path.join(d, "gripper_enclosed_air_tight.obj"))
        finger1 = TriMesh.load_obj(os.path.join(d, "finger1.obj"))
        with open(os.path.join(d, "params.json")) as f:
            params = json.load(f)
        T_gg = _load_rigid_tf(os.path.join(d, "T_grasp_gripper.tf"), want=("gripper", "grasp"))
        grasp_in_base = np.linalg.inv(T_gg)
        # the flange is the gripper base: its pose in the grasp frame
        ee_in_grasp = np.linalg.inv(grasp_in_base).astype(np.float32)

        v = finger1.transformed(np.linalg.inv(grasp_in_base)).vertices
        xmin, xmax = float(v[:, 0].min()), float(v[:, 0].max())
        zmin, zmax = float(v[:, 2].min()), float(v[:, 2].max())
        y_inner = float(np.abs(v[:, 1]).min())
        y_outer = float(np.abs(v[:, 1]).max())
        spec = GripperSpec(
            max_width=float(params.get("max_width", 2 * y_inner)),
            finger_len=xmax - max(xmin, 0.0),
            finger_thickness=max(y_outer - y_inner, 1e-3),
            finger_depth=zmax - zmin,
        )
        return Gripper(spec=spec, mesh_open=mesh_open, mesh_enclosed=mesh_enc,
                       params=params, ee_in_grasp=ee_in_grasp)

    def save(self, gripper_dir: str) -> None:
        """Write this gripper as a reference-format asset directory (the
        inverse of ``load``)."""
        os.makedirs(gripper_dir, exist_ok=True)
        base_in_grasp = np.asarray(self.ee_in_grasp)
        grasp_in_base = np.linalg.inv(base_in_grasp)
        self.mesh_open.transformed(grasp_in_base).export_obj(
            os.path.join(gripper_dir, "gripper_air_tight.obj"))
        self.mesh_enclosed.transformed(grasp_in_base).export_obj(
            os.path.join(gripper_dir, "gripper_enclosed_air_tight.obj"))
        s = self.spec
        _finger_box_mesh(s).transformed(grasp_in_base).export_obj(
            os.path.join(gripper_dir, "finger1.obj"))
        with open(os.path.join(gripper_dir, "params.json"), "w") as f:
            json.dump({"max_width": s.max_width, **{k: v for k, v in self.params.items()
                                                    if np.isscalar(v)}}, f)
        # T_grasp_gripper maps gripper-base coordinates to grasp coordinates:
        # exactly ee_in_grasp
        _save_rigid_tf(os.path.join(gripper_dir, "T_grasp_gripper.tf"), base_in_grasp,
                       "gripper", "grasp")

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


def _finger_box_mesh(spec: GripperSpec) -> TriMesh:
    """The +y finger as a box mesh in the grasp frame."""
    t = spec.finger_thickness
    return box((spec.finger_len, t, spec.finger_depth),
               center=(spec.finger_len / 2, spec.max_width / 2 + t / 2, 0.0))


def _load_rigid_tf(path: str, want: tuple[str, str]) -> np.ndarray:
    """An autolab_core RigidTransform text file (from_frame, to_frame, tx ty
    tz, three rotation rows) as the 4x4 oriented ``want=(from, to)``,
    inverted if stored the other way; any other frames raise."""
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    frm, to = lines[0], lines[1]
    t = np.array(lines[2].split(), dtype=np.float64)
    R = np.stack([np.array(ln.split(), dtype=np.float64) for ln in lines[3:6]])
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = R, t
    if (frm, to) == want:
        return T
    if (to, frm) == want:
        return np.linalg.inv(T).astype(np.float32)
    raise RuntimeError(f"T_grasp_gripper frames ({frm},{to}) != {want}")


def _save_rigid_tf(path: str, T: np.ndarray, frm: str, to: str) -> None:
    with open(path, "w") as f:
        f.write(f"{frm}\n{to}\n")
        f.write(" ".join(f"{x:.8f}" for x in T[:3, 3]) + "\n")
        for row in T[:3, :3]:
            f.write(" ".join(f"{x:.8f}" for x in row) + "\n")
