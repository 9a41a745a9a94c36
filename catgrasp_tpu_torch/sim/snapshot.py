"""Scene snapshot and restore (``catgrasp_tpu/sim/snapshot.py`` in
PyTorch).

The scene state is a handful of tensors, so a snapshot is an exact host
copy of them, and any scene record the data generator writes is itself a
restorable scene.
"""
from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from ..core import transforms as tf
from ..device import resolve_device
from .types import SceneParams, SceneState, ShapeLib


def save_state(state: SceneState) -> SceneState:
    """An exact host copy of ``state`` (CPU tensors)."""
    return SceneState(**{f.name: getattr(state, f.name).detach().to("cpu", copy=True)
                         for f in fields(state)})


def restore_state(snapshot: SceneState, device=None) -> SceneState:
    """The snapshot back on ``device`` (the GPU unless the caller says
    ``device="cpu"``), as copies: stepping the restored state leaves the
    snapshot as it was."""
    dev = resolve_device(device)
    return SceneState(**{f.name: getattr(snapshot, f.name).to(dev, copy=True)
                         for f in fields(snapshot)})


def save_scene_npz(path: str, state: SceneState, params: SceneParams, **extra) -> None:
    """Write a restorable scene record: the bodies' poses, velocities,
    active flags, shapes and scales (the fields the data generator writes,
    with the velocities), and ``extra`` arrays."""
    ob_in_world = tf.pose_from_qt(state.quat, state.pos)

    def host(t):
        return t.detach().cpu().numpy()

    np.savez_compressed(
        path, ob_in_world=host(ob_in_world).astype(np.float32),
        linvel=host(state.linvel), angvel=host(state.angvel), active=host(state.active),
        shape_id=host(params.shape_id).astype(np.int32), scales=host(params.scale), **extra)


def scene_from_record(record: dict, lib: ShapeLib):
    """(state, params) on the library's device from a snapshot file or a
    ``generate_pile_data`` scene record; a record without velocities is
    restored at rest."""
    dev = lib.device
    T = torch.as_tensor(np.asarray(record["ob_in_world"]), dtype=torch.float32, device=dev)
    n = T.shape[0]

    def field(key, default=None, dtype=torch.float32):
        v = record[key] if key in record else default
        return torch.as_tensor(np.asarray(v), dtype=dtype, device=dev)

    state = SceneState(
        pos=T[:, :3, 3].contiguous(),
        quat=tf.matrix_to_quat(T[:, :3, :3]),
        linvel=field("linvel", np.zeros((n, 3))),
        angvel=field("angvel", np.zeros((n, 3))),
        active=field("active", np.ones(n, bool), torch.bool),
    )
    params = SceneParams.create(lib, field("shape_id", dtype=torch.int64), field("scales"))
    return state, params
