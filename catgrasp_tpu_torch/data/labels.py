"""Training-label extraction from rendered scenes (``catgrasp_tpu/data/labels.py``,
host numpy, copied): the reference's ``tool.py`` passes.

* :func:`isolated_object_clouds`   — ``make_isolated_training_data``
  (``tool.py:125-157``): per-instance clouds (xyz/normal/nocs) for the
  NUNOCS and grasp-quality nets.
* :func:`scene_cloud`              — ``make_crop_scene_dataset``
  (``tool.py:161-224``): whole-scene cloud with instance labels for the
  segmentation net.
* :func:`dense_clutter_grasp_labels` — ``make_dense_clutter_grasp_data``
  (``tool.py:280-418``): project the offline grasp DB into a scene, keep
  grasps on sufficiently-visible objects whose approach faces the camera,
  up to ``max_per_scene``; label = DB perturbation score.

All functions are host-side numpy over .npz scene records (variable-length
outputs); device-side consumers re-pad to fixed shapes.
"""
from __future__ import annotations

import numpy as np

_PIXEL_GRIDS: dict = {}


def _pixel_grid(H: int, W: int):
    """Cached (us, vs) meshgrid — pack_split calls load_scene tens of
    thousands of times on same-shaped scenes."""
    if (H, W) not in _PIXEL_GRIDS:
        _PIXEL_GRIDS[(H, W)] = np.meshgrid(
            np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    return _PIXEL_GRIDS[(H, W)]


def load_scene(path: str) -> dict:
    """Load a scene record, decoding the compact on-disk encoding back to
    the in-memory schema (f32 maps + int32 seg + xyz cam-frame cloud).

    On-disk compaction (mirrors the reference's ``depth*1e4`` uint16 pngs,
    ``env.py:420-433``): depth u16 in 0.1 mm, seg i16, nocs/normal f16, xyz
    omitted (reconstructed from depth via the pinhole model).
    """
    with np.load(path, allow_pickle=True) as z:
        scene = {k: z[k] for k in z.files}
    if scene["depth"].dtype == np.uint16:
        scene["depth"] = scene["depth"].astype(np.float32) / 1e4
    scene["seg"] = scene["seg"].astype(np.int32)
    for k in ("nocs", "normal"):
        if k in scene and scene[k].dtype == np.float16:
            scene[k] = scene[k].astype(np.float32)
    if "xyz" not in scene:
        K = scene["K"]
        depth = scene["depth"]
        H, W = depth.shape
        us, vs = _pixel_grid(H, W)
        xyz = np.empty((H, W, 3), np.float32)
        xyz[..., 0] = (us - K[0, 2]) / K[0, 0] * depth
        xyz[..., 1] = (vs - K[1, 2]) / K[1, 1] * depth
        xyz[..., 2] = depth
        scene["xyz"] = xyz
    return scene


def isolated_object_clouds(scene: dict, min_vis: float = 0.3,
                           min_points: int = 64, min_z: float = 0.1):
    """Per-object dicts: cloud_xyz / cloud_normal / cloud_nocs (cam frame) +
    gt pose/scale.  Mirrors the ≥0.1 m z filter of ``dataset_nunocs.py:40``."""
    seg = scene["seg"]
    out = []
    for i in np.where(scene["active"])[0]:
        if scene["vis_ratio"][i] < min_vis:
            continue
        m = (seg == i) & (scene["xyz"][..., 2] >= min_z)
        if m.sum() < min_points:
            continue
        out.append({
            "body": int(i),
            "cloud_xyz": scene["xyz"][m].astype(np.float32),
            "cloud_normal": scene["normal"][m].astype(np.float32),
            "cloud_nocs": scene["nocs"][m].astype(np.float32),
            "ob_in_world": scene["ob_in_world"][i],
            "cam_in_world": scene["cam_in_world"],
            "scale": float(scene["scales"][i]),
            "shape_id": int(scene["shape_id"][i]),
        })
    return out


def scene_cloud(scene: dict, min_z: float = 0.1, include_env: bool = True):
    """Whole-scene cloud with per-point instance ids (env = -2)."""
    seg = scene["seg"]
    m = (seg != -1) & (scene["xyz"][..., 2] >= min_z)
    if not include_env:
        m &= seg >= 0
    return {
        "cloud_xyz": scene["xyz"][m].astype(np.float32),
        "cloud_normal": scene["normal"][m].astype(np.float32),
        "instance_id": seg[m].astype(np.int32),
    }


def dense_clutter_grasp_labels(scene: dict, grasp_db: dict, min_vis: float = 0.8,
                               max_per_scene: int = 20, rng=None):
    """(grasp_in_cam, score, body) labels for the grasp-quality dataset.

    Reference gates (``tool.py:280-418``): object visibility >= 0.8 and
    approach direction faces the camera — and nothing else: the reference's
    ``collision_with_scene`` rejection counter is declared but never
    incremented and ``check_finger_region`` is hardcoded False, so
    in-collision grasps keep their free-space DB scores in the training set.
    We reproduce that labeling behavior exactly.
    """
    rng = rng or np.random.default_rng(0)
    T_wc = np.linalg.inv(scene["cam_in_world"])
    poses_db = grasp_db["grasp_poses"]
    scores_db = grasp_db["scores"]
    shape_match = grasp_db.get("shape_id", None)

    # Select indices first, materialize matrices only for the <=max_per_scene
    # survivors: the DB holds thousands of poses per object and building a
    # tuple per kept pose dominated pack_split's profile.  The approach-
    # faces-camera gate needs only rotations: (ob_in_cam @ g)[2, 0] =
    # ob_in_cam[2, :3] @ g[:3, 0] (translation cannot enter a rotation
    # column), so the full per-pose matmul is deferred to the survivors.
    bodies, cams, scales, pose_ids = [], [], [], []
    for i in np.where(scene["active"])[0]:
        if scene["vis_ratio"][i] < min_vis:
            continue
        if shape_match is not None and int(scene["shape_id"][i]) != int(shape_match):
            continue
        ob_in_cam = T_wc @ scene["ob_in_world"][i]
        ids = np.nonzero(poses_db[:, :3, 0] @ ob_in_cam[2, :3] >= 0)[0]
        if ids.size:
            bodies.append(int(i))
            cams.append(ob_in_cam)
            scales.append(float(scene["scales"][i]))
            pose_ids.append(ids)
    if not bodies:
        return []
    counts = np.array([len(ids) for ids in pose_ids])
    total = int(counts.sum())
    sel = (rng.choice(total, max_per_scene, replace=False)
           if total > max_per_scene else np.arange(total))
    starts = np.concatenate([[0], np.cumsum(counts)])
    labels = []
    for k in sel:
        b = int(np.searchsorted(starts, k, side="right")) - 1
        j = int(pose_ids[b][k - starts[b]])
        g = poses_db[j].copy()
        g[:3, 3] *= scales[b]
        labels.append(((cams[b] @ g).astype(np.float32),
                       float(scores_db[j]), bodies[b]))
    return labels
