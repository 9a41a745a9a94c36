"""Checkpoints -> predicters (``catgrasp_tpu/predict/artifacts.py`` in
PyTorch): each net is built as its config describes it, its flax
parameters are read with the port's own checkpoint reader
(``predict/ckpt.py``) and converted (``convert.py``), and it is moved to
the device.
"""
from __future__ import annotations

import json
import os

from .. import convert
from ..config.loader import load_config
from ..device import resolve_device
from ..nn.pointnet import PointNetCls, PointNetSeg
from ..nn.voxelnet import SegNet
from .ckpt import read_params
from .predicter import GraspPredicter, NunocsPredicter, SegPredicter


def _ckpt(dir_: str) -> str:
    """best_val, then best_train, then the periodic ``last.ckpt``."""
    for name in ("best_val.ckpt", "best_train.ckpt", "last.ckpt"):
        p = os.path.join(dir_, name)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"no checkpoint in {dir_}")


def _load(model, state_dict: dict, dev):
    model.load_state_dict(state_dict)
    return model.to(dev).eval()


def load_predicters(artifact_dir: str = "artifacts", class_name: str = "nut",
                    device=None, roles=("nocs", "grasp", "seg")) -> dict:
    """The predicter dict the eval consumes, from
    ``{artifact_dir}/{nunocs,grasp,seg}/``, for the ``roles`` asked; a role
    whose directory is missing is skipped (the eval's oracle or analytic
    path fills in)."""
    dev = resolve_device(device)
    out = {}
    d = os.path.join(artifact_dir, "nunocs")
    if "nocs" in roles and os.path.isdir(d):
        cfg = load_config("config_nunocs.yml")
        bins = cfg.get("ce_loss_bins", 100)
        model = PointNetSeg(3 * bins, cfg.get("input_channel", 6))
        out["nocs"] = NunocsPredicter(
            _load(model, convert.flax_state_dict(read_params(_ckpt(d))), dev), bins,
            cfg.get("n_pts", 2048))
    d = os.path.join(artifact_dir, "grasp")
    if "grasp" in roles and os.path.isdir(d):
        cfg = load_config("config_grasp.yml")
        model = PointNetCls(len(cfg["classes"]) - 1, cfg.get("input_channel", 6))
        out["grasp"] = GraspPredicter(
            _load(model, convert.flax_state_dict(read_params(_ckpt(d))), dev),
            cfg.get("n_pts", 1024))
    d = os.path.join(artifact_dir, "seg")
    if "seg" in roles and os.path.isdir(d):
        cfg = load_config("config_seg.yml")
        model = SegNet(voxel_size=float(cfg.get("voxel_size", 0.004)),
                       grid_dims=tuple(cfg.get("grid_dims", (96, 96, 48))))
        # the MeanShift bandwidth calibrated to this net's offset noise
        # (calib.json, written at export), else the class table's
        bandwidth = None
        calib_path = os.path.join(d, "calib.json")
        if os.path.exists(calib_path):
            with open(calib_path) as f:
                bandwidth = json.load(f).get("bandwidth")
            print(f"seg: calibrated MeanShift bandwidth {bandwidth}")
        out["seg"] = SegPredicter(
            _load(model, convert.flax_state_dict(read_params(_ckpt(d))), dev), class_name,
            cfg.get("n_pts", 20000), bandwidth)
    return out
