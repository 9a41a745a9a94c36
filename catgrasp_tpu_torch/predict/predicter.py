"""Inference wrappers (``catgrasp_tpu/predict/predicter.py`` in PyTorch):

* :class:`GraspPredicter`: per-grasp scene clouds in the grasp frame ->
  softmax over 10 score bins -> (label, confidence, distribution);
* :class:`NunocsPredicter`: per-point bin argmax -> NUNOCS cloud -> the
  RANSAC 9D fit at thresholds {3, 5 mm}, gated on the inlier ratio;
* :class:`SegPredicter`: SegNet offsets -> MeanShift of the shifted points
  -> per-point instance labels.

Each runs on its model's device.  The host-side draws are the JAX
predicters': ``default_rng(0)`` per call for the point subsample; the
device draws (MeanShift seeds, RANSAC hypotheses) come from a
``torch.Generator`` seeded with 0 per call, so a call repeats as JAX's
``PRNGKey(0)`` per call does.  With a ``timings`` dict, a call adds its
stages' wall seconds to it (the device synchronised at each stage's end).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import transforms as tf
from ..data import augment
from ..nn.cluster import mean_shift
from ..nn.pointnet import PointNetCls, PointNetSeg
from ..nn.voxelnet import SegNet
from ..utils.metrics import StageClock
from .ransac import estimate_9d_transform

# per-class MeanShift bandwidths, where the seg artifact has no calib.json
CLUSTER_BANDWIDTH = {"nut": 0.012, "hnm": 0.005, "screw": 0.009}
KNN_CHUNK = 1024  # query rows of one (rows, samples) distance block


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


@dataclass
class GraspPredicter:
    model: PointNetCls
    n_pts: int = 1024
    batch: int = 200  # grasps a forward pass

    @torch.inference_mode()
    def predict_batch(self, cloud_xyz: np.ndarray, cloud_normal: np.ndarray,
                      grasp_poses: np.ndarray, timings: dict | None = None):
        """Scene cloud (N, 3) with normals + grasp poses (G, 4, 4) -> (labels
        (G,), confidence (G,), distribution (G, bins)), numpy.  GroupNorm is
        per sample, so a batch's other grasps do not change a grasp's
        distribution (JAX pads the last batch with identity poses; the
        port does not pad)."""
        dev = _device(self.model)
        clock = StageClock(timings, dev)
        n = len(cloud_xyz)
        ids = np.random.default_rng(0).choice(n, self.n_pts, replace=n < self.n_pts)
        xyz = torch.as_tensor(cloud_xyz[ids], dtype=torch.float32, device=dev)
        nrm = torch.as_tensor(cloud_normal[ids], dtype=torch.float32, device=dev)
        poses = torch.as_tensor(np.asarray(grasp_poses), dtype=torch.float32, device=dev)
        dists = []
        for i in range(0, len(poses), self.batch):
            Tinv = tf.pose_inverse(poses[i:i + self.batch])
            x = tf.transform_points(Tinv, xyz)  # (g, P, 3)
            nn_ = torch.einsum("gij,pj->gpi", Tinv[:, :3, :3], nrm)
            logits, _ = self.model(torch.cat([x, nn_], dim=-1))
            dists.append(torch.softmax(logits, dim=-1))
        dist = torch.cat(dists).cpu().numpy()
        clock.lap("grasp_net_s")
        return dist.argmax(axis=-1), dist.max(axis=-1), dist

    @staticmethod
    def expected_quality(dist: np.ndarray, bin_values: np.ndarray | None = None):
        """P(G): the distribution's mean over the bins' centres."""
        nb = dist.shape[-1]
        if bin_values is None:
            bin_values = (np.arange(nb) + 0.5) / nb
        return (dist * bin_values).sum(-1)


@dataclass
class NunocsPredicter:
    model: PointNetSeg
    n_bins: int = 100
    n_pts: int = 2048

    @torch.inference_mode()
    def predict(self, cloud_xyz: np.ndarray, cloud_normal: np.ndarray,
                timings: dict | None = None) -> dict:
        """-> dict(nocs_pose (4, 4): centered NUNOCS (nocs - 0.5) -> camera
        with per-axis scale, ratio, inliers, nocs_cloud (P, 3) in [0, 1],
        cloud_ids, valid: ratio >= 0.3).  The inlier thresholds 3 mm and
        5 mm are tried in order until one reaches the ratio 0.3; the best
        is kept."""
        min_ratio = 0.3
        dev = _device(self.model)
        gen = torch.Generator(device=dev).manual_seed(0)
        clock = StageClock(timings, dev)
        n = len(cloud_xyz)
        ids = np.random.default_rng(0).choice(n, self.n_pts, replace=n < self.n_pts)
        d = augment.normalize_cloud({"cloud_xyz": cloud_xyz[ids].copy(),
                                     "cloud_normal": cloud_normal[ids].copy()})
        inp = torch.as_tensor(np.concatenate([d["cloud_xyz"], d["cloud_normal"]], -1),
                              dtype=torch.float32, device=dev)[None]
        logits, _ = self.model(inp)
        bins = torch.argmax(logits.reshape(1, -1, 3, self.n_bins), dim=-1)[0]
        nocs = (bins.float() + 0.5) / self.n_bins  # (P, 3) in [0, 1]
        clock.lap("nocs_net_s")

        target = torch.as_tensor(cloud_xyz[ids], dtype=torch.float32, device=dev)
        mask = torch.ones(self.n_pts, dtype=torch.bool, device=dev)
        max_scale, min_scale = (torch.full((3,), s, device=dev) for s in (0.5, 0.001))
        best = None
        for th in (0.003, 0.005):
            T, ratio, inl = estimate_9d_transform(nocs - 0.5, target, mask, th, max_scale=max_scale,
                                                  min_scale=min_scale, generator=gen)
            r = float(ratio)
            if best is None or r > best["ratio"]:
                best = {"nocs_pose": T.cpu().numpy(), "ratio": r, "inliers": inl.cpu().numpy()}
            if r >= min_ratio:
                break
        best["nocs_cloud"] = nocs.cpu().numpy()
        best["cloud_ids"] = ids
        best["valid"] = best["ratio"] >= min_ratio
        clock.lap("ransac_s")
        return best


def nearest_sample(queries: torch.Tensor, samples: torch.Tensor):
    """For each query point (Q, 3), the index of its nearest sample (S, 3),
    ties to the lowest index, and the squared distance; in blocks of
    ``KNN_CHUNK`` queries."""
    idx, dist = [], []
    for i in range(0, len(queries), KNN_CHUNK):
        d2 = ((queries[i:i + KNN_CHUNK, None] - samples[None]) ** 2).sum(-1)
        j = torch.argmin(d2, dim=1)
        idx.append(j)
        dist.append(d2.gather(1, j[:, None])[:, 0])
    return torch.cat(idx), torch.cat(dist)


@dataclass
class SegPredicter:
    model: SegNet
    class_name: str = "nut"
    n_pts: int = 20000
    # None: the class table's; load_predicters sets it from the seg
    # artifact's calib.json
    bandwidth: float | None = None

    @torch.inference_mode()
    def predict(self, cloud_xyz: np.ndarray, cloud_normal: np.ndarray,
                bandwidth_scale: float = 1.0, timings: dict | None = None):
        """-> (instance labels (N,) int32, -1 for background, n_instances):
        net offsets -> MeanShift on the shifted points of the net's
        objects -> every point not labelled that way (not sampled, or
        sampled as background) takes its nearest labelled sample's label
        when that lies within 1 cm.  MeanShift runs from 64 seeds."""
        dev = _device(self.model)
        gen = torch.Generator(device=dev).manual_seed(0)
        clock = StageClock(timings, dev)
        n = len(cloud_xyz)
        ids = np.random.default_rng(0).choice(n, self.n_pts, replace=n < self.n_pts)
        xyz = torch.as_tensor(cloud_xyz[ids], dtype=torch.float32, device=dev)
        nrm = torch.as_tensor(cloud_normal[ids], dtype=torch.float32, device=dev)
        origin = xyz.amin(dim=0) - 0.01
        offsets, objectness = self.model(xyz, nrm, origin)
        clock.lap("seg_net_s")

        bw = self.bandwidth or CLUSTER_BANDWIDTH.get(self.class_name, 0.02)
        bw = float(bw) * float(bandwidth_scale)
        labels, _, n_modes = mean_shift(xyz + offsets, bw, mask=torch.sigmoid(objectness) > 0.5,
                                        n_seeds=64, generator=gen)
        lab_s = labels.cpu().numpy()
        full = np.full(n, -1, np.int32)
        full[ids] = lab_s
        missing = np.where(full == -1)[0]
        labelled = lab_s >= 0
        if len(missing) and labelled.any():
            src = torch.as_tensor(labelled, device=dev)
            nn_, d2 = nearest_sample(torch.as_tensor(cloud_xyz[missing], dtype=torch.float32,
                                                     device=dev), xyz[src])
            near = (d2 < 0.01 ** 2).cpu().numpy()
            full[missing[near]] = lab_s[labelled][nn_.cpu().numpy()[near]]
        clock.lap("meanshift_s")
        return full, int(n_modes)
