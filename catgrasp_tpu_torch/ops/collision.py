"""The grasp filter's collision gate: CUDA kernel K1 ``box_hits``
(``csrc/box_hits.cu``, the port of the Pallas kernel
``catgrasp_tpu/ops/collision.py:box_hits``) and its plain PyTorch version.

``box_hits`` takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

_FAR = 1e6  # sentinel for masked points: outside every box
_PAIRS_PER_CHUNK = 1 << 20  # (pose, point) pairs per chunk of the plain version


def _static_arrays(boxes, offsets, device):
    centers = torch.tensor([b[0] for b in boxes], dtype=torch.float32, device=device)
    halves = torch.tensor([b[1] for b in boxes], dtype=torch.float32, device=device)
    offs = torch.tensor(offsets, dtype=torch.float32, device=device)
    return centers, halves, offs


def box_hits_plain(t_inv: torch.Tensor, cloud: torch.Tensor, mask: torch.Tensor,
                   boxes: tuple, offsets: tuple, margin: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`box_hits`: the chunked
    ``_hits_per_offset`` logic of the JAX filter's XLA backend.  Poses are
    processed in chunks so memory stays bounded."""
    centers, halves, offs = _static_arrays(boxes, offsets, cloud.device)
    P, C = t_inv.shape[0], cloud.shape[0]
    R, t = t_inv[:, :3, :3], t_inv[:, :3, 3]
    chunk = max(1, _PAIRS_PER_CHUNK // max(C, 1))
    out = []
    for s in range(0, P, chunk):
        pts = torch.einsum("pij,cj->pci", R[s:s + chunk], cloud) + t[s:s + chunk, None, :]
        rel = pts[:, :, None, :] - centers  # (B,C,K,3)
        ok_xz = ((torch.abs(rel[..., 0]) - halves[:, 0] < margin)
                 & (torch.abs(rel[..., 2]) - halves[:, 2] < margin)
                 & mask[None, :, None])
        # gripper shifted +off => point relative y decreases by off
        q_y = torch.abs(rel[..., 1][..., None] - offs) - halves[:, 1, None]  # (B,C,K,A)
        hit = ok_xz[..., None] & (q_y < margin)
        out.append(hit.any(dim=2).any(dim=1))
    if not out:
        return torch.zeros((0, len(offsets)), dtype=torch.bool, device=cloud.device)
    return torch.cat(out)


def _launcher():
    fn = build.load("box_hits").box_hits_launch
    if fn.argtypes is None:  # declare the C signature once
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_float,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def box_hits(t_inv: torch.Tensor, cloud: torch.Tensor, mask: torch.Tensor,
             boxes: tuple, offsets: tuple, margin: float) -> torch.Tensor:
    """For P world->grasp transforms, which lateral offsets collide?

    t_inv:  (P, 4, 4) world(/camera)->grasp-frame transforms.
    cloud:  (C, 3) points in the world(/camera) frame.
    mask:   (C,) bool — invalid points never hit.
    boxes:  ((center_xyz), (half_xyz)) pairs in the grasp frame (<= 4).
    offsets: lateral +y gripper shifts (<= 8).

    Returns hit: (P, len(offsets)) bool.
    """
    if t_inv.device.type == "cpu":
        return box_hits_plain(t_inv, cloud, mask, boxes, offsets, margin)
    P, C, A = t_inv.shape[0], cloud.shape[0], len(offsets)
    build.check_cuda(t_inv, "box_hits t_inv", torch.float32, (P, 4, 4))
    build.check_cuda(cloud, "box_hits cloud", torch.float32, (C, 3))
    build.check_cuda(mask, "box_hits mask", torch.bool, (C,))
    pts = torch.where(mask[:, None], cloud, _FAR).contiguous()
    out = torch.empty((P, A), dtype=torch.uint8, device=t_inv.device)
    c = np.ascontiguousarray([b[0] for b in boxes], np.float32)
    h = np.ascontiguousarray([b[1] for b in boxes], np.float32)
    o = np.ascontiguousarray(offsets, np.float32)
    status = _launcher()(t_inv.data_ptr(), pts.data_ptr(), P, C,
                         len(boxes), c.ctypes.data, h.ctypes.data, A, o.ctypes.data,
                         float(margin), out.data_ptr(),
                         torch.cuda.current_stream(t_inv.device).cuda_stream)
    build.check_status(status, "box_hits")
    box_hits.launches += 1
    return out.bool()


box_hits.launches = 0


def pose_inverse_batch(T: torch.Tensor) -> torch.Tensor:
    """(N,4,4) rigid-pose inverse: [R^T, -R^T t]."""
    R = T[:, :3, :3]
    t = T[:, :3, 3]
    Rt = R.transpose(1, 2)
    ti = -torch.einsum("nij,nj->ni", Rt, t)
    out = torch.zeros_like(T)
    out[:, :3, :3] = Rt
    out[:, :3, 3] = ti
    out[:, 3, 3] = 1.0
    return out


def as_static_boxes(centers, halves) -> tuple:
    """Convert (K,3) center/half arrays to the nested-tuple form."""
    c = np.asarray(centers, dtype=np.float64)
    h = np.asarray(halves, dtype=np.float64)
    return tuple((tuple(map(float, ci)), tuple(map(float, hi))) for ci, hi in zip(c, h))
