"""The grasp filter's collision gate: CUDA kernel K1 ``box_hits``
(``csrc/box_hits.cu``, the port of the Pallas kernel
``catgrasp_tpu/ops/collision.py:box_hits``) and its plain PyTorch version.

``box_hits`` has the JAX function's signature and answers one approach depth.
``box_hits_depths`` answers several depths (each a +x shift of the boxes)
from one pass over the cloud: (P, D, A) where ``box_hits`` gives (P, A).  It
is what the filter calls, once a cloud.

Both take the plain version only for tensors on the CPU; for CUDA tensors
they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

_FAR = 1e6  # sentinel for masked points: outside every box
_PAIRS_PER_CHUNK = 1 << 20  # (pose, point) pairs per chunk of the plain version
_POINT_PAD = 128  # the kernel walks the cloud in whole chunks of points
# the most boxes, offsets and depths the kernel takes (the first two as the
# Pallas kernel's wrapper); depths x offsets fill its 32-bit mask
MAX_COUNTS = (4, 8, 4)


def _static_arrays(boxes, offsets, depths, device):
    """(centers (K, 3), halves (K, 3), offsets (A,), centers_x (D, K)): the
    boxes at depth 0 and their centre x at every depth.  The sums are taken
    in double and rounded once, as a box built at that depth is."""
    centers = torch.tensor([b[0] for b in boxes], dtype=torch.float32, device=device)
    halves = torch.tensor([b[1] for b in boxes], dtype=torch.float32, device=device)
    offs = torch.tensor(offsets, dtype=torch.float32, device=device)
    centers_x = torch.tensor([[b[0][0] + d for b in boxes] for d in depths],
                             dtype=torch.float32, device=device)
    return centers, halves, offs, centers_x


def box_hits_depths_plain(t_inv: torch.Tensor, cloud: torch.Tensor, mask: torch.Tensor,
                          boxes: tuple, offsets: tuple, depths: tuple,
                          margin: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`box_hits_depths`: the chunked
    ``_hits_per_offset`` logic of the JAX filter's XLA backend, with the
    cloud transformed once for all depths.  Poses are processed in chunks so
    memory stays bounded."""
    centers, halves, offs, centers_x = _static_arrays(boxes, offsets, depths, cloud.device)
    P, C = t_inv.shape[0], cloud.shape[0]
    R, t = t_inv[:, :3, :3], t_inv[:, :3, 3]
    chunk = max(1, _PAIRS_PER_CHUNK // max(C, 1))
    out = []
    for s in range(0, P, chunk):
        pts = torch.einsum("pij,cj->pci", R[s:s + chunk], cloud) + t[s:s + chunk, None, :]
        rel = pts[:, :, None, :] - centers  # (B,C,K,3)
        ok_z = (torch.abs(rel[..., 2]) - halves[:, 2] < margin) & mask[None, :, None]
        # gripper shifted +off => point relative y decreases by off
        q_y = torch.abs(rel[..., 1][..., None] - offs) - halves[:, 1, None]  # (B,C,K,A)
        per_depth = []
        for d in range(len(depths)):
            ok_xz = (torch.abs(pts[:, :, None, 0] - centers_x[d]) - halves[:, 0] < margin) & ok_z
            hit = ok_xz[..., None] & (q_y < margin)
            per_depth.append(hit.any(dim=2).any(dim=1))
        out.append(torch.stack(per_depth, dim=1))
    if not out:
        return torch.zeros((0, len(depths), len(offsets)), dtype=torch.bool,
                           device=cloud.device)
    return torch.cat(out)


def box_hits_plain(t_inv: torch.Tensor, cloud: torch.Tensor, mask: torch.Tensor,
                   boxes: tuple, offsets: tuple, margin: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`box_hits`."""
    return box_hits_depths_plain(t_inv, cloud, mask, boxes, offsets, (0.0,), margin)[:, 0]


def _launcher():
    fn = build.load("box_hits").box_hits_launch
    if fn.argtypes is None:  # declare the C signature once
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def pack_cloud(cloud: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The cloud as the kernel reads it: (C', 4) float32, a point a 16-byte
    load, C' the next multiple of 128; masked points and the padding sit at
    the 1e6 sentinel, outside every box."""
    C = cloud.shape[0]
    pts = torch.full((-(-C // _POINT_PAD) * _POINT_PAD, 4), _FAR, dtype=torch.float32,
                     device=cloud.device)
    pts[:C, :3] = torch.where(mask[:, None], cloud, _FAR)
    return pts


def _box_hits_cuda(t_inv, cloud, mask, boxes, offsets, depths, margin):
    """Check the inputs, launch the kernel and count the launch; returns
    (P, D, A) bool."""
    P, C, K, A, D = t_inv.shape[0], cloud.shape[0], len(boxes), len(offsets), len(depths)
    build.check_cuda(t_inv, "box_hits t_inv", torch.float32, (P, 4, 4))
    build.check_cuda(cloud, "box_hits cloud", torch.float32, (C, 3))
    build.check_cuda(mask, "box_hits mask", torch.bool, (C,))
    if any(not 1 <= n <= most for n, most in zip((K, A, D), MAX_COUNTS)):
        raise ValueError(f"box_hits: the kernel takes 1 to {MAX_COUNTS[0]} boxes, "
                         f"{MAX_COUNTS[1]} offsets and {MAX_COUNTS[2]} depths; got "
                         f"{K} boxes, {A} offsets, {D} depths")
    pts = pack_cloud(cloud, mask)
    out = torch.empty((P, D, A), dtype=torch.uint8, device=t_inv.device)
    c = np.ascontiguousarray([b[0] for b in boxes], np.float32)
    h = np.ascontiguousarray([b[1] for b in boxes], np.float32)
    o = np.ascontiguousarray(offsets, np.float32)
    cx = np.ascontiguousarray([[b[0][0] + d for b in boxes] for d in depths], np.float32)
    if P > 0:
        status = _launcher()(t_inv.data_ptr(), pts.data_ptr(), P, pts.shape[0],
                             K, c.ctypes.data, h.ctypes.data, A, o.ctypes.data, D,
                             cx.ctypes.data, float(margin), out.data_ptr(),
                             torch.cuda.current_stream(t_inv.device).cuda_stream)
        build.check_status(status, "box_hits")
        box_hits.launches += 1
    return out.bool()


def box_hits_depths(t_inv: torch.Tensor, cloud: torch.Tensor, mask: torch.Tensor,
                    boxes: tuple, offsets: tuple, depths: tuple, margin: float) -> torch.Tensor:
    """For P world->grasp transforms, which (approach depth, lateral offset)
    pairs collide?  One launch of K1 (counted on ``box_hits.launches``).

    t_inv:  (P, 4, 4) world(/camera)->grasp-frame transforms.
    cloud:  (C, 3) points in the world(/camera) frame.
    mask:   (C,) bool — invalid points never hit.
    boxes:  ((center_xyz), (half_xyz)) pairs in the grasp frame at depth 0
            (<= 4 on the GPU).
    offsets: lateral +y gripper shifts (<= 8 on the GPU).
    depths: +x shifts of the boxes: the grasp pushed deeper along its
            approach (<= 4 on the GPU).

    Returns hit: (P, len(depths), len(offsets)) bool.
    """
    if t_inv.device.type == "cpu":
        return box_hits_depths_plain(t_inv, cloud, mask, boxes, offsets, depths, margin)
    return _box_hits_cuda(t_inv, cloud, mask, boxes, offsets, depths, margin)


def box_hits(t_inv: torch.Tensor, cloud: torch.Tensor, mask: torch.Tensor,
             boxes: tuple, offsets: tuple, margin: float) -> torch.Tensor:
    """For P world->grasp transforms, which lateral offsets collide?
    :func:`box_hits_depths` at the one depth 0.

    Returns hit: (P, len(offsets)) bool.
    """
    return box_hits_depths(t_inv, cloud, mask, boxes, offsets, (0.0,), margin)[:, 0]


box_hits.launches = 0  # launches of K1, through either entry


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
