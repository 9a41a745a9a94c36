"""Operation counts, from shapes alone."""


def pointnet_macs(n_clouds: int, n_pts: int, seg_head: bool, n_out: int, c_in: int = 6) -> float:
    """Multiply-adds of one PointNetCls / PointNetSeg forward on ``n_clouds``
    clouds of ``n_pts`` points: per point the two STNs' shared MLPs, the
    transforms, the encoder's MLPs and (segmentation) the per-point head;
    per cloud the STNs' pooled heads and (classification) the cloud's head.
    A frozen copy of ``chip_smoke.py:pointnet_macs``."""
    per_pt = (c_in + 64) * 64 + 2 * (64 * 128 + 128 * 1024)  # the STNs' MLPs
    per_pt += 3 * 3 + 64 * 64 + c_in * 64 + 64 * 128 + 128 * 1024
    per_cloud = 2 * (1024 * 512 + 512 * 256) + 256 * (3 * 3 + 64 * 64)
    if seg_head:
        per_pt += 1088 * 512 + 512 * 256 + 256 * 128 + 128 * n_out
    else:
        per_cloud += 1024 * 512 + 512 * 256 + 256 * n_out
    return float(n_clouds) * (n_pts * per_pt + per_cloud)

