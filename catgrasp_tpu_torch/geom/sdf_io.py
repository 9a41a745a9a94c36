"""SDFGen ``.sdf`` text files (``catgrasp_tpu/geom/sdf_io.py``, the port's
own copy).

The format, as the SDFGen voxelizer writes it and ``meshpy``'s
``SdfFile`` reads it::

    line 1:  nx ny nz
    line 2:  ox oy oz            (grid origin, mesh coords)
    line 3:  dx                  (cell size)
    then nx*ny*nz values, one per line, x fastest, then y, then z,
    read into an array indexed [i][j][k] = [x][y][z].

``grid_to_file`` and ``grid_from_file`` convert to and from the port's
:class:`~catgrasp_tpu_torch.geom.sdf.SdfGrid`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .sdf import SdfGrid


def read_sdf(path: str):
    """Read an SDFGen file -> (values[x,y,z] float32, origin (3,), dx)."""
    with open(path) as f:
        dims = np.array(f.readline().split(), dtype=int)
        origin = np.array(f.readline().split(), dtype=np.float32)
        dx = float(f.readline())
        data = np.loadtxt(f, dtype=np.float32)
    nx, ny, nz = dims
    if data.size != nx * ny * nz:
        raise ValueError(f"{path}: expected {nx * ny * nz} values, got {data.size}")
    # file order: x fastest, then y, then z -> reshape (z,y,x) and transpose
    values = data.reshape(nz, ny, nx).transpose(2, 1, 0)
    return np.ascontiguousarray(values), origin, dx


def write_sdf(path: str, values: np.ndarray, origin, dx: float):
    """Write an SDFGen-format file from values indexed [x,y,z]."""
    values = np.asarray(values, np.float32)
    nx, ny, nz = values.shape
    flat = values.transpose(2, 1, 0).reshape(-1)  # x fastest on disk
    with open(path, "w") as f:
        f.write(f"{nx} {ny} {nz}\n")
        ox, oy, oz = np.asarray(origin, np.float64)
        f.write(f"{ox:.8g} {oy:.8g} {oz:.8g}\n")
        f.write(f"{dx:.8g}\n")
        np.savetxt(f, flat, fmt="%.6g")


def grid_to_file(path: str, grid: SdfGrid):
    """Write an :class:`SdfGrid` as an SDFGen file."""
    write_sdf(path, grid.values.detach().cpu().numpy(), grid.lower.detach().cpu().numpy(),
              float(grid.spacing))


def grid_from_file(path: str, device=None) -> SdfGrid:
    """Load an SDFGen file into an :class:`SdfGrid` on ``device`` (cubic
    cells, which SDFGen always writes)."""
    dev = resolve_device(device)
    values, origin, dx = read_sdf(path)
    return SdfGrid(values=torch.as_tensor(values, device=dev),
                   lower=torch.as_tensor(origin, device=dev),
                   spacing=torch.tensor(dx, dtype=torch.float32, device=dev))
