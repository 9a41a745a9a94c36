"""Category-level NUNOCS canonical frame (``catgrasp_tpu/pipelines/
make_canonical.py``).  Only the transform into the canonical frame is
ported; building a canonical model is not."""
from __future__ import annotations

import numpy as np


def to_nunocs_transform(points: np.ndarray) -> np.ndarray:
    """4x4 anisotropic similarity mapping object coords -> CENTERED NUNOCS
    [-0.5, 0.5]^3.  The canonical frame is centered so category symmetry
    transforms apply about the origin."""
    lo = points.min(axis=0)
    hi = points.max(axis=0)
    ext = np.maximum(hi - lo, 1e-9)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.diag(1.0 / ext)
    T[:3, 3] = -lo / ext - 0.5
    return T
