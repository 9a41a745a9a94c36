"""Where the port's command-line tools may write: never into the tracked
data of the repository, which they only read."""
from __future__ import annotations

import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the tracked grasp DBs, affordance labels, canonicals, checkpoints, logs
# and meshes
TRACKED = ("dataset/grasps", "dataset/affordance", "dataset/nut_canonical.npz",
           "dataset/screw_canonical.npz", "dataset/hnm_canonical.npz", "artifacts_tracked",
           "logs", "assets")


def refuse_tracked(path: str) -> None:
    """Raise ``ValueError`` when ``path`` is or lies in one of ``TRACKED``."""
    real = os.path.realpath(path)
    for d in TRACKED:
        root = os.path.realpath(os.path.join(REPO, d))
        if real == root or real.startswith(root + os.sep):
            raise ValueError(f"{path} is tracked data ({d}); write under another directory")
