"""Arm-side helpers (``catgrasp_tpu/sim/arm.py``); only the collider merge
used by the eval's scene set-up is ported so far."""
from __future__ import annotations

import torch

from . import engine


def merge_envs(*envs: engine.StaticEnv) -> engine.StaticEnv:
    """Concatenate StaticEnv collider sets."""
    return engine.StaticEnv(
        center=torch.cat([e.center for e in envs]),
        half=torch.cat([e.half for e in envs]),
        quat=torch.cat([e.quat for e in envs]),
        vel=torch.cat([e.vel for e in envs]),
        friction=torch.cat([e.friction for e in envs]),
        enabled=torch.cat([e.enabled for e in envs]),
        imp_budget=torch.cat([e.imp_budget for e in envs]),
        grip=torch.cat([e.grip for e in envs]),
    )
