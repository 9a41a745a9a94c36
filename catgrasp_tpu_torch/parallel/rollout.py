"""Sharded simulation rollouts: scenes over the mesh's batch axes
(``catgrasp_tpu/parallel/rollout.py`` in PyTorch).

Scenes are independent (the engine step reduces nothing across the scene
axis), so each shard of a scene batch steps on its own device and the
shards' scenes come out as the same scenes of the whole batch do.

The shards run one after another from the calling thread.  The
eager engine step is bound by the host's launch rate, so one thread does
not scale over several GPUs: that needs a thread (or a process) per
device, and a machine with several cards to measure it on.
"""
from __future__ import annotations

import torch

from ..sim import engine
from .mesh import Mesh, dp_sharding, gather, shard_batch, to_device


def sharded_rollout(mesh: Mesh, states, params, lib, env, n_steps: int,
                    dt: float = engine.DT):
    """Roll a batch of scenes ``n_steps`` forward (``engine.rollout_batch``)
    with its scene axis split over the mesh; ``lib`` and ``env`` are copied
    once to each device.  Returns the global batch on the first batch
    device."""
    devs = dp_sharding(mesh)
    shared = {d: (to_device(lib, d), to_device(env, d)) for d in dict.fromkeys(devs)}
    out = [engine.rollout_batch(s, p, *shared[d], n_steps, dt=dt)
           for s, p, d in zip(shard_batch(mesh, states), shard_batch(mesh, params), devs)]
    return gather(mesh, out)


def sharded_map(mesh: Mesh, fn, *batched_args):
    """``fn`` on each element of the batched arguments
    (``torch.func.vmap``), the leading axis split over the mesh; returns
    the global batch on the first batch device."""
    shards = zip(*(shard_batch(mesh, a) for a in batched_args))
    return gather(mesh, [torch.func.vmap(fn)(*args) for args in shards])
