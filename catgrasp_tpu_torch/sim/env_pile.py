"""Pile-drop environment (``catgrasp_tpu/sim/env_pile.py`` in PyTorch).

``reset`` spawns a randomized column of category objects above the bin,
``settle`` steps physics until the scene is stable and culls out-of-bin
bodies.  Randomness comes from a ``torch.Generator`` in place of a
``jax.random`` key.  ``reset_batch`` and ``make_pile_batch`` do the same for
a batch of scenes with a leading axis, where the JAX package uses ``vmap``.
``add_duplicate_object_on_pile`` activates free body slots as duplicates of
one shape above the bin.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from ..core import transforms as tf
from . import engine
from .types import SceneParams, SceneState, ShapeLib


@dataclass(frozen=True)
class PileConfig:
    max_bodies: int = 10
    scale_range: tuple = (0.75, 1.25)
    bin_inner: tuple = (0.3, 0.3, 0.12)
    drop_height: float = 0.06
    drop_spacing: float = 0.035
    dt: float = engine.DT
    settle_chunk: int = 50  # steps per stability check
    settle_max_chunks: int = 10
    stable_motion: float = 5e-4  # max per-chunk body motion to call it stable


def _draw_pile(generator: torch.Generator, lib: ShapeLib, cfg: PileConfig,
               lead: tuple, n_objects):
    """(state, params) with leading axes ``lead`` ahead of the body axis:
    ``()`` for one scene, ``(B,)`` for a batch.  Every quantity is drawn for
    all scenes at once from the one generator."""
    N = cfg.max_bodies
    dev = lib.device
    g = generator

    def draw(fn, *args):
        return fn(*args, generator=g, device=g.device).to(dev)

    shape_id = draw(torch.randint, 0, lib.num_shapes, (*lead, N))
    lo, hi = cfg.scale_range
    scale = lo + (hi - lo) * draw(torch.rand, (*lead, N))
    params = SceneParams.create(lib, shape_id, scale)

    if n_objects is None:
        n_objects = draw(torch.randint, 1, N + 1, (*lead, 1))
    active = torch.arange(N, device=dev) < n_objects

    xy = -0.06 + 0.12 * draw(torch.rand, (*lead, N, 2))
    z = cfg.drop_height + torch.arange(N, device=dev, dtype=torch.float32) * cfg.drop_spacing
    pos = torch.cat([xy, z[:, None].expand(*lead, N, 1)], dim=-1)
    quat = tf.quat_normalize(draw(torch.randn, (*lead, N, 4)))

    state = SceneState(
        pos=pos, quat=quat,
        linvel=torch.zeros((*lead, N, 3), device=dev),
        angvel=torch.zeros((*lead, N, 3), device=dev),
        active=active.expand(*lead, N).contiguous(),
    )
    return state, params


def reset(generator: torch.Generator, lib: ShapeLib, cfg: PileConfig,
          n_objects: int | None = None):
    """One scene: (state, params) on the library's device.

    Objects get random shapes, scales, orientations and staggered drop
    heights in a jittered column over the bin center."""
    return _draw_pile(generator, lib, cfg, (), n_objects)


def reset_batch(generator: torch.Generator, lib: ShapeLib, cfg: PileConfig, batch: int,
                n_objects: int | None = None):
    """``batch`` scenes, (B, N, ...): the counterpart of ``vmap(reset)``.  The
    same distributions as ``reset``, scene by scene (``n_objects`` uniform in
    1..N for each scene unless given), from one explicit generator."""
    return _draw_pile(generator, lib, cfg, (batch,), n_objects)


def _cull_out_of_bin(state: SceneState, cfg: PileConfig) -> SceneState:
    """Deactivate bodies that escaped the bin."""
    ix, iy, _ = cfg.bin_inner
    p = state.pos
    inside = ((torch.abs(p[..., 0]) < ix / 2 + 0.05)
              & (torch.abs(p[..., 1]) < iy / 2 + 0.05)
              & (p[..., 2] > -0.05)
              & (p[..., 2] < 0.5))
    return state.replace(active=state.active & inside)


def step(state: SceneState, params: SceneParams, lib: ShapeLib,
         env: engine.StaticEnv, cfg: PileConfig) -> SceneState:
    """One env step: one physics step plus out-of-bin culling."""
    return _cull_out_of_bin(engine.step(state, params, lib, env, dt=cfg.dt), cfg)


def settle(state: SceneState, params: SceneParams, lib: ShapeLib,
           env: engine.StaticEnv, cfg: PileConfig):
    """Step in chunks until the max body motion per chunk falls below the
    threshold, with an iteration cap; returns (state, n_chunks_used)."""
    n = 0
    while n < cfg.settle_max_chunks:
        prev = state
        state = _cull_out_of_bin(
            engine.rollout(state, params, lib, env, cfg.settle_chunk, dt=cfg.dt), cfg)
        n += 1
        if float(engine.max_body_motion(prev, state)) < cfg.stable_motion:
            break
    return state, n


def settle_fixed(state: SceneState, params: SceneParams, lib: ShapeLib,
                 env: engine.StaticEnv, cfg: PileConfig, n_steps: int,
                 narrowphase: str = "csg") -> SceneState:
    """Fixed-step settle: no data-dependent trip count."""
    st = engine.rollout(state, params, lib, env, n_steps, dt=cfg.dt, narrowphase=narrowphase)
    return _cull_out_of_bin(st, cfg)


def draw_duplicate_poses(generator: torch.Generator, n: int, cfg: PileConfig, device):
    """Poses for ``n`` body slots above the bin: xy uniform over the bin's
    inner footprint, z uniform in [0.05, 0.3], a normalised Gaussian
    quaternion.  Returns (pos (n, 3), quat (n, 4)) on ``device``."""
    g = generator

    def draw(fn, *args):
        return fn(*args, generator=g, device=g.device).to(device)

    ix, iy, _ = cfg.bin_inner
    half = torch.tensor([ix / 2, iy / 2], device=device)
    xy = (-1.0 + 2.0 * draw(torch.rand, (n, 2))) * half
    z = 0.05 + 0.25 * draw(torch.rand, (n,))
    quat = tf.quat_normalize(draw(torch.randn, (n, 4)))
    return torch.cat([xy, z[:, None]], dim=1), quat


def add_duplicate_object_on_pile(generator: torch.Generator, state: SceneState,
                                 params: SceneParams, shape_id: int, scale: float, n_ob: int,
                                 cfg: PileConfig, lib: ShapeLib | None = None):
    """Spawn ``n_ob`` duplicates of one shape at random poses above the bin:
    the first ``n_ob`` inactive body slots become active at poses from
    ``draw_duplicate_poses`` (drawn for every slot), at rest.  With ``lib``
    those slots' parameters become ``shape_id`` at ``scale``; without it
    they keep theirs.  Returns (state, params); settle afterwards.

    The scene's slot count is fixed, so adding a body activates a free
    slot."""
    N, dev = state.pos.shape[0], state.pos.device
    pos, quat = draw_duplicate_poses(generator, N, cfg, dev)
    inactive = ~state.active
    chosen = inactive & (torch.cumsum(inactive.int(), dim=0) <= n_ob)
    c = chosen[:, None]
    state = state.replace(
        pos=torch.where(c, pos, state.pos),
        quat=torch.where(c, quat, state.quat),
        linvel=torch.where(c, 0.0, state.linvel),
        angvel=torch.where(c, 0.0, state.angvel),
        active=state.active | chosen,
    )
    if lib is not None:
        fresh = SceneParams.create(lib, torch.full((N,), int(shape_id), device=dev),
                                   torch.full((N,), float(scale), device=dev))
        params = SceneParams(**{
            f.name: torch.where(chosen.reshape((N,) + (1,) * (getattr(params, f.name).dim() - 1)),
                                getattr(fresh, f.name), getattr(params, f.name))
            for f in fields(params)})
    return state, params


def make_pile_batch(generator: torch.Generator, lib: ShapeLib, cfg: PileConfig, batch: int,
                    settle_steps: int = 400):
    """B settled pile scenes in one call: batched reset + fixed settle in the
    engine (the production settle; ``ops.fused_rollout`` is the throughput
    path).  Returns (states, params, env)."""
    env = engine.StaticEnv.open_bin(cfg.bin_inner, device=lib.device)
    states, params = reset_batch(generator, lib, cfg, batch)
    st = engine.rollout_batch(states, params, lib, env, settle_steps, dt=cfg.dt)
    return _cull_out_of_bin(st, cfg), params, env
