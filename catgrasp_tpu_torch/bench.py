"""Throughput entry point on one GPU: ``python -m catgrasp_tpu_torch.bench``
(the counterpart of the JAX package's root ``bench.py``).  Prints ONE JSON
line: {"metric", "value", "unit", "extra": {...}, "device": {...}}.

Primary: batched pile-drop env steps/second.  An env step is one full
physics step of one scene (10 bodies, CSG narrowphase + 4 Jacobi impulse
iterations), the unit of ``p.stepSimulation()`` in the reference hot loop.
It runs through kernel K3 (``ops.fused_rollout.rollout_fused``);
``extra.engine_env_steps_per_sec`` is the same batch through the eager engine
(``sim.engine.rollout_batch``), the unfused comparison.

extra.grasp_collision_checks_per_sec: the grasp filter's collision gate
through kernel K1 (``ops.collision.box_hits``).  One check = one (pose x
lateral offset) gripper-vs-scene-cloud query on a 2,048-point cloud.

extra.ik_gate_poses_per_sec: the branch-free S-R-S IK-feasibility gate
(``kin.iiwa.ik_feasible``).

extra.labeled_render_frames_per_sec: the full label stack (depth, seg,
NUNOCS, normal, xyz) of one 10-body pile at 384x512 through kernel K2
(``ops.render_march.march_csg``).

Every phase raises when its kernel does not build or launch: there is no
fall-back to another path.  Times are host-clock times around calls that end
in ``torch.cuda.synchronize()`` and a read-back of a sum.
"""
from __future__ import annotations

import json
import subprocess
import time

import torch

from .core import transforms as tf
from .device import resolve_device, sync
from .geom import csg as csglib
from .geom import primitives as prim
from .grasp.filter import ADJUST_OFFSETS, _static_open_boxes
from .kin import iiwa
from .ops import collision
from .ops.fused_rollout import rollout_fused
from .render import raymarch
from .sim import engine, env_pile
from .sim.env_grasp import GripperSpec
from .sim.types import build_shape_lib

ENV_SHAPES = (("nut", 0), ("screw", 0), ("hnm", 0), ("nut", 3))
RENDER_SHAPES = (("nut", 0), ("screw", 0), ("hnm", 0))


def _readback(x: torch.Tensor) -> float:
    """Force a device -> host read-back, so the clock stops after the work."""
    return float(x.sum())


def _timed(dev: torch.device, fn, n_calls: int, out_of):
    """Seconds for ``n_calls`` calls of ``fn`` (each given the last result),
    after one untimed warm-up call; returns (seconds, last result)."""
    res = fn(None)
    sync(dev)
    _readback(out_of(res))
    t0 = time.perf_counter()
    for _ in range(n_calls):
        res = fn(res)
    sync(dev)
    _readback(out_of(res))
    return time.perf_counter() - t0, res


def pile_lib(specs, n_surf: int, dev: torch.device):
    """Shape library of the (class, train instance) pairs ``specs``."""
    meshes = [prim.make_instance(c, "train", i) for c, i in specs]
    csgs = [csglib.make_csg_instance(c, "train", i) for c, i in specs]
    return build_shape_lib(meshes, csgs, n_surf=n_surf, device=dev)


def env_steps_phase(lib, env, states, params, dt: float, steps_per_call: int, n_calls: int):
    """Step a scene batch through K3 (one warm-up call, then ``n_calls`` timed
    calls that carry the state on) and, from the same start, through the
    eager engine (a one-step warm-up, then one timed call).
    Returns (fused env steps/s, engine env steps/s, final fused state)."""
    dev = states.pos.device
    batch = states.pos.shape[0]
    secs, final = _timed(
        dev, lambda st: rollout_fused(states if st is None else st, params, lib, env,
                                      steps_per_call, dt=dt),
        n_calls, lambda st: st.pos)
    fused = batch * steps_per_call * n_calls / secs
    engine.rollout_batch(states, params, lib, env, 1, dt=dt)
    sync(dev)
    t0 = time.perf_counter()
    st = engine.rollout_batch(states, params, lib, env, steps_per_call, dt=dt)
    sync(dev)
    _readback(st.pos)
    unfused = batch * steps_per_call / (time.perf_counter() - t0)
    return fused, unfused, final


def bench_env_steps(device=None, batch: int = 1024, max_bodies: int = 10, n_surf: int = 32,
                    steps_per_call: int = 50, n_calls: int = 4, keep: dict | None = None):
    """(K3 env steps/s, engine env steps/s).  ``keep``, here and in the other
    phases, receives the phase's inputs and last output, for a caller that
    checks them."""
    dev = resolve_device(device)
    cfg = env_pile.PileConfig(max_bodies=max_bodies)
    lib = pile_lib(ENV_SHAPES, n_surf, dev)
    env = engine.StaticEnv.open_bin(cfg.bin_inner, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    states, params = env_pile.reset_batch(gen, lib, cfg, batch)
    fused, unfused, final = env_steps_phase(lib, env, states, params, cfg.dt, steps_per_call,
                                            n_calls)
    if keep is not None:
        keep.update(env_first=states, env_last=final)
    return fused, unfused


def bench_collision_gate(device=None, n_poses: int = 131072, n_points: int = 2048,
                         n_calls: int = 8, keep: dict | None = None) -> float:
    dev = resolve_device(device)
    boxes = _static_open_boxes(GripperSpec())
    offsets = tuple(float(o) for o in ADJUST_OFFSETS)
    gen = torch.Generator(device=dev).manual_seed(1)
    t_inv = torch.eye(4, device=dev).repeat(n_poses, 1, 1)
    t_inv[:, :3, 3] = -0.2 + 0.4 * torch.rand((n_poses, 3), generator=gen, device=dev)
    cloud = -0.15 + 0.3 * torch.rand((n_points, 3), generator=gen, device=dev)
    mask = torch.ones((n_points,), dtype=torch.bool, device=dev)
    gate = (t_inv, cloud, mask, boxes, offsets, 0.0)
    secs, hit = _timed(dev, lambda _: collision.box_hits(*gate), n_calls, lambda hit: hit)
    if keep is not None:
        keep.update(hits=hit, gate_inputs=gate)
    return n_poses * len(offsets) * n_calls / secs


def bench_ik_gate(device=None, n_poses: int = 65536, n_calls: int = 8,
                  keep: dict | None = None) -> float:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(3)
    T = torch.eye(4, device=dev).repeat(n_poses, 1, 1)
    T[:, :3, 3] = -0.8 + 1.6 * torch.rand((n_poses, 3), generator=gen, device=dev)
    axis = torch.randn((n_poses, 3), generator=gen, device=dev)
    axis = axis / torch.linalg.vector_norm(axis, dim=1, keepdim=True)
    angle = 3.1 * torch.rand((n_poses,), generator=gen, device=dev)
    T[:, :3, :3] = tf.axis_angle_to_matrix(axis, angle)
    secs, ok = _timed(dev, lambda _: iiwa.ik_feasible(T), n_calls, lambda ok: ok)
    if keep is not None:
        keep.update(ik_ok=ok)
    return n_poses * n_calls / secs


def bench_render(device=None, batch: int = 8, hw: tuple = (384, 512), n_calls: int = 8,
                 keep: dict | None = None) -> float:
    """Labeled-frame renderer throughput at the eval-protocol resolution: one
    frame = the full label stack of one 10-body pile."""
    dev = resolve_device(device)
    H, W = hw
    cfg = env_pile.PileConfig(max_bodies=10)
    lib = pile_lib(RENDER_SHAPES, 32, dev)
    env = engine.StaticEnv.open_bin(cfg.bin_inner, device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    states, params = env_pile.reset_batch(gen, lib, cfg, batch)
    fx = 2257.75 * (W / 2064.0)
    K = torch.tensor([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1.0]], device=dev)
    cam = torch.eye(4, device=dev)
    cam[:3, :3] = torch.tensor([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]], device=dev)
    cam[2, 3] = 0.7
    secs, out = _timed(dev, lambda _: raymarch.render_batch(lib, states, params, K, cam, H, W,
                                                            env=env),
                       n_calls, lambda out: out["depth"])
    if keep is not None:
        keep.update(frames=out, render_inputs=(lib, states, params, K, cam, H, W, env))
    return batch * n_calls / secs


def device_record(dev: torch.device) -> dict:
    """The device the numbers were taken on; for a GPU its name and power
    limit as ``nvidia-smi --query-gpu=name,power.limit`` prints them."""
    if dev.type != "cuda":
        return {"platform": "cpu"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    name, _, limit = smi.stdout.strip().splitlines()[idx].partition(",")
    return {"platform": "gpu", "name": name.strip(), "power_limit": limit.strip()}


def record(dev: torch.device, sps: float, eps: float, cps: float, ips: float,
           rps: float) -> dict:
    """The entry point's JSON object from the five rates."""
    return {
        "metric": "pile_env_steps_per_sec",
        "value": round(sps, 1),
        "unit": "env_steps/s",
        "extra": {
            "engine_env_steps_per_sec": round(eps, 1),
            "grasp_collision_checks_per_sec": round(cps, 1),
            "ik_gate_poses_per_sec": round(ips, 1),
            "labeled_render_frames_per_sec": round(rps, 1),
        },
        "device": device_record(dev),
    }


def run(device=None, keep: dict | None = None) -> dict:
    """All four phases at the entry point's own sizes."""
    dev = resolve_device(device)
    sps, eps = bench_env_steps(dev, keep=keep)
    cps = bench_collision_gate(dev, keep=keep)
    ips = bench_ik_gate(dev, keep=keep)
    rps = bench_render(dev, keep=keep)
    return record(dev, sps, eps, cps, ips, rps)


def main() -> None:
    print(json.dumps(run()))


if __name__ == "__main__":
    main()
