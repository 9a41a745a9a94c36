"""Closed-loop clutter evaluation, front half
(``catgrasp_tpu/pipelines/run_grasp_simulation.py`` in PyTorch).

The JAX loop ``simulate_grasp_rounds`` runs, per round: scene set-up, pile
reset and settle, then per attempt: render -> segment -> per segment:
occupancy fill, grasp sampling + filtering, scoring, pick, place, tally.
This module ports the part up to the filtered candidate set as three
functions the full loop calls unchanged:

* :func:`setup_scene` — shape library, bin + table colliders, camera, robot
  base, cone sampler (JAX lines 343-455);
* :func:`make_round_pile` — one round's pile: reset, fixture body, fixed
  settle (lines 458-482);
* :func:`oracle_cone_attempt` — one attempt in oracle perception mode with
  the cone sampler: render, ground-truth segments by pixel count, per
  segment the occupancy-densified background cloud, sampling and the
  filter, stopping at the first segment that yields candidates (lines
  484-604).

The oracle NUNOCS pose, the NOCS-transfer sampler, scoring, the pick and
place and the tallies come with the next slice.  Numpy randomness (the
512-point collision subsample, the 4,096-point background subsample) makes
the same calls in the same order as the JAX loop.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..config.loader import load_config
from ..device import resolve_device
from ..geom import csg as csglib
from ..geom import occupancy
from ..geom import primitives as prim
from ..grasp.filter import compact_valid
from ..grasp.gripper import Gripper
from ..grasp.sampler import PointConeGraspSampler
from ..render import raymarch
from ..sim import arm as simarm
from ..sim import engine, env_pile
from ..sim.types import SceneParams, SceneState, ShapeLib, build_shape_lib

FIXTURE_POS = np.array([-0.10, -0.50, 0.0], np.float32)  # world, beside the bin
MAX_COLLISION_PTS = 512
MAX_BACKGROUND_PTS = 4096


@dataclass
class EvalScene:
    """Everything one eval run sets up before its rounds."""

    class_name: str
    n_objects: int
    instance: int  # < 0: mixed instances at jittered scales
    n_inst: int
    fixture_idx: int
    meshes: list
    lib: ShapeLib
    pile_cfg: env_pile.PileConfig
    env_bin: engine.StaticEnv
    H: int
    W: int
    K: torch.Tensor  # (3, 3) intrinsics
    cam: np.ndarray  # (4, 4) camera in world
    base_in_world: np.ndarray  # (4, 4) robot base in world
    cam_in_base: torch.Tensor  # (4, 4)
    gripper: Gripper
    cone: PointConeGraspSampler
    device: torch.device
    # 1.56 mm occupancy voxels (128^3 over the 0.2 m reach)
    grid_dims: tuple = (128, 128, 128)


def setup_scene(class_name: str = "nut", n_objects: int = 5, cfg_run: dict | None = None,
                render_hw=(384, 512), instance: int | None = None,
                device=None) -> EvalScene:
    """Scene set-up of one eval run: the pile is ONE object model at scale 1
    (or mixed instances when ``instance`` < 0) plus that model's place
    fixture."""
    dev = resolve_device(device)
    cfg_run = cfg_run or load_config("config_run.yml")
    gripper = Gripper.default()

    split = cfg_run.get("instance_split", "test")
    n_inst = prim.num_instances(class_name, split)
    if instance is None:
        instance = int(cfg_run.get("instance_index", 0))
    fix_params = prim.instance_params(class_name, split, instance) if instance >= 0 else None
    meshes = [prim.make_instance(class_name, split, i) for i in range(n_inst)]
    csgs = [csglib.make_csg_instance(class_name, split, i) for i in range(n_inst)]
    meshes.append(prim.place_fixture(class_name, fix_params))
    csgs.append(csglib.csg_place_fixture(class_name, fix_params))
    # 256 surface points a body: the peg-through-nut-hole interaction needs
    # < 3 mm point spacing on thin features
    lib = build_shape_lib(meshes, csgs, n_surf=256, device=dev)

    pile_cfg = env_pile.PileConfig(max_bodies=n_objects, scale_range=(0.9, 1.1))
    # table slab under the fixture area catches objects that miss the fixture
    env_bin = simarm.merge_envs(
        engine.StaticEnv.open_bin(pile_cfg.bin_inner, device=dev),
        engine.StaticEnv.boxes([[FIXTURE_POS[0], FIXTURE_POS[1], -0.006]],
                               [[0.15, 0.15, 0.005]], device=dev))
    H, W = render_hw
    # focal length scales with resolution (fx 2257.75 at 2064 wide)
    fx = 2257.75 * (W / 2064.0)
    K = torch.tensor([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1.0]], device=dev)
    cam = np.eye(4, dtype=np.float32)
    cam[:3, :3] = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32)
    cam[:3, 3] = [0, 0, 0.7]
    # robot base ~0.56 m from the bin center
    base_in_world = np.eye(4, dtype=np.float32)
    base_in_world[:3, 3] = [-0.559, -0.367, 0.052]
    cam_in_base = torch.as_tensor(np.linalg.inv(base_in_world) @ cam, device=dev)

    cone = PointConeGraspSampler(
        gripper, max_num_samples=64,
        n_sphere_dir=int(cfg_run.get("cone_grasp_smapler_n_sphere_dir", 30)),
        approach_step=float(cfg_run.get("cone_grasp_smapler_approach_step", 0.002)),
    )
    return EvalScene(class_name=class_name, n_objects=n_objects, instance=instance,
                     n_inst=n_inst, fixture_idx=len(meshes) - 1, meshes=meshes, lib=lib,
                     pile_cfg=pile_cfg, env_bin=env_bin, H=H, W=W, K=K, cam=cam,
                     base_in_world=base_in_world, cam_in_base=cam_in_base,
                     gripper=gripper, cone=cone, device=dev)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_round_pile(scene: EvalScene, rng: np.random.Generator,
                    generator: torch.Generator, settle_steps: int = 500,
                    timings: dict | None = None):
    """One round's pile: the objects (instance ids and scales from ``rng``),
    the fixture as a static huge-mass body, a ``generator``-drawn drop
    column, and a fixed settle.  Returns (state, params).  With a
    ``timings`` dict, the device is synchronised after the reset and after
    the settle, and their wall times are stored under ``reset_s`` and
    ``settle_s``."""
    n, dev = scene.n_objects, scene.device
    t0 = time.perf_counter()
    if scene.instance >= 0:
        ob_ids = np.full(n, scene.instance % scene.n_inst)
        ob_scales = np.ones(n)
    else:
        ob_ids = rng.integers(0, scene.n_inst, n)
        ob_scales = rng.uniform(*scene.pile_cfg.scale_range, n)
    shape_id = np.concatenate([ob_ids, [scene.fixture_idx]]).astype(np.int64)
    scale = np.concatenate([ob_scales, [1.0]]).astype(np.float32)
    params = SceneParams.create(scene.lib, shape_id, scale)
    mass, inertia, friction = params.mass.clone(), params.inertia.clone(), params.friction.clone()
    mass[n] = 1e9
    inertia[n] = 1e9
    friction[n] = 0.1  # reference fixture lateralFriction
    params = params.replace(mass=mass, inertia=inertia, friction=friction)

    state_p, _ = env_pile.reset(generator, scene.lib, scene.pile_cfg, n_objects=n)
    fixture_quat = torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=dev)
    state = SceneState(
        pos=torch.cat([state_p.pos, torch.as_tensor(FIXTURE_POS, device=dev)[None]]),
        quat=torch.cat([state_p.quat, fixture_quat]),
        linvel=torch.cat([state_p.linvel, torch.zeros((1, 3), device=dev)]),
        angvel=torch.cat([state_p.angvel, torch.zeros((1, 3), device=dev)]),
        active=torch.ones(n + 1, dtype=torch.bool, device=dev),
    )
    if timings is not None:
        _sync(dev)
        t1 = time.perf_counter()
        timings["reset_s"] = t1 - t0
    state = env_pile.settle_fixed(state, params, scene.lib, scene.env_bin,
                                  scene.pile_cfg, settle_steps)
    if timings is not None:
        _sync(dev)
        timings["settle_s"] = time.perf_counter() - t1
    # the out-of-bin cull must not deactivate the fixture
    active = state.active.clone()
    active[n] = True
    return state.replace(active=active), params


@dataclass
class AttemptFront:
    """What one attempt's front half produced."""

    out: dict  # the render: depth, seg, xyz, normal, nocs, rgb (tensors)
    # (segment mask, target body, its points, normals, candidate grasps in
    # the camera frame, provenance) of the first segment with candidates
    found: tuple | None
    # one entry per segment tried: seg id, candidate count G, the (G,)
    # valid mask, the valid count and the filter's rejection counters
    tried: list
    # wall seconds of the render, the occupancy fills and the sample+filter
    # calls, each read where the host already waits for the device
    timings: dict

    @property
    def fstats(self) -> dict | None:
        return self.tried[-1]["stats"] if self.found is not None else None


def oracle_cone_attempt(scene: EvalScene, state: SceneState, params: SceneParams,
                        rng: np.random.Generator, generator: torch.Generator) -> AttemptFront:
    """One attempt, oracle perception and the cone sampler: render, try the
    ground-truth segments from largest to smallest, and return at the first
    one whose filtered candidate set is non-empty."""
    n, dev, H, W = scene.n_objects, scene.device, scene.H, scene.W
    active = state.active[:n].cpu().numpy()
    t0 = time.perf_counter()
    out = raymarch.render(scene.lib, state, params, scene.K,
                          torch.as_tensor(scene.cam, device=dev), H, W,
                          env=scene.env_bin, geometry="csg")
    seg_body = out["seg"].cpu().numpy()  # ground-truth body ids
    xyz = out["xyz"].cpu().numpy()
    normal = out["normal"].cpu().numpy()
    timings = {"render_s": time.perf_counter() - t0, "occupancy_s": 0.0,
               "sample_filter_s": 0.0}

    min_px = max(20, (H * W) // 2500)
    seg_ids = sorted((i for i in range(n) if active[i]), key=lambda i: -(seg_body == i).sum())
    tried = []
    for sid in seg_ids:
        m = seg_body == sid
        if m.sum() < min_px:
            break  # sorted: the rest are smaller
        t0 = time.perf_counter()
        pts = xyz[m]
        nrm = normal[m]
        # background = visible non-target points + occupancy-densified
        # occluded space
        bg_m = ~m & (seg_body != -1)
        depth_bg = torch.where(torch.as_tensor(m, device=dev), 0.0, out["depth"])
        occ_c, occ_m = occupancy.background_cloud_from_depth(
            depth_bg, scene.K, out["seg"], -1, grid_dims=scene.grid_dims, pad=1e-3,
            center=torch.as_tensor(pts.mean(0), device=dev), reach=0.1)
        occ_pts = occ_c[occ_m].cpu().numpy()
        t1 = time.perf_counter()
        timings["occupancy_s"] += t1 - t0
        bg = np.concatenate([xyz[bg_m], occ_pts.astype(np.float32)])
        if len(bg) == 0:
            bg = np.full((1, 3), 999.0, np.float32)
        elif len(bg) > MAX_BACKGROUND_PTS:
            bg = bg[rng.choice(len(bg), MAX_BACKGROUND_PTS, replace=False)]

        n_sub = min(len(pts), MAX_COLLISION_PTS)
        ids = rng.choice(len(pts), n_sub, replace=False)
        poses_c, valid_c, stats = scene.cone.sample_grasps(
            torch.as_tensor(pts[ids], device=dev), torch.as_tensor(nrm[ids], device=dev),
            background_cloud=torch.as_tensor(bg, device=dev),
            background_mask=torch.ones(len(bg), dtype=torch.bool, device=dev),
            generator=generator, cam_in_world=scene.cam_in_base, filter_ik=True,
            adjust_depth=True)
        valid = valid_c.cpu().numpy()
        cand = compact_valid(poses_c.cpu().numpy(), valid)
        timings["sample_filter_s"] += time.perf_counter() - t1
        tried.append({"seg": int(sid), "n_candidates": int(poses_c.shape[0]),
                      "valid": valid, "n_valid": len(cand),
                      "stats": {k: int(v) for k, v in stats.items()}})
        if len(cand):
            found = (m, sid, pts, nrm, cand, np.zeros(len(cand), np.int32))
            return AttemptFront(out=out, found=found, tried=tried, timings=timings)
    return AttemptFront(out=out, found=None, tried=tried, timings=timings)
