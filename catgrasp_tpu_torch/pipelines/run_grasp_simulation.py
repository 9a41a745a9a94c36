"""Closed-loop clutter evaluation
(``catgrasp_tpu/pipelines/run_grasp_simulation.py`` in PyTorch).

Per round: scene set-up, pile reset and settle; then per attempt: render ->
segments -> per segment: occupancy-densified background, the NUNOCS pose,
cone and NOCS-transfer grasp sampling + filtering -> task-affordance
scoring P(T|G), quality P(G), thresholds on P(T,G) and an engagement
tiebreak -> IK + RRT to the pregrasp over the best
12 -> arm-executed pick (approach, close, hold gate, lift) -> arm-executed
place over the category's fixture (symmetry loop, RRT transport,
insertion, release) -> re-settle -> tallies ``num_objects / num_attempts
/ num_stable_grasp / num_task_grasp_succ``.

The floating-gripper baseline replaces the arm's execution: with
``use_arm=0`` the pick is the first candidate in score order, with
``arm_exec=0`` the IK + RRT gate still chooses it; either way a floating
gripper closes on it in the pile (``execute_pick``) and the place is
``sim.env_semantic.place_and_drop``, steered by the commanded grasp.  With
``obj_path`` the pile is one external mesh, its SDF grid baked on the
device, and physics and rendering run through the baked grids (the grid
narrowphase and the grid march) instead of CSG.

Perception is the oracle's (the renderer's ground-truth segments, the
simulator's poses, the analytic wrench quality) or learned
(``--oracle 0 --artifacts``: the seg net's segments with MeanShift,
retried at other bandwidths, the NUNOCS net's RANSAC pose and the grasp
net's P(G); a grasp predicter alone gives P(G) in oracle mode too).  With
learned segments the simulator tracks the body the segment mostly shows,
rebound after the pick to the body most in the grasp's closing channel.
With ``arm_dynamics`` the arm-executed pick and place step the trajectory
a force-limited PD-controlled articulated arm achieves tracking the planned
schedule (``sim.arm.dynamicize_schedule``), not the schedule itself.

The numpy randomness makes the JAX loop's calls in the same order: the
4,096-point background and 512-point collision subsamples of each segment
tried, the 128-candidate subsample, the 1,024-point obstacle subsample, and
the planners' own ``default_rng`` streams.  torch draws (the pile reset, the
cone sampler's points) come from one ``torch.Generator`` seeded with
``seed``.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config.loader import load_config
from ..core import transforms as tf
from ..core.symmetry import get_symmetry_tfs
from ..device import constant, resolve_device, sync
from ..geom import csg as csglib
from ..geom import occupancy
from ..geom import primitives as prim
from ..geom.mesh import TriMesh
from ..grasp.filter import compact_valid, engagement_depth
from ..grasp.gripper import Gripper
from ..grasp.quality import parallel_jaw_quality
from ..grasp.sampler import NocsTransferGraspSampler, PointConeGraspSampler
from ..kin import iiwa, planner
from ..pipelines.make_canonical import to_nunocs_transform
from ..predict.artifacts import load_predicters
from ..render import raymarch
from ..sim import arm as simarm
from ..sim import engine, env_pile
from ..sim import env_semantic as es
from ..sim.env_grasp import (GripperSpec, closing_channel_mask, closing_step,
                             closing_touched_init, finger_contact_points, gripper_env)
from ..sim.types import SceneParams, SceneState, ShapeLib, build_shape_lib
from ..utils.metrics import MetricsLogger, StageClock

Q_HOME = np.zeros(7, np.float32)  # straight-up home (clear of the bin)
LIFT_HEIGHT = 0.25
LIFT_STEPS = 80
CLOSE_STEPS = 50
# arm-executed phase lengths (engine steps)
N_APP, N_LIFT_A = 140, 50  # approach = RRT segment (110) + descent (30)
N_MOVE_P, N_DROP_P = 140, 100
SETTLE_STEPS = 500  # a round's pile
RESETTLE_STEPS = 150  # after each attempt
FIXTURE_POS = np.array([-0.10, -0.50, 0.0], np.float32)  # world, beside the bin
MAX_COLLISION_PTS = 512
MAX_BACKGROUND_PTS = 4096
MAX_CANDIDATES = 128
MAX_OBSTACLE_PTS = 1024
PICK_TRIES = 12  # candidates the pick gate tries, in order
RRT_MAX_ITER = 500
# learned segmentation retries an attempt at these multiples of the
# MeanShift bandwidth (merged or split clusters) before giving up the round
BANDWIDTH_RETRIES = (1.0, 0.67, 1.5)


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
    # the canonical model (numpy arrays) and its grasp-codebook sampler;
    # None without a canonical
    canonical: dict | None = None
    nocs: NocsTransferGraspSampler | None = None
    sym: np.ndarray | None = None  # (S, 4, 4) the category's symmetries
    T_fix: np.ndarray | None = None  # (4, 4) fixture in world
    fix_pts_base: np.ndarray | None = None  # fixture surface points, base frame
    # 1.56 mm occupancy voxels (128^3 over the 0.2 m reach)
    grid_dims: tuple = (128, 128, 128)
    # "csg" (the procedural instances' trees) or "grid" (baked SDF grids of
    # an external mesh): the narrowphase of every step and the render's
    geometry: str = "csg"


def setup_scene(class_name: str = "nut", n_objects: int = 5, cfg_run: dict | None = None,
                render_hw=(384, 512), instance: int | None = None,
                canonical: dict | None = None, device=None,
                obj_path: str | None = None) -> EvalScene:
    """Scene set-up of one eval run: the pile is ONE object model at scale 1
    (or mixed instances when ``instance`` < 0) plus that model's place
    fixture; with a ``canonical`` model, its grasp codebook feeds the
    NOCS-transfer sampler.  With ``obj_path`` the model is that watertight
    .obj instead, beside the category's default fixture; both get SDF grids
    baked on the device (56 a side) and the scene runs on grid geometry."""
    dev = resolve_device(device)
    cfg_run = cfg_run or load_config("config_run.yml")
    gripper = Gripper.default()

    split = cfg_run.get("instance_split", "test")
    if obj_path:
        # the mesh needs no CSG tree: a bounding-box placeholder keeps the
        # stacked-shape layout (the fixture keeps its own)
        m = TriMesh.load_obj(obj_path)
        b = m.bounds
        n_inst, instance = 1, 0
        meshes = [m, prim.place_fixture(class_name, None)]
        csgs = [csglib.csg_box(b[1] - b[0], center=(b[1] + b[0]) / 2),
                csglib.csg_place_fixture(class_name, None)]
        lib = build_shape_lib(meshes, csgs, n_surf=256, bake_grids=True, dims=56, device=dev)
        geometry = "grid"
    else:
        n_inst = prim.num_instances(class_name, split)
        if instance is None:
            instance = int(cfg_run.get("instance_index", 0))
        fix_params = (prim.instance_params(class_name, split, instance) if instance >= 0
                      else None)
        meshes = [prim.make_instance(class_name, split, i) for i in range(n_inst)]
        csgs = [csglib.make_csg_instance(class_name, split, i) for i in range(n_inst)]
        meshes.append(prim.place_fixture(class_name, fix_params))
        csgs.append(csglib.csg_place_fixture(class_name, fix_params))
        # 256 surface points a body: the peg-through-nut-hole interaction
        # needs < 3 mm point spacing on thin features
        lib = build_shape_lib(meshes, csgs, n_surf=256, device=dev)
        geometry = "csg"
    fixture_idx = len(meshes) - 1

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
    nocs = None
    if canonical is not None and len(canonical.get("canonical_grasps", [])):
        nocs = NocsTransferGraspSampler(
            gripper, np.asarray(canonical["canonical_grasps"]),
            np.asarray(canonical["canonical_grasp_scores"]),
            score_larger_than=float(cfg_run.get("nocs_grasp_sampler_score_larger_than", 0.95)),
            max_n_grasp=int(cfg_run.get("nocs_grasp_sampler_max_n_grasp", 10000)),
        )
    # the place fixture is a huge-mass body of the scene, so insertion
    # contact is simulated; it is an obstacle of the arm planners too
    T_fix = np.eye(4, dtype=np.float32)
    T_fix[:3, 3] = FIXTURE_POS
    fix_pts_base = ((lib.surf_pts[fixture_idx].cpu().numpy() + FIXTURE_POS
                     - base_in_world[:3, 3]) @ base_in_world[:3, :3])
    return EvalScene(class_name=class_name, n_objects=n_objects, instance=instance,
                     n_inst=n_inst, fixture_idx=fixture_idx, meshes=meshes, lib=lib,
                     pile_cfg=pile_cfg, env_bin=env_bin, H=H, W=W, K=K, cam=cam,
                     base_in_world=base_in_world, cam_in_base=cam_in_base,
                     gripper=gripper, cone=cone, device=dev, canonical=canonical, nocs=nocs,
                     sym=get_symmetry_tfs(class_name), T_fix=T_fix,
                     fix_pts_base=fix_pts_base, geometry=geometry)


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
        sync(dev)
        t1 = time.perf_counter()
        timings["reset_s"] = t1 - t0
    state = settle_keep_fixture(scene, state, params, settle_steps)
    if timings is not None:
        sync(dev)
        timings["settle_s"] = time.perf_counter() - t1
    return state, params


def settle_keep_fixture(scene: EvalScene, state: SceneState, params: SceneParams,
                        n_steps: int) -> SceneState:
    """A fixed settle whose out-of-bin cull leaves the fixture active."""
    state = env_pile.settle_fixed(state, params, scene.lib, scene.env_bin, scene.pile_cfg,
                                  n_steps, narrowphase=scene.geometry)
    active = state.active.clone()
    active[scene.n_objects] = True
    return state.replace(active=active)


@dataclass
class Found:
    """The first segment whose candidate set is non-empty."""

    mask: np.ndarray  # (H, W) the segment's pixels
    target: int  # the body it belongs to
    pts: np.ndarray  # (M, 3) its points, camera frame
    nrm: np.ndarray  # (M, 3) their normals
    bg_m: np.ndarray  # (H, W) visible pixels of other bodies and the env
    nocs_pose: np.ndarray  # (4, 4) centered NUNOCS -> camera
    grasps_cam: np.ndarray  # (G, 4, 4) valid candidates, camera frame
    prov: np.ndarray  # (G,) 0 = cone sampler, 1 = NOCS transfer


@dataclass
class AttemptFront:
    """What one attempt's front half produced."""

    out: dict  # the render: depth, seg, xyz, normal, nocs, rgb (tensors)
    # the render's xyz (H, W, 3) and ground-truth body ids (H, W), and the
    # objects' active flags (n,), on the host
    xyz: np.ndarray
    seg_body: np.ndarray
    active: np.ndarray
    found: Found | None
    # one entry per segment tried: seg id, then per sampler ("cone", and
    # "nocs" with a canonical) the candidate count, the valid mask, the
    # valid count and the filter's rejection counters
    tried: list
    # learned segmentation: (bandwidth scale, segments) of each bandwidth
    # at which no segment gave candidates
    bandwidth_misses: list = field(default_factory=list)


def _filtered(poses: torch.Tensor, valid: torch.Tensor, stats: dict) -> dict:
    """One sampler's filter call: candidate count, valid mask, the valid
    candidates (camera frame) and the rejection counters, on the host."""
    cand = compact_valid(poses, valid)
    return {"n_candidates": int(poses.shape[0]), "valid": valid.cpu().numpy(), "cand": cand,
            "n_valid": len(cand), "stats": {k: int(v) for k, v in stats.items()}}


def oracle_nocs_pose(scene: EvalScene, state: SceneState, params: SceneParams,
                     target: int) -> np.ndarray:
    """The oracle 9D pose of a body: centered NUNOCS -> camera, from its
    simulated pose and its mesh's bounding box at its scale."""
    T_wc = np.linalg.inv(scene.cam)
    ob_in_cam = T_wc @ tf.pose_from_qt(state.quat[target], state.pos[target]).cpu().numpy()
    s = float(params.scale[target])
    T_nocs = to_nunocs_transform(scene.meshes[int(params.shape_id[target])].vertices * s)
    return (ob_in_cam @ np.linalg.inv(T_nocs)).astype(np.float32)


def segment_body(seg_body: np.ndarray, m: np.ndarray, active: np.ndarray,
                 n_objects: int) -> int | None:
    """The simulated body a learned segment's pixels mostly show (ground
    truth, for the simulator's bookkeeping only: its closing law tracks
    one body), or None when they show none or an inactive one."""
    inside = seg_body[m & (seg_body >= 0)]
    if len(inside) == 0:
        return None
    target = int(np.bincount(inside, minlength=n_objects).argmax())
    return target if active[target] else None


def attempt_front(scene: EvalScene, state: SceneState, params: SceneParams,
                  rng: np.random.Generator, generator: torch.Generator, oracle: bool = True,
                  predicters: dict | None = None, timings: dict | None = None) -> AttemptFront:
    """One attempt's front half: render, try the segments from largest to
    smallest, and per segment build the background cloud, the NUNOCS pose
    and the cone (and, with a canonical, NOCS-transfer) candidates; return
    at the first segment where their union is non-empty.

    The segments are the ground truth's, or, with ``oracle`` off and a seg
    predicter, the seg net's over the visible objects' points, tried again
    at 0.67 and 1.5 times the bandwidth when no segment gives candidates;
    the pose is the simulator's, or, with ``oracle`` off, the NUNOCS net's
    (a segment whose fit is not valid is skipped).  With a ``timings``
    dict, the wall seconds of the render, the occupancy fills, the two
    samplers' sample+filter calls and, with learned perception, the nets
    and their post-processing (seg_net_s, meanshift_s, nocs_net_s,
    ransac_s) are added to it, the device synchronised at each stage's
    end."""
    n, dev, H, W = scene.n_objects, scene.device, scene.H, scene.W
    active = state.active[:n].cpu().numpy()
    clock = StageClock(timings, dev)
    out = raymarch.render(scene.lib, state, params, scene.K,
                          torch.as_tensor(scene.cam, device=dev), H, W,
                          env=scene.env_bin, geometry=scene.geometry)
    seg_body = out["seg"].cpu().numpy()  # ground-truth body ids
    xyz = out["xyz"].cpu().numpy()
    normal = out["normal"].cpu().numpy()
    clock.lap("render_s")

    min_px = max(20, (H * W) // 2500)
    learned_seg = not oracle and "seg" in (predicters or {})
    tried, misses = [], []
    for bw_scale in BANDWIDTH_RETRIES if learned_seg else (1.0,):
        if learned_seg:
            vm = seg_body >= 0
            part = {} if timings is not None else None
            labels, n_seg = predicters["seg"].predict(xyz[vm], normal[vm],
                                                      bandwidth_scale=bw_scale, timings=part)
            clock.add(part)
            seg = np.full(seg_body.shape, -1, np.int64)
            seg[vm] = labels
            seg_ids, seg_t = range(max(n_seg, 1)), torch.as_tensor(seg, device=dev)
        else:
            seg, seg_ids, seg_t = seg_body, [i for i in range(n) if active[i]], out["seg"]
        seg_ids = sorted(seg_ids, key=lambda i: -(seg == i).sum())
        for sid in seg_ids:
            m = seg == sid
            if m.sum() < min_px:
                break  # sorted: the rest are smaller
            target = segment_body(seg_body, m, active, n) if learned_seg else sid
            if target is None:
                continue
            pts = xyz[m]
            nrm = normal[m]
            # background = visible non-target points + occupancy-densified
            # occluded space
            bg_m = ~m & (seg_body != -1)
            depth_bg = torch.where(torch.as_tensor(m, device=dev), 0.0, out["depth"])
            occ_c, occ_m = occupancy.background_cloud_from_depth(
                depth_bg, scene.K, seg_t, -1, grid_dims=scene.grid_dims, pad=1e-3,
                center=torch.as_tensor(pts.mean(0), device=dev), reach=0.1)
            occ_pts = occ_c[occ_m].cpu().numpy()
            clock.lap("occupancy_s")
            bg = np.concatenate([xyz[bg_m], occ_pts.astype(np.float32)])
            if len(bg) == 0:
                bg = np.full((1, 3), 999.0, np.float32)
            elif len(bg) > MAX_BACKGROUND_PTS:
                bg = bg[rng.choice(len(bg), MAX_BACKGROUND_PTS, replace=False)]
            if oracle:
                nocs_pose = oracle_nocs_pose(scene, state, params, target)
            else:
                part = {} if timings is not None else None
                res = predicters["nocs"].predict(pts, nrm, timings=part)
                clock.add(part)
                if not res["valid"]:
                    continue
                nocs_pose = res["nocs_pose"].astype(np.float32)

            n_sub = min(len(pts), MAX_COLLISION_PTS)
            ids = rng.choice(len(pts), n_sub, replace=False)
            bg_t = torch.as_tensor(bg, device=dev)
            bg_mask = torch.ones(len(bg), dtype=torch.bool, device=dev)
            cone = _filtered(*scene.cone.sample_grasps(
                torch.as_tensor(pts[ids], device=dev), torch.as_tensor(nrm[ids], device=dev),
                background_cloud=bg_t, background_mask=bg_mask, generator=generator,
                cam_in_world=scene.cam_in_base, filter_ik=True, adjust_depth=True))
            clock.lap("sample_filter_s")
            entry = {"seg": int(sid), "cone": cone, "nocs": None}
            cand, prov = [cone["cand"]], [np.zeros(cone["n_valid"], np.int32)]
            if scene.nocs is not None:
                nocs = _filtered(*scene.nocs.sample_grasps(
                    nocs_pose=torch.as_tensor(nocs_pose, device=dev),
                    symmetry_tfs=scene.sym, background_cloud=bg_t, background_mask=bg_mask,
                    collision_cloud=pts[ids], collision_mask=np.ones(n_sub, bool),
                    cam_in_world=scene.cam_in_base, filter_ik=True, adjust_depth=True))
                clock.lap("nocs_filter_s")
                entry["nocs"] = nocs
                cand.append(nocs["cand"])
                prov.append(np.ones(nocs["n_valid"], np.int32))
            tried.append(entry)
            grasps_cam = np.concatenate(cand)
            if len(grasps_cam):
                found = Found(mask=m, target=int(target), pts=pts, nrm=nrm, bg_m=bg_m,
                              nocs_pose=nocs_pose, grasps_cam=grasps_cam,
                              prov=np.concatenate(prov))
                return AttemptFront(out, xyz, seg_body, active, found, tried, misses)
        if learned_seg:
            misses.append((bw_scale, len(seg_ids)))
    return AttemptFront(out, xyz, seg_body, active, None, tried, misses)


# ---------------------------------------------------------------------------
# Scoring
# ---------------------------------------------------------------------------


def grasp_affordance(canonical: dict, nocs_pose: np.ndarray, grasps_cam: np.ndarray,
                     width: float, spec: GripperSpec, device=None) -> np.ndarray:
    """P(T|G) of each grasp (G, 4, 4): the mean canonical affordance over
    the canonical points the fingers would touch at opening ``width``, 0
    where they touch none.  All grasps in one batch."""
    dev = resolve_device(device)
    pts_nocs = canonical["canonical_cloud"]
    aff = torch.as_tensor(canonical["canonical_affordance"], device=dev)
    pts_cam = torch.as_tensor(pts_nocs @ nocs_pose[:3, :3].T + nocs_pose[:3, 3], device=dev)
    g = torch.as_tensor(grasps_cam, device=dev)
    pg = (pts_cam[None] - g[:, None, :3, 3]) @ g[:, :3, :3]  # (G, C, 3)
    m1, m2 = finger_contact_points(pg, torch.tensor(width, device=dev), spec,
                                   surface_tol=0.004)
    m = (m1 | m2).float()
    cnt = m.sum(dim=-1)
    mean = (m * aff).sum(dim=-1) / torch.clamp(cnt, min=1.0)
    return torch.where(cnt > 0, mean, 0.0).cpu().numpy().astype(np.float32)


@dataclass
class Scores:
    p_T_given_G: np.ndarray
    p_G: np.ndarray
    p_T_G: np.ndarray
    eng: np.ndarray  # engagement depth in [0, 1]
    ok: np.ndarray  # passes the thresholds and is viable
    order: list  # candidate indices in the order the pick gate tries them


def score_candidates(scene: EvalScene, cfg_run: dict, found: Found,
                     predicters: dict | None = None, timings: dict | None = None) -> Scores:
    """P(T|G) from the canonical codebook (1 without one), P(G) from the
    grasp net's expected quality when a grasp predicter is loaded (its
    ``grasp_net_s`` added to ``timings``), else from the analytic wrench
    quality, the thresholds on P(G), P(T|G) and P(T,G), and the order:
    threshold-passing viable candidates first, by P(T,G) to two decimals and
    then engagement depth, then the rest in the same order."""
    dev = scene.device
    grasps_cam = found.grasps_cam
    canonical = scene.canonical
    if canonical is not None and canonical["canonical_affordance"].any():
        p_T_given_G = grasp_affordance(canonical, found.nocs_pose, grasps_cam, width=0.012,
                                       spec=scene.gripper.spec, device=dev)
    else:
        p_T_given_G = np.ones(len(grasps_cam), np.float32)
    pts = torch.as_tensor(found.pts, device=dev)
    g = torch.as_tensor(grasps_cam, device=dev)
    if predicters and "grasp" in predicters:
        net = predicters["grasp"]
        p_G = net.expected_quality(net.predict_batch(found.pts, found.nrm, grasps_cam,
                                                     timings=timings)[2])
    else:
        q = parallel_jaw_quality(pts, torch.as_tensor(found.nrm, device=dev), g,
                                 scene.gripper.spec).cpu().numpy()
        p_G = np.clip(q / 0.3, 0.0, 1.0).astype(np.float32)
    p_T_G = p_T_given_G * p_G

    ok = ((p_G >= cfg_run.get("p_G_thres", 0.5))
          & (p_T_given_G >= cfg_run.get("p_T_given_G_thres", 0.5))
          & (p_T_G >= cfg_run.get("p_T_G_thres", 0.1)))
    if not ok.any():
        ok = p_T_G >= 0  # best-effort pick (keep clearing the bin)
    eng = engagement_depth(pts, g, scene.gripper.spec).cpu().numpy()
    # geometric viability outranks the scores: a grasp whose captured
    # surface sits < ~3.6 mm inside the fingertip plane closes on air
    viable = eng >= 0.08
    srt = np.lexsort((-eng, -np.round(p_T_G, 2), ~viable))
    ok = ok & viable
    order = [i for i in srt if ok[i]] + [i for i in srt if not ok[i]]
    return Scores(p_T_given_G=p_T_given_G, p_G=p_G, p_T_G=p_T_G, eng=eng, ok=ok, order=order)


# ---------------------------------------------------------------------------
# Pick: IK + descent + lift + RRT over the best candidates, then the arm
# ---------------------------------------------------------------------------


def obstacles_in_base(scene: EvalScene, xyz: np.ndarray, bg_m: np.ndarray,
                      rng: np.random.Generator) -> np.ndarray:
    """The planners' obstacle cloud in the robot base frame: up to 1,024
    visible non-target points (the wrist necessarily comes within capsule
    radius of the object it grasps) and the fixture's surface points."""
    obs_cam = xyz[bg_m]
    if len(obs_cam) > MAX_OBSTACLE_PTS:
        obs_cam = obs_cam[rng.choice(len(obs_cam), MAX_OBSTACLE_PTS, replace=False)]
    cib = scene.cam_in_base.cpu().numpy()
    obs_base = obs_cam @ cib[:3, :3].T + cib[:3, 3]
    return np.concatenate([obs_base, scene.fix_pts_base]).astype(np.float32)


def _lerp_poses(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.stack([a * (1 - s) + b * s for s in np.linspace(0, 1, 5)])


def plan_pick(scene: EvalScene, grasps_cam: np.ndarray, order: list, obs_base: np.ndarray,
              seed: int):
    """Iterate the candidates in ``order`` (the first 12) until one has IK
    at the pregrasp (10 cm back along the approach) and the grasp, a
    Cartesian descent and straight-up lift, and an RRT path from home to
    the pregrasp.  Returns (pick, (path, descent qs, lift qs), n_ik_fail,
    n_plan_fail); pick is None when no candidate passes."""
    dev = scene.device
    ee_in_grasp = scene.gripper.ee_in_grasp
    base_inv = np.linalg.inv(scene.base_in_world)
    rrt = planner.RRTConnect(obs_base, floor_z=-0.04, seed=seed, device=dev)
    tries = list(order[:PICK_TRIES])
    ee_pre, ee_goal = [], []
    for i in tries:
        g_base = (base_inv @ scene.cam @ grasps_cam[i]).astype(np.float32)
        # the pregrasp is 10 cm back along the approach; the grasp itself is
        # reached by the Cartesian descent
        pre = g_base.copy()
        pre[:3, 3] -= 0.10 * pre[:3, 0]
        ee_pre.append(pre @ ee_in_grasp)
        ee_goal.append(g_base @ ee_in_grasp)
    ee_pre, ee_goal = np.reshape(ee_pre, (-1, 4, 4)), np.reshape(ee_goal, (-1, 4, 4))
    # the IK of every tried pregrasp and grasp in one device call
    q_best, found_best = iiwa.ik_best(torch.as_tensor(np.concatenate([ee_pre, ee_goal]),
                                                      device=dev))
    q_best, found_best = q_best.cpu().numpy(), found_best.cpu().numpy()
    n = len(tries)
    n_ik_fail = n_plan_fail = 0
    for k, i in enumerate(tries):
        if not (found_best[k] and found_best[n + k]):
            n_ik_fail += 1
            continue
        q_pre = q_best[k]
        qs_d, ok_d = planner.plan_cartesian_waypoints(
            _lerp_poses(ee_pre[k], ee_goal[k]), q_seed=q_pre, device=dev)
        if not ok_d:
            n_ik_fail += 1
            continue
        ee_lift = ee_goal[k].copy()
        ee_lift[:3, 3] += [0.0, 0.0, LIFT_HEIGHT]
        qs_l, ok_l = planner.plan_cartesian_waypoints(
            _lerp_poses(ee_goal[k], ee_lift), q_seed=qs_d[-1], device=dev)
        if not ok_l:
            n_ik_fail += 1
            continue
        path = rrt.plan(Q_HOME, q_pre, max_iter=RRT_MAX_ITER)
        if path is not None:
            return i, (np.stack(path), qs_d, qs_l), n_ik_fail, n_plan_fail
        n_plan_fail += 1
    return None, None, n_ik_fail, n_plan_fail


def pick_schedule(pick_plan) -> np.ndarray:
    """The pick's joint schedule: RRT path and descent resampled to the
    approach, the grasp config held through close and hold, the lift."""
    path, qs_d, qs_l = pick_plan
    app = np.concatenate([simarm.resample_traj(path, N_APP - 30),
                          simarm.resample_traj(qs_d, 30)])
    return np.concatenate([
        app, np.repeat(app[-1][None], CLOSE_STEPS + LIFT_STEPS, axis=0),
        simarm.resample_traj(qs_l, N_LIFT_A)]).astype(np.float32)


# ---------------------------------------------------------------------------
# Place
# ---------------------------------------------------------------------------


def _trans(t) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = t
    return T


def plan_place(scene: EvalScene, ob_in_grasp: np.ndarray, q_cur: np.ndarray,
               obs_base: np.ndarray, seed: int, verbose: bool = False):
    """Plan the arm-executed place: over the category's symmetries, the
    first orientation whose pre-place and place tool poses have IK, whose
    Cartesian insertion descent has IK, and whose pre-place config an RRT
    reaches from ``q_cur``.  The fallback ladder tries up to 6 IK branches
    of the pre-place pose, and plans a branch the observed cloud blocks
    again with no obstacles and no floor.
    Returns (the place schedule (T, 7) or None, the gate's record: the
    index of the symmetry taken or None, and its ``fails`` counters)."""
    dev = scene.device
    pre_t, place_t = es.TASK_POSES[scene.class_name]
    base_inv = np.linalg.inv(scene.base_in_world)
    ee_in_grasp = scene.gripper.ee_in_grasp
    inv_oig = np.linalg.inv(np.asarray(ob_in_grasp))
    rrt = planner.RRTConnect(obs_base, floor_z=-0.04, seed=seed + 77, device=dev)
    rrt_free = planner.RRTConnect(np.float32([[10.0, 10.0, 10.0]]), floor_z=-10.0,
                                  seed=seed + 78, device=dev)
    fails = {"ik_pre": 0, "ik_place": 0, "descent": 0, "rrt": 0,
             "relax_start": 0, "relax_goal": 0, "relax_iter": 0}
    sym = np.asarray(scene.sym, np.float32)
    ee_pre, ee_place = [], []
    for S in sym:
        O_pre = scene.T_fix @ _trans(pre_t) @ S
        O_place = scene.T_fix @ _trans(place_t) @ S
        ee_pre.append((base_inv @ O_pre @ inv_oig @ ee_in_grasp).astype(np.float32))
        ee_place.append((base_inv @ O_place @ inv_oig @ ee_in_grasp).astype(np.float32))
    ee_pre, ee_place = np.stack(ee_pre), np.stack(ee_place)
    # the IK of every orientation in one device call each
    ee_pre_t = torch.as_tensor(ee_pre, device=dev)
    q_pre_all, ok_pre = (x.cpu().numpy() for x in iiwa.ik_best(ee_pre_t))
    ok_place = iiwa.ik_best(torch.as_tensor(ee_place, device=dev))[1].cpu().numpy()
    qs_all, val_all = (x.cpu().numpy() for x in iiwa.ik(ee_pre_t))
    plan = None
    for s in range(len(sym)):
        if not ok_pre[s]:
            fails["ik_pre"] += 1
            continue
        if not ok_place[s]:
            fails["ik_place"] += 1
            continue
        branches = [q_pre_all[s]]
        qs = qs_all[s][val_all[s]]
        near = np.argsort(np.linalg.norm(qs - np.asarray(q_cur)[None], axis=1))
        for q in qs[near[:8]]:
            if all(np.linalg.norm(q - b) > 1e-3 for b in branches):
                branches.append(q)
        branches = branches[:6]
        descent = _lerp_poses(ee_pre[s], ee_place[s])
        for q_pre_b in branches:
            qs_d, okd = planner.plan_cartesian_waypoints(descent, q_seed=q_pre_b, device=dev)
            if not okd:
                fails["descent"] += 1
                break  # a waypoint with no IK solution: branch-independent
            path = rrt.plan(np.asarray(q_cur), q_pre_b, max_iter=RRT_MAX_ITER)
            if path is None:
                path = rrt_free.plan(np.asarray(q_cur), q_pre_b, max_iter=RRT_MAX_ITER)
                if path is None:
                    sg = rrt_free._free(np.stack([np.asarray(q_cur), q_pre_b]))
                    key = "relax_start" if not sg[0] else (
                        "relax_goal" if not sg[1] else "relax_iter")
                    fails[key] += 1
            if path is None:
                fails["rrt"] += 1
                continue
            plan = (np.stack(path), qs_d)
            break
        if plan is not None:
            break
    if plan is None:
        if verbose:
            print("    place: no IK-feasible/plannable orientation among "
                  f"{len(sym)} symmetries (gate fails: {fails})")
        return None, {"sym": None, "fails": fails}
    path, qs_d = plan
    move = np.concatenate([simarm.resample_traj(path, N_MOVE_P - 40),
                           simarm.resample_traj(qs_d, 40)]).astype(np.float32)
    sched = np.concatenate([move, np.repeat(move[-1][None], N_DROP_P, axis=0)])
    return sched, {"sym": s, "fails": fails}


def dynamicized(sched: np.ndarray, device) -> np.ndarray:
    """The trajectory the articulated arm achieves tracking a planned
    schedule (T, 7), tracked on ``device``."""
    return simarm.dynamicize_schedule(torch.as_tensor(sched, device=device)).cpu().numpy()


def execute_place(scene: EvalScene, state: SceneState, params: SceneParams, target: int,
                  sched: np.ndarray, ob_in_grasp: torch.Tensor, width: torch.Tensor,
                  grip_center: torch.Tensor, verbose: bool = False,
                  arm_dynamics: bool = False):
    """Step the place schedule in the scene (with ``arm_dynamics``, the
    trajectory the articulated arm achieves tracking it) and check the drop
    against the category's success bands.  Returns (placed, state after the
    drop)."""
    dev = scene.device
    place_t = es.TASK_POSES[scene.class_name][1]
    ee_in_grasp = torch.as_tensor(scene.gripper.ee_in_grasp, device=dev)
    base = torch.as_tensor(scene.base_in_world, device=dev)
    run = dynamicized(sched, dev) if arm_dynamics else sched
    final, ob_pose_final, place_traj = simarm.execute_place_arm(
        scene.lib, state, params, scene.env_bin, target, torch.as_tensor(run, device=dev),
        base, ee_in_grasp, ob_in_grasp, width, scene.gripper.spec, n_move=N_MOVE_P,
        n_drop=N_DROP_P, narrowphase=scene.geometry, center=grip_center)
    T_fix_inv = torch.as_tensor(np.linalg.inv(scene.T_fix), device=dev)
    ob_in_fix = T_fix_inv @ ob_pose_final
    placed = bool(es.place_success(scene.class_name, ob_in_fix,
                                   torch.as_tensor(place_t, dtype=torch.float32, device=dev)))
    if verbose and not placed:
        oif = ob_in_fix.cpu().numpy()
        G_rel = simarm.grasp_pose_of(torch.as_tensor(sched[N_MOVE_P - 1], device=dev), base,
                                     ee_in_grasp).cpu().numpy()
        rel_pose = np.linalg.inv(scene.T_fix) @ G_rel @ ob_in_grasp.cpu().numpy()
        print(f"    place: dropped at fixture-frame t={oif[:3, 3].round(4)}"
              f" z-axis={oif[:3, 2].round(3)} (want xy<=6mm of "
              f"{place_t[:2]}, z<={es._SUCCESS_Z_MAX[scene.class_name]}, upright)\n"
              f"           fixture body at {final.pos[-1].cpu().numpy().round(4)}, release "
              f"pose t={rel_pose[:3, 3].round(4)} z-axis={rel_pose[:3, 2].round(3)}")
        tp = place_traj[0].cpu().numpy()[N_MOVE_P::10] - scene.T_fix[:3, 3]
        print("           drop xy-dev:",
              np.linalg.norm(tp[:, :2] - place_t[None, :2], axis=1).round(4),
              "z:", tp[:, 2].round(3))
    return placed, final


# ---------------------------------------------------------------------------
# The floating-gripper baseline: pick in the pile, place in the fixture world
# ---------------------------------------------------------------------------


def execute_pick(lib: ShapeLib, state: SceneState, params: SceneParams,
                 env_bin: engine.StaticEnv, target: int, grasp_in_world: torch.Tensor,
                 spec: GripperSpec = GripperSpec(), narrowphase: str = "csg"):
    """A floating gripper at ``grasp_in_world`` closes on the target in the
    pile for ``CLOSE_STEPS`` steps, then holds still under gravity for
    ``LIFT_STEPS``; the hold test asks for a displacement below 2 cm from the
    end of the close, a width above 1 mm (closed on something) and the
    object still between the fingers, measured from the finger midline the
    close settled at.  Transport is an attachment, so the caller removes the
    object from the pile.  Returns (picked, final state, the target's pose
    in the grasp frame, the final width) as tensors; no step waits for the
    device."""
    dt = engine.DT
    dev = grasp_in_world.device
    G_inv = tf.pose_inverse(grasp_in_world)
    local = simarm._target_points_local(lib, params, target)
    st = state
    w = torch.full((), spec.max_width, device=dev)
    c = torch.zeros((), device=dev)
    tch = closing_touched_init(dev)
    pos_close = st.pos[target]
    for i in range(CLOSE_STEPS + LIFT_STEPS):
        closing = i < CLOSE_STEPS
        R = tf.quat_to_matrix(st.quat[target])
        pts_g = tf.transform_points(G_inv, st.pos[target] + local @ R.T)
        w, c, tch, v_p, v_n = closing_step(pts_g, w, c, tch, closing, spec, dt)
        genv = gripper_env(grasp_in_world, w, c, v_p, v_n, spec,
                           grip=False if closing else tch[0] & tch[1])
        st = engine.step(st, params, lib, simarm.merge_envs(env_bin, genv), dt=dt,
                         gravity=-9.8, narrowphase=narrowphase)
        if i == CLOSE_STEPS - 1:
            pos_close = st.pos[target].clone()
    disp = tf.norm(st.pos[target] - pos_close)
    ob_in_grasp = G_inv @ tf.pose_from_qt(st.quat[target], st.pos[target])
    ref = torch.stack([torch.full((), 0.02, device=dev), c, torch.zeros((), device=dev)])
    bound = constant((0.06, 0.05, 0.05), torch.float32, dev)
    centered = torch.all(torch.abs(ob_in_grasp[:3, 3] - ref) < bound)
    picked = (disp < 0.02) & (w > 1e-3) & centered
    return picked, st, ob_in_grasp, w


def place_floating(scene: EvalScene, state: SceneState, params: SceneParams, target: int,
                   ob_in_grasp: torch.Tensor, width: torch.Tensor,
                   grasp_world: torch.Tensor) -> torch.Tensor:
    """The floating baseline's place: ``place_and_drop`` with the actual
    in-hand pose (pick slip included) and the commanded one, the commanded
    grasp in the target's pre-pick frame."""
    cmd = tf.pose_inverse(tf.pose_from_qt(state.quat[target], state.pos[target])) @ grasp_world
    return es.place_and_drop(scene.lib, params.shape_id[target], scene.fixture_idx,
                             params.scale[target], tf.pose_inverse(ob_in_grasp),
                             scene.class_name, width, scene.gripper.spec,
                             narrowphase=scene.geometry, grasp_in_ob_cmd=cmd)


# ---------------------------------------------------------------------------
# Main loop
# ---------------------------------------------------------------------------


@dataclass
class EvalCounters:
    num_objects: int = 0
    num_attempts: int = 0
    num_stable_grasp: int = 0
    num_task_grasp_succ: int = 0


def _check_mode(oracle, predicters):
    if not oracle and "nocs" not in (predicters or {}):
        raise ValueError("learned perception (oracle off) needs the NUNOCS predicter: pass "
                         "predicters from predict.artifacts.load_predicters")


def rebind_target_to_channel(xyz: np.ndarray, seg_body: np.ndarray, grasp_cam: np.ndarray,
                             target: int, active: np.ndarray, spec: GripperSpec,
                             n_objects: int) -> int:
    """The active body with the most observed points inside this grasp's
    closing channel (ground-truth seg, for the simulator's bookkeeping
    only), or ``target`` when the channel holds none: a merged learned
    segment can put the chosen grasp on another body than the segment's
    majority, and the closing law tracks one body."""
    vis = seg_body >= 0
    p_g = (xyz[vis] - grasp_cam[:3, 3]) @ grasp_cam[:3, :3]
    in_chan = closing_channel_mask(p_g, spec)
    if not in_chan.any():
        return target
    cnt = np.bincount(seg_body[vis][in_chan].astype(np.int64), minlength=n_objects)[:n_objects]
    cnt[~active] = 0
    return int(cnt.argmax()) if cnt.any() else target


def simulate_grasp_rounds(class_name: str = "nut", n_rounds: int = 2,
                          n_objects: int = 5, cfg_run: dict | None = None,
                          oracle: bool = True, canonical: dict | None = None,
                          predicters: dict | None = None, seed: int = 0,
                          max_attempts_per_round: int = 8,
                          render_hw=(384, 512), verbose: bool = True,
                          metrics_path: str | None = None, use_arm: bool = True,
                          arm_exec: bool = True, instance: int | None = None,
                          obj_path: str | None = None, arm_dynamics: bool = False,
                          device=None, timings: dict | None = None) -> EvalCounters:
    """The closed-loop eval: ``n_rounds`` piles of ``n_objects``, up to
    ``max_attempts_per_round`` pick-and-place attempts each.  Returns the
    tallies.  ``predicters`` (``predict.artifacts.load_predicters``) give
    learned perception with ``oracle`` off: the seg net's segments (when
    loaded) and the NUNOCS net's pose; a grasp predicter gives P(G) in
    either mode.  With a ``timings`` dict, the wall seconds of each stage
    are summed into it (the device synchronised at each stage end;
    ``scoring_s`` includes ``grasp_net_s``)."""
    _check_mode(oracle, predicters)
    dev = resolve_device(device)
    mlog = MetricsLogger(metrics_path, run="eval", class_name=class_name,
                         seed=seed, oracle=oracle)
    cfg_run = cfg_run or load_config("config_run.yml")
    stages = StageClock(timings, dev)
    scene = setup_scene(class_name, n_objects, cfg_run, render_hw, instance,
                        canonical=canonical, device=dev, obj_path=obj_path)
    stages.lap("setup_s")
    if canonical is None or not canonical["canonical_affordance"].any():
        print("WARNING: canonical has no affordance codebook — P(T|G) fixed at 1.0; "
              "grasp selection is TASK-BLIND")
    n = n_objects
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    spec = scene.gripper.spec
    ee_in_grasp = torch.as_tensor(scene.gripper.ee_in_grasp, device=dev)
    base = torch.as_tensor(scene.base_in_world, device=dev)
    counters = EvalCounters()
    learned_seg = not oracle and "seg" in (predicters or {})

    for rnd in range(n_rounds):
        pile_t = {} if timings is not None else None
        state, params = make_round_pile(scene, rng, gen, SETTLE_STEPS, timings=pile_t)
        stages.add(pile_t)
        counters.num_objects += int(state.active[:n].sum())

        for attempt in range(max_attempts_per_round):
            if not bool(state.active[:n].any()):
                break
            front_t = {} if timings is not None else None
            front = attempt_front(scene, state, params, rng, gen, oracle, predicters,
                                  timings=front_t)
            stages.add(front_t)
            for t in front.tried:
                mlog.event("filter", round=rnd, attempt=attempt, seg=t["seg"],
                           n_valid=t["cone"]["n_valid"], **t["cone"]["stats"])
            if verbose:
                for bw_scale, n_seg in front.bandwidth_misses:
                    print(f"round {rnd} attempt {attempt}: no candidates at bandwidth "
                          f"x{bw_scale} ({n_seg} segments)")
            if front.found is None:
                if verbose:
                    print(f"round {rnd} attempt {attempt}: no grasp candidates on any segment"
                          + (" at any bandwidth" if front.bandwidth_misses else ""))
                break
            f = front.found
            target = f.target
            if len(f.grasps_cam) > MAX_CANDIDATES:
                sel = rng.choice(len(f.grasps_cam), MAX_CANDIDATES, replace=False)
                f.grasps_cam, f.prov = f.grasps_cam[sel], f.prov[sel]

            net_t = {} if timings is not None else None
            sc = score_candidates(scene, cfg_run, f, predicters, timings=net_t)
            stages.lap("scoring_s")
            stages.add(net_t)

            pick_plan = None
            if use_arm:
                obs_base = obstacles_in_base(scene, front.xyz, f.bg_m, rng)
                pick, pick_plan, n_ik_fail, n_plan_fail = plan_pick(
                    scene, f.grasps_cam, sc.order, obs_base, seed)
                stages.lap("pick_planning_s")
                if pick is None:
                    mlog.event("plan_fail", round=rnd, attempt=attempt,
                               n_candidates=len(sc.order), n_ik_fail=n_ik_fail,
                               n_plan_fail=n_plan_fail)
                    if verbose:
                        print(f"round {rnd} attempt {attempt}: no reachable/plannable grasp "
                              f"among {min(len(sc.order), PICK_TRIES)} (ik/descent fails "
                              f"{n_ik_fail}, rrt fails {n_plan_fail})")
                    break
            else:
                pick = sc.order[0]
            if learned_seg:
                new_t = rebind_target_to_channel(front.xyz, front.seg_body, f.grasps_cam[pick],
                                                 target, front.active, spec, n)
                if new_t != target and verbose:
                    print(f"    target rebind {target} -> {new_t} (grasp channel majority)")
                target = new_t

            counters.num_attempts += 1
            arm = use_arm and arm_exec
            if arm:
                # --- execute the pick through the arm ---
                sched = pick_schedule(pick_plan)
                if arm_dynamics:
                    # the colliders follow the articulated arm's achieved
                    # trajectory, not the planned one
                    sched = dynamicized(sched, dev)
                picked, state_after, ob_in_grasp, w_f, c_f, disturb = simarm.execute_pick_arm(
                    scene.lib, state, params, scene.env_bin, target,
                    torch.as_tensor(sched, device=dev), base, ee_in_grasp, spec,
                    n_app=N_APP, n_close=CLOSE_STEPS, n_hold=LIFT_STEPS,
                    narrowphase=scene.geometry)
                disturb = float(disturb)
            else:
                # --- the floating gripper closes on it in the pile ---
                grasp_world = torch.as_tensor(
                    (scene.cam @ f.grasps_cam[pick]).astype(np.float32), device=dev)
                picked, state_after, ob_in_grasp, w_f = execute_pick(
                    scene.lib, state, params, scene.env_bin, target, grasp_world, spec,
                    scene.geometry)
                disturb = 0.0
            picked = bool(picked)
            stages.lap("pick_execution_s")
            placed = False
            if picked:
                counters.num_stable_grasp += 1
                if arm:
                    place_sched, _ = plan_place(scene, ob_in_grasp.cpu().numpy(), sched[-1],
                                                obs_base, seed, verbose)
                    stages.lap("place_planning_s")
                    if place_sched is not None:
                        placed, state_after = execute_place(
                            scene, state_after, params, target, place_sched, ob_in_grasp, w_f,
                            c_f, verbose, arm_dynamics)
                        stages.lap("place_execution_s")
                else:
                    placed = bool(place_floating(scene, state, params, target, ob_in_grasp, w_f,
                                                 grasp_world))
                    stages.lap("place_execution_s")
                slip = float(torch.linalg.vector_norm(
                    ob_in_grasp[:3, 3] - torch.tensor([0.02, 0.0, 0.0], device=dev)))
                mlog.event("place", round=rnd, attempt=attempt, placed=placed, slip=slip)
                if placed:
                    counters.num_task_grasp_succ += 1
            # remove the attempted object from the pile (placed or scattered)
            active = state_after.active.clone()
            active[target] = not picked
            state = settle_keep_fixture(scene, state_after.replace(active=active), params,
                                        RESETTLE_STEPS)
            stages.lap("resettle_s")
            mlog.event("attempt", round=rnd, attempt=attempt, target=target,
                       n_candidates=len(f.grasps_cam), picked=picked, placed=placed,
                       disturbance=disturb, p_G=float(sc.p_G[pick]),
                       p_T_given_G=float(sc.p_T_given_G[pick]), p_T_G=float(sc.p_T_G[pick]))
            if verbose:
                print(f"round {rnd} attempt {attempt}: target {target} "
                      f"picked={picked} placed={placed if picked else '-'} "
                      f"p_T_G={sc.p_T_G[pick]:.2f}")
                if not picked:
                    t = ob_in_grasp[:3, 3].cpu().numpy()
                    print(f"    pick diag: width {float(w_f) * 1e3:.1f} mm, ob_in_grasp t "
                          f"[{t[0] * 1e3:.1f} {t[1] * 1e3:.1f} {t[2] * 1e3:.1f}] mm, "
                          f"disturb {disturb * 1e3:.1f} mm")

    mlog.event("tally", **counters.__dict__)
    mlog.close()
    return counters


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--class_name", default=None)
    ap.add_argument("--n_rounds", type=int, default=2)
    ap.add_argument("--n_objects", type=int, default=5)
    ap.add_argument("--canonical", default=None)
    ap.add_argument("--artifacts", default=None,
                    help="artifact dir with nunocs/grasp/seg checkpoints (enables learned "
                         "perception; use with --oracle 0)")
    ap.add_argument("--oracle", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics", default=None, help="JSONL metrics path")
    ap.add_argument("--use_arm", type=int, default=1,
                    help="gate grasps on IK reachability + RRT plannability")
    ap.add_argument("--arm_exec", type=int, default=1,
                    help="step the planned arm motion in the scene (pick AND place); 0 = "
                         "floating-gripper baseline")
    ap.add_argument("--instance", type=int, default=None,
                    help="pin the pile to one test instance at scale 1 (default from "
                         "config_run.yml instance_index; -1 = mixed instances at jittered "
                         "scales)")
    ap.add_argument("--arm_dynamics", type=int, default=0)
    ap.add_argument("--obj_path", default=None,
                    help="external watertight .obj to evaluate instead of the procedural "
                         "instances (baked-SDF physics and grid raymarch)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs on the host)")
    args = ap.parse_args(argv)

    cfg_run = load_config("config_run.yml")
    class_name = args.class_name or cfg_run.get("class_name", "nut")
    canonical = dict(np.load(args.canonical)) if args.canonical else None
    predicters = None
    if args.artifacts:
        predicters = load_predicters(args.artifacts, class_name, device=args.device)
        print(f"loaded predicters: {sorted(predicters)}")
    t0 = time.perf_counter()
    c = simulate_grasp_rounds(class_name, args.n_rounds, args.n_objects, cfg_run,
                              oracle=bool(args.oracle), canonical=canonical,
                              predicters=predicters, seed=args.seed,
                              metrics_path=args.metrics,
                              use_arm=bool(args.use_arm), arm_exec=bool(args.arm_exec),
                              instance=args.instance, obj_path=args.obj_path,
                              arm_dynamics=bool(args.arm_dynamics), device=args.device)
    print(f"num_objects={c.num_objects} num_attempts={c.num_attempts} "
          f"num_stable_grasp={c.num_stable_grasp} "
          f"num_task_grasp_succ={c.num_task_grasp_succ}")
    print(f"wall_s={time.perf_counter() - t0:.1f}")
    return c


if __name__ == "__main__":
    main()
