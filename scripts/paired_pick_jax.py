"""Paired pick records, JAX half: the eval's arm-executed pick on scenes that
the PyTorch port replays step for step (``scripts/paired_pick_protocol.py``).

For each seed: the eval's first-round pile (``jax.random.PRNGKey(seed)``
split as ``simulate_grasp_rounds`` splits it, 500 settle steps), rendered
at the eval's 384x512; then on the largest segments, in order of pixel
count, the oracle front half of ``tests/test_torch_eval_loop.py`` (the
NOCS-transfer candidates of the class's canonical, P(T|G), P(G), the
engagement order) and the pick gate (IK + RRT over the first 12), until
``--picks`` segments have a plan.  Each plan becomes the eval's
320-waypoint schedule (``run_grasp_simulation.py:763-779``: 140 approach,
50 close, 80 hold, 50 lift) and runs through JAX's ``execute_pick_arm``
three times, each from the scene as restored from its record:

- ``kin``: the kinematic schedule;
- ``dyn``: ``dynamicize_schedule`` of it (``--arm_dynamics 1``);
- ``nudge``: ``dyn`` with every body's position moved 1e-6 m in a seeded
  direction (the chaos floor: how soon JAX parts from itself).

One ``.npz`` an attempt lands in ``--out``: the scene as
``sim/snapshot.py:save_scene_npz`` writes it, the params the eval sets on
the fixture, the target and both schedules, and for each run ``picked``,
``w_f``, ``c_f``, ``ob_in_grasp``, ``disturb`` and the target's position
after every step.  With ``--obj_path`` the pile is that mesh's baked grids
(4 objects, the grid narrowphase, as the eval's ``--obj_path``).

    JAX_PLATFORMS=cpu python scripts/paired_pick_jax.py --class_name nut --seeds 0-23
    JAX_PLATFORMS=cpu python scripts/paired_pick_jax.py --class_name screw \\
        --obj_path assets/screw_demo.obj --n_objects 4 --seeds 0-1

A seed takes minutes on a CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from catgrasp_tpu.config.loader import load_config
from catgrasp_tpu.core import transforms as tf
from catgrasp_tpu.core.symmetry import get_symmetry_tfs
from catgrasp_tpu.geom import csg as csglib
from catgrasp_tpu.geom import primitives as prim
from catgrasp_tpu.grasp import filter as gfilter
from catgrasp_tpu.grasp import quality
from catgrasp_tpu.grasp.gripper import Gripper
from catgrasp_tpu.grasp.sampler import NocsTransferGraspSampler
from catgrasp_tpu.kin import iiwa, planner
from catgrasp_tpu.pipelines import run_grasp_simulation as rgs
from catgrasp_tpu.pipelines.make_canonical import to_nunocs_transform
from catgrasp_tpu.render import raymarch
from catgrasp_tpu.sim import arm as simarm
from catgrasp_tpu.sim import engine, env_pile
from catgrasp_tpu.sim import snapshot
from catgrasp_tpu.sim.types import SceneParams, SceneState, build_shape_lib

NUDGE_M = 1e-6
RUNS = ("kin", "dyn", "nudge")


def build_scene(class_name, n_objects, obj_path=None, render_hw=(384, 512), codebook=None):
    """The eval's set-up (``simulate_grasp_rounds`` lines 343-441); the
    NOCS-transfer sampler starts from the canonical's ``codebook`` best
    grasps (the eval's config value without one)."""
    cfg = load_config("config_run.yml")
    split = cfg.get("instance_split", "test")
    if obj_path:
        from catgrasp_tpu.geom.mesh import TriMesh
        m = TriMesh.load_obj(obj_path)
        b = m.bounds
        n_inst, instance = 1, 0
        meshes = [m, prim.place_fixture(class_name, None)]
        csgs = [csglib.csg_box(b[1] - b[0], center=(b[1] + b[0]) / 2),
                csglib.csg_place_fixture(class_name, None)]
        lib = build_shape_lib(meshes, csgs, n_surf=256, bake_grids=True, dims=56)
        geom = "grid"
    else:
        n_inst = prim.num_instances(class_name, split)
        instance = int(cfg.get("instance_index", 0))
        fix_params = prim.instance_params(class_name, split, instance)
        meshes = [prim.make_instance(class_name, split, i) for i in range(n_inst)]
        csgs = [csglib.make_csg_instance(class_name, split, i) for i in range(n_inst)]
        meshes.append(prim.place_fixture(class_name, fix_params))
        csgs.append(csglib.csg_place_fixture(class_name, fix_params))
        lib = build_shape_lib(meshes, csgs, n_surf=256)
        geom = "csg"
    pile_cfg = env_pile.PileConfig(max_bodies=n_objects, scale_range=(0.9, 1.1))
    env_bin = simarm.merge_envs(engine.StaticEnv.open_bin(pile_cfg.bin_inner),
                                engine.StaticEnv.boxes(
                                    jnp.array([[rgs.FIXTURE_POS[0], rgs.FIXTURE_POS[1], -0.006]]),
                                    jnp.array([[0.15, 0.15, 0.005]])))
    H, W = render_hw
    fx = 2257.75 * (W / 2064.0)
    cam = np.eye(4, dtype=np.float32)
    cam[:3, :3] = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32)
    cam[:3, 3] = [0, 0, 0.7]
    base_in_world = np.eye(4, dtype=np.float32)
    base_in_world[:3, 3] = [-0.559, -0.367, 0.052]
    fixture_idx = len(meshes) - 1
    canonical = dict(np.load(f"dataset/{class_name}_canonical.npz"))
    gripper = Gripper.default()
    return dict(
        class_name=class_name, n_objects=n_objects, n_inst=n_inst, instance=instance,
        meshes=meshes, lib=lib, geom=geom, pile_cfg=pile_cfg, env_bin=env_bin, H=H, W=W,
        K=np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1.0]], np.float32), cam=cam,
        base_in_world=base_in_world, cam_in_base=np.linalg.inv(base_in_world) @ cam,
        fixture_idx=fixture_idx, canonical=canonical, gripper=gripper,
        sym=get_symmetry_tfs(class_name),
        nocs=NocsTransferGraspSampler(
            gripper, canonical["canonical_grasps"], canonical["canonical_grasp_scores"],
            score_larger_than=float(cfg.get("nocs_grasp_sampler_score_larger_than", 0.95)),
            max_n_grasp=codebook or int(cfg.get("nocs_grasp_sampler_max_n_grasp", 10000))),
        fix_pts_base=((np.asarray(lib.surf_pts)[fixture_idx] + rgs.FIXTURE_POS
                       - base_in_world[:3, 3]) @ base_in_world[:3, :3]))


def eval_params(sc):
    """The eval's params: the pile's instance at scale 1, the fixture a
    huge-mass body with friction 0.1 (lines 465-476)."""
    n = sc["n_objects"]
    shape_id = jnp.asarray(np.concatenate([np.full(n, sc["instance"] % sc["n_inst"]),
                                           [sc["fixture_idx"]]]), jnp.int32)
    params = SceneParams.create(sc["lib"], shape_id, jnp.ones(n + 1, jnp.float32))
    return params.replace(mass=params.mass.at[n].set(1e9),
                          inertia=params.inertia.at[n].set(1e9),
                          friction=params.friction.at[n].set(0.1))


def make_pile(sc, seed):
    """The first round's pile of ``simulate_grasp_rounds`` at ``seed``."""
    n = sc["n_objects"]
    _, k1 = jax.random.split(jax.random.PRNGKey(seed))
    params = eval_params(sc)
    state_p, _ = env_pile.reset(k1, sc["lib"], sc["pile_cfg"], n_objects=jnp.int32(n))
    state = SceneState(
        pos=jnp.concatenate([state_p.pos, jnp.asarray(rgs.FIXTURE_POS)[None]]),
        quat=jnp.concatenate([state_p.quat, jnp.array([[1.0, 0, 0, 0]])]),
        linvel=jnp.concatenate([state_p.linvel, jnp.zeros((1, 3))]),
        angvel=jnp.concatenate([state_p.angvel, jnp.zeros((1, 3))]),
        active=jnp.ones(n + 1, bool))
    state = env_pile.settle_fixed(state, params, sc["lib"], sc["env_bin"], sc["pile_cfg"],
                                  500, narrowphase=sc["geom"])
    return state.replace(active=state.active.at[n].set(True)), params


def candidates(sc, state, params, out, target, rng):
    """The oracle segment body of ``_jax_candidates``
    (``tests/test_torch_eval_loop.py``) on segment ``target``."""
    seg, xyz, normal = out["seg"], out["xyz"], out["normal"]
    m = seg == target
    pts, nrm = xyz[m], normal[m]
    bg_m = ~m & (seg != -1)
    bg = xyz[bg_m]
    ob_in_cam = np.linalg.inv(sc["cam"]) @ np.asarray(
        tf.pose_from_qt(state.quat[target], state.pos[target]))
    T_nocs = to_nunocs_transform(sc["meshes"][int(params.shape_id[target])].vertices
                                 * float(params.scale[target]))
    nocs_pose = (ob_in_cam @ np.linalg.inv(T_nocs)).astype(np.float32)
    n_sub = min(len(pts), 512)
    ids = rng.choice(len(pts), n_sub, replace=False)
    poses, valid, _ = sc["nocs"].sample_grasps(
        jnp.asarray(nocs_pose), jnp.asarray(sc["sym"]), bg, np.ones(len(bg), bool),
        pts[ids], np.ones(n_sub, bool), cam_in_world=jnp.asarray(sc["cam_in_base"]),
        filter_ik=True, chunk=128, adjust_depth=True, backend="xla")
    return m, pts, nrm, bg_m, nocs_pose, np.asarray(poses)[np.asarray(valid)]


def scores(sc, nocs_pose, pts, nrm, grasps_cam):
    """``_jax_scores``: P(T|G), P(G), the thresholds and the order."""
    spec = sc["gripper"].spec
    p_T_given_G = rgs.grasp_affordance(sc["canonical"], nocs_pose, grasps_cam, width=0.012,
                                       spec=spec)
    q = np.asarray(quality.parallel_jaw_quality(jnp.asarray(pts), jnp.asarray(nrm),
                                                jnp.asarray(grasps_cam), spec))
    p_G = np.clip(q / 0.3, 0.0, 1.0).astype(np.float32)
    p_T_G = p_T_given_G * p_G
    ok = (p_G >= 0.5) & (p_T_given_G >= 0.5) & (p_T_G >= 0.1)
    if not ok.any():
        ok = p_T_G >= 0
    eng = np.asarray(gfilter.engagement_depth(jnp.asarray(pts), jnp.asarray(grasps_cam), spec))
    viable = eng >= 0.08
    srt = np.lexsort((-eng, -np.round(p_T_G, 2), ~viable))
    ok = ok & viable
    return [i for i in srt if ok[i]] + [i for i in srt if not ok[i]]


def plan(sc, grasps_cam, order, obs_base, seed):
    """``_jax_plan``: the pick gate over the first 12 candidates."""
    g = sc["gripper"]
    base_in_world = sc["base_in_world"]
    rrt = planner.RRTConnect(obs_base.astype(np.float32), floor_z=-0.04, seed=seed)
    for i in order[:12]:
        g_base = (np.linalg.inv(base_in_world) @ sc["cam"] @ grasps_cam[i]).astype(np.float32)
        pre = g_base.copy()
        pre[:3, 3] -= 0.10 * pre[:3, 0]
        ee_pre = pre @ np.asarray(g.ee_in_grasp)
        ee_goal = g_base @ np.asarray(g.ee_in_grasp)
        q_pre, found_pre = iiwa.ik_best(jnp.asarray(ee_pre))
        _, found_g = iiwa.ik_best(jnp.asarray(ee_goal))
        if not (bool(found_pre) and bool(found_g)):
            continue
        descent = np.stack([ee_pre * (1 - a) + ee_goal * a for a in np.linspace(0, 1, 5)])
        qs_d, ok_d = planner.plan_cartesian_waypoints(descent, q_seed=np.asarray(q_pre))
        if not ok_d:
            continue
        ee_lift = ee_goal.copy()
        ee_lift[:3, 3] += [0.0, 0.0, rgs.LIFT_HEIGHT]
        lift = np.stack([ee_goal * (1 - a) + ee_lift * a for a in np.linspace(0, 1, 5)])
        qs_l, ok_l = planner.plan_cartesian_waypoints(lift, q_seed=qs_d[-1])
        if not ok_l:
            continue
        path = rrt.plan(rgs.Q_HOME, np.asarray(q_pre), max_iter=500)
        if path is not None:
            return i, (np.stack(path), qs_d, qs_l)
    return None, None


def pick_schedule(pick_plan):
    """The eval's 320-waypoint kinematic pick schedule (lines 763-776)."""
    path, qs_d, qs_l = pick_plan
    app = np.concatenate([simarm.resample_traj(path, rgs.N_APP - 30),
                          simarm.resample_traj(qs_d, 30)])
    return np.concatenate([
        app, np.repeat(app[-1][None], rgs.CLOSE_STEPS + rgs.LIFT_STEPS, axis=0),
        simarm.resample_traj(qs_l, rgs.N_LIFT_A)]).astype(np.float32)


_STEP_FN = "execute_pick_arm.<locals>.step_fn"


def _pick_traced(lib, state, params, env_bin, target, qs, base_in_world, ee_in_grasp,
                 spec, narrowphase):
    """JAX's ``execute_pick_arm`` as it is, plus the per-step target
    positions its scan already stacks (and the function drops): the scan
    is watched while the function is traced."""
    seen = []
    scan = jax.lax.scan

    def watch(f, init, xs=None, *a, **k):
        out = scan(f, init, xs, *a, **k)
        if getattr(f, "__qualname__", "") == _STEP_FN:
            seen.append(out[1])
        return out

    jax.lax.scan = watch
    try:
        res = simarm.execute_pick_arm.__wrapped__(
            lib, state, params, env_bin, target, qs, base_in_world, ee_in_grasp, spec,
            n_app=rgs.N_APP, n_close=rgs.CLOSE_STEPS, n_hold=rgs.LIFT_STEPS,
            narrowphase=narrowphase)
    finally:
        jax.lax.scan = scan
    assert len(seen) == 1
    return res, seen[0]


pick_traced = jax.jit(_pick_traced, static_argnames=("spec", "narrowphase"))


def restore(sc, record):
    """The scene of a record, through ``sim/snapshot.py:scene_from_record``,
    with the eval's fixture params."""
    state, _ = snapshot.scene_from_record(record, sc["lib"])
    return state, eval_params(sc)


def run_pick(sc, state, params, target, sched):
    g = sc["gripper"]
    (picked, _, oig, w_f, c_f, disturb), traj = pick_traced(
        sc["lib"], state, params, sc["env_bin"], jnp.int32(target), jnp.asarray(sched),
        jnp.asarray(sc["base_in_world"]), jnp.asarray(g.ee_in_grasp), g.spec, sc["geom"])
    return dict(picked=np.bool_(picked), w_f=np.float32(w_f), c_f=np.float32(c_f),
                ob_in_grasp=np.asarray(oig, np.float32), disturb=np.float32(disturb),
                traj=np.asarray(traj, np.float32))


def scene_attempts(sc, seed, n_picks, out_dir, tag, log):
    t0 = time.perf_counter()
    state, params = make_pile(sc, seed)
    out = {k: np.asarray(v) for k, v in raymarch.render(
        sc["lib"], state, params, jnp.asarray(sc["K"]), jnp.asarray(sc["cam"]), sc["H"],
        sc["W"], env=sc["env_bin"], geometry=sc["geom"]).items()}
    n = sc["n_objects"]
    active = np.asarray(state.active)[:n]
    seg = out["seg"]
    min_px = max(20, (sc["H"] * sc["W"]) // 2500)
    seg_ids = sorted((i for i in range(n) if active[i]), key=lambda i: -(seg == i).sum())
    rng = np.random.default_rng(seed)
    done = 0
    for rank, target in enumerate(seg_ids):
        if done == n_picks or (seg == target).sum() < min_px:
            break
        m, pts, nrm, bg_m, nocs_pose, grasps_cam = candidates(sc, state, params, out, target,
                                                              rng)
        if len(grasps_cam) == 0:
            continue
        if len(grasps_cam) > 128:
            grasps_cam = grasps_cam[rng.choice(len(grasps_cam), 128, replace=False)]
        order = scores(sc, nocs_pose, pts, nrm, grasps_cam)
        obs_cam = out["xyz"][bg_m]
        if len(obs_cam) > 1024:
            obs_cam = obs_cam[rng.choice(len(obs_cam), 1024, replace=False)]
        cib = sc["cam_in_base"]
        obs = np.concatenate([obs_cam @ cib[:3, :3].T + cib[:3, 3], sc["fix_pts_base"]])
        pick, pick_plan = plan(sc, grasps_cam, order, obs, seed)
        if pick is None:
            continue
        sched_kin = pick_schedule(pick_plan)
        sched_dyn = simarm.dynamicize_schedule(sched_kin)
        path = os.path.join(out_dir, f"{tag}_seed{seed:02d}_seg{rank}.npz")
        snapshot.save_scene_npz(path, state, params)
        record = dict(np.load(path))
        st0, prm = restore(sc, record)
        nudge = np.random.default_rng(10_000 + 100 * seed + rank).normal(size=(n + 1, 3))
        nudge = (NUDGE_M * nudge / np.linalg.norm(nudge, axis=1, keepdims=True)).astype(
            np.float32)
        starts = {"kin": (st0, sched_kin), "dyn": (st0, sched_dyn),
                  "nudge": (st0.replace(pos=st0.pos + jnp.asarray(nudge)), sched_dyn)}
        res = {r: run_pick(sc, s, prm, target, q) for r, (s, q) in starts.items()}
        extra = dict(class_name=sc["class_name"], seed=seed, seg_rank=rank, target=target,
                     geometry=sc["geom"], obj_path=sc.get("obj_path") or "",
                     n_objects=n, n_codebook=sc["nocs"].max_n_grasp, mass=np.asarray(prm.mass), inertia=np.asarray(prm.inertia),
                     friction=np.asarray(prm.friction), quat0=np.asarray(st0.quat),
                     pos0=np.asarray(st0.pos), sched_kin=sched_kin, sched_dyn=sched_dyn,
                     nudge=nudge, n_app=rgs.N_APP, n_close=rgs.CLOSE_STEPS,
                     n_hold=rgs.LIFT_STEPS)
        for r, d in res.items():
            extra.update({f"{r}_{k}": v for k, v in d.items()})
        snapshot.save_scene_npz(path, state, params, **extra)
        done += 1
        row = dict(record=os.path.basename(path), seed=seed, seg_rank=rank, target=int(target),
                   **{f"{r}_picked": bool(res[r]["picked"]) for r in RUNS},
                   **{f"{r}_w_f": float(res[r]["w_f"]) for r in RUNS},
                   wall_s=round(time.perf_counter() - t0, 1))
        print(json.dumps(row), flush=True)
        log.write(json.dumps(row) + "\n")
        log.flush()


def parse_seeds(s):
    out = []
    for part in s.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b or a) + 1))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--class_name", default="nut")
    ap.add_argument("--obj_path", default=None)
    ap.add_argument("--n_objects", type=int, default=8)
    ap.add_argument("--seeds", default="0-23")
    ap.add_argument("--picks", type=int, default=2, help="segments a scene with a plan")
    ap.add_argument("--codebook", type=int, default=None,
                    help="the canonical's best grasps the NOCS sampler starts from "
                         "(default: the eval's config_run.yml value)")
    ap.add_argument("--out", default="logs/paired_pick")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    sc = build_scene(args.class_name, args.n_objects, args.obj_path, codebook=args.codebook)
    sc["obj_path"] = args.obj_path
    tag = f"demo_{args.class_name}" if args.obj_path else args.class_name
    with open(os.path.join(args.out, f"jax_{tag}.jsonl"), "a") as log:
        for seed in parse_seeds(args.seeds):
            scene_attempts(sc, seed, args.picks, args.out, tag, log)


if __name__ == "__main__":
    main()
