#!/usr/bin/env python3
"""Drive the PyTorch port (``catgrasp_tpu_torch``) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:

1. the card's name and power limit (``nvidia-smi``);
2. build the three CUDA kernels with ``nvcc`` from ``catgrasp_tpu_torch/csrc``;
3. kernel K1 ``box_hits`` against its plain PyTorch version: every compiled
   variant and the one with run-time counts on a ragged case, then the grasp
   filter's gate as the filter launches it (254,848 random poses; 512 points
   x 3 open-gripper boxes and 4,096 points x the closing box; 7 offsets x 4
   depths a launch): agreement, times, bound, and the lane use a
   one-thread-a-pose mapping would have on those inputs;
4. the main path, once, at the eval's full size: nut scene set-up, pile
   reset and a 500-step settle, render at 384x512, occupancy, cone sampling
   and the filter — with every kernel's launch count set to 0 just before
   and read just after;
5. kernel K2 ``march_csg`` against its plain version on that settled
   scene at 384x512: agreement, its cull lists against the plain cull, that
   one call queues the kernel and nothing else (torch.profiler), the render
   stage split into march and label passes, times, the bound from the bodies
   each ray's line meets beside the bounds over what a tile's cull keeps,
   where the kernel's time goes (its prologue alone, step budgets, no env
   boxes), and the tried tiles;
6. a device-time profile (torch.profiler) of 20 settle steps, of one
   attempt's front half and of 20 arm-executed pick steps, by kernel; that
   the pick executor (approach, close, hold, lift) and the place executor
   (transport, release), and the floating baseline's pick (``execute_pick``)
   and place (``place_and_drop``), never make the host wait for the device
   (``torch.cuda.set_sync_debug_mode``); the attempt's own collision-gate
   inputs are recorded and K1 is held against its plain version and timed
   on them (the whole gate of one filter call: 2 launches);
7. the pick-and-place path, once, at full width: one round of
   ``simulate_grasp_rounds`` (nut, 8 objects, the canonical's
   NOCS-transfer sampler, at most 2 attempts: oracle NUNOCS pose, cone and
   NOCS candidates, scoring, IK + RRT, the arm-executed pick and place,
   re-settle), with every launch count set to 0 just before and read just
   after: the tallies, each attempt's outcome, the stage times; then K1
   against its plain version on the NOCS-transfer gate's own inputs from
   that round (68,148 poses): agreement, times, bound; and K2 against its
   plain version on the round's last render (384x512, 8 nuts and the
   fixture, 6 env boxes): the frame the round rendered through the kernel
   against the plain march's, times, bound;
8. the rest of the oracle eval, each a round of ``simulate_grasp_rounds``
   with every launch count set to 0 just before and read just after: a
   screw round (8 objects, at most 2 attempts) and an hnm round (8
   objects, 1 attempt), K1 held against its plain version on each round's
   own NOCS-transfer gate inputs (357,768 and 4,896 poses, 2 launches a
   filter call) and K2 on each round's frame; a floating-gripper attempt
   (nut, ``use_arm=0``, 8 objects); a grid round (``--obj_path``
   ``assets/nut_demo.obj``, 4 objects, 1 attempt, no K2 launch) with the
   bake's time, the grid render's, and one grid engine step's time,
   launches and device-busy share;
9. kernel K3 ``rollout_fused`` against its plain version at the throughput
   entry point's shapes (10 bodies x 32 points, 5 bin boxes) on 128 scenes:
   1, 5 and 50 steps, two kernel runs bit for bit, then a batch with no
   contact for the whole call, a settled batch and a batch with every body
   active;
10. the second path, once, at full width: ``catgrasp_tpu_torch.bench`` (1,024
   scenes x 5 calls of 50 steps through K3 and once through the eager engine;
   the collision gate through K1; the IK gate; 9 batches of 8 frames through
   K2, one launch a batch) — again with every launch count set to 0 just
   before and read just after; then K1 and K2 against their plain versions
   at that path's own shapes: the hit matrix and two of the frames it
   computed, on its own inputs; K2's batch against each scene marched alone,
   its cull lists, times and tried tiles;
11. K3's times on the 1,024-scene, 50-step call (kernel, wrapper, plain
   version, eager engine) and its bound from that call's own contacts; the
   kernel's time with the iterations off, on settled piles and with every
   body active; its registers, shared memory and blocks an SM;
12. the learned round: the three nut nets (seg, NUNOCS, grasp) loaded by
   the port's own checkpoint reader from ``artifacts_tracked/nut``, then a
   round of ``simulate_grasp_rounds`` in learned perception (``oracle`` off:
   the seg net's segments with MeanShift and their bandwidth retries, the
   NUNOCS net's RANSAC pose, the grasp net's P(G); nut, 8 objects, the
   canonical, at most 2 attempts) with every launch count set to 0 just
   before and read just after: tallies, outcomes, stage times with the
   nets' own; K1 held against its plain version on the round's
   NOCS-transfer gate and K2 on its frame; each net's device time a call
   at full width, with its multiply-adds; and the seg net's bf16 forward on
   the card held against the same module on the CPU, on the round's cloud;
13. grasp-DB generation: one nut instance through ``generate_complete_grasps``
   at ``config_grasp.yml``'s settings (42,700 cone poses through the
   filter, up to 4,096 candidates x 50 perturbations, 12,800 rollouts of 100
   engine steps a chunk) with every launch count set to 0 just before and
   read just after: counters, score mean and bins, the balanced DB's size,
   the time of sampling + filter and of scoring, rollouts a second; K1 held
   against its plain version on that gate's own inputs (C = 200 and C = 1,
   A = 7, D = 1); 20 rollout steps of a chunk profiled (launches a step,
   busy share) and free of host waits; the 256 poses of the stored
   ``nut_train_0`` DB that JAX's drift probe re-scores, re-scored and held
   against the stored scores (Spearman >= 0.90, mean |diff| <= 0.07, means
   within 0.03); one grid chunk on ``assets/nut_demo.obj``, twice, the same
   candidates and scores both times;
14. a ``grasp_db`` and a ``kernels`` JSON line, the card line, then
   ``{"ok": true, ...}``.

It imports nothing of the JAX package.  Without a GPU it exits non-zero
before printing any result.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s off the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12  # dense, on the tensor cores
N_POSES = 254_848  # 64 samples x 181 rotations x 22 depths


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int, warm_up: bool = True) -> float:
    """Median wall time of ``fn`` on the device, in ms, from CUDA events
    around each call (after one warm-up call, unless the call is too long to
    make twice)."""
    if warm_up:
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def kernel_ms(fn, kernel: str, reps: int = 20):
    """Mean device time of one launch of the CUDA kernel named ``kernel``
    over ``reps`` calls of ``fn`` (each launches it once), in ms, from
    torch.profiler's CUPTI trace; None when the trace shows no device time
    for it.  The mean is taken over the launches the trace holds: late in a
    long process it drops some, and a sum over all calls would read low."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us, seen = 0.0, 0
    for evt in prof.key_averages():
        if kernel in evt.key:
            t = getattr(evt, "device_time_total", None)
            total_us += t if t is not None else getattr(evt, "cuda_time_total", 0.0)
            seen += evt.count
    if seen != reps:
        print(f"  (the profiler's trace holds {seen} of {reps} launches of {kernel})", flush=True)
    return total_us / seen / 1e3 if total_us > 0 else None


def timed(fn, kernel: str):
    """(kernel ms, wrapper ms, how the kernel ms was taken): the kernel's
    own device time from the profiler, and the wrapper's (cull, packing,
    launch) from CUDA events; the events stand in when the profiler sees no
    device time."""
    wrapper = cuda_ms(fn, 25)
    k = kernel_ms(fn, kernel)
    return (k, wrapper, "torch.profiler") if k is not None else (wrapper, wrapper, "cuda events")


def random_poses(rng, n: int) -> np.ndarray:
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    R = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                  2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                  2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                 axis=-1).reshape(n, 3, 3)
    T = np.zeros((n, 4, 4), np.float32)
    T[:, :3, :3] = R
    T[:, :3, 3] = rng.uniform(-0.05, 0.05, (n, 3))
    T[:, 3, 3] = 1.0
    return T


# --------------------------------------------------------------------------
# K1 box_hits
# --------------------------------------------------------------------------


def box_hits_work(collision, t_inv, cloud, mask, boxes, offsets, depths, margin):
    """(operations, operations depth by depth, [need of each depth]) of a
    launch.  A pose examines points in order until all its depth x offset
    bits are set (``need`` points, the early exit: the largest need over its
    depths).  Each examined point costs the 3x4 transform once (9 FMA = 18
    ops), per box the z test (2 ops) and per box and depth the x test (2
    ops); each (point, box) that passes z, and x at some depth, costs the y
    test per offset (3 ops).  The second figure is the single-depth count
    summed over the depths, as D launches of a single-depth kernel would do
    them (transform and z test once a depth, the y tests once an x/z pass a
    depth); at one depth the two are equal."""
    centers, halves, offs, centers_x = collision._static_arrays(boxes, offsets, depths,
                                                                cloud.device)
    P, C, K, A, D = t_inv.shape[0], cloud.shape[0], len(boxes), len(offsets), len(depths)
    R, t = t_inv[:, :3, :3], t_inv[:, :3, 3]
    chunk = max(1, (1 << 20) // C)
    ops, ops_by_depth, needs = 0.0, 0.0, [[] for _ in depths]
    for s in range(0, P, chunk):
        pts = torch.einsum("pij,cj->pci", R[s:s + chunk], cloud) + t[s:s + chunk, None, :]
        rel = pts[:, :, None, :] - centers
        ok_z = (torch.abs(rel[..., 2]) - halves[:, 2] < margin) & mask[None, :, None]
        ok_y = torch.abs(rel[..., 1][..., None] - offs) - halves[:, 1, None] < margin
        xz_any = torch.zeros_like(ok_z)
        for d in range(D):
            ok_xz = (torch.abs(pts[:, :, None, 0] - centers_x[d]) - halves[:, 0] < margin) & ok_z
            xz_any |= ok_xz
            hit = (ok_xz[..., None] & ok_y).any(dim=2)  # (B,C,A)
            first = torch.where(hit.any(dim=1), hit.to(torch.uint8).argmax(dim=1), C)
            need = torch.where((first < C).all(dim=1), first.amax(dim=1) + 1, C)  # (B,)
            xz_cum = torch.cumsum(ok_xz.sum(dim=2), dim=1)  # (B,C)
            xz_need = xz_cum.gather(1, (need - 1)[:, None])[:, 0]
            ops_by_depth += float(need.sum()) * (18 + 4 * K) + float(xz_need.sum()) * 3 * A
            needs[d].append(need)
        need = torch.stack([n[-1] for n in needs]).amax(dim=0)
        xz_cum = torch.cumsum(xz_any.sum(dim=2), dim=1)
        xz_need = xz_cum.gather(1, (need - 1)[:, None])[:, 0]
        ops += float(need.sum()) * (18 + K * (2 + 2 * D)) + float(xz_need.sum()) * 3 * A
    return ops, ops_by_depth, [torch.cat(n) for n in needs]


def lane_use(need: torch.Tensor, group: int) -> float:
    """Share of lane-steps that do needed work when ``group`` consecutive
    poses, one a thread, run until the slowest of them has all its bits:
    sum(need) / sum(group x the group's max need)."""
    pad = -need.numel() % group
    g = torch.cat([need, need.new_zeros(pad)]).view(-1, group)
    return float(need.sum()) / float(group * g.amax(dim=1).sum())


def measure_box_hits(name, collision, t_inv, cloud, mask, boxes, offsets, depths, margin,
                     hit_k=None):
    """Hold K1 against its plain version on these inputs (``hit_k``: a result
    the kernel already gave for them), time it and the plain version, and
    work out the bound from what these inputs need (``box_hits_work``)."""
    P, C, D, A = t_inv.shape[0], cloud.shape[0], len(depths), len(offsets)
    args = (t_inv, cloud, mask, boxes, offsets, depths, margin)
    if hit_k is None:
        hit_k = collision.box_hits_depths(*args)
    torch.cuda.synchronize()
    base_mib = torch.cuda.memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    hit_p = collision.box_hits_depths_plain(*args)
    torch.cuda.synchronize()
    plain_peak_mib = torch.cuda.max_memory_allocated() / 2**20 - base_mib
    if hit_k.shape != (P, D, A) or hit_k.dtype != torch.bool:
        fail(f"box_hits {name}: shape {tuple(hit_k.shape)} dtype {hit_k.dtype}")
    n_diff = int((hit_k != hit_p).sum())
    frac_hit = float(hit_p.float().mean())
    ms, wrapper_ms, how = timed(lambda: collision.box_hits_depths(*args), "box_hits_kernel")
    # the plain version ran just above: one timed call will do
    plain_ms = cuda_ms(lambda: collision.box_hits_depths_plain(*args), 1, warm_up=False)
    nbytes = P * 64 + C * 13 + P * D * A
    ops, ops_by_depth, needs = box_hits_work(collision, t_inv, cloud, mask, boxes, offsets,
                                             depths, margin)
    use_warp = [lane_use(need, 32) for need in needs]
    use_block = [lane_use(need, 256) for need in needs]
    bound, _ = bound_of(ops, nbytes)
    bound_by_depth, _ = bound_of(ops_by_depth, nbytes)
    print(f"K1 box_hits [{name}] P={P} C={C} K={len(boxes)} A={A} D={D}, one launch: "
          f"{n_diff} of {hit_k.numel()} (pose, depth, offset) entries differ from the plain "
          f"version (hit rate {frac_hit:.4f}); kernel {ms:.4f} ms ({how}), wrapper "
          f"{wrapper_ms:.4f} ms, plain {plain_ms:.3f} ms (its peak memory above the inputs "
          f"{plain_peak_mib:.1f} MiB), bound {bound:.4f} ms "
          f"({ops:.3e} ops, {nbytes:.3e} bytes; counted depth by depth as {D} single-depth "
          f"launches would work: {bound_by_depth:.4f} ms, {ops_by_depth:.3e} ops); lane use of "
          f"a one-thread-a-pose mapping without compaction, by depth: a warp "
          f"{[round(u, 4) for u in use_warp]}, a 256-pose block "
          f"{[round(u, 4) for u in use_block]}", flush=True)
    if n_diff > 1e-5 * hit_k.numel():
        fail(f"box_hits {name}: {n_diff} entries differ (limit 1e-5 of entries)")
    return {"n_diff": n_diff, "n_entries": hit_k.numel(), "ms": ms, "wrapper_ms": wrapper_ms,
            "timing": how, "plain_ms": plain_ms, "plain_peak_mib": plain_peak_mib,
            "bytes": nbytes, "ops": ops,
            "ops_by_depth": ops_by_depth, "lane_use_warp": float(np.mean(use_warp)),
            "lane_use_block": float(np.mean(use_block))}


def add_up(parts):
    """The two launches of one filter call's gate, added up (lane use: the
    mean)."""
    res = {}
    for one in parts:
        for k, v in one.items():
            res[k] = v if k == "timing" else res.get(k, 0) + v
    for k in ("lane_use_warp", "lane_use_block"):
        res[k] /= len(parts)
    res["plain_peak_mib"] = max(p["plain_peak_mib"] for p in parts)
    return res


def bound_of(ops: float, nbytes: float):
    """(bound ms, what bounds it) from the operations and bytes of a call."""
    t_ops, t_bytes = ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def check_box_hits_variants(dev):
    """Every compiled (boxes, offsets, depths) variant, and the variant with
    run-time counts (3 offsets, 2 depths; 4 boxes x 8 offsets x 4 depths), on
    a case ragged against the pose blocks and the point chunks, with poses
    that hit everything and nothing, and on an all-masked cloud: exact."""
    from catgrasp_tpu_torch.grasp import filter as gfilter
    from catgrasp_tpu_torch.ops import collision
    from catgrasp_tpu_torch.sim.env_grasp import GripperSpec

    rng = np.random.default_rng(5)
    n, c = 3001, 2500
    T = random_poses(rng, n)
    T[:, :3, 3] = rng.uniform(-0.08, 0.08, (n, 3))
    T[:40, :3, 3] = 5.0  # far from every point: none-hit poses
    t_inv = collision.pose_inverse_batch(torch.from_numpy(T).to(dev)).contiguous()
    pts = rng.uniform(-0.3, 0.3, (c, 3)).astype(np.float32)
    pts[:1500] = rng.uniform(-0.04, 0.04, (1500, 3))  # dense at the origin: all-hit poses
    cloud = torch.from_numpy(pts).to(dev)
    mask = torch.from_numpy(rng.uniform(size=c) > 0.2).to(dev)
    spec = GripperSpec()
    all_offsets = tuple(float(o) for o in gfilter.ADJUST_OFFSETS)
    all_depths = tuple(float(d) for d in gfilter.DEPTH_OFFSETS)
    open_boxes, closing_box = gfilter._static_open_boxes(spec), gfilter._static_enclosed_box(spec)
    cases = [(boxes, offsets, depths) for boxes in (open_boxes, closing_box)
             for offsets in (all_offsets, (0.0,)) for depths in (all_depths, (0.0,))]
    cases += [(open_boxes, all_offsets[:3], all_depths[:2]),
              (open_boxes + closing_box, all_offsets + (4e-3,), all_depths)]
    n_cases = 0
    for boxes, offsets, depths in cases:
        for m in (mask, torch.zeros_like(mask)):
            args = (t_inv, cloud, m, boxes, offsets, depths, 5e-4)
            ref = collision.box_hits_depths_plain(*args)
            got = collision.box_hits_depths(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                fail(f"box_hits variant K={len(boxes)} A={len(offsets)} D={len(depths)}: "
                     f"{int((got != ref).sum())} entries differ")
            n_cases += 1
    args = (t_inv, cloud, mask, open_boxes, all_offsets, all_depths, 5e-4)
    ref = collision.box_hits_depths_plain(*args)
    all_hit = int(ref.all(dim=2).all(dim=1).sum())
    none_hit = int((~ref.any(dim=2).any(dim=1)).sum())
    print(f"K1 box_hits variants: {n_cases} cases (8 compiled variants and 2 sets of run-time "
          f"counts x a masked and an all-masked cloud) at P={n}, C={c}: 0 entries differ; the "
          f"open-gripper case "
          f"has {all_hit} all-hit and {none_hit} none-hit poses", flush=True)
    if all_hit == 0 or none_hit < 40:
        fail("box_hits variants: the case lacks all-hit or none-hit poses")


def check_box_hits(dev):
    from catgrasp_tpu_torch.grasp import filter as gfilter
    from catgrasp_tpu_torch.ops import collision
    from catgrasp_tpu_torch.sim.env_grasp import GripperSpec

    rng = np.random.default_rng(0)
    T = torch.from_numpy(random_poses(rng, N_POSES)).to(dev)
    t_inv = collision.pose_inverse_batch(T).contiguous()
    offsets = tuple(float(o) for o in gfilter.ADJUST_OFFSETS)
    depths = tuple(float(d) for d in gfilter.DEPTH_OFFSETS)
    spec, margin = GripperSpec(), 5e-4
    # the target's points in a 15 mm ball at the origin; the background a
    # 3 cm slab below it, as the occupancy fill makes it; poses within 5 cm
    ball = rng.normal(size=(512, 3))
    ball *= 0.015 * rng.uniform(size=(512, 1)) ** (1 / 3) / np.linalg.norm(ball, axis=1,
                                                                           keepdims=True)
    slab = np.concatenate([rng.uniform(-0.1, 0.1, (4096, 2)),
                           rng.uniform(-0.05, -0.02, (4096, 1))], axis=1)
    cases = [("open", ball, gfilter._static_open_boxes(spec)),
             ("enclosed", slab, gfilter._static_enclosed_box(spec))]
    parts = []
    for name, pts, boxes in cases:
        cloud = torch.from_numpy(pts.astype(np.float32)).to(dev)
        mask = torch.from_numpy(rng.uniform(size=len(pts)) > 0.05).to(dev)
        parts.append(measure_box_hits(name, collision, t_inv, cloud, mask, boxes, offsets,
                                      depths, margin))
    return add_up(parts)  # the two clouds of one filter call's gate


def eval_gate(dev, scene, state, params):
    """K1 on the eval path's own inputs: one more attempt on the settled pile
    with the filter's two launches recorded, then both held against the plain
    version and timed.  Returns the whole gate of one filter call, added up."""
    from catgrasp_tpu_torch.ops import collision
    from catgrasp_tpu_torch.pipelines import run_grasp_simulation as rgs

    calls, entry = [], collision.box_hits_depths

    def recorder(*args):
        calls.append((args, entry(*args)))
        return calls[-1][1]

    collision.box_hits_depths = recorder
    try:
        rgs.attempt_front(scene, state, params, np.random.default_rng(0),
                           torch.Generator(device=dev).manual_seed(0))
    finally:
        collision.box_hits_depths = entry
    if len(calls) < 2 or len(calls) % 2:
        fail(f"the filter launched K1 {len(calls)} times: expected 2 a filter call")
    parts = [measure_box_hits(f"eval path, {name}", collision, *args, hit_k=hit)
             for name, (args, hit) in zip(("open gripper", "closing volume"), calls[-2:])]
    gate = add_up(parts)
    bound, _ = bound_of(gate["ops"], gate["bytes"])
    bound_by_depth, _ = bound_of(gate["ops_by_depth"], gate["bytes"])
    print(f"K1 box_hits, the whole gate of one filter call on the eval path's inputs (2 "
          f"launches, 4 depths each): kernel {gate['ms']:.4f} ms, wrappers "
          f"{gate['wrapper_ms']:.4f} ms, plain {gate['plain_ms']:.3f} ms, bound {bound:.4f} ms "
          f"(counted depth by depth: {bound_by_depth:.4f} ms)", flush=True)
    return gate


# --------------------------------------------------------------------------
# K2 march_csg
# --------------------------------------------------------------------------

# ops of one slot's primitive SDF as the kernel writes it (box 20, cylinder
# 18, hex prism 40), plus 5 for the slot offset and the union/subtract
# combine (csrc/march_csg.cu:scene_phi)
_SLOT_OPS = {1: 20 + 5, 2: 18 + 5, 3: 40 + 5}
_BODY_OPS = 23  # move the point into the body frame, scale, min-combine
_ENV_OPS = 39  # one env box: move into its frame, box SDF, min
_STEP_OPS = 11  # ray point (3 FMA) and the step update
# the tiles tried (rows, columns), one ray a thread; 1 x 256 is a 256-ray strip
_MARCH_VARIANTS = [(8, 8), (8, 16), (16, 8), (16, 16), (8, 32), (32, 8), (1, 256)]


def march_work(rm, lib, state, params, o_w, d_w, tmax, env, n_steps, hit_eps, hw):
    """Operations this run's data needs.  Each ray evaluates the scene at
    every step until it converges (step counts from the plain march's rule);
    ``need`` counts at each step the bodies whose bounding sphere (radius +
    1e-3) the ray's own line meets and the enabled env boxes, the least any
    conservative cull can leave; ``strip`` the bodies the cull of the ray's
    256-ray strip keeps (the tile of the kernel's first design), ``tile``
    those the cull of the kernel's own tile keeps."""
    P = d_w.shape[0]
    t = torch.full((P,), 0.05, device=d_w.device)
    done = torch.zeros((P,), dtype=torch.bool, device=d_w.device)
    evals = torch.zeros((P,), dtype=torch.float64, device=d_w.device)
    for _ in range(n_steps):
        evals += (~done).double()
        x = o_w + t[:, None] * d_w
        phi = torch.minimum(torch.amin(rm.scene_sdf(lib, state, params, x)[0], dim=-1),
                            rm.env_sdf(env, x))
        newly = phi < hit_eps
        t = torch.where(done | newly, t, torch.minimum(t + torch.clamp(phi, min=hit_eps / 2),
                                                       tmax))
        done = done | newly | (t >= tmax)
    types = lib.csg.types[params.shape_id]
    body_ops = torch.full(types.shape[:1], float(_BODY_OPS), dtype=torch.float64,
                          device=d_w.device)
    for code, ops in _SLOT_OPS.items():
        body_ops += (types == code).sum(dim=-1).double() * ops
    fixed = _STEP_OPS + _ENV_OPS * int(env.enabled.sum())
    radius_w = lib.radius[params.shape_id] * params.scale
    c = state.pos - o_w
    along = d_w @ c.T  # (P, N)
    perp2 = (c * c).sum(dim=-1) - along * along
    meets = (perp2 <= (radius_w + 1e-3) ** 2) & state.active
    work = {"need": float((evals * (meets.double() @ body_ops + fixed)).sum())}
    for key, tile in (("strip", (1, rm.TILE)), ("tile", None)):
        geo = (None, tile) if key == "strip" else (hw, None)
        visidx, visn = rm.tile_visibility(o_w, d_w, state.pos, radius_w, state.active, *geo)
        kept = torch.arange(visidx.shape[-1], device=d_w.device) < visn[:, None]
        tile_ops = (body_ops[visidx.long()] * kept).sum(dim=-1)
        H, W, th, tw = rm.tile_geometry(P, *geo)
        idx, valid = rm.tile_rays(H, W, th, tw, d_w.device)
        per_ray = torch.zeros((P,), dtype=torch.float64, device=d_w.device)
        per_ray[idx[valid]] = tile_ops[:, None].expand_as(idx)[valid]
        work[key] = float((evals * (per_ray + fixed)).sum())
    return work


def march_variants(lib, states, params, o_w, d_w, tmax, env, hw):
    """Kernel ms of the tried tiles on these inputs (one launch each, a batch
    of scenes if ``states`` has one), keyed "rows x columns"; None where the
    profiler's trace lost the tile's launches."""
    from catgrasp_tpu_torch.ops import render_march as rm
    ms = {}
    for th, tw in _MARCH_VARIANTS:
        def call(th=th, tw=tw):
            return rm._march(lib, states, params, o_w, d_w, tmax, env=env, hw=hw, tile=(th, tw))
        ms[f"{th}x{tw}"] = kernel_ms(call, "march_csg_kernel")
    return ms


def march_breakdown(lib, states, params, o_w, d_w, tmax, env, hw):
    """Where the kernel's time goes on these inputs, kernel ms: the block
    prologue alone (the cull launch), the march with a step budget of 0, 1,
    4, 16 and 64, and at 64 steps without the env boxes."""
    from catgrasp_tpu_torch.ops import render_march as rm
    calls = {"cull_only": (lambda: rm.tile_visibility_kernel(lib, states, params, o_w, d_w,
                                                             hw=hw), "march_csg_cull_kernel")}
    for n in (0, 1, 4, 16, 64):
        calls[f"steps_{n}"] = (lambda n=n: rm.march_csg_batch(lib, states, params, o_w, d_w, tmax,
                                                              env=env, n_steps=n, hw=hw),
                               "march_csg_kernel")
    calls["steps_64_no_env"] = (lambda: rm.march_csg_batch(lib, states, params, o_w, d_w, tmax,
                                                           hw=hw), "march_csg_kernel")
    return {k: kernel_ms(fn, name) for k, (fn, name) in calls.items()}


def check_cull_lists(label, rm, lib, states, params, o_w, d_w, hw):
    """The kernel's cull lists (a launch of its block prologue alone) against
    the plain ``tile_visibility`` with the same tiles: a body may fall on the
    other side only within 1e-5 of the threshold.  Returns the number of
    (scene, tile) lists that differ and the number of lists."""
    vk, nk = rm.tile_visibility_kernel(lib, states, params, o_w, d_w, hw=hw)
    radius_w = lib.radius[params.shape_id] * params.scale
    vp, np_ = rm.tile_visibility(o_w, d_w, states.pos, radius_w, states.active, hw)
    margin, inside = rm.cull_margin(o_w, d_w, states.pos, radius_w, hw)
    N = vk.shape[-1]
    body = torch.arange(N, device=d_w.device)
    in_k = (vk.long()[..., None] == body).any(dim=-2)
    listed_p = torch.where(body < np_[..., None], vp, -1)
    in_p = (listed_p.long()[..., None] == body).any(dim=-2)
    differ = in_k != in_p
    near = (margin + 1e-4).abs() < 1e-5
    n_lists = int(differ.any(dim=-1).sum())
    # in index order, -1 past the count
    ordered = bool(((vk[..., 1:] > vk[..., :-1]) | (vk[..., 1:] < 0)).all()) and bool(
        torch.equal(vk >= 0, body < nk[..., None]))
    print(f"K2 cull lists [{label}]: {n_lists} of {nk.numel()} (scene, tile) lists differ from "
          f"the plain cull, all within 1e-5 of the threshold: {bool((~differ | near).all())}; "
          f"kept bodies a tile, mean {float(nk.float().mean()):.3f}, max {int(nk.max())}",
          flush=True)
    if not bool((~differ | near).all()) or not ordered:
        fail(f"march_csg [{label}]: the kernel's cull lists disagree with the plain cull")
    return n_lists, int(nk.numel())


def one_launch(call, reps: int = 5):
    """What one call queues on the device, from torch.profiler over ``reps``
    calls: (the CUDA API calls that queue work, made inside
    each call; the device activities of the whole window).  The trace may
    drop device records, so the runtime calls are read per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            with record_function(f"one_call_{i}"):
                call()
        torch.cuda.synchronize()
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name.startswith("one_call_") and e.device_type == DeviceType.CPU)
    queued = [[e.name for e in events if e.device_type == DeviceType.CPU
               and any(w in e.name for w in ("Launch", "Memcpy", "Memset"))
               and lo <= e.time_range.start <= hi] for lo, hi in spans]
    device = [e.name for e in events if e.device_type == DeviceType.CUDA
              and not e.name.startswith("one_call_")]  # less the calls' own annotations
    return queued, device


def check_march(label, lib, state, params, K, cam, H, W, env, frame=None):
    """Hold K2 against its plain version on this scene, time both and work
    out the bounds.  ``frame``: the images a path rendered of this scene
    through the kernel; they are what is compared where given."""
    from catgrasp_tpu_torch.ops import render_march as rm
    from catgrasp_tpu_torch.render import raymarch

    o_w, d_w, d_cam, tmax = raymarch.camera_rays(K, cam, H, W)
    kw = dict(env=env, n_steps=64, hit_eps=raymarch.HIT_EPS)
    t_k = rm.march_csg(lib, state, params, o_w, d_w, tmax, hw=(H, W), **kw)
    t_p = rm.march_csg_plain(lib, state, params, o_w, d_w, tmax, **kw)
    out_k = frame if frame is not None else raymarch.shade(lib, state, params, cam, H, W, env,
                                                           d_w, d_cam, tmax, t_k)
    out_p = raymarch.shade(lib, state, params, cam, H, W, env, d_w, d_cam, tmax, t_p)
    torch.cuda.synchronize()
    if not torch.isfinite(t_k).all():
        fail("march_csg returned non-finite t")
    seg_k, seg_p = out_k["seg"], out_p["seg"]
    agree = float((seg_k == seg_p).float().mean())
    both = (seg_k == seg_p) & (seg_p != -1)
    err = float((out_k["depth"] - out_p["depth"])[both].abs().max())
    visible_k = set(seg_k.unique().tolist())
    visible_p = set(seg_p.unique().tolist())
    ms, wrapper_ms, how = timed(
        lambda: rm.march_csg(lib, state, params, o_w, d_w, tmax, hw=(H, W), **kw),
        "march_csg_kernel")
    plain_ms = cuda_ms(lambda: rm.march_csg_plain(lib, state, params, o_w, d_w, tmax, **kw), 3)
    P = d_w.shape[0]
    nbytes = P * (12 + 4 + 4)
    work = march_work(rm, lib, state, params, o_w, d_w, tmax, env, 64, raymarch.HIT_EPS, (H, W))
    bound, bound_by = bound_of(work["need"], nbytes)
    bound_strip, by_strip = bound_of(work["strip"], nbytes)
    bound_tile, by_tile = bound_of(work["tile"], nbytes)
    th, tw = rm.IMAGE_TILE
    print(f"K2 march_csg [{label}] {H}x{W} ({P} rays), {state.pos.shape[0]} bodies "
          f"({int(state.active.sum())} active), "
          f"{env.center.shape[0]} env boxes: seg agrees on {agree:.6f} of pixels, depth max "
          f"|err| {err:.3e} m where it agrees, bodies seen {sorted(visible_k)} vs "
          f"{sorted(visible_p)}; kernel {ms:.4f} ms ({how}), wrapper (call to return) "
          f"{wrapper_ms:.4f} ms, plain {plain_ms:.3f} ms; bound {bound:.4f} ms, {bound_by} "
          f"({work['need']:.3e} ops: the bodies each ray's line meets); over the bodies a cull "
          f"keeps: 256-ray strips {bound_strip:.4f} ms, {by_strip} ({work['strip']:.3e} ops), "
          f"{th}x{tw} tiles {bound_tile:.4f} ms, {by_tile} ({work['tile']:.3e} ops); "
          f"{nbytes:.3e} bytes", flush=True)
    if agree <= 0.995 or err > 2e-3 or visible_k != visible_p:
        fail(f"march_csg [{label}] disagrees with its plain version")
    return {"max_abs_err": err, "seg_agree": agree, "ms": ms, "wrapper_ms": wrapper_ms,
            "timing": how, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "bound_ms_tile_cull": bound_strip, "bound_ms_square_tile_cull": bound_tile,
            "shapes": f"{H}x{W} rays, {state.pos.shape[0]} bodies, {env.center.shape[0]} env "
                      f"boxes, 64 steps"}


def eval_march(scene, state, params, times):
    """K2 on the eval path's settled scene: against its plain version, its
    cull lists, one call = one device activity, the render stage split into
    march and label passes, and the tried tiles."""
    from catgrasp_tpu_torch.ops import render_march as rm
    from catgrasp_tpu_torch.render import raymarch
    from catgrasp_tpu_torch.sim.types import as_batch

    dev = state.pos.device
    cam = torch.as_tensor(scene.cam, dtype=torch.float32, device=dev)
    K = torch.as_tensor(scene.K, dtype=torch.float32, device=dev)
    H, W, env = scene.H, scene.W, scene.env_bin
    k2 = check_march("eval path", scene.lib, state, params, K, cam, H, W, env)
    o_w, d_w, d_cam, tmax = raymarch.camera_rays(K, cam, H, W)
    kw = dict(env=env, n_steps=64, hit_eps=raymarch.HIT_EPS, hw=(H, W))
    call = lambda: rm.march_csg(scene.lib, state, params, o_w, d_w, tmax, **kw)  # noqa: E731
    queued, device = one_launch(call)
    print(f"K2 {len(queued)} march_csg calls under torch.profiler: work queued inside each "
          f"{queued}; device activities {sorted(set(device))} x {len(device)}", flush=True)
    if len(queued) != 5 or any(len(q) != 1 or "Launch" not in q[0] for q in queued) \
            or not device or any("march_csg_kernel" not in n for n in device):
        fail("one march_csg call is not one launch of the kernel and nothing else")
    one = (as_batch(state), as_batch(params))
    check_cull_lists("eval path", rm, scene.lib, *one, o_w, d_w, (H, W))
    t = call()

    def wall_ms(fn, reps=10):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(out))
    split = {"camera_rays_ms": wall_ms(lambda: raymarch.camera_rays(K, cam, H, W)),
             "march_ms": wall_ms(call),
             "shade_ms": wall_ms(lambda: raymarch.shade(scene.lib, state, params, cam, H, W, env,
                                                        d_w, d_cam, tmax, t)),
             "render_ms": wall_ms(lambda: raymarch.render(scene.lib, state, params, K, cam, H, W,
                                                          env=env))}
    print(f"eval path render stage, host wall with a synchronise, median of 10 (the main path's "
          f"one render_s {times['render_s'] * 1e3:.3f} ms): {json.dumps(split)}", flush=True)
    k2["breakdown_ms"] = march_breakdown(scene.lib, *one, o_w, d_w, tmax, env, (H, W))
    print(f"K2 where the kernel's time goes [eval path], kernel ms: "
          f"{json.dumps(k2['breakdown_ms'])}", flush=True)
    k2["variants_ms"] = march_variants(scene.lib, *one, o_w, d_w, tmax, env, (H, W))
    print(f"K2 tiles [eval path, 1 scene], kernel ms: "
          f"{json.dumps(k2['variants_ms'])}", flush=True)
    k2["render_split_ms"] = split
    return k2


# --------------------------------------------------------------------------
# K3 rollout_fused
# --------------------------------------------------------------------------

# Operations of K3 as csrc/fused_rollout.cu writes them (a square root, a
# division or a reciprocal square root counted as one).  A slot: its offset,
# its primitive's SDF with normal, and the union/subtract combine.
_K3_SLOT_OPS = {1: 42 + 9, 2: 38 + 9, 3: 95 + 9}
_K3_BODY_STEP = 160   # a body a step: rotation, world inverse inertia, damping, integration
_K3_POINT_STEP = 21   # a point a step: world position and lever arm
_K3_BODY_PAIR = 33    # point vs body: into the body's frame, normalise, scale, test
_K3_ENV_PAIR = 39     # point vs env box: into its frame, box distance, test
_K3_CONTACT = {"body": 86, "env": 80}   # a pair in contact: world normal, K_n, rounding
_K3_CONTACT_ITER = {"body": 191, "env": 119}  # a pair in contact, one Jacobi iteration
_K3_BODY_ITER = 60    # a body, one iteration: apply the summed impulses


def bench_scene(dev, batch):
    """The throughput entry point's env-steps inputs: its shapes, bin and
    reset, from its seed."""
    from catgrasp_tpu_torch import bench
    from catgrasp_tpu_torch.sim import engine, env_pile

    cfg = env_pile.PileConfig(max_bodies=10)
    lib = bench.pile_lib(bench.ENV_SHAPES, 32, dev)
    env = engine.StaticEnv.open_bin(cfg.bin_inner, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    states, params = env_pile.reset_batch(gen, lib, cfg, batch)
    return cfg, lib, env, states, params


def rollout_work(pfr, lib, env, states, params, n_steps, n_iter, dt):
    """(operations, bytes) that ``n_steps`` of this batch need: per step the
    point-collider pairs of active bodies with the slots each really
    evaluates, and per iteration the pairs in contact (counted on the
    kernel's own trajectory, one step a launch)."""
    B, N = states.pos.shape[:2]
    P, M = lib.surf_pts.shape[1], env.center.shape[0]
    types = lib.csg.types[params.shape_id]  # (B, N, S)
    slot_ops = torch.zeros_like(types, dtype=torch.float64)
    for code, ops in _K3_SLOT_OPS.items():
        slot_ops += (types == code) * float(ops)
    act = states.active.double()
    n_act = act.sum(dim=1)  # (B,)
    body_ops = (slot_ops.sum(dim=-1) + _K3_BODY_PAIR) * act  # a point against body j
    # every point of every other active body evaluates body j
    pair_ops = float((body_ops.sum(dim=1) * (n_act - 1).clamp(min=0)).sum()) * P
    fixed = (float(n_act.sum()) * (_K3_BODY_STEP + n_iter * _K3_BODY_ITER)
             + float(n_act.sum()) * P * (_K3_POINT_STEP + M * _K3_ENV_PAIR) + pair_ops)
    c = pfr.prepare(states, params, lib, env)
    ops, n_body, n_env = fixed * n_steps, 0, 0
    st = states
    for _ in range(n_steps):
        slabs, _ = pfr.narrowphase(pfr.Frame(st.pos, st.quat, c), c)
        nb = sum(int((s[0] < 0).sum()) for s in slabs[:N])
        ne = sum(int((s[0] < 0).sum()) for s in slabs[N:])
        n_body, n_env = n_body + nb, n_env + ne
        ops += nb * (_K3_CONTACT["body"] + n_iter * _K3_CONTACT_ITER["body"]) \
            + ne * (_K3_CONTACT["env"] + n_iter * _K3_CONTACT_ITER["env"])
        st = pfr.rollout_fused(st, params, lib, env, 1, dt=dt)
    S = types.shape[-1]
    nbytes = B * N * 4 * (13 + 13 + 8 + 3 * P + 2 * S + 6 * S) + M * 19 * 4
    return ops, nbytes, n_body / n_steps / B, n_env / n_steps / B


_STATE_FIELDS = ("pos", "quat", "linvel", "angvel")


def _state_errors(a, b):
    """Per active body: max |difference| of pos, quat, linvel, angvel."""
    act = a.active
    return {f: (getattr(a, f) - getattr(b, f)).abs().amax(dim=-1)[act] for f in _STATE_FIELDS}


def compare_rollout(pfr, label, st, par, lib, env, n, dt, fall_steps):
    """Hold ``n`` kernel steps from ``st`` against the plain version: the
    share of active bodies within 1e-4 m / 1e-3 quat / 1e-2 velocities (at
    least 0.99), the largest errors, and the share of bodies that contact has
    slowed below 0.9 of a ``fall_steps`` free fall."""
    k = pfr.rollout_fused(st, par, lib, env, n, dt=dt)
    p = pfr.rollout_fused_plain(st, par, lib, env, n, dt=dt)
    torch.cuda.synchronize()
    if not all(torch.isfinite(getattr(k, f)).all() for f in _STATE_FIELDS):
        fail(f"rollout_fused [{label}] returned non-finite state after {n} steps")
    if not all(torch.equal(getattr(k, f)[~k.active], getattr(st, f)[~k.active])
               for f in _STATE_FIELDS):
        fail(f"rollout_fused [{label}] moved an inactive body")
    err = _state_errors(k, p)
    within = ((err["pos"] < 1e-4) & (err["quat"] < 1e-3) & (err["linvel"] < 1e-2)
              & (err["angvel"] < 1e-2))
    frac = float(within.float().mean())
    worst = {f: float(e.max()) for f, e in err.items()}
    slowed = float((k.linvel[..., 2].abs() < 0.9 * 9.8 * fall_steps * dt)[k.active]
                   .float().mean())
    N, P = st.pos.shape[1], lib.surf_pts.shape[1]
    print(f"K3 rollout_fused vs plain [{label}], {st.pos.shape[0]} scenes x {N} bodies x {P} "
          f"points, {n} step(s): {frac:.5f} of {int(within.numel())} active bodies within "
          f"1e-4 m / 1e-3 quat / 1e-2 velocities; max |err| {json.dumps(worst)}; "
          f"{slowed:.3f} of bodies slowed by contact", flush=True)
    if frac < 0.99:
        fail(f"rollout_fused [{label}] disagrees with its plain version after {n} steps")
    return frac, worst, slowed


def rollout_regimes(dev, n_scenes=1024):
    """The kernel's time for a 50-step call of ``n_scenes`` scenes in four
    regimes: the entry point's own call (piles falling from the reset), the
    same with the solver's iterations off, settled piles (the state after the
    entry point's 250 steps) and a batch with every body active."""
    from catgrasp_tpu_torch.ops import fused_rollout as pfr
    from catgrasp_tpu_torch.sim import env_pile

    cfg, lib, env, states, params = bench_scene(dev, n_scenes)
    settled = states
    for _ in range(5):
        settled = pfr.rollout_fused(settled, params, lib, env, 50, dt=cfg.dt)
    gen = torch.Generator(device=dev).manual_seed(0)
    full_st, full_par = env_pile.reset_batch(gen, lib, cfg, n_scenes, n_objects=10)
    regimes = {
        "from_reset": lambda: pfr.rollout_fused(states, params, lib, env, 50, dt=cfg.dt),
        "n_iter_0": lambda: pfr.rollout_fused(states, params, lib, env, 50, dt=cfg.dt, n_iter=0),
        "settled": lambda: pfr.rollout_fused(settled, params, lib, env, 50, dt=cfg.dt),
        "all_active": lambda: pfr.rollout_fused(full_st, full_par, lib, env, 50, dt=cfg.dt),
    }
    ms = {}
    for name, call in regimes.items():
        for _ in range(20):  # keep the card busy ahead of the short timed window
            call()
        k = kernel_ms(call, "fused_rollout_kernel", reps=10)
        ms[name] = k if k is not None else cuda_ms(call, 10)
    print(f"K3 rollout_fused kernel ms, {n_scenes} scenes x 50 steps: "
          f"{json.dumps({k: round(v, 4) for k, v in ms.items()})}", flush=True)
    return ms


def check_rollout(dev, build_log: str):
    from catgrasp_tpu_torch.ops import fused_rollout as pfr
    from catgrasp_tpu_torch.sim import engine, env_pile
    from catgrasp_tpu_torch.sim.types import index_scenes

    cfg, lib, env, states, params = bench_scene(dev, 1024)
    N, P, M = states.pos.shape[1], lib.surf_pts.shape[1], env.center.shape[0]
    S = lib.csg.types.shape[1]
    sl = slice(0, 128)
    fresh, par128 = index_scenes(states, sl), index_scenes(params, sl)
    # the reset drops the piles from 6 cm up: fall 50 steps first, so that the
    # compared steps are contact steps
    fallen = pfr.rollout_fused(states, params, lib, env, 50, dt=cfg.dt)
    st128 = index_scenes(fallen, sl)
    res = {}
    for n in (1, 5):
        res[n] = compare_rollout(pfr, "after 50 steps of fall", st128, par128, lib, env, n,
                                 cfg.dt, 50)
    k50 = pfr.rollout_fused(st128, par128, lib, env, 50, dt=cfg.dt)
    k50b = pfr.rollout_fused(st128, par128, lib, env, 50, dt=cfg.dt)
    # the plain version takes seconds a call whatever the batch (it is bound
    # by its launches), so its one 50-step call runs all 1,024 scenes and is
    # the call that is timed; the check reads the first 128 of them
    plain_out = []
    plain_ms = cuda_ms(lambda: plain_out.append(
        pfr.rollout_fused_plain(fallen, params, lib, env, 50, dt=cfg.dt)), 1, warm_up=False)
    p50 = index_scenes(plain_out[0], sl)
    torch.cuda.synchronize()
    same = all(torch.equal(getattr(k50, f), getattr(k50b, f)) for f in _STATE_FIELDS)
    act = k50.active
    zk, zp = k50.pos[..., 2][act], p50.pos[..., 2][act]
    # a body that meets the 1 cm floor at ~2 m/s (the top of a tall column)
    # passes through it, in the kernel as in the plain version: the kernel is
    # held to the plain version's set of such bodies, not to an empty one
    low_k, low_p = zk < -0.02, zp < -0.02
    mean_k, mean_p = float(zk[~low_k].mean()), float(zp[~low_p].mean())
    print(f"K3 after 50 more steps: mean z of the bodies in the bin kernel {mean_k:.5f} m, "
          f"plain {mean_p:.5f} m; bodies below -0.02 m kernel {int(low_k.sum())}, plain "
          f"{int(low_p.sum())} of {zk.numel()}, the same bodies: {torch.equal(low_k, low_p)}; "
          f"two kernel runs {'identical' if same else 'DIFFER'} bit for bit", flush=True)
    if not torch.equal(low_k, low_p) or abs(mean_k - mean_p) > 1e-3 or not same:
        fail("rollout_fused: 50-step settle (bodies below the floor, mean z within 1 mm) or "
             "determinism")

    # a batch with no contact for the whole call (the solver is skipped): the
    # first steps after the reset are free fall
    _, _, slowed = compare_rollout(pfr, "no contact", fresh, par128, lib, env, 5, cfg.dt, 5)
    if slowed != 0.0:
        fail("rollout_fused: the no-contact batch had a contact")
    # settled piles (dense contacts): the state after the entry point's 250 steps
    settled = st128
    for _ in range(4):
        settled = pfr.rollout_fused(settled, par128, lib, env, 50, dt=cfg.dt)
    for n in (1, 5):
        _, _, slowed = compare_rollout(pfr, "settled", settled, par128, lib, env, n, cfg.dt, 50)
        if slowed < 0.9:
            fail("rollout_fused: the settled batch is not at rest")
    # every body active: 10 of 10 in each scene
    gen = torch.Generator(device=dev).manual_seed(0)
    full_st, full_par = env_pile.reset_batch(gen, lib, cfg, 128, n_objects=10)
    if not bool(full_st.active.all()):
        fail("rollout_fused: the all-active batch has an inactive body")
    full_st = pfr.rollout_fused(full_st, full_par, lib, env, 50, dt=cfg.dt)
    compare_rollout(pfr, "every body active", full_st, full_par, lib, env, 5, cfg.dt, 50)

    # times and bound on the entry point's own call: 1,024 scenes x 50 steps
    call = lambda: pfr.rollout_fused(states, params, lib, env, 50, dt=cfg.dt)  # noqa: E731
    ms, wrapper_ms, how = timed(call, "fused_rollout_kernel")
    regimes = rollout_regimes(dev)
    prep_ms = cuda_ms(lambda: pfr.prepare(states, params, lib, env), 10)
    # the eager engine takes seconds a call: timed once (the plain version was
    # timed above, on the same batch 50 steps on)
    engine_ms = cuda_ms(lambda: engine.rollout_batch(states, params, lib, env, 50, dt=cfg.dt),
                        1, warm_up=False)
    ops, nbytes, cb, ce = rollout_work(pfr, lib, env, states, params, 50, 4, cfg.dt)
    bound, bound_by = bound_of(ops, nbytes)
    print(f"K3 rollout_fused 1024 scenes x {N} bodies x {P} points x {N + M} colliders, 50 "
          f"steps: kernel {ms:.4f} ms ({how}), wrapper {wrapper_ms:.4f} ms (the plain "
          f"version's per-call gathers, now part of the kernel's staging, take {prep_ms:.4f} "
          f"ms in PyTorch), plain {plain_ms:.1f} ms, eager engine "
          f"rollout_batch {engine_ms:.1f} ms, bound {bound:.4f} ms ({ops:.3e} ops, "
          f"{nbytes:.3e} bytes; {cb:.2f} body and {ce:.2f} env contacts a scene-step, "
          f"{float(states.active.float().sum(1).mean()):.2f} active bodies a scene)", flush=True)
    foot = pfr.kernel_footprint(N, P, S, M)
    regs = [ln.strip() for ln in build_log.splitlines() if "registers" in ln]
    print(f"K3 rollout_fused footprint at these shapes: {foot['threads']} threads and "
          f"{foot['smem_bytes']} bytes of shared memory a block, {foot['blocks_per_sm']} "
          f"blocks an SM (occupancy calculator); block barriers a step: 2 without a body-body "
          f"contact in the scene, else 1 + 2 x n_iter = 9; ptxas: "
          f"{regs[-1] if regs else 'not printed'}",
          flush=True)
    return {"max_abs_err": res[5][1]["pos"], "within_tol_frac": res[5][0], "ms": ms,
            "wrapper_ms": wrapper_ms, "prepare_ms": prep_ms, "timing": how,
            "plain_ms": plain_ms, "engine_ms": engine_ms, "bound_ms": bound,
            "bound_by": bound_by, "regimes_ms": regimes, "footprint": foot,
            "shapes": f"1024 scenes x {N} bodies x {P} points x {N + M} colliders, 4 slots, "
                      f"50 steps"}


# --------------------------------------------------------------------------
# the second path: the throughput entry point
# --------------------------------------------------------------------------


def march_batch(lib, states, params, K, cam, H, W, env):
    """K2 on the entry point's whole render batch, one launch: the batch
    against each scene marched alone (bit for bit), its cull lists, its
    times, and the tried tiles."""
    from catgrasp_tpu_torch.ops import render_march as rm
    from catgrasp_tpu_torch.render import raymarch
    from catgrasp_tpu_torch.sim.types import index_scenes

    o_w, d_w, _, tmax = raymarch.camera_rays(K, cam, H, W)
    kw = dict(env=env, n_steps=64, hit_eps=raymarch.HIT_EPS, hw=(H, W))
    t_b = rm.march_csg_batch(lib, states, params, o_w, d_w, tmax, **kw)
    same = all(torch.equal(t_b[b], rm.march_csg(lib, index_scenes(states, b),
                                                 index_scenes(params, b), o_w, d_w, tmax, **kw))
               for b in range(states.pos.shape[0]))
    check_cull_lists("bench path, the batch", rm, lib, states, params, o_w, d_w, (H, W))
    ms, wrapper_ms, how = timed(lambda: rm.march_csg_batch(lib, states, params, o_w, d_w, tmax,
                                                           **kw), "march_csg_kernel")
    variants = march_variants(lib, states, params, o_w, d_w, tmax, env, (H, W))
    B, P = states.pos.shape[0], d_w.shape[0]
    work = [march_work(rm, lib, index_scenes(states, b), index_scenes(params, b), o_w, d_w, tmax,
                       env, 64, raymarch.HIT_EPS, (H, W)) for b in range(B)]
    nbytes = B * P * 4 + P * 16
    bound, bound_by = bound_of(sum(w["need"] for w in work), nbytes)
    bound_strip, _ = bound_of(sum(w["strip"] for w in work), nbytes)
    print(f"K2 march_csg_batch [bench path] {B} scenes x {H}x{W}, one launch: each scene's t "
          f"equals the scene marched alone bit for bit: {same}; kernel {ms:.4f} ms ({how}), "
          f"wrapper (call to return) {wrapper_ms:.4f} ms, bound {bound:.4f} ms, {bound_by} (over "
          f"what 256-ray strips' culls keep: {bound_strip:.4f} ms); tiles, kernel "
          f"ms: {json.dumps(variants)}", flush=True)
    if not same:
        fail("march_csg_batch: a scene of the batch differs from the scene marched alone")
    return {"batch_ms": ms, "batch_wrapper_ms": wrapper_ms, "batch_bound_ms": bound,
            "batch_bound_ms_tile_cull": bound_strip, "batch_variants_ms": variants}


def bench_path(dev):
    """``catgrasp_tpu_torch.bench`` once at its own sizes, with every launch
    count set to 0 just before and read just after."""
    from catgrasp_tpu_torch import bench
    from catgrasp_tpu_torch.ops import collision, fused_rollout, render_march
    from catgrasp_tpu_torch.sim.types import index_scenes

    counters = {"box_hits": collision.box_hits, "march_csg": render_march.march_csg,
                "rollout_fused": fused_rollout.rollout_fused}
    for fn in counters.values():
        fn.launches = 0
    keep = {}
    t0 = time.perf_counter()
    record = bench.run(dev, keep=keep)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"bench path ({time.perf_counter() - t0:.2f} s): {json.dumps(record)}", flush=True)
    print(f"bench path launches: {json.dumps(launches)}", flush=True)
    if launches != {"box_hits": 9, "march_csg": 9, "rollout_fused": 5}:
        fail(f"bench path launches {launches}: expected 5 K3 calls (1 warm-up + 4), 9 K1 calls "
             f"and 9 K2 calls (one a batch of 8 frames)")
    rates = [record["value"], *record["extra"].values()]
    if not all(np.isfinite(r) and r > 0 for r in rates):
        fail(f"bench path rates not finite and positive: {rates}")
    first, last = keep["env_first"], keep["env_last"]
    act = last.active
    if last.pos.shape != (1024, 10, 3) or not all(
            torch.isfinite(getattr(last, f)).all() for f in _STATE_FIELDS):
        fail("bench path: env state has the wrong shape or non-finite values")
    z_end = last.pos[..., 2][act]
    inside = z_end > -0.02  # the rest met the floor too fast and passed through it
    z0, z1 = float(first.pos[..., 2][act].mean()), float(z_end[inside].mean())
    qn = torch.linalg.vector_norm(last.quat, dim=-1)
    speed = float(torch.linalg.vector_norm(last.linvel, dim=-1)[act][inside].mean())
    still = bool(torch.equal(last.pos[~act], first.pos[~act]))
    print(f"bench path env state after 250 steps: {float(inside.float().mean()):.4f} of "
          f"{z_end.numel()} active bodies in the bin, their mean z {z0:.4f} -> {z1:.4f} m and "
          f"mean speed {speed:.4f} m/s, |quat| in [{float(qn.min()):.6f}, "
          f"{float(qn.max()):.6f}], inactive bodies untouched: {still}", flush=True)
    if not (float(inside.float().mean()) > 0.97 and 0.0 < z1 < 0.06 and speed < 0.3 and still
            and float((qn - 1).abs().max()) < 1e-3):
        fail("bench path: the piles did not settle into the bin")
    hits, ok, frames = keep["hits"], keep["ik_ok"], keep["frames"]
    if hits.shape != (131072, 7) or not 0 < int(hits.sum()) < hits.numel():
        fail("bench path: collision gate output")
    if ok.shape != (65536,) or not 0 < int(ok.sum()) < ok.numel():
        fail("bench path: IK gate output")
    if frames["depth"].shape != (8, 384, 512) or not all(
            torch.isfinite(v.float()).all() for v in frames.values()) \
            or not (frames["seg"] >= 0).any():
        fail("bench path: render output")
    # K1 and K2 at this path's own shapes: what the path computed, against the
    # plain versions on the path's inputs
    t_inv, cloud, mask, boxes, offsets, margin = keep["gate_inputs"]
    k1 = measure_box_hits("bench path", collision, t_inv, cloud, mask, boxes, offsets, (0.0,),
                          margin, hit_k=hits[:, None, :])
    lib, states, params, K, cam, H, W, env = keep["render_inputs"]
    n_active = states.active.sum(dim=1)
    k2 = None
    for b in dict.fromkeys([int(n_active.argmax()), int(n_active.argmin())]):
        one = check_march(f"bench path, scene {b}", lib, index_scenes(states, b),
                          index_scenes(params, b), K, cam, H, W, env,
                          frame={k: v[b] for k, v in frames.items()})
        k2 = one if k2 is None else k2  # the fullest scene's numbers are the ones kept
    k2.update(march_batch(lib, states, params, K, cam, H, W, env))
    k1_bound, k1_by = bound_of(k1["ops"], k1["bytes"])
    at_bench = {
        "box_hits": {"shapes": "P=131072, C=2048, K=3 open boxes, A=7, margin 0",
                     "mismatch_frac": k1["n_diff"] / k1["n_entries"], "ms": k1["ms"],
                     "wrapper_ms": k1["wrapper_ms"], "plain_ms": k1["plain_ms"],
                     "bound_ms": k1_bound, "bound_by": k1_by,
                     "lane_use_warp": k1["lane_use_warp"],
                     "lane_use_block": k1["lane_use_block"]},
        "march_csg": {k: k2[k] for k in ("shapes", "max_abs_err", "ms", "wrapper_ms", "plain_ms",
                                         "bound_ms", "bound_by", "bound_ms_tile_cull",
                                         "bound_ms_square_tile_cull", "batch_ms",
                                         "batch_wrapper_ms", "batch_bound_ms",
                                         "batch_bound_ms_tile_cull", "batch_variants_ms")},
    }
    return launches, at_bench


# --------------------------------------------------------------------------
# the main path
# --------------------------------------------------------------------------


def main_path(dev):
    from catgrasp_tpu_torch.ops import collision, fused_rollout, render_march
    from catgrasp_tpu_torch.pipelines import run_grasp_simulation as rgs

    collision.box_hits.launches = 0
    render_march.march_csg.launches = 0
    fused_rollout.rollout_fused.launches = 0
    t0 = time.perf_counter()
    scene = rgs.setup_scene("nut", n_objects=5, render_hw=(384, 512), device=dev)
    torch.cuda.synchronize()
    times = {"setup_s": time.perf_counter() - t0}
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    state, params = rgs.make_round_pile(scene, rng, gen, settle_steps=500, timings=times)
    res = rgs.attempt_front(scene, state, params, rng, gen, timings=times)
    tried = [t["cone"] | {"seg": t["seg"]} for t in res.tried]
    torch.cuda.synchronize()
    launches = {"box_hits": collision.box_hits.launches,
                "march_csg": render_march.march_csg.launches,
                "rollout_fused": fused_rollout.rollout_fused.launches}
    times["total_s"] = time.perf_counter() - t0
    print("main path stage times (s, synchronised): "
          + json.dumps({k: round(v, 6) for k, v in times.items()}), flush=True)
    print(f"main path launches: {json.dumps(launches)}; bodies active after settle "
          f"{state.active.int().tolist()}; segments tried {len(tried)}", flush=True)
    for t in tried:
        s = t["stats"]
        print(f"  segment {t['seg']}: G={t['n_candidates']} candidates, {t['n_valid']} valid, "
              f"fstats {json.dumps(s)}", flush=True)
        total = s["n_approach_dir_rej"] + s["n_ik_rej"] + s["n_collision_rej"] + t["n_valid"]
        if total != t["n_candidates"]:
            fail(f"filter counters sum to {total}, not G={t['n_candidates']}")
    if not tried:
        fail("no segment was large enough to sample")
    if res.found is None:
        fail("no segment yielded grasp candidates")
    if tried[-1]["n_candidates"] != N_POSES:
        fail(f"G={tried[-1]['n_candidates']}, expected {N_POSES}")
    print(f"K1 box_hits launches a filter call: "
          f"{launches['box_hits'] / max(len(tried), 1):g}", flush=True)
    if launches["box_hits"] != 2 * len(tried):
        fail(f"box_hits launched {launches['box_hits']} times for {len(tried)} filter calls")
    if launches["march_csg"] != 1:
        fail(f"march_csg launched {launches['march_csg']} times for one render, expected 1")
    s = tried[-1]["stats"]
    print(f"filter counters of the last segment: {s['n_approach_dir_rej']:,} / {s['n_ik_rej']:,} / "
          f"{s['n_collision_rej']:,} rejected (approach, IK, collision), "
          f"{tried[-1]['n_valid']:,} valid of {tried[-1]['n_candidates']:,} (with the "
          f"256-ray strip cull on this settled pile: 17,710 / 51,213 / 163,699 rejected, 22,226 "
          f"valid)", flush=True)
    if launches["rollout_fused"] != 0:
        fail("the eval's settle runs the engine, not rollout_fused")
    out = res.out
    if out["depth"].shape != (384, 512) or not all(torch.isfinite(v).all() for v in out.values()):
        fail("render output has the wrong shape or non-finite values")
    if not np.isfinite(res.found.grasps_cam).all():
        fail("non-finite candidate poses")
    print(f"candidates: {len(res.found.grasps_cam)} grasps on body {res.found.target} "
          f"(fstats {json.dumps(tried[-1]['stats'])})", flush=True)
    return scene, state, params, launches, times


# --------------------------------------------------------------------------
# the pick-and-place path: one round of the closed-loop eval
# --------------------------------------------------------------------------

PICKPLACE_STAGES = ("setup_s", "settle_s", "render_s", "occupancy_s", "sample_filter_s", "nocs_filter_s",
                    "scoring_s", "pick_planning_s", "pick_execution_s", "place_planning_s",
                    "place_execution_s", "resettle_s")
# learned perception's own stages (scoring_s includes grasp_net_s)
NET_STAGES = ("seg_net_s", "meanshift_s", "nocs_net_s", "ransac_s", "grasp_net_s")


def eval_round(dev, label: str, cls: str = "nut", n_objects: int = 8, max_attempts: int = 2,
               hold: bool = True, **kw):
    """One round of ``simulate_grasp_rounds`` at full width (the class's
    canonical and its NOCS-transfer sampler, ``n_objects`` objects, at most
    ``max_attempts`` attempts; ``kw`` picks the mode), with every launch
    count set to 0 just before and read just after; the tallies, each
    attempt's outcome and the stage times from its event log and timings.
    With ``hold``, K1's two launches of the last NOCS-transfer filter call
    and the last render (one K2 launch) are recorded, then held against the
    plain versions, timed and bounded on those inputs.  Returns the launch
    counts and a record of the round (with ``k1`` and ``k2`` when held)."""
    import tempfile

    from catgrasp_tpu_torch.core.symmetry import get_symmetry_tfs
    from catgrasp_tpu_torch.ops import collision, fused_rollout, render_march
    from catgrasp_tpu_torch.pipelines import run_grasp_simulation as rgs
    from catgrasp_tpu_torch.render import raymarch

    canonical = dict(np.load(os.path.join(REPO, "dataset", f"{cls}_canonical.npz")))
    n_codebook = int((canonical["canonical_grasp_scores"] >= 0.95).sum())
    n_nocs = n_codebook * len(get_symmetry_tfs(cls))  # the codebook x the symmetries
    nocs_calls, entry = [], collision.box_hits_depths

    def recorder(*args):
        hit = entry(*args)
        if args[0].shape[0] == n_nocs:
            nocs_calls[:] = (nocs_calls + [(args, hit)])[-2:]
        return hit

    renders, render = [], raymarch.render

    def render_recorder(*args, **kw):
        out = render(*args, **kw)
        renders[:] = [(args, kw, out)]
        return out

    metrics = os.path.join(tempfile.mkdtemp(), "eval.jsonl")
    timings = {}
    collision.box_hits_depths = recorder
    raymarch.render = render_recorder
    collision.box_hits.launches = 0
    render_march.march_csg.launches = 0
    fused_rollout.rollout_fused.launches = 0
    t0 = time.perf_counter()
    try:
        c = rgs.simulate_grasp_rounds(cls, n_rounds=1, n_objects=n_objects, seed=0,
                                      max_attempts_per_round=max_attempts, canonical=canonical,
                                      metrics_path=metrics, device=dev, timings=timings, **kw)
        torch.cuda.synchronize()
    finally:
        collision.box_hits_depths = entry
        raymarch.render = render
    wall = time.perf_counter() - t0
    launches = {"box_hits": collision.box_hits.launches,
                "march_csg": render_march.march_csg.launches,
                "rollout_fused": fused_rollout.rollout_fused.launches}
    with open(metrics) as fh:
        events = [json.loads(line) for line in fh]
    tally = {k: getattr(c, k) for k in ("num_objects", "num_attempts", "num_stable_grasp",
                                        "num_task_grasp_succ")}
    attempts = [{k: e[k] for k in ("attempt", "target", "n_candidates", "picked", "placed",
                                   "p_T_G")} for e in events if e["kind"] == "attempt"]
    filters = [e for e in events if e["kind"] == "filter"]
    stage = {k: round(timings.get(k, 0.0), 4) for k in PICKPLACE_STAGES + NET_STAGES
             if k in timings}
    print(f"{label} tallies: {json.dumps(tally)}", flush=True)
    for a in attempts:
        print(f"  attempt {json.dumps(a)}", flush=True)
    print(f"{label} stage times (s, synchronised, summed over the round): "
          f"{json.dumps(stage)}; wall {wall:.2f} s", flush=True)
    print(f"{label} launches: {json.dumps(launches)}; segments filtered "
          f"{len(filters)} (K1 4 launches each: cone and NOCS-transfer gates)", flush=True)
    if not (c.num_task_grasp_succ <= c.num_stable_grasp <= c.num_attempts <= max_attempts
            and 0 < c.num_objects <= n_objects):
        fail(f"{label}: inconsistent tallies {tally}")
    if c.num_attempts < 1 or len(attempts) != c.num_attempts:
        fail(f"{label}: the round made {c.num_attempts} attempts ({len(attempts)} attempt "
             f"events): the pick was not driven")
    if events[-2]["kind"] != "tally" or any(events[-2][k] != v for k, v in tally.items()):
        fail(f"{label}: the event log's tally disagrees with the returned tallies")
    if launches["box_hits"] != 4 * len(filters) or not filters:
        fail(f"{label}: box_hits launched {launches['box_hits']} times for {len(filters)} "
             f"segments filtered by both samplers (4 each)")
    renders_expected = (0, 0) if kw.get("obj_path") else (1, max_attempts)
    if not renders_expected[0] <= launches["march_csg"] <= renders_expected[1]:
        fail(f"{label}: march_csg launched {launches['march_csg']} times, expected "
             f"{renders_expected[0]} to {renders_expected[1]} (one a CSG render)")
    if launches["rollout_fused"] != 0:
        fail(f"{label}: the eval settles with the engine, not rollout_fused")
    out = {"tally": tally, "attempts": attempts, "stage_s": stage, "wall_s": wall,
           "launches": launches, "segments_filtered": len(filters), "render": renders[-1]}
    if not hold:
        return launches, out
    if len(nocs_calls) != 2:
        fail(f"{label}: recorded {len(nocs_calls)} K1 launches at the NOCS gate's P={n_nocs}")
    parts = [measure_box_hits(f"{label}, NOCS gate, {name}", collision, *args, hit_k=hit)
             for name, (args, hit) in zip(("open gripper", "closing volume"), nocs_calls)]
    gate = add_up(parts)
    bound, bound_by = bound_of(gate["ops"], gate["bytes"])
    print(f"K1 box_hits, the whole NOCS-transfer gate of one filter call on the {label}'s own "
          f"inputs (P={n_nocs}, 2 launches, 4 depths each): {gate['n_diff']} of "
          f"{gate['n_entries']} entries differ; kernel {gate['ms']:.4f} ms, wrappers "
          f"{gate['wrapper_ms']:.4f} ms, plain {gate['plain_ms']:.3f} ms (peak memory "
          f"{gate['plain_peak_mib']:.1f} MiB), bound {bound:.4f} ms ({bound_by})", flush=True)
    gate.update(bound_ms=bound, bound_by=bound_by, P=n_nocs)
    # K2 on the round's last render: the frame it made through the kernel
    # against the plain march's on the same scene and rays
    (lib, state, params, K, cam, H, W), rkw, frame = renders[-1]
    k2 = check_march(label, lib, state, params, K, cam, H, W, rkw["env"], frame=frame)
    out.update(k1=gate, k2=k2)
    return launches, out


def nocs_gate_row(label: str, cls: str, gate: dict) -> dict:
    return {"shapes": f"the NOCS-transfer gate of one filter call on the {label}'s own inputs "
                      f"({cls}): P={gate['P']}; the segment's collision subsample, at most 512 "
                      f"points (3 open boxes), and the background cloud, at most 4,096 "
                      f"(closing box); A=7, D=4",
            "mismatch_frac": gate["n_diff"] / gate["n_entries"], "ms": gate["ms"],
            "wrapper_ms": gate["wrapper_ms"], "plain_ms": gate["plain_ms"],
            "plain_peak_mib": gate["plain_peak_mib"], "bound_ms": gate["bound_ms"],
            "bound_by": gate["bound_by"]}


def pickplace_path(dev):
    """The nut round: at most 2 attempts on 8 nuts, seed 0.  Its outcome
    has been attempt 0 closing on air and attempt 1 picked and placed in
    every run on the card; it is printed beside that.  Returns (launches, K1
    at the NOCS gate, K2 on the round's frame)."""
    launches, out = eval_round(dev, "pick-and-place path", "nut", 8, 2)
    outcome = [(a["picked"], a["placed"]) for a in out["attempts"]]
    print(f"pick-and-place path outcome {outcome}: attempt 0 on air and attempt 1 picked and "
          f"placed, as in every earlier run: {outcome == [(False, False), (True, True)]}",
          flush=True)
    return launches, out["k1"], out["k2"]


def floating_waits(scene, state, params) -> None:
    """``no_host_waits`` over the floating baseline's two executors on the
    main path's pile: ``execute_pick`` (10 close, 10 hold steps) over the
    first body, and ``place_and_drop`` of that body (a 60-step drop)."""
    from catgrasp_tpu_torch.core import transforms as tf
    from catgrasp_tpu_torch.pipelines import run_grasp_simulation as rgs
    from catgrasp_tpu_torch.sim import env_semantic as es

    dev = state.pos.device
    G = torch.eye(4, device=dev)
    G[:3, :3] = torch.tensor([[0.0, 1, 0], [0, 0, -1], [-1, 0, 0]], device=dev)
    G[:3, 3] = state.pos[0] + torch.tensor([0.0, 0.0, 0.02], device=dev)
    steps = rgs.CLOSE_STEPS, rgs.LIFT_STEPS
    rgs.CLOSE_STEPS, rgs.LIFT_STEPS = 10, 10
    try:
        no_host_waits("the floating pick executor: 10 close, 10 hold steps",
                      lambda: rgs.execute_pick(scene.lib, state, params, scene.env_bin, 0, G,
                                               scene.gripper.spec))
    finally:
        rgs.CLOSE_STEPS, rgs.LIFT_STEPS = steps
    oig = tf.pose_inverse(G) @ tf.pose_from_qt(state.quat[0], state.pos[0])
    width = torch.full((), 0.02, device=dev)
    no_host_waits("the floating place: place_and_drop, 8 waypoints and a 60-step drop",
                  lambda: es.place_and_drop(scene.lib, params.shape_id[0], scene.fixture_idx,
                                            params.scale[0], tf.pose_inverse(oig),
                                            scene.class_name, width, scene.gripper.spec))


def grid_round(dev):
    """The ``--obj_path`` path: one round of 4 demo nuts (baked grids, the
    grid narrowphase and march), one attempt, through ``eval_round``; then
    the bake's time, the grid render's time on the round's last frame, and
    one grid engine step's time, launches and device-busy share on that
    pile."""
    from catgrasp_tpu_torch.geom import sdf
    from catgrasp_tpu_torch.geom.mesh import TriMesh
    from catgrasp_tpu_torch.geom import primitives as prim
    from catgrasp_tpu_torch.render import raymarch
    from catgrasp_tpu_torch.sim import engine

    obj = os.path.join(REPO, "assets", "nut_demo.obj")
    launches, out = eval_round(dev, "grid round", "nut", 4, 1, hold=False, obj_path=obj)
    (lib, state, params, K, cam, H, W), rkw, frame = out["render"]
    if rkw.get("geometry") != "grid" or lib.sdf_values is None:
        fail("grid round: the render did not run on the baked grids")
    if not all(torch.isfinite(v.float()).all() for v in frame.values()) \
            or not (frame["seg"] >= 0).any():
        fail("grid round: render output")
    meshes = [TriMesh.load_obj(obj), prim.place_fixture("nut", None)]
    bake_ms = cuda_ms(lambda: [sdf.bake_sdf(m.vertices, m.faces, dims=56, padding=0.003,
                                            device=dev) for m in meshes], 3)
    render_ms = cuda_ms(lambda: raymarch.render(lib, state, params, K, cam, H, W, **rkw), 5)
    env = rkw["env"]
    step = lambda: engine.step(state, params, lib, env, narrowphase="grid")  # noqa: E731
    step_ms = cuda_ms(step, 20)
    csg_step_ms = cuda_ms(lambda: engine.step(state, params, lib, env), 20)
    print(f"grid round: bake of the demo nut and the fixture at 56^3 {bake_ms:.3f} ms "
          f"({', '.join(str(len(m.faces)) for m in meshes)} faces); the grid render at "
          f"{H}x{W} {render_ms:.3f} ms (plain PyTorch march, 0 K2 launches); one grid engine "
          f"step {step_ms:.3f} ms (the CSG step on the same pile, bounding-box placeholder "
          f"trees: {csg_step_ms:.3f} ms)", flush=True)
    device_profile("one grid engine step", step, step_ms / 1e3)
    out.update(bake_ms=bake_ms, render_ms=render_ms, step_ms=step_ms)
    return launches, out


def segnet_macs(grid_dims, n_pts: int, base: int = 16, c_in: int = 4) -> float:
    """Multiply-adds of one SegNet forward (``nn/voxelnet.py``): the five
    ConvBlocks (two 3x3x3 convs each) at their grid sizes, the two 2x2x2
    transposed convs, and the per-point head."""
    v1 = float(np.prod(grid_dims))
    v2, v3 = v1 / 8, v1 / 64
    blocks = ((v1, c_in, base), (v2, base, 2 * base), (v3, 2 * base, 4 * base),
              (v2, 4 * base, 2 * base), (v1, 2 * base, base))
    macs = sum(v * 27 * (ci * co + co * co) for v, ci, co in blocks)
    macs += v3 * 8 * 4 * base * 2 * base + v2 * 8 * 2 * base * base
    return macs + n_pts * ((3 + 3 + base) * 64 + 64 * 64 + 64 * 4)


def pointnet_macs(n_clouds: int, n_pts: int, seg_head: bool, n_out: int, c_in: int = 6) -> float:
    """Multiply-adds of one PointNetCls / PointNetSeg forward
    (``nn/pointnet.py``) on ``n_clouds`` clouds of ``n_pts`` points: per
    point the two STNs' shared MLPs, the transforms, the encoder's MLPs and
    (segmentation) the per-point head; per cloud the STNs' pooled heads and
    (classification) the cloud's head."""
    per_pt = (c_in + 64) * 64 + 2 * (64 * 128 + 128 * 1024)  # the STNs' MLPs
    per_pt += 3 * 3 + 64 * 64 + c_in * 64 + 64 * 128 + 128 * 1024
    per_cloud = 2 * (1024 * 512 + 512 * 256) + 256 * (3 * 3 + 64 * 64)
    if seg_head:
        per_pt += 1088 * 512 + 512 * 256 + 256 * 128 + 128 * n_out
    else:
        per_cloud += 1024 * 512 + 512 * 256 + 256 * n_out
    return float(n_clouds) * (n_pts * per_pt + per_cloud)


def learned_round(dev):
    """The learned round: the nut nets loaded by the port's reader, one
    round of the eval in learned perception through ``eval_round`` (K1 and
    K2 held on its own gate and frame), the nets' stage times; then each
    net's device time a call at full width on the round's own inputs, and
    the seg net's card forward against the same module on the CPU.
    Returns (launches, the round's record, the nets' record)."""
    import copy

    from catgrasp_tpu_torch.predict import predicter
    from catgrasp_tpu_torch.predict.artifacts import load_predicters

    t0 = time.perf_counter()
    nets = load_predicters(os.path.join(REPO, "artifacts_tracked", "nut"), "nut", device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if sorted(nets) != ["grasp", "nocs", "seg"]:
        fail(f"learned round: loaded the roles {sorted(nets)}, not grasp, nocs and seg")
    print(f"learned round: loaded {sorted(nets)} from artifacts_tracked/nut in {load_s:.2f} s "
          f"(seg voxel {nets['seg'].model.voxel_size} m, grid {nets['seg'].model.grid_dims}, "
          f"{nets['seg'].n_pts} points; NUNOCS {nets['nocs'].n_pts} points x 3 x "
          f"{nets['nocs'].n_bins} bins; grasp {nets['grasp'].n_pts} points, batches of "
          f"{nets['grasp'].batch})", flush=True)
    inputs, calls = {}, {r: 0 for r in nets}

    def keep(role):
        def hook(module, args):
            inputs[role] = args
            calls[role] += 1
        return hook

    hooks = [nets[r].model.register_forward_pre_hook(keep(r)) for r in nets]
    post = {"meanshift": predicter.mean_shift, "ransac": predicter.estimate_9d_transform}

    def recording(name):
        def call(*args, **kw):
            inputs[name] = (args, kw)
            return post[name](*args, **kw)
        return call

    predicter.mean_shift, predicter.estimate_9d_transform = (recording(k) for k in post)
    try:
        launches, out = eval_round(dev, "learned round", "nut", 8, 2, oracle=False, predicters=nets)
    finally:
        for h in hooks:
            h.remove()
        predicter.mean_shift, predicter.estimate_9d_transform = post.values()
    missing = [k for k in NET_STAGES if not out["stage_s"].get(k, 0.0) > 0]
    if missing or not all(calls.values()):
        fail(f"learned round: the nets did not all run (net calls {calls}, no time in {missing})")
    print(f"learned round: net calls {json.dumps(calls)}", flush=True)

    rec = {"load_s": load_s, "calls": calls}
    with torch.inference_mode():
        seg = nets["seg"].model
        xyz, nrm, origin = inputs["seg"]
        seg_ms = cuda_ms(lambda: seg(xyz, nrm, origin), 10)
        nocs_in = inputs["nocs"][0]
        nocs_ms = cuda_ms(lambda: nets["nocs"].model(nocs_in), 10)
        g_in = inputs["grasp"][0]  # the round's last batch (at most 128 candidates)
        full = g_in.repeat((-(-nets["grasp"].batch // len(g_in)), 1, 1))[:nets["grasp"].batch]
        grasp_round_ms = cuda_ms(lambda: nets["grasp"].model(g_in), 5)
        grasp_ms = cuda_ms(lambda: nets["grasp"].model(full), 5)
        # the post-processing on the round's own inputs: the last MeanShift
        # (seeds x points) and the last RANSAC fit (1,000 hypotheses)
        for name, what in (("meanshift", "MeanShift of the shifted points"),
                           ("ransac", "RANSAC 9D fit, 1,000 hypotheses")):
            args, kw = inputs[name]
            rec[name] = {"ms": cuda_ms(lambda: post[name](*args, **kw), 10),
                         "shapes": f"{what}, {len(args[0])} points"}
            print(f"{name}: {rec[name]['ms']:.3f} ms a call ({rec[name]['shapes']})", flush=True)
        for name, ms, macs, peak, shape in (
                ("seg", seg_ms, segnet_macs(seg.grid_dims, len(xyz)), BF16_OPS_PER_S,
                 f"{len(xyz)} points, grid {'x'.join(map(str, seg.grid_dims))}, bf16 convs"),
                ("nocs", nocs_ms, pointnet_macs(1, nocs_in.shape[1], True, 300), F32_OPS_PER_S,
                 f"1 x {nocs_in.shape[1]} points, f32"),
                ("grasp", grasp_ms, pointnet_macs(len(full), full.shape[1], False, 10),
                 F32_OPS_PER_S, f"{len(full)} x {full.shape[1]} points, f32"),
                ("grasp_round_batch", grasp_round_ms,
                 pointnet_macs(len(g_in), g_in.shape[1], False, 10), F32_OPS_PER_S,
                 f"{len(g_in)} x {g_in.shape[1]} points, f32")):
            bound = 2 * macs / peak * 1e3
            rec[name] = {"ms": ms, "gmacs": macs / 1e9, "bound_ms": bound, "shapes": shape}
            print(f"net {name}: {ms:.3f} ms a call ({shape}), {macs / 1e9:.2f} G multiply-adds, "
                  f"{2 * macs / ms / 1e9:.1f} TFLOP/s, bound {bound:.4f} ms at the "
                  f"{'bf16' if peak == BF16_OPS_PER_S else 'f32'} peak", flush=True)
        # the card's bf16 forward against the same module on the CPU
        og, bg = seg(xyz, nrm, origin)
        oc, bc = copy.deepcopy(seg).cpu()(xyz.cpu(), nrm.cpu(), origin.cpu())
    d = (og.cpu() - oc).abs().flatten()
    d_max, d_99 = float(d.max()), float(torch.quantile(d, 0.99))
    signs = float(((bg.cpu() > 0) == (bc > 0)).float().mean())
    print(f"seg net, card against CPU on the learned round's cloud ({len(xyz)} points): offsets "
          f"max {d_max:.2e} m, 99th percentile {d_99:.2e} m (tolerance 2e-3, 5e-4); objectness "
          f"signs agree on {signs:.6f} (tolerance >= 0.995)", flush=True)
    if not (torch.isfinite(og).all() and torch.isfinite(bg).all()):
        fail("learned round: the seg net's card output is not finite")
    if d_max > 2e-3 or d_99 > 5e-4 or signs < 0.995:
        fail("learned round: the seg net on the card disagrees with its CPU forward")
    rec["seg_vs_cpu"] = {"max_abs_err": d_max, "p99_abs_err": d_99, "sign_agree": signs}
    return launches, out, rec


# --------------------------------------------------------------------------
# grasp-DB generation
# --------------------------------------------------------------------------


def grasp_db_phase(dev):
    """Grasp-DB generation at full width: one nut instance through
    ``generate_complete_grasps`` at ``config_grasp.yml``'s settings (200
    surface points, 42,700 cone poses through the filter, up to 4,096
    candidates x 50 perturbations in chunks of 256 grasps) with every launch
    count set to 0 just before and read just after; K1 held on that gate's
    recorded inputs; 20 rollout steps of one chunk profiled; the stored
    ``nut_train_0`` DB's drift-probe subsample re-scored and held against
    its stored scores; one grid chunk on ``assets/nut_demo.obj``, run twice
    to show a DB is deterministic.  Returns (launches, record)."""
    from catgrasp_tpu_torch.config.loader import load_config
    from catgrasp_tpu_torch.core import transforms as tf
    from catgrasp_tpu_torch.geom import csg, primitives
    from catgrasp_tpu_torch.grasp.gripper import Gripper
    from catgrasp_tpu_torch.ops import collision, fused_rollout, render_march
    from catgrasp_tpu_torch.pipelines import generate_grasp as pgg
    from catgrasp_tpu_torch.pipelines import rescore_grasp_db as rdb
    from catgrasp_tpu_torch.sim import env_grasp as eg
    from catgrasp_tpu_torch.sim.types import build_shape_lib

    cfg, gripper = load_config("config_grasp.yml"), Gripper.default()
    bins = np.array(cfg["classes"])
    trials = int(cfg["perturbation_trials"])
    calls, entry = [], collision.box_hits_depths

    def recorder(*args):
        calls.append((args, entry(*args)))
        return calls[-1][1]

    collision.box_hits_depths = recorder
    collision.box_hits.launches = 0
    render_march.march_csg.launches = 0
    fused_rollout.rollout_fused.launches = 0
    info = {}
    t0 = time.perf_counter()
    try:
        db = pgg.generate_complete_grasps("nut", "train", 0, gripper, cfg, device=dev, info=info)
        torch.cuda.synchronize()
    finally:
        collision.box_hits_depths = entry
    wall = time.perf_counter() - t0
    launches = {"box_hits": collision.box_hits.launches,
                "march_csg": render_march.march_csg.launches,
                "rollout_fused": fused_rollout.rollout_fused.launches}
    scores, n = db["scores"], len(db["scores"])
    hist = np.histogram(scores, bins)[0].tolist()
    bal = pgg.balance_score_bins(db, bins, int(cfg["max_per_score_bin"]))
    n_poses = int(calls[0][0][0].shape[0]) if calls else 0
    stats = info["stats"]
    rollouts_s = n * trials / info["scoring_s"]
    print(f"grasp DB, nut/train/0 at full width: {n_poses:,} cone poses filtered, counters "
          f"{json.dumps(stats)}, {n:,} candidates scored x {trials} trials; score mean "
          f"{scores.mean():.4f}, bins {hist}, balanced DB {len(bal['scores']):,}; wall "
          f"{wall:.2f} s = sampling + filter {info['sample_filter_s']:.3f} s + scoring "
          f"{info['scoring_s']:.3f} s ({rollouts_s:,.1f} rollouts/s of "
          f"{eg.N_CLOSE_STEPS + eg.N_SHAKE_STEPS} steps)", flush=True)
    print(f"grasp DB launches: {json.dumps(launches)}", flush=True)
    if launches != {"box_hits": 2, "march_csg": 0, "rollout_fused": 0} or len(calls) != 2:
        fail(f"grasp DB: launches {launches}, {len(calls)} K1 calls recorded: expected the "
             f"filter's 2 K1 launches and nothing else")
    if n_poses != 42_700:
        fail(f"grasp DB: {n_poses} cone poses, expected 100 x 61 x 7 = 42,700")
    if db["grasp_poses"].shape != (n, 4, 4) or not 0 < n <= 4096 \
            or not np.isfinite(db["grasp_poses"]).all() \
            or not (np.isfinite(scores).all() and 0 <= scores.min() <= scores.max() <= 1):
        fail("grasp DB: candidate poses or scores out of shape or range")
    if not 0.3 < scores.mean() < 0.9:
        fail(f"grasp DB: score mean {scores.mean():.4f}, JAX's 12 nut DBs lie in 0.50-0.76")

    # K1 on the gate's own inputs: the object cloud against the 3 open boxes
    # and the point at infinity against the closing box
    parts = [measure_box_hits(f"grasp DB gate, {name}", collision, *args, hit_k=hit)
             for name, (args, hit) in zip(("open gripper", "closing volume"), calls)]
    gate = add_up(parts)
    bound, bound_by = bound_of(gate["ops"], gate["bytes"])
    gate.update(bound_ms=bound, bound_by=bound_by, P=n_poses)
    print(f"K1 box_hits, the grasp DB's whole gate (P={n_poses}, C=200 and C=1, A=7, D=1, 2 "
          f"launches): {gate['n_diff']} of {gate['n_entries']} entries differ; kernel "
          f"{gate['ms']:.4f} ms, wrappers {gate['wrapper_ms']:.4f} ms, plain "
          f"{gate['plain_ms']:.3f} ms, bound {bound:.4f} ms ({bound_by})", flush=True)

    # 20 rollout steps of one chunk (256 grasps x 50 perturbations): wall,
    # launches a step and the device's busy share
    lib = build_shape_lib([primitives.make_instance("nut", "train", 0)],
                          [csg.make_csg_instance("nut", "train", 0)], n_surf=64, seed=0,
                          device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    chunk = torch.from_numpy(db["grasp_poses"][:256]).to(dev)
    offsets = tf.random_uniform_magnitude(gen, 0.005, 10.0, shape=(len(chunk), trials))
    perturbed = torch.einsum("gij,gtjk->gtik", chunk, offsets)
    params, carry, _ = eg.grasp_rollout_start(lib, 0, 1.0, perturbed, gripper.spec)

    def steps():
        return eg.grasp_rollout_steps(lib, params, perturbed, carry, range(20),
                                      eg.N_CLOSE_STEPS, gripper.spec)

    steps()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    steps()
    torch.cuda.synchronize()
    steps_s = time.perf_counter() - t1
    print(f"grasp DB: 20 closing steps of a {perturbed.shape[0]} x {perturbed.shape[1]} "
          f"rollout batch {steps_s * 1e3:.1f} ms ({steps_s / 20 * 1e3:.2f} ms a step)",
          flush=True)
    busy = device_profile(f"20 grasp-rollout steps of {perturbed.shape[0] * trials} scenes",
                          steps, steps_s)
    print(f"grasp DB: {busy['launches'] / 20:.1f} launches a rollout step (the closing law, "
          f"the gripper env and the engine step)", flush=True)
    no_host_waits("5 grasp-rollout steps of a chunk",
                  lambda: eg.grasp_rollout_steps(lib, params, perturbed, carry, range(48, 53),
                                                 eg.N_CLOSE_STEPS, gripper.spec))

    # the same candidates as JAX's drift probe: nut_train_0's stored v3 DB
    db_path = os.path.join("dataset", "grasps", "nut_train_0_complete_grasp.npz")
    _, _, stored, fresh, rescore_s = rdb.rescore(os.path.join(REPO, db_path), 256, trials,
                                                 device=dev)
    row = rdb.drift_row(db_path, stored, fresh, trials, rescore_s)
    print(f"grasp DB rescore of nut_train_0's 256 drift-probe poses x {trials} trials (one "
          f"chunk, {rescore_s:.2f} s): Spearman {row['spearman']:.4f}, mean |diff| "
          f"{row['mean_abs_diff']:.4f}, means stored {row['stored_mean']:.4f} fresh "
          f"{row['fresh_mean']:.4f} (JAX re-scoring the same poses: 0.9663, 0.0436, 0.6767 / "
          f"0.6797; limits >= 0.90, <= 0.07, within 0.03)", flush=True)
    if row["spearman"] < 0.90 or row["mean_abs_diff"] > 0.07 \
            or abs(row["fresh_mean"] - row["stored_mean"]) > 0.03:
        fail("grasp DB: the rescore of nut_train_0 disagrees with its stored v3 scores")

    # one grid chunk on the demo mesh, twice: K1 launches, time, determinism
    obj = os.path.join(REPO, "assets", "nut_demo.obj")
    grid = []
    for _ in range(2):
        collision.box_hits.launches = 0
        ginfo = {}
        t2 = time.perf_counter()
        g = pgg.generate_complete_grasps("nut", "train", 0, gripper, cfg, max_candidates=256,
                                         obj_path=obj, device=dev, info=ginfo)
        torch.cuda.synchronize()
        grid.append((g, time.perf_counter() - t2, collision.box_hits.launches, ginfo))
    (g, grid_s, grid_k1, ginfo), (g2, *_) = grid
    same = bool(np.array_equal(g["grasp_poses"], g2["grasp_poses"])
                and np.array_equal(g["scores"], g2["scores"]))
    print(f"grasp DB grid chunk on assets/nut_demo.obj ({len(g['scores'])} x {trials}, grid "
          f"narrowphase): {grid_s:.2f} s (sampling + filter {ginfo['sample_filter_s']:.3f} s, "
          f"scoring {ginfo['scoring_s']:.3f} s), K1 launches {grid_k1}, score mean "
          f"{g['scores'].mean():.4f}; a second run gives the same candidates and scores: "
          f"{same}", flush=True)
    if grid_k1 != 2 or len(g["scores"]) != 256 or not np.isfinite(g["scores"]).all():
        fail("grasp DB grid chunk")
    if not same:
        fail("grasp DB: two runs of one seed gave other candidates or scores")
    record = {"n_poses": n_poses, "n_candidates": n, "stats": stats,
              "score_mean": float(scores.mean()), "bins": hist, "balanced": len(bal["scores"]),
              "wall_s": wall, "sample_filter_s": info["sample_filter_s"],
              "scoring_s": info["scoring_s"], "rollouts_per_s": rollouts_s,
              "step_ms": steps_s / 20 * 1e3, "profile": busy, "rescore": row,
              "grid_chunk": {"s": grid_s, "k1_launches": grid_k1,
                             "score_mean": float(g["scores"].mean()), "deterministic": same},
              "k1": gate}
    return launches, record


def no_host_waits(label: str, fn) -> None:
    """Call ``fn`` once to warm it up, then again under
    ``torch.cuda.set_sync_debug_mode("warn")``: fail if any operation in it
    made the host wait for the device (a read of a device value, a copy
    from pageable host memory)."""
    import traceback
    import warnings
    fn()
    torch.cuda.synchronize()
    waits, other, inside = [], [], []

    def record(message, category, filename, lineno, *_):
        if not inside:
            return  # switching the mode on or off, not fn's work
        # the innermost frames of the package that led to the warning
        frames = [f"{os.path.relpath(f.filename, REPO)}:{f.lineno}"
                  for f in reversed(traceback.extract_stack())
                  if f.filename.startswith(REPO) and not f.filename.endswith("chip_smoke.py")]
        where = " < ".join(frames[:3]) or f"outside the package ({filename}:{lineno})"
        if "called a synchronizing CUDA operation" in str(message):
            waits.append(where)
        else:
            other.append(f"{str(message).splitlines()[0][:120]} at {where}")
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            inside.append(True)
            fn()
            inside.clear()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    print(f"host waits for the device in {label}: {len(waits)} (torch.cuda.set_sync_debug_mode)"
          + (f" at {sorted(set(waits))}" if waits else "")
          + (f"; other warnings {sorted(set(other))}" if other else ""), flush=True)
    if waits:
        fail(f"{label} made the host wait for the device {len(waits)} times")


def device_profile(label: str, fn, wall_s: float) -> dict:
    """Print the device time of ``fn`` by CUDA kernel (torch.profiler) and
    its busy share of ``wall_s``, the same work's wall time unprofiled;
    return the launches, busy and wall ms and the busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        t = getattr(e, "device_time", None)
        t = t if t is not None else getattr(e, "cuda_time", 0.0)
        n, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (n + t, c + 1)
    busy_us = sum(t for t, _ in by_name.values())
    launches = sum(c for _, c in by_name.values())
    print(f"profile [{label}]: {launches} kernel launches, device busy {busy_us / 1e3:.3f} ms "
          f"of {wall_s * 1e3:.1f} ms unprofiled wall ({busy_us / 1e4 / wall_s:.2f}%)",
          flush=True)
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"    {t / 1e3:9.3f} ms {100 * t / max(busy_us, 1e-9):5.1f}%  x{c:<6d} {name[:90]}",
              flush=True)
    return {"launches": launches, "busy_ms": busy_us / 1e3, "wall_ms": wall_s * 1e3,
            "busy_share": busy_us / 1e6 / wall_s}


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, REPO)
    from catgrasp_tpu_torch.ops import build

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"built {', '.join(logs)} in {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    check_box_hits_variants(dev)
    k1_random = check_box_hits(dev)
    scene, state, params, launches, times = main_path(dev)
    k2 = eval_march(scene, state, params, times)

    # where the main path's time goes on the device (launches made here are
    # outside the counted run)
    from catgrasp_tpu_torch.pipelines import run_grasp_simulation as rgs
    from catgrasp_tpu_torch.sim import engine
    device_profile("20 settle steps",
                   lambda: engine.rollout(state, params, scene.lib, scene.env_bin, 20),
                   times["settle_s"] * 20 / 500)
    device_profile("one attempt: render, occupancy, sample + filter",
                   lambda: rgs.attempt_front(scene, state, params,
                                              np.random.default_rng(0),
                                              torch.Generator(device=dev).manual_seed(0)),
                   times["render_s"] + times["occupancy_s"] + times["sample_filter_s"])
    # 20 steps of the arm-executed pick on the same pile (the arm at home,
    # clear of it): approach, close and hold, the pick's per-step work
    from catgrasp_tpu_torch.sim import arm as simarm
    home = torch.zeros((20, 7), device=dev)
    base = torch.as_tensor(scene.base_in_world, device=dev)
    ee = torch.as_tensor(scene.gripper.ee_in_grasp, device=dev)

    def pick_steps():
        return simarm.execute_pick_arm(scene.lib, state, params, scene.env_bin, 0, home, base, ee,
                                       scene.gripper.spec, n_app=10, n_close=5, n_hold=5)

    pick_steps()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pick_steps()
    torch.cuda.synchronize()
    device_profile("20 arm-executed pick steps", pick_steps, time.perf_counter() - t0)
    # every phase of both executors, a few steps each
    hold = torch.zeros((), device=dev) + 0.02
    ob_in_grasp = torch.eye(4, device=dev)
    no_host_waits("the pick executor: 6 approach, 5 close, 5 hold, 6 lift steps",
                  lambda: simarm.execute_pick_arm(scene.lib, state, params, scene.env_bin, 0,
                                                  home.new_zeros((22, 7)), base, ee,
                                                  scene.gripper.spec,
                                                  n_app=6, n_close=5, n_hold=5))
    no_host_waits("the place executor: 10 transport, 10 release steps",
                  lambda: simarm.execute_place_arm(scene.lib, state, params, scene.env_bin, 0,
                                                   home, base, ee, ob_in_grasp, hold,
                                                   scene.gripper.spec, n_move=10, n_drop=10))

    floating_waits(scene, state, params)

    k1 = eval_gate(dev, scene, state, params)
    pp_launches, k1_nocs, k2_pp = pickplace_path(dev)
    # the rest of the oracle eval: screw and hnm, the floating gripper, the
    # baked-grid geometry
    screw_launches, screw = eval_round(dev, "screw round", "screw", 8, 2)
    hnm_launches, hnm = eval_round(dev, "hnm round", "hnm", 8, 1)
    float_launches, floating = eval_round(dev, "floating attempt", "nut", 8, 1, hold=False,
                                          use_arm=False)
    grid_launches, grid = grid_round(dev)
    k3 = check_rollout(dev, logs["fused_rollout"])
    bench_launches, at_bench = bench_path(dev)
    learned_launches, learned, nets = learned_round(dev)
    db_launches, grasp_db = grasp_db_phase(dev)

    from catgrasp_tpu_torch.ops import render_march
    k1_bound, k1_by = bound_of(k1["ops"], k1["bytes"])
    k1_by_depth, _ = bound_of(k1["ops_by_depth"], k1["bytes"])
    random_bound, _ = bound_of(k1_random["ops"], k1_random["bytes"])
    random_by_depth, _ = bound_of(k1_random["ops_by_depth"], k1_random["bytes"])
    kernels = [
        {"name": "box_hits", "route": "cuda", "source": "catgrasp_tpu_torch/csrc/box_hits.cu",
         "replaces": "catgrasp_tpu/ops/collision.py:82", "launches": launches["box_hits"],
         "launches_bench_path": bench_launches["box_hits"],
         "max_abs_err": float(k1["n_diff"] > 0), "mismatch_frac": k1["n_diff"] / k1["n_entries"],
         "ms": k1["ms"], "wrapper_ms": k1["wrapper_ms"], "timing": k1["timing"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": None, "bound_ms_per_depth_sum": k1_by_depth,
         "lane_use_warp": k1["lane_use_warp"], "lane_use_block": k1["lane_use_block"],
         "shapes": f"the whole gate of one filter call on the eval path's own inputs: "
                   f"P={N_POSES}, 2 launches (3 open boxes on the collision cloud, the closing "
                   f"box on the background cloud), A=7, D=4",
         "at_random_poses": {
             "shapes": f"P={N_POSES}; C=512 (3 open boxes) + C=4096 (closing box); A=7, D=4",
             "mismatch_frac": k1_random["n_diff"] / k1_random["n_entries"],
             "ms": k1_random["ms"], "wrapper_ms": k1_random["wrapper_ms"],
             "plain_ms": k1_random["plain_ms"], "bound_ms": random_bound,
             "bound_ms_per_depth_sum": random_by_depth,
             "lane_use_warp": k1_random["lane_use_warp"],
             "lane_use_block": k1_random["lane_use_block"]},
         "at_bench_path": at_bench["box_hits"],
         "launches_pickplace_path": pp_launches["box_hits"],
         "at_nocs_gate": {
             "shapes": f"the NOCS-transfer gate of one filter call on the pick-and-place "
                       f"round's own inputs: P={k1_nocs['P']}; the segment's collision "
                       f"subsample, at most 512 points (3 open boxes), and the background "
                       f"cloud, at most 4,096 (closing box); A=7, D=4",
             "mismatch_frac": k1_nocs["n_diff"] / k1_nocs["n_entries"], "ms": k1_nocs["ms"],
             "wrapper_ms": k1_nocs["wrapper_ms"], "plain_ms": k1_nocs["plain_ms"],
             "bound_ms": k1_nocs["bound_ms"], "bound_by": k1_nocs["bound_by"]},
         "launches_screw_round": screw_launches["box_hits"],
         "at_nocs_gate_screw": nocs_gate_row("screw round", "screw", screw["k1"]),
         "launches_hnm_round": hnm_launches["box_hits"],
         "at_nocs_gate_hnm": nocs_gate_row("hnm round", "hnm", hnm["k1"]),
         "launches_floating_attempt": float_launches["box_hits"],
         "launches_grid_round": grid_launches["box_hits"],
         "launches_learned_round": learned_launches["box_hits"],
         "at_nocs_gate_learned": nocs_gate_row("learned round", "nut", learned["k1"]),
         "launches_grasp_db": db_launches["box_hits"],
         "at_grasp_db_gate": {
             "shapes": f"the grasp DB's collision gate on nut/train/0's own inputs: "
                       f"P={grasp_db['k1']['P']}; the 200-point object cloud (3 open boxes) "
                       f"and the 1-point background at infinity (closing box); A=7, D=1",
             "mismatch_frac": grasp_db["k1"]["n_diff"] / grasp_db["k1"]["n_entries"],
             "ms": grasp_db["k1"]["ms"], "wrapper_ms": grasp_db["k1"]["wrapper_ms"],
             "plain_ms": grasp_db["k1"]["plain_ms"], "bound_ms": grasp_db["k1"]["bound_ms"],
             "bound_by": grasp_db["k1"]["bound_by"]}},
        {"name": "march_csg", "route": "cuda", "source": "catgrasp_tpu_torch/csrc/march_csg.cu",
         "replaces": "catgrasp_tpu/ops/render_march.py:224", "launches": launches["march_csg"],
         "launches_bench_path": bench_launches["march_csg"],
         "max_abs_err": k2["max_abs_err"], "seg_agree": k2["seg_agree"], "ms": k2["ms"],
         "wrapper_ms": k2["wrapper_ms"], "timing": k2["timing"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"], "library_ms": None,
         "bound_ms_tile_cull": k2["bound_ms_tile_cull"],
         "bound_ms_square_tile_cull": k2["bound_ms_square_tile_cull"],
         "tile": "x".join(map(str, render_march.IMAGE_TILE)),
         "design": "one ray a thread", "variants_ms": k2["variants_ms"],
         "breakdown_ms": k2["breakdown_ms"], "render_split_ms": k2["render_split_ms"],
         "shapes": k2["shapes"], "at_bench_path": at_bench["march_csg"],
         "launches_pickplace_path": pp_launches["march_csg"],
         "at_pickplace_path": {k: k2_pp[k] for k in (
             "shapes", "seg_agree", "max_abs_err", "ms", "wrapper_ms", "timing", "plain_ms",
             "bound_ms", "bound_by")},
         "launches_screw_round": screw_launches["march_csg"],
         "at_screw_round": {k: screw["k2"][k] for k in (
             "shapes", "seg_agree", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
         "launches_hnm_round": hnm_launches["march_csg"],
         "at_hnm_round": {k: hnm["k2"][k] for k in (
             "shapes", "seg_agree", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
         "launches_floating_attempt": float_launches["march_csg"],
         "launches_grid_round": grid_launches["march_csg"],
         "launches_learned_round": learned_launches["march_csg"],
         "launches_grasp_db": db_launches["march_csg"],
         "at_learned_round": {k: learned["k2"][k] for k in (
             "shapes", "seg_agree", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}},
        {"name": "rollout_fused", "route": "cuda",
         "source": "catgrasp_tpu_torch/csrc/fused_rollout.cu",
         "replaces": "catgrasp_tpu/ops/fused_rollout.py:531",
         "launches": launches["rollout_fused"],
         "launches_bench_path": bench_launches["rollout_fused"],
         "launches_pickplace_path": pp_launches["rollout_fused"],
         "launches_screw_round": screw_launches["rollout_fused"],
         "launches_hnm_round": hnm_launches["rollout_fused"],
         "launches_floating_attempt": float_launches["rollout_fused"],
         "launches_grid_round": grid_launches["rollout_fused"],
         "launches_learned_round": learned_launches["rollout_fused"],
         "launches_grasp_db": db_launches["rollout_fused"],
         "max_abs_err": k3["max_abs_err"], "within_tol_frac": k3["within_tol_frac"],
         "ms": k3["ms"], "wrapper_ms": k3["wrapper_ms"], "prepare_ms": k3["prepare_ms"],
         "timing": k3["timing"], "plain_ms": k3["plain_ms"], "engine_ms": k3["engine_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"], "library_ms": None,
         "regimes_ms": k3["regimes_ms"], "footprint": k3["footprint"],
         "shapes": k3["shapes"]},
    ]
    print(json.dumps({"nets": nets}), flush=True)
    print(json.dumps({"grasp_db": {k: v for k, v in grasp_db.items() if k != "k1"}}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
