#!/usr/bin/env python3
"""Drive the PyTorch port (``catgrasp_tpu_torch``) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels with ``nvcc`` from ``catgrasp_tpu_torch/csrc``;
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
   before and read just after (R1 once a seg forward): tallies, outcomes,
   stage times with the nets' own; K1 held against its plain version on the
   round's NOCS-transfer gate and K2 on its frame; each net's device time a call
   at full width, with its multiply-adds; and the seg net's bf16 forward on
   the card held against the same module on the CPU, on the round's cloud,
   and its U-Net's two grid forms bit for bit;
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
14. training data and training: ``generate_scenes`` makes 64 nut train
   scenes in 4 batches of 16 at full width (386x516 frames, 1-10 bodies a
   pile, 400 settle steps, the visibility at 96x129) with every launch
   count set to 0 just before and read just after (2 K2 launches a batch:
   the 16 frames, then the 16 x 11 visibility frames); the stage times,
   scenes a second and the bodies active after the settle; K2 held against
   its plain version on one batch's own two launches (on the frames seg on
   > 99.5% of pixels and on >= 99% of those where either side sees a body,
   the same bodies seen in every scene, depth within 2e-3 m; per-body pixel counts
   within 0.5% on the visibility frames), with times and bounds; every file
   through the port's ``load_scene``; ``pack_split`` with the 12 nut grasp
   DBs; then kernel R1 ``row_group_norm_relu`` (the seg head's GroupNorm +
   ReLU) against its plain version at the seg cell's head shape (2.2 M rows
   x 64 f32): y and the three gradients within their tolerances, two
   backward calls bit for bit, the forward's and backward's kernel times
   beside the plain version's and their bytes bounds; then each net (seg: 4
   scenes of 20,000 points at 96x96x48 x 2 mm; NUNOCS: 34 x 8,192 points;
   grasp: 240 x 2,048, dropout 0.4) trained on the packed rows through
   ``Trainer.fit`` for 1 epoch or 20 steps, whichever is fewer (R1 launched
   3 times a seg step, never for the PointNets): the predicter's load of its ``best_train.ckpt``
   against the trained module, ms a step (CUDA events), samples/s, peak
   memory, launches and busy share over 10 profiled steps, no host wait in
   a step, a ``last.ckpt`` resumed in a fresh state giving the same next
   loss, and the loss falling over 20 steps on one repeated batch; then the
   paired training protocol on the card against the host CPU
   (``scripts/train_parity_protocol.py``): each net from the tracked nut
   export, 2 epochs of 1 step with val and ``best_val`` on the packed rows
   (seg 1, NUNOCS 1, grasp 4 clouds a batch at full width), on the card,
   on the card from parameters nudged 1e-6 relative (the floor) and on the
   host, with every launch count set to 0 just before and read just after
   (R1 in the seg net's card runs, no other kernel): the host's val losses
   within max(2 x the floor's difference, 1e-3) relative of the card's, the
   same ``best_val`` epoch, its first loss within 2^-8 (seg, bf16 convs) or 1e-3 of the card's;
15. affordance labels and the canonical: nut/train/0's 4,096 tracked DB
   grasps x 1,024 affordance points through ``generate_affordance`` in one
   dispatch, with every launch count set to 0 just before and read just
   after (no kernel on this path): the wall, the outcomes and the point
   affordance against the tracked JAX labels (outcomes within 2 binomial
   SD); one dispatch of the CLI's 256 grasps, timed and equal to the whole
   batch's labels of the same grasps; 10 drop steps of the batch profiled;
   no host wait in ``try_grasp``; ``compute_canonical`` for nut on the card
   with this instance's labels, its medoid and codebook equal to the CPU
   run's, its affordance against the tracked canonical;
16. ``--arm_dynamics 1``: a nut round of 8 objects, at most 1 attempt,
   through the same counted run as phase 7 (K1 and K2 held on its gate and
   frame), each ``dynamicize_schedule`` call timed with its largest
   |achieved - scheduled| joint error, and no host wait in one;
17. paired picks: two committed records of ``scripts/paired_pick_jax.py``
   (a nut pile, a grid pile of a demo mesh) replayed through
   ``execute_pick_arm`` on JAX's dynamicized schedule, with every launch
   count set to 0 just before and read just after (no kernel on this path):
   the target's trajectory within 1e-4 m of JAX's up to the step at which
   JAX parts from its own run from positions nudged 1e-6 m, and where JAX
   agrees with that run, the pick and the width (0.2 mm) too;
18. the remaining modules: the reference camera (``Camera.from_config``,
   1544 x 2064) over the main path's settled pile through
   ``render_chunked`` (7 K2 launches, one a strip of 256 rows), each strip
   held against the plain march, the kernel, plain and label-pass times and
   the bound, ``depth_to_xyzmap`` against the frame's xyz, and the chunked
   render against one pass at 384x512; a ``CombinedGraspSampler`` of two
   NOCS-transfer samplers, one centred, on the main path's first segment
   (4 K1 launches, each held against the plain version) and the centred
   cone sampler; ``add_duplicate_object_on_pile`` and 100 steps,
   ``save_state`` / ``restore_state`` and the two futures' difference,
   ``scene_from_record`` on a training-data record; ``rescore_grasp_db
   --write --rebalance`` on the drift probe's 256 poses; ``calibrate_bandwidth``
   with the tracked seg net on the training-data scenes (R1 launched); the cluster
   reducers on the card against the CPU;
19. ``parallel/``, with every launch count set to 0 just before and read
   just after (R1 in the seg net's steps, no other kernel): ``make_mesh()`` over the real
   devices; ``sharded_rollout`` of 64 nut piles of the front half's pile
   config on a virtual mesh of 4 x the card and on the real mesh, against
   one ``rollout_batch`` (within 1e-5 m after 10 steps; after 50 the
   largest difference and the share of active bodies within 1e-4 m), with
   the wall times; ``sharded_map`` of a per-scene function; one mesh train
   step of each net at its config's width and batch on a virtual mesh of 2 x
   the card against the one-device step from the same parameters
   (parameters within 1e-4 of a leaf's norm for the PointNet nets, the
   grasp net's dropout off; the seg net's gradients at cosine >= 0.999),
   with ms a step of both;
20. a ``grasp_db``, a ``training``, a ``train_parity``, an ``affordance``, an
   ``arm_dynamics``, a ``paired_pick``, a ``remaining_modules``, a
   ``parallel`` and a ``kernels`` JSON line, the card line, then
   ``{"ok": true, ...}``.

It imports nothing of the JAX package.  Without a GPU it exits non-zero
before printing any result.
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile
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


def queued_ms(fn, reps: int = 20) -> float:
    """Device ms a call of ``fn`` from two CUDA events around ``reps`` calls
    queued back to back (after one warm-up call): the host's launches hide
    behind the queue, as in a training step, where ``cuda_ms``'s one call
    between events also counts the device waiting for the launch."""
    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


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


def launch_counts(zero: bool = False) -> dict:
    """Every kernel's launch count (set to 0 first with ``zero``): K1-K3 and
    R1, the seg head's GroupNorm + ReLU (one launch forward, two backward)."""
    from catgrasp_tpu_torch.ops import collision, fused_rollout, render_march, row_group_norm
    fns = {"box_hits": collision.box_hits, "march_csg": render_march.march_csg,
           "rollout_fused": fused_rollout.rollout_fused,
           "row_group_norm_relu": row_group_norm.row_group_norm_relu}
    for fn in fns.values():
        fn.launches = 0 if zero else fn.launches
    return {k: fn.launches for k, fn in fns.items()}


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


def march_need_batch(rm, lib, st, par, o_w, d_w, tmax, n_steps, hit_eps, env=None):
    """Operations a batch of scenes needs, all scenes at once: at each step
    of each ray until it converges (step counts from the plain march's
    rule), the bodies whose bounding sphere (radius + 1e-3) the ray's line
    meets and the enabled env boxes.  Returns (the count, the steps each ray
    evaluates (B, P), each body's ops (B, N), the fixed ops of a step)."""
    B, P = st.pos.shape[0], d_w.shape[0]
    t = torch.full((B, P), 0.05, device=d_w.device)
    done = torch.zeros((B, P), dtype=torch.bool, device=d_w.device)
    evals = torch.zeros((B, P), dtype=torch.float64, device=d_w.device)
    for _ in range(n_steps):
        evals += (~done).double()
        x = o_w + t[..., None] * d_w
        phi = torch.amin(rm.scene_sdf(lib, st, par, x)[0], dim=-1)
        if env is not None:
            phi = torch.minimum(phi, rm.env_sdf(env, x))
        newly = phi < hit_eps
        t = torch.where(done | newly, t, torch.minimum(t + torch.clamp(phi, min=hit_eps / 2),
                                                       tmax))
        done = done | newly | (t >= tmax)
    types = lib.csg.types[par.shape_id]
    body_ops = torch.full(types.shape[:2], float(_BODY_OPS), dtype=torch.float64,
                          device=d_w.device)
    for code, ops in _SLOT_OPS.items():
        body_ops += (types == code).sum(dim=-1).double() * ops
    radius_w = lib.radius[par.shape_id] * par.scale
    c = st.pos - o_w  # (B, N, 3)
    along = torch.einsum("pk,bnk->bpn", d_w, c)
    perp2 = (c * c).sum(dim=-1)[:, None] - along * along
    meets = (perp2 <= ((radius_w + 1e-3) ** 2)[:, None]) & st.active[:, None]
    fixed = _STEP_OPS + (_ENV_OPS * int(env.enabled.sum()) if env is not None else 0)
    need = float((evals * ((meets.double() * body_ops[:, None]).sum(dim=-1) + fixed)).sum())
    return need, evals, body_ops, fixed


def march_work(rm, lib, state, params, o_w, d_w, tmax, env, n_steps, hit_eps, hw):
    """Operations this run's data needs.  Each ray evaluates the scene at
    every step until it converges (step counts from the plain march's rule);
    ``need`` counts at each step the bodies whose bounding sphere (radius +
    1e-3) the ray's own line meets and the enabled env boxes, the least any
    conservative cull can leave; ``strip`` the bodies the cull of the ray's
    256-ray strip keeps (the tile of the kernel's first design), ``tile``
    those the cull of the kernel's own tile keeps."""
    from catgrasp_tpu_torch.sim.types import as_batch
    P = d_w.shape[0]
    need, evals, body_ops, fixed = march_need_batch(rm, lib, as_batch(state), as_batch(params),
                                                    o_w, d_w, tmax, n_steps, hit_eps, env)
    evals, body_ops = evals[0], body_ops[0]
    radius_w = lib.radius[params.shape_id] * params.scale
    work = {"need": need}
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
    from catgrasp_tpu_torch.ops import collision
    from catgrasp_tpu_torch.sim.types import index_scenes

    launch_counts(zero=True)
    keep = {}
    t0 = time.perf_counter()
    record = bench.run(dev, keep=keep)
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"bench path ({time.perf_counter() - t0:.2f} s): {json.dumps(record)}", flush=True)
    print(f"bench path launches: {json.dumps(launches)}", flush=True)
    if launches != {"box_hits": 9, "march_csg": 9, "rollout_fused": 5,
                    "row_group_norm_relu": 0}:
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
    from catgrasp_tpu_torch.pipelines import run_grasp_simulation as rgs

    launch_counts(zero=True)
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
    launches = launch_counts()
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
    if launches["row_group_norm_relu"] != 0:
        fail("the oracle eval's front half runs no seg net, yet R1 launched")
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
    from catgrasp_tpu_torch.ops import collision
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
    launch_counts(zero=True)
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
    launches = launch_counts()
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
    if kw.get("oracle", True) and launches["row_group_norm_relu"] != 0:
        fail(f"{label}: an oracle round runs no seg net, yet R1 launched "
             f"{launches['row_group_norm_relu']} times")
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
    the seg net's card forward against the same module on the CPU, and its
    U-Net on the net's contiguous grid against the unsqueezed one-scene
    view, bit for bit.
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
    if launches["row_group_norm_relu"] != calls["seg"]:
        fail(f"learned round: R1 launched {launches['row_group_norm_relu']} times for "
             f"{calls['seg']} seg forwards (one each)")

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

    # the U-Net's input layout: the contiguous (1, C, D, H, W) grid the net
    # builds against the unsqueezed one-scene view grid.permute(3, 0, 1,
    # 2)[None] (NCDHW conv kernels too), on the round's grid
    from catgrasp_tpu_torch.nn.voxelnet import voxelize
    with torch.inference_mode():
        grid, _ = voxelize(xyz[None], nrm[None], origin[None], seg.voxel_size, seg.grid_dims)
        u_batch = seg.VoxelUNet_0(grid.permute(0, 4, 1, 2, 3).contiguous())
        u_view = seg.VoxelUNet_0(grid[0].permute(3, 0, 1, 2)[None])
    same = torch.equal(u_batch, u_view)
    print(f"seg net U-Net on the learned round's grid: the batch's contiguous grid gives the "
          f"unsqueezed one-scene view's features bit for bit: {same}", flush=True)
    if not same:
        fail("learned round: the seg net's grid layout changed its conv kernels")
    rec["unet_layout_bit_equal"] = same
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
    from catgrasp_tpu_torch.ops import collision
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
    launch_counts(zero=True)
    info = {}
    t0 = time.perf_counter()
    try:
        db = pgg.generate_complete_grasps("nut", "train", 0, gripper, cfg, device=dev, info=info)
        torch.cuda.synchronize()
    finally:
        collision.box_hits_depths = entry
    wall = time.perf_counter() - t0
    launches = launch_counts()
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
    if launches != {"box_hits": 2, "march_csg": 0, "rollout_fused": 0,
                    "row_group_norm_relu": 0} or len(calls) != 2:
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


# --------------------------------------------------------------------------
# training data and training
# --------------------------------------------------------------------------

N_DATA_SCENES = 64  # 4 batches of 16
SCENE_BATCH = 16


def march_batch_check(label, rm, mlib, st, par, d_cam, tmax, hw, agree_fn):
    """K2 against its plain version on a camera-frame scene batch (the data
    generator's launch): ``agree_fn(t_kernel, t_plain)`` prints and checks
    the agreement and returns its record; then the kernel's and the plain
    march's times and the bound from the bodies each ray's line meets, over
    every scene of the batch."""
    from catgrasp_tpu_torch.render import raymarch
    zero = torch.zeros(3, device=d_cam.device)
    kw = dict(n_steps=64, hit_eps=raymarch.HIT_EPS)

    def call():
        return rm.march_csg_batch(mlib, st, par, zero, d_cam, tmax, hw=hw, **kw)

    def plain():
        return rm.march_csg_plain(mlib, st, par, zero, d_cam, tmax, **kw)

    t_k, t_p = call(), plain()
    torch.cuda.synchronize()
    if not torch.isfinite(t_k).all():
        fail(f"march_csg [{label}] returned non-finite t")
    rec = agree_fn(t_k, t_p)
    ms, wrapper_ms, how = timed(call, "march_csg_kernel")
    plain_ms = cuda_ms(plain, 1, warm_up=False)
    B, P = t_k.shape
    need = march_need_batch(rm, mlib, st, par, zero, d_cam, tmax, 64, raymarch.HIT_EPS)[0]
    nbytes = P * (12 + 4) + B * P * 4  # the rays and tmax read, t written
    bound, bound_by = bound_of(need, nbytes)
    rec.update(ms=ms, wrapper_ms=wrapper_ms, timing=how, plain_ms=plain_ms, bound_ms=bound,
               bound_by=bound_by, ops=need, bytes=nbytes,
               shapes=f"{B} scenes x {hw[0]}x{hw[1]} rays ({P}), {st.pos.shape[1]} bodies a "
                      f"scene, 64 steps")
    print(f"K2 march_csg [{label}]: {rec['shapes']}; kernel {ms:.4f} ms ({how}), wrapper "
          f"{wrapper_ms:.4f} ms, plain {plain_ms:.3f} ms; bound {bound:.4f} ms, {bound_by} "
          f"({need:.3e} ops: the bodies each ray's line meets; {nbytes:.3e} bytes)", flush=True)
    return rec


def training_data_phase(dev, work: str):
    """Training data at full width: ``generate_scenes`` makes 64 nut train
    scenes in 4 batches of 16 (386x516 frames, 400 settle steps, the
    visibility at 96x129) with every launch count set to 0 just before and
    read just after; K2 held against its plain version on one batch's own
    two launches (the 16 frames; the 16 x 11 visibility frames); every
    file loaded by the port's ``load_scene``; ``pack_split`` with the 12 nut
    grasp DBs.  Returns (launches, record, the packed directory)."""
    import glob

    from catgrasp_tpu_torch.config.loader import load_config
    from catgrasp_tpu_torch.data import labels, packed
    from catgrasp_tpu_torch.ops import render_march
    from catgrasp_tpu_torch.pipelines import generate_pile_data as gpd
    from catgrasp_tpu_torch.pipelines import pack_training_data as ptd
    from catgrasp_tpu_torch.render import raymarch
    from catgrasp_tpu_torch.sim import engine, env_pile

    cfg = load_config("config.yml")
    K, H, W = gpd.frame_geometry(cfg)
    out = os.path.join(work, "train")
    timings = {}
    launch_counts(zero=True)
    t0 = time.perf_counter()
    gpd.generate_scenes("nut", "train", N_DATA_SCENES, out, cfg=cfg, batch=SCENE_BATCH,
                        device=dev, timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    n_batches = N_DATA_SCENES // SCENE_BATCH
    print(f"training data: {N_DATA_SCENES} nut train scenes at {H}x{W} (visibility at "
          f"{H // gpd.VIS_DOWNSCALE}x{W // gpd.VIS_DOWNSCALE}), {n_batches} batches of "
          f"{SCENE_BATCH}, 400 settle steps: {wall:.2f} s, {N_DATA_SCENES / wall:.3f} scenes/s "
          f"(each stage ends in a synchronise); stages s {json.dumps(timings)} (write_s: the "
          f"writer threads, beside the device's work); launches {json.dumps(launches)}, "
          f"{launches['march_csg'] / n_batches:.1f} K2 launches a batch", flush=True)
    if launches != {"box_hits": 0, "march_csg": 2 * n_batches, "rollout_fused": 0,
                    "row_group_norm_relu": 0}:
        fail(f"training data: launches {launches}, expected 2 K2 launches a batch and "
             f"nothing else")

    files = sorted(glob.glob(os.path.join(out, "*.npz")))
    if len(files) != N_DATA_SCENES:
        fail(f"training data: {len(files)} scene files, expected {N_DATA_SCENES}")
    n_active, vis_all, seg_bodies = [], [], 0
    for f in files:
        sc = labels.load_scene(f)
        ok = (sc["depth"].shape == (H, W) and sc["seg"].dtype == np.int32
              and sc["xyz"].shape == (H, W, 3) and sc["nocs"].shape == (H, W, 3)
              and sc["rgb"].dtype == np.uint8 and np.isfinite(sc["depth"]).all()
              and np.isfinite(sc["vis_ratio"]).all() and sc["ob_in_world"].shape == (10, 4, 4))
        if not ok:
            fail(f"training data: {f} does not load as a scene record")
        n_active.append(int(sc["active"].sum()))
        vis_all.append(sc["vis_ratio"][sc["active"]])
        seg_bodies += len(set(np.unique(sc["seg"]).tolist()) - {-2, -1})
    vis_all = np.concatenate(vis_all)
    print(f"training data: all {len(files)} files load through load_scene; bodies active "
          f"after the settle {sum(n_active)} (mean {np.mean(n_active):.2f} a scene, of 1-10 "
          f"dropped); bodies seen in the frames {seg_bodies}; visibility of the active bodies: "
          f"mean {vis_all.mean():.3f}, >= 0.8 for {(vis_all >= 0.8).mean():.3f}, max "
          f"{vis_all.max():.3f}", flush=True)
    if sum(n_active) == 0 or seg_bodies == 0 or (vis_all < 0).any():
        fail("training data: no body in the piles or the frames")

    # K2 on the first batch's own inputs: the same seed and draws
    lib = gpd.category_lib("nut", "train", device=dev)
    pile = gpd.pile_config(cfg)
    env = engine.StaticEnv.open_bin(pile.bin_inner, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    states, params, cams = gpd.draw_batch(gen, lib, pile, SCENE_BATCH, K, (H, W))
    states = env_pile.settle_fixed(states, params, lib, env, pile, 400)
    first = [int(a) for a in states.active.sum(dim=1).tolist()]
    print(f"training data: batch 0 again (same seed) has active bodies {first}, the files "
          f"{n_active[:SCENE_BATCH]}", flush=True)
    Kt = torch.as_tensor(K, device=dev)
    eye = torch.eye(4, device=dev)
    _, d_cam, _, tmax = raymarch.camera_rays(Kt, eye, H, W)
    mlib, st, par = raymarch.camera_frame_scenes(lib, states, params, cams, env)

    def frames_agree(t_k, t_p):
        out_k = raymarch.shade_frames(lib, states, params, cams, H, W, env, d_cam, tmax, t_k)
        out_p = raymarch.shade_frames(lib, states, params, cams, H, W, env, d_cam, tmax, t_p)
        seg_k, seg_p = out_k["seg"], out_p["seg"]
        same = seg_k == seg_p
        agree = float(same.float().mean())
        bodies = (seg_k >= 0) | (seg_p >= 0)
        agree_bodies = float(same[bodies].float().mean())
        err = float((out_k["depth"] - out_p["depth"])[same & (seg_p != -1)].abs().max())
        seen_same = all(set(seg_k[b].unique().tolist()) == set(seg_p[b].unique().tolist())
                        for b in range(seg_k.shape[0]))
        print(f"K2 on the data path's 16 frames: seg agrees on {agree:.6f} of pixels and on "
              f"{agree_bodies:.6f} of the {int(bodies.sum())} pixels where either side sees a "
              f"body, depth max |err| {err:.3e} m where it agrees, the same bodies seen in "
              f"every scene: {seen_same} (limits > 0.995, >= 0.99, <= 2e-3, True)", flush=True)
        if agree <= 0.995 or agree_bodies < 0.99 or err > 2e-3 or not seen_same:
            fail("march_csg on the data path's frames disagrees with its plain version")
        return {"seg_agree": agree, "seg_agree_bodies": agree_bodies, "max_abs_err": err,
                "bodies_seen_equal": seen_same}

    k2_frames = march_batch_check("data path, 16 frames", render_march, mlib, st, par, d_cam,
                                  tmax, (H, W), frames_agree)

    Hv, Wv = H // gpd.VIS_DOWNSCALE, W // gpd.VIS_DOWNSCALE
    Kv = Kt.clone()
    Kv[:2] /= gpd.VIS_DOWNSCALE
    _, dv, _, tv = raymarch.camera_rays(Kv, eye, Hv, Wv)
    st2, par2, cams2 = raymarch.visibility_scenes(states, params, cams)
    mlib2, stc, parc = raymarch.camera_frame_scenes(lib, st2, par2, cams2)

    def solos_agree(t_k, t_p):
        res = {}
        for which, ck, cp in zip(("full", "alone"),
                                 raymarch.pixel_counts(lib, states, params, cams, dv, tv, t_k),
                                 raymarch.pixel_counts(lib, states, params, cams, dv, tv, t_p)):
            diff = int((ck - cp).abs().sum())
            total = int(cp.sum())
            res[which] = {"pixels": total, "abs_diff": diff,
                          "max_body_diff": int((ck - cp).abs().max())}
        print(f"K2 on the data path's visibility frames: per-body pixel counts kernel vs plain "
              f"{json.dumps(res)} (limit: the summed |diff| <= 0.5% of the pixels)", flush=True)
        if any(r["abs_diff"] > 0.005 * max(r["pixels"], 1) for r in res.values()):
            fail("march_csg on the visibility frames disagrees with its plain version")
        return {"counts": res, "max_abs_err": max(r["abs_diff"] / max(r["pixels"], 1)
                                                  for r in res.values())}

    k2_solos = march_batch_check("data path, 16 x 11 visibility frames", render_march, mlib2,
                                 stc, parc, dv, tv, (Hv, Wv), solos_agree)

    packed_dir = os.path.join(work, "packed_train")
    dbs = ptd.load_grasp_dbs("nut", db_dir=os.path.join(REPO, "dataset", "grasps"))
    if len(dbs) != 12:
        fail(f"training data: {len(dbs)} nut grasp DBs, expected 12")
    need = {"n_seg": 4, "n_nunocs": 34, "n_grasp_keys": 240}  # a full batch of each net
    n_scenes = N_DATA_SCENES
    while True:
        t1 = time.perf_counter()
        meta = packed.pack_split(out, packed_dir, grasp_db=dbs, seed=0, log_every=0)
        pack_s = time.perf_counter() - t1
        print(f"pack_split of {meta['n_scenes']} scenes with {len(dbs)} grasp DBs: "
              f"{pack_s:.2f} s; {json.dumps(meta)}", flush=True)
        short = [k for k, v in need.items() if meta[k] < v]
        if not short:
            break
        if n_scenes >= 4 * N_DATA_SCENES:
            fail(f"training data: fewer rows than one batch of {short} from {n_scenes} scenes")
        print(f"training data: fewer rows than a batch of {short}; 64 more scenes", flush=True)
        gpd.generate_scenes("nut", "train", n_scenes + N_DATA_SCENES, out, cfg=cfg,
                            batch=SCENE_BATCH, start=n_scenes, device=dev)
        n_scenes += N_DATA_SCENES
    record = {"scenes": N_DATA_SCENES, "wall_s": wall, "scenes_per_s": N_DATA_SCENES / wall,
              "stages_s": timings, "k2_launches_a_batch": launches["march_csg"] / n_batches,
              "active_bodies": sum(n_active), "pack": meta, "pack_s": pack_s,
              "k2_frames": k2_frames, "k2_visibility": k2_solos}
    return launches, record, packed_dir


ROW_GN_ROWS = 2_200_000  # the seg cell's head: 110 scenes x 20,000 points


def check_row_group_norm(dev) -> dict:
    """Kernel R1 ``row_group_norm_relu`` (``csrc/row_group_norm.cu``, the seg
    head's GroupNorm + ReLU) against its plain version at the seg cell's
    head shape, x (2.2 M, 64) f32 in 8 groups: y, dx, dgamma and dbeta
    within the tolerances of ``tests/test_torch_kernels_cuda.py``'s
    ``test_row_group_norm_relu_matches_plain`` (their reasons are there),
    dx, dgamma and dbeta the same bits over two backward calls; then the
    forward's and the backward's kernel times (the backward's two kernels
    added) beside the plain version's and each pass's bytes bound (forward:
    read x, write y; backward: read x and dy, write dx)."""
    import torch.nn.functional as F

    from catgrasp_tpu_torch.nn.pointnet import GN_EPS
    from catgrasp_tpu_torch.ops import row_group_norm as rgn

    m, op, plain = ROW_GN_ROWS, rgn.row_group_norm_relu, rgn.row_group_norm_relu_plain
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, normal=True):
        return (torch.randn if normal else torch.rand)(*shape, device=dev, generator=gen)

    # rows of their own offset and scale, gamma near 1; dy zero within 1e-3
    # of the ReLU's kink, where the two sides may take different branches
    x = 2 * rand(m, 1) + (0.5 + 1.5 * rand(m, 1, normal=False)) * rand(m, 64)
    w, b = 1 + 0.2 * rand(64), 0.2 * rand(64)
    pre = F.group_norm(x, 8, w, b, GN_EPS)
    dy = torch.where(pre.abs() < 1e-3, 0.0, rand(m, 64))

    def grads(fn):
        xs, ws, bs = (t.clone().requires_grad_() for t in (x, w, b))
        y = fn(xs, ws, bs, 8, GN_EPS)
        y.backward(dy)
        return y.detach(), xs.grad, ws.grad, bs.grad

    n0 = op.launches
    k, k2, p = grads(op), grads(op), grads(plain)
    torch.cuda.synchronize()
    if op.launches != n0 + 6:
        fail(f"R1: {op.launches - n0} launches for two forwards and backwards, expected 6")
    xg = x.double().view(m, 8, 8)
    rstd = (xg.var(-1, unbiased=False) + GN_EPS).rsqrt()
    u = 2.0 ** -20 * (1 + (rstd * xg.abs().amax(-1)).repeat_interleave(8, dim=1))
    rstd = rstd.repeat_interleave(8, dim=1)
    g = dy.double() * (pre > 0)
    gg_max = (g * w.double()).abs().view(m, 8, 8).amax(-1).repeat_interleave(8, dim=1)
    x_hat = F.group_norm(x.double(), 8, None, None, GN_EPS)
    err, err_over_tol = {}, {}
    for name, a, e, tol in (("y", k[0], p[0], u * (1 + p[0].double().abs())),
                            ("dx", k[1], p[1], u * rstd * (1 + 4 * gg_max)),
                            ("dgamma", k[2], p[2], (u * g.abs() * (1 + x_hat.abs())).sum(0)),
                            ("dbeta", k[3], p[3], (u * g.abs()).sum(0))):
        diff = (a.double() - e.double()).abs()
        err[name], err_over_tol[name] = float(diff.max()), float((diff / tol).max())
    repeat = all(torch.equal(a, e) for a, e in zip(k[1:], k2[1:]))
    half_on = float((pre > 0).float().mean())
    del xg, rstd, u, g, gg_max, x_hat, diff, tol, k2

    def kernels_ms(fn, names):
        """(ms, how): the named kernels' device time a call from the
        profiler's trace, or, where the trace holds none of their launches
        (late in this process it drops them), from queued calls."""
        parts = [kernel_ms(fn, name) for name in names]
        if None in parts:
            return queued_ms(fn), "cuda events, 20 calls queued"
        return sum(parts), "torch.profiler"

    def fwd():
        with torch.no_grad():
            return op(x, w, b, 8, GN_EPS)

    wrapper_f = cuda_ms(fwd, 25)
    ms_f, how = kernels_ms(fwd, ("row_gn_fwd",))
    with torch.no_grad():
        plain_f = cuda_ms(lambda: plain(x, w, b, 8, GN_EPS), 10)
    back = {}
    for name, fn in (("kernel", op), ("plain", plain)):
        xs, ws, bs = (t.clone().requires_grad_() for t in (x, w, b))
        y = fn(xs, ws, bs, 8, GN_EPS)
        back[name] = lambda y=y, ins=(xs, ws, bs): torch.autograd.grad(y, ins, dy,
                                                                        retain_graph=True)
    wrapper_b = cuda_ms(back["kernel"], 25)
    ms_b, how_b = kernels_ms(back["kernel"], ("row_gn_bwd", "row_gn_sum_partials"))
    plain_b = cuda_ms(back["plain"], 10)
    del back, y, xs, ws, bs
    row_bytes = 64 * 4
    bound_f, bound_b = (n * m * row_bytes / HBM_BYTES_PER_S * 1e3 for n in (2, 3))
    rec = {"shapes": f"x ({m}, 64) f32, 8 groups of 8 channels, each row its own sample; "
                     f"{100 * half_on:.1f}% of the ReLU on",
           "max_abs_err": err, "max_err_over_tol": err_over_tol, "repeat_bit_equal": repeat,
           "ms": ms_f, "wrapper_ms": wrapper_f, "timing": how, "plain_ms": plain_f,
           "bound_ms": bound_f, "bound_by": "bytes",
           "bwd_ms": ms_b, "bwd_wrapper_ms": wrapper_b, "bwd_plain_ms": plain_b,
           "bwd_bound_ms": bound_b, "bwd_timing": how_b}
    print(f"R1 row_group_norm_relu at {m:,} rows (the seg cell's head): max |diff| "
          f"{json.dumps(err)}, over its tolerance {json.dumps(err_over_tol)}; repeated backward "
          f"bit for bit: {repeat}; forward {ms_f:.4f} ms ({how}), wrapper {wrapper_f:.4f} ms, "
          f"plain {plain_f:.3f} ms, bound {bound_f:.4f} ms; backward {ms_b:.4f} ms (2 kernels, "
          f"{how_b}), wrapper {wrapper_b:.4f} ms, plain {plain_b:.3f} ms, bound {bound_b:.4f} ms",
          flush=True)
    if not all(np.isfinite(v) and v <= 1.0 for v in err_over_tol.values()):
        fail("R1: the kernels disagree with the plain version beyond the tolerance")
    if not repeat:
        fail("R1: two backward calls on the same inputs gave different bits")
    return rec


def training_phase(dev, packed_dir: str, work: str) -> dict:
    """Each net trained on the packed rows at its config's widths and
    batch (seg 4 scenes of 20,000 points at 96x96x48 x 2 mm, NUNOCS 34 x
    8,192, grasp 240 x 2,048 with dropout 0.4) through ``Trainer.fit`` for 1
    epoch or 20 steps, whichever is fewer; then the predicter's load of its
    ``best_train.ckpt`` against the trained module; ms a step (CUDA events),
    samples/s, peak memory, launches and busy share over 10 profiled steps,
    no host wait in a step, a ``last.ckpt`` resumed in a fresh state giving
    the next step's loss, and the loss over 20 steps on one repeated batch."""
    from itertools import islice

    from catgrasp_tpu_torch.config.loader import load_config
    from catgrasp_tpu_torch.data import packed
    from catgrasp_tpu_torch.pipelines import train_grasp, train_nunocs, train_seg
    from catgrasp_tpu_torch.predict.artifacts import load_predicters
    from catgrasp_tpu_torch.train import trainer as T

    art = os.path.join(work, "artifacts")
    nets = {
        "seg": (load_config("config_seg.yml"), lambda c: train_seg.build(c), packed.PackedSeg),
        "nunocs": (load_config("config_nunocs.yml"), lambda c: train_nunocs.build(c, "nut"),
                   packed.PackedNunocs),
        "grasp": (load_config("config_grasp.yml"), train_grasp.build, packed.PackedGrasp)}
    nets["seg"][0]["batch_size"] = 4  # a short run's batch, not the config's 110
    record = {}
    for net, (cfg, build, data) in nets.items():
        torch.cuda.empty_cache()
        bs = cfg["batch_size"]
        ds = data(packed_dir, cfg)
        spe = max(len(ds) // bs, 1)
        n_steps = min(len(ds) // bs, 20)
        model, loss_fn = build(cfg)
        state = T.create_state(model, cfg, spe, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer = T.Trainer(model=model, cfg=cfg, loss_fn=loss_fn,
                            train_data=lambda: islice(ds.batches(bs), n_steps),
                            ckpt_dir=os.path.join(art, net))
        launch_counts(zero=True)
        t0 = time.perf_counter()
        state = trainer.fit(state, n_epochs=1, log_every=n_steps, verbose=False)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        r1_fit = launch_counts()["row_group_norm_relu"]
        if r1_fit != (3 * n_steps if net == "seg" else 0):
            fail(f"training [{net}]: R1 launched {r1_fit} times in a fit of {n_steps} steps "
                 f"(the seg head's: 3 a step, forward and backward; the PointNets': none)")
        host = list(islice(ds.batches(bs), 2))
        b0, b1 = (T.to_device(b, dev) for b in host)

        # the predicter on the run's best_train.ckpt against the trained module
        role = {"nunocs": "nocs"}.get(net, net)
        pred = load_predicters(art, "nut", device=dev)[role].model
        with torch.no_grad():
            if net == "seg":
                xyz, nrm = b0["xyz"][0], b0["normal"][0]
                origin = xyz.amin(dim=0) - 0.01
                mine, theirs = state.model(xyz, nrm, origin), pred(xyz, nrm, origin)
            else:
                mine, theirs = state.model(b0["x"])[:1], pred(b0["x"])[:1]
        pred_err = max(float((a - b).abs().max()) for a, b in zip(mine, theirs))

        step = T.make_train_step(loss_fn)
        ms = cuda_ms(lambda: step(state, b0), 10)
        busy = device_profile(f"10 {net} training steps",
                              lambda: [step(state, b0) for _ in range(10)], 10 * ms / 1e3)
        no_host_waits(f"a {net} training step (the batch's copy to the device included)",
                      lambda: step(state, T.to_device(host[0], dev)))
        peak = torch.cuda.max_memory_allocated() / 2 ** 20

        # last.ckpt resumed in a fresh state gives the same next step
        path = os.path.join(art, net, "last.ckpt")
        T.save_checkpoint(path, state, 0)
        rng = torch.cuda.get_rng_state()
        _, l_cont, _ = step(state, b1)
        fresh = T.create_state(build(cfg)[0], cfg, spe, device=dev)
        fresh, _ = T.load_checkpoint(path, fresh)
        torch.cuda.set_rng_state(rng)
        _, l_res, _ = step(fresh, b1)
        p_cont = next(state.model.parameters())
        p_res = next(fresh.model.parameters())
        resume_err = abs(float(l_cont) - float(l_res))
        param_err = float((p_cont - p_res).abs().max())
        del fresh

        # the loss over 20 steps on one repeated batch, from a fresh start
        model3, _ = build(cfg)
        s3 = T.create_state(model3, cfg, spe, device=dev)
        with torch.no_grad():
            l_before = float(loss_fn(s3.model, b0, False)[0])
        for _ in range(20):
            step(s3, b0)
        with torch.no_grad():
            l_after = float(loss_fn(s3.model, b0, False)[0])
        del s3, model3
        rec = {"batch": bs, "rows": len(ds), "fit_steps": n_steps, "fit_s": fit_s,
               "r1_launches_fit": r1_fit,
               "ms_a_step": ms, "samples_per_s": bs / ms * 1e3, "peak_mib": peak,
               "launches_a_step": busy["launches"] / 10, "busy_share": busy["busy_share"],
               "predicter_max_abs_err": pred_err, "resume_loss_diff": resume_err,
               "resume_param_diff": param_err, "loss_repeated_batch": [l_before, l_after]}
        record[net] = rec
        print(f"training [{net}] batch {bs}, {len(ds)} rows: fit of {n_steps} steps "
              f"{fit_s:.2f} s ({r1_fit} R1 launches); a step {ms:.3f} ms (CUDA events), "
              f"{rec['samples_per_s']:.1f} samples/s, peak {peak:.1f} MiB, "
              f"{rec['launches_a_step']:.0f} launches a step, "
              f"busy {100 * busy['busy_share']:.1f}%; predicter on best_train.ckpt max |diff| "
              f"{pred_err:.3e}; resumed last.ckpt: next-step loss {float(l_res):.6f} vs "
              f"{float(l_cont):.6f} in process (|diff| {resume_err:.3e}, params after it "
              f"{param_err:.3e}); loss on one batch repeated 20 steps {l_before:.5f} -> "
              f"{l_after:.5f}", flush=True)
        if pred_err > 1e-5:
            fail(f"training [{net}]: the predicter's forward differs from the trained module's")
        if resume_err > 1e-5 * max(1.0, abs(float(l_cont))):
            fail(f"training [{net}]: the resumed last.ckpt gives another next step")
        if not l_after < l_before:
            fail(f"training [{net}]: the loss did not fall on a repeated batch")
        del state, model, b0, b1
    return record


# the paired-training phase: each net's batch (cut from the trainers' so
# that the host CPU's run fits the phase), 2 epochs of 1 step and 1 val
# batch (the training data's rows), and the first step's loss on the host
# within this of the card's (one batch, the same parameters): one bf16
# step, 2^-8, for the seg net, whose convs run in bf16 (found 1.0e-4 and
# 5.4e-4 apart in two runs), 1e-3 for the f32 nets (found < 2e-7)
TRAIN_PARITY_BATCH = {"seg": 1, "nunocs": 1, "grasp": 4}
TRAIN_PARITY_STEPS, TRAIN_PARITY_EPOCHS = 1, 2
TRAIN_PARITY_FIRST_REL = {"seg": 2.0 ** -8, "nunocs": 1e-3, "grasp": 1e-3}


def train_parity_phase(dev, card: str, packed_dir: str, work: str) -> dict:
    """The paired training protocol (``scripts/train_parity_protocol.py``)
    on the card against the host CPU: each net from the tracked nut export
    through ``Trainer.fit`` on the training data's packed rows (train and
    val), at full width and points a cloud, 2 epochs of 1 step with a val
    pass and ``best_val`` at each epoch end (the grasp net's dropout masks
    carried in), three runs: on the card, on the card from the parameters
    nudged by 1e-6 relative (the floor) and on the host.  With every launch
    count set to 0 just before and read just after (R1 in the seg net's
    card runs, no other kernel).  Fails unless the host's run holds to the
    card's as the protocol holds two runs (``compare``: the same
    ``best_val`` epoch, each val loss within max(2 x the floor's
    difference, 1e-3) relative) and its first loss is within
    ``TRAIN_PARITY_FIRST_REL`` of the card's."""
    from scripts import train_parity_protocol as tpp

    t0 = time.perf_counter()
    launch_counts(zero=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)
    rows = {}
    try:
        for net, batch in TRAIN_PARITY_BATCH.items():
            runs = {}
            for run, device, nudged in (("card", dev, False), ("card_nudged", dev, True),
                                        ("host", torch.device("cpu"), False)):
                runs[run] = tpp.run_port(net, (packed_dir, packed_dir), device, run, nudged,
                                         out_root=os.path.join(work, "train_parity"),
                                         batch=batch, n_epochs=TRAIN_PARITY_EPOCHS,
                                         steps=TRAIN_PARITY_STEPS)
            c = tpp.compare(runs["host"], runs["card"], runs["card_nudged"])
            first = tpp.rel(runs["host"]["loss"][0], runs["card"]["loss"][0])
            rows[net] = {"batch": batch, "steps": runs["card"]["n_steps"],
                         "s": {k: r["seconds"] for k, r in runs.items()},
                         "first_loss_rel": first,
                         **{k: c[k] for k in ("ok", "breaches", "val_rel", "val_band",
                                              "best_val_epoch", "loss_rel_max",
                                              "param_rel_l2")},
                         "floor_loss_rel_max": c["floor_diff"]["loss_rel_max"],
                         "floor_param_rel_l2": c["floor_diff"]["param_rel_l2"]}
            r = rows[net]
            print(f"paired training [{net}] batch {batch}, {r['steps']} steps: host against "
                  f"{card}: first loss {first:.2e} apart, step losses up to "
                  f"{r['loss_rel_max']:.2e} (floor {r['floor_loss_rel_max']:.2e}), val "
                  f"{['%.2e' % x for x in r['val_rel']]} (band "
                  f"{['%.2e' % x for x in r['val_band']]}), best_val {r['best_val_epoch']}, "
                  f"params {r['param_rel_l2']:.2e} (floor {r['floor_param_rel_l2']:.2e}); "
                  f"card {r['s']['card']:.2f} s, host {r['s']['host']:.2f} s", flush=True)
            if not c["ok"]:
                fail(f"paired training [{net}]: {'; '.join(c['breaches'])}")
            if first > TRAIN_PARITY_FIRST_REL[net]:
                fail(f"paired training [{net}]: the host's first loss {first:.2e} off the card's")
    finally:
        torch.set_num_threads(threads)
    launches = launch_counts()
    wall = time.perf_counter() - t0
    print(f"paired training: 3 nets x 3 runs in {wall:.2f} s; launches {json.dumps(launches)}",
          flush=True)
    if launches["row_group_norm_relu"] == 0:
        fail("paired training: the seg net's card runs launched no R1")
    return {"nets": rows, "wall_s": wall, "launches": launches}


# --------------------------------------------------------------------------
# affordance labels and the canonical; articulated arm dynamics in the eval
# --------------------------------------------------------------------------

# the least per-grasp ret agreement and point-affordance Pearson with the
# tracked JAX labels of nut/train/0: JAX's own labels made on a CPU agree
# with its TPU-made ones on 0.999756 of hnm/train/1's grasps, and the port
# agreed 1.0000 / Pearson 1.0000 on nut/train/0 on the card (PERF.md)
RET_AGREE_MIN, AFFORDANCE_PEARSON_MIN = 0.99, 0.99


def affordance_phase(dev, card: str):
    """Affordance labels and the canonical at full width: nut/train/0's
    4,096 tracked DB grasps with 1,024 affordance points through
    ``generate_affordance`` in one dispatch (``chunk 4096``) with every
    launch count set to 0 just before and read just after (no kernel on
    this path); one ``chunk 256`` dispatch, the CLI's default, timed and
    held equal to the same grasps of the whole batch; 10 drop steps of the
    batch profiled; ``no_host_waits`` over ``try_grasp``; the outcomes and
    the point affordance against the tracked JAX labels; then
    ``compute_canonical`` for nut on the card with this instance's labels in
    place of the tracked ones: the medoid and the codebook equal to the same
    call on the CPU, the canonical affordance against the tracked file.
    Returns (launches, record)."""
    from catgrasp_tpu_torch.pipelines import generate_affordance as ga
    from catgrasp_tpu_torch.pipelines import make_canonical as mc
    from catgrasp_tpu_torch.sim import env_semantic as es
    from scripts import affordance_protocol

    db = dict(np.load(os.path.join(REPO, "dataset", "grasps", "nut_train_0_complete_grasp.npz")))
    tracked = np.load(os.path.join(REPO, "dataset", "affordance", "nut_train_0_affordance.npz"))
    drops, drop = [], es.drop_on_fixture

    def drop_recorder(*args, **kw):
        drops[:] = [(args, kw)]
        return drop(*args, **kw)

    es.drop_on_fixture = drop_recorder
    launch_counts(zero=True)
    t0 = time.perf_counter()
    try:
        out = ga.generate_affordance("nut", "train", 0, db, chunk=4096, device=dev,
                                     verbose=False)
        torch.cuda.synchronize()
    finally:
        es.drop_on_fixture = drop
    wall = time.perf_counter() - t0
    launches = launch_counts()
    rets = out["rets"]
    n = len(rets)
    cmp = affordance_protocol.compare_labels(out, tracked)
    print(f"affordance, nut/train/0 at full width ({n:,} grasps x 1,024 points, one chunk of "
          f"4,096): wall {wall:.2f} s on {card}; outcomes fail / stable / task "
          f"{cmp['outcomes']} against the tracked JAX labels' {cmp['jax_outcomes']} (2 "
          f"binomial SD {[round(x, 1) for x in cmp['two_sd_counts']]}); per-grasp ret "
          f"agreement {cmp['ret_agree']:.4f} (limit {RET_AGREE_MIN}); point affordance "
          f"Pearson {cmp['affordance_pearson']:.4f} (limit {AFFORDANCE_PEARSON_MIN}; mean "
          f"|diff| {cmp['affordance_mean_abs_diff']:.4f})", flush=True)
    print(f"affordance launches: {json.dumps(launches)} (no kernel on this path)", flush=True)
    if launches != {"box_hits": 0, "march_csg": 0, "rollout_fused": 0,
                    "row_group_norm_relu": 0}:
        fail(f"affordance: launches {launches}, expected none")
    if rets.shape != (4096,) or out["affordance"].shape != (1024,) \
            or not np.isfinite(out["affordance"]).all() or set(np.unique(rets)) - {0, 1, 2}:
        fail("affordance: labels out of shape or range")
    if not cmp["points_equal_jax"]:
        fail("affordance: the affordance points differ from JAX's draw")
    if not cmp["within_two_sd"]:
        fail(f"affordance: outcomes {cmp['outcomes']} outside 2 binomial SD of JAX's")
    if cmp["ret_agree"] < RET_AGREE_MIN:
        fail(f"affordance: per-grasp ret agreement {cmp['ret_agree']:.4f} < {RET_AGREE_MIN}")
    if cmp["affordance_pearson"] < AFFORDANCE_PEARSON_MIN:
        fail(f"affordance: point affordance Pearson {cmp['affordance_pearson']:.4f} < "
             f"{AFFORDANCE_PEARSON_MIN}")

    # one dispatch of the CLI's default chunk, on the same grasps
    lib, aff_pts, _ = ga.affordance_setup("nut", "train", 0, device=dev)
    aff_t = torch.as_tensor(aff_pts, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    r256, m256 = ga.try_grasp_chunks(lib, "nut", aff_t, db["grasp_poses"][:256], 256,
                                     verbose=False)
    chunk_s = time.perf_counter() - t1
    same = bool(np.array_equal(r256, rets[:256]))
    print(f"affordance: one chunk-256 dispatch {chunk_s:.2f} s (x {4096 / 256:.0f} dispatches "
          f"extrapolates to {chunk_s * 16:.1f} s an instance, against {wall:.2f} s measured in "
          f"one); its rets equal the "
          f"whole batch's on the same grasps: {same}", flush=True)
    if not same:
        fail("affordance: the labels depend on the chunk")

    # 10 drop steps of the whole batch: launches a step and busy share
    (dargs, _), = drops
    release = dargs[4]

    def drop10():
        return es.drop_on_fixture(*dargs[:5], 10)

    drop10()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    drop10()
    torch.cuda.synchronize()
    drop_s = time.perf_counter() - t2
    busy = device_profile(f"10 drop steps of {release.shape[0]} scenes x 2 bodies", drop10,
                          drop_s)
    grasps64 = torch.as_tensor(db["grasp_poses"][:64], device=dev)
    no_host_waits("try_grasp over 64 grasps (rollout, contacts, sweep, drop)",
                  lambda: es.try_grasp(lib, 0, 1, 1.0, grasps64, "nut", aff_t))

    # the canonical for nut on the card, this instance's labels in place of
    # the tracked ones, against the same call on the CPU
    dbs, affs = mc.load_inputs("nut", os.path.join(REPO, "dataset", "grasps"),
                               os.path.join(REPO, "dataset", "affordance"))
    affs[0] = out
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    canon = mc.compute_canonical("nut", dbs, affs, device=dev)
    canon_s = time.perf_counter() - t3
    cpu = mc.compute_canonical("nut", dbs, affs, device="cpu")
    canon_cmp = affordance_protocol.compare_canonical(
        canon, cpu, np.load(os.path.join(REPO, "dataset", "nut_canonical.npz")))
    same_cpu = canon_cmp["equal_cpu"]
    print(f"canonical, nut on the card with this instance's labels: {canon_s:.2f} s; medoid "
          f"{canon_cmp['medoid']} (file {canon_cmp['medoid_tracked']}), "
          f"{canon_cmp['n_codebook']:,} codebook grasps; equal to the CPU run: "
          f"{json.dumps(same_cpu)}; canonical affordance against the tracked file: Pearson "
          f"{canon_cmp['canonical_affordance_pearson']:.4f}, mean |diff| "
          f"{canon_cmp['canonical_affordance_mean_abs_diff']:.4f}", flush=True)
    if not (same_cpu["medoid_index"] and same_cpu["canonical_grasps"]
            and same_cpu["canonical_grasp_scores"]):
        fail("canonical: the card's medoid or codebook differs from the CPU run")
    if canon_cmp["affordance_max_abs_diff_cpu"] > 1e-6:
        fail("canonical: the card's affordance codebook differs from the CPU run")
    record = dict(cmp, wall_s=wall, chunk256_s=chunk_s, drop_step_ms=drop_s / 10 * 1e3,
                  drop_profile=busy, canonical_s=canon_s, canonical=canon_cmp)
    return launches, record


def dynamics_round(dev, card: str):
    """``--arm_dynamics 1``: one nut round of 8 objects, at most 1 attempt,
    through ``eval_round`` (K1 and K2 held on its gate and frame), every
    ``dynamicize_schedule`` call timed (synchronised) with its largest
    |achieved - scheduled| joint error; ``no_host_waits`` over a 20-waypoint
    schedule.  Returns (launches, record)."""
    from catgrasp_tpu_torch.sim import arm as simarm

    calls, entry = [], simarm.dynamicize_schedule

    def recorder(qs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = entry(qs)
        torch.cuda.synchronize()
        calls.append({"waypoints": int(qs.shape[0]), "ms": (time.perf_counter() - t0) * 1e3,
                      "max_err_rad": float((out - qs).abs().max())})
        return out

    simarm.dynamicize_schedule = recorder
    try:
        launches, out = eval_round(dev, "arm-dynamics round", "nut", 8, 1, arm_dynamics=True)
    finally:
        simarm.dynamicize_schedule = entry
    for c in calls:
        print(f"  dynamicize_schedule: {c['waypoints']} waypoints x 8 substeps in "
              f"{c['ms']:.1f} ms ({c['ms'] / c['waypoints'] / 8 * 1e3:.1f} us a substep) on "
              f"{card}; largest |achieved - scheduled| {c['max_err_rad']:.4f} rad", flush=True)
    # one call a pick, and one a place that was planned
    tally = out["tally"]
    if not tally["num_attempts"] <= len(calls) <= tally["num_attempts"] \
            + tally["num_stable_grasp"]:
        fail(f"arm-dynamics round: {len(calls)} dynamicize_schedule calls for {tally}")
    if not all(np.isfinite(c["max_err_rad"]) for c in calls):
        fail("arm-dynamics round: the tracked schedule is not finite")
    qs = torch.zeros((20, 7), device=dev) + torch.linspace(0, 0.3, 20, device=dev)[:, None]
    no_host_waits("dynamicize_schedule over 20 waypoints", lambda: entry(qs))
    out.update(dynamicize=calls)
    return launches, out


# two paired-pick records (scripts/paired_pick_jax.py) replayed by the smoke:
# one nut pile of the eval matrix, one grid pile of a demo mesh
PAIRED_RECORDS = ("logs/paired_pick/nut_seed00_seg0.npz",
                  "logs/paired_pick/demo_nut_seed00_seg1.npz")


def paired_pick_phase(dev, card: str) -> dict:
    """Two committed paired-pick records replayed on the card through
    ``execute_pick_arm`` on JAX's dynamicized 320-waypoint schedule
    (``scripts/paired_pick_protocol.py``), with every launch count set to 0
    just before and read just after (no kernel on this path): the target's
    trajectory within 1e-4 m of JAX's recorded one up to the record's floor
    horizon (where JAX parts from its own run from positions nudged 1e-6
    m); where JAX agrees with its nudged self, ``picked`` equal and the width
    within 0.2 mm."""
    from scripts import paired_pick_protocol as ppp

    t0 = time.perf_counter()
    launch_counts(zero=True)
    rows = [ppp.replay(os.path.join(REPO, p), dev, runs=("dyn",)) for p in PAIRED_RECORDS]
    launches = launch_counts()
    wall = time.perf_counter() - t0
    for row in rows:
        r = row["dyn"]
        print(f"paired pick {row['record']} on {card}: picked {r['picked']} (JAX "
              f"{r['jax_picked']}), width {r['w_f'] * 1e3:.3f} mm (JAX {r['jax_w_f'] * 1e3:.3f}), "
              f"parts from JAX at step {r['part']} of 320 (floor {row['floor_part']}), largest "
              f"deviation {r['max_dev_m']:.2e} m, {r['s']:.2f} s", flush=True)
        breaches = ppp.horizon_breaches(row)
        if breaches:
            fail(f"paired pick {row['record']}: {'; '.join(breaches)}")
    print(f"paired pick: {len(rows)} records in {wall:.2f} s on {card}; launches "
          f"{json.dumps(launches)}", flush=True)
    return {"rows": rows, "wall_s": wall, "launches": launches}


# --------------------------------------------------------------------------
# the remaining modules: the reference camera, the samplers' centering and
# CombinedGraspSampler, the scene tools, the rescore, the calibration and
# the cluster reducers
# --------------------------------------------------------------------------

ROWS_PER_CHUNK = 256  # render_chunked's default: 7 strips a 1544 x 2064 frame


def fullres_frame(scene, state, params) -> dict:
    """The reference camera (``Camera.from_config`` on ``config.yml``: its K,
    1544 x 2064) over the front half's settled nut pile through
    ``render_chunked`` in strips of 256 rows, with the launch counts set to
    0 just before and read just after (one K2 launch a strip); then each
    strip's rays marched again by K2 and by the plain march: agreement,
    kernel, plain and label-pass ms, the bound from the bodies each ray's
    line meets (the padded last strip's repeated rows counted once);
    ``depth_to_xyzmap`` of the frame's depth against its xyz; and the
    chunked render against one pass at the eval's 384 x 512."""
    from catgrasp_tpu_torch.config.loader import load_config
    from catgrasp_tpu_torch.core.camera import Camera, depth_to_xyzmap
    from catgrasp_tpu_torch.ops import render_march as rm
    from catgrasp_tpu_torch.render import raymarch
    from catgrasp_tpu_torch.sim.types import as_batch

    dev = state.pos.device
    camera = Camera.from_config(load_config("config.yml"))
    H, W, rows = camera.H, camera.W, ROWS_PER_CHUNK
    K = torch.as_tensor(camera.K, device=dev)
    cam = torch.as_tensor(scene.cam, dtype=torch.float32, device=dev)
    env, lib = scene.env_bin, scene.lib
    launch_counts(zero=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frame = raymarch.render_chunked(lib, state, params, K, cam, H, W, env=env,
                                    rows_per_chunk=rows)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    n_strips = -(-H // rows)
    if launches != {"box_hits": 0, "march_csg": n_strips, "rollout_fused": 0,
                    "row_group_norm_relu": 0}:
        fail(f"render_chunked at {H}x{W}: launches {launches}, expected {n_strips} of K2")
    if frame["depth"].shape != (H, W) or not all(torch.isfinite(v).all() for v in frame.values()):
        fail("the full-resolution frame has the wrong shape or non-finite values")

    kw = dict(env=env, n_steps=64, hit_eps=raymarch.HIT_EPS)
    tot = {"ms": 0.0, "wrapper_ms": 0.0, "plain_ms": 0.0, "shade_ms": 0.0, "need": 0.0,
           "agree": 0, "err": 0.0}
    seen_k, seen_p = set(), set()
    for r0 in range(0, H, rows):
        crop = 0
        if H - r0 < rows:  # the padded last strip: its first rows were rendered already
            crop, r0 = rows - (H - r0), H - rows
        Ks = K.clone()
        Ks[1, 2] -= float(r0)
        o_w, d_w, d_cam, tmax = raymarch.camera_rays(Ks, cam, rows, W)

        def march(o_w=o_w, d_w=d_w, tmax=tmax):
            return rm.march_csg(lib, state, params, o_w, d_w, tmax, hw=(rows, W), **kw)

        t_k = march()
        plain = {}
        tot["plain_ms"] += cuda_ms(lambda: plain.update(t=rm.march_csg_plain(
            lib, state, params, o_w, d_w, tmax, **kw)), 1, warm_up=False)
        outs = [raymarch.shade(lib, state, params, cam, rows, W, env, d_w, d_cam, tmax, t)
                for t in (t_k, plain["t"])]
        tot["shade_ms"] += cuda_ms(lambda: raymarch.shade(lib, state, params, cam, rows, W, env,
                                                          d_w, d_cam, tmax, t_k), 3)
        seg_k, seg_p = outs[0]["seg"][crop:], outs[1]["seg"][crop:]
        tot["agree"] += int((seg_k == seg_p).sum())
        both = (seg_k == seg_p) & (seg_p != -1)
        if both.any():
            tot["err"] = max(tot["err"], float((outs[0]["depth"][crop:] - outs[1]["depth"][crop:])
                                               [both].abs().max()))
        seen_k |= set(seg_k.unique().tolist())
        seen_p |= set(seg_p.unique().tolist())
        tot["wrapper_ms"] += cuda_ms(march, 10)
        ms = kernel_ms(march, "march_csg_kernel", reps=10)
        tot["ms"] += ms if ms is not None else cuda_ms(march, 10)
        tot["need"] += march_need_batch(rm, lib, as_batch(state), as_batch(params), o_w,
                                        d_w[crop * W:], tmax[crop * W:], 64, raymarch.HIT_EPS,
                                        env)[0]
    P = H * W
    agree = tot["agree"] / P
    nbytes = P * (12 + 4 + 4)
    bound, bound_by = bound_of(tot["need"], nbytes)
    xyz = depth_to_xyzmap(frame["depth"], K)
    hit = frame["seg"] != -1
    xyz_err = float((xyz - frame["xyz"])[hit].abs().max())
    print(f"K2 march_csg [the reference camera, fx {float(camera.K[0, 0]):.2f}] {H}x{W} "
          f"({P:,} rays) in "
          f"{n_strips} strips of {rows} rows, {state.pos.shape[0]} bodies, "
          f"{env.center.shape[0]} env boxes: {launches['march_csg']} launches; seg agrees with "
          f"the plain march on {agree:.6f} of pixels, depth max |err| {tot['err']:.3e} m where "
          f"it agrees, bodies seen {sorted(seen_k)} vs {sorted(seen_p)}; kernel "
          f"{tot['ms']:.4f} ms a frame ({tot['ms'] / n_strips:.4f} a strip; the calls, CUDA "
          f"events, {tot['wrapper_ms']:.4f} ms), plain "
          f"{tot['plain_ms']:.1f} ms, label passes (shade) {tot['shade_ms']:.2f} ms, bound "
          f"{bound:.4f} ms, {bound_by} ({tot['need']:.3e} ops, {nbytes:.3e} bytes); "
          f"render_chunked wall {wall_ms:.1f} ms; depth_to_xyzmap against the render's xyz: "
          f"max |err| {xyz_err:.3e} m on {int(hit.sum()):,} pixels", flush=True)
    if agree <= 0.995 or tot["err"] > 2e-3 or seen_k != seen_p:
        fail("march_csg at the reference camera disagrees with its plain version")
    if xyz_err > 1e-4:
        fail("depth_to_xyzmap of the full-resolution depth disagrees with the render's xyz")

    # chunked against one pass at the eval's 384 x 512 (2 strips)
    Ke = torch.as_tensor(scene.K, dtype=torch.float32, device=dev)
    one = raymarch.render(lib, state, params, Ke, cam, scene.H, scene.W, env=env)
    n0 = rm.march_csg.launches
    chk = raymarch.render_chunked(lib, state, params, Ke, cam, scene.H, scene.W, env=env,
                                  rows_per_chunk=rows)
    torch.cuda.synchronize()
    n_eval = rm.march_csg.launches - n0
    eval_agree = float((chk["seg"] == one["seg"]).float().mean())
    both = (chk["seg"] == one["seg"]) & (one["seg"] != -1)
    eval_err = float((chk["depth"] - one["depth"])[both].abs().max())
    print(f"render_chunked against one pass at {scene.H}x{scene.W} ({n_eval} K2 launches, one a "
          f"strip of {rows} rows): seg agrees on {eval_agree:.6f} of pixels, depth max |err| "
          f"{eval_err:.3e} m where it agrees", flush=True)
    if n_eval != -(-scene.H // rows) or eval_agree <= 0.995 or eval_err > 2e-3:
        fail("render_chunked disagrees with a single-pass render at the eval's frame")
    return {"shapes": f"{H}x{W} rays (the reference camera, config.yml) in {n_strips} strips of "
                      f"{rows} rows, {state.pos.shape[0]} bodies, {env.center.shape[0]} env "
                      f"boxes, 64 steps",
            "launches": launches["march_csg"], "seg_agree": agree, "max_abs_err": tot["err"],
            "ms": tot["ms"], "ms_per_strip": tot["ms"] / n_strips, "timing": "torch.profiler",
            "wrapper_ms": tot["wrapper_ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": bound, "bound_by": bound_by,
            "label_pass_ms": tot["shade_ms"], "render_chunked_wall_ms": wall_ms,
            "xyz_max_err": xyz_err,
            "chunked_vs_single_pass_384x512": {"launches": n_eval, "seg_agree": eval_agree,
                                               "max_abs_err": eval_err}}


def sampler_phase(dev, scene, state, params) -> dict:
    """A ``CombinedGraspSampler`` of two NOCS-transfer samplers, the second
    centred (``center_ob_between_gripper``), on the front half's first
    segment (its oracle NUNOCS pose, its collision subsample and
    background), with the launch counts set to 0 just before and read just
    after (2 K1 launches a filter call, 4 in all); K1 held against its plain
    version on each of the four launches' own inputs; then the cone
    sampler with its centering on the same segment (2 launches)."""
    from catgrasp_tpu_torch.config.loader import load_config
    from catgrasp_tpu_torch.grasp.sampler import CombinedGraspSampler, NocsTransferGraspSampler
    from catgrasp_tpu_torch.ops import collision
    from catgrasp_tpu_torch.pipelines import run_grasp_simulation as rgs

    res = rgs.attempt_front(scene, state, params, np.random.default_rng(0),
                            torch.Generator(device=dev).manual_seed(0))
    if res.found is None:
        fail("the front half found no segment for the samplers")
    f, rng = res.found, np.random.default_rng(1)
    ids = rng.choice(len(f.pts), min(len(f.pts), rgs.MAX_COLLISION_PTS), replace=False)
    bg = res.xyz[f.bg_m]
    bg = bg[rng.choice(len(bg), min(len(bg), rgs.MAX_BACKGROUND_PTS), replace=False)]
    can = dict(np.load(os.path.join(REPO, "dataset", "nut_canonical.npz")))
    cfg = load_config("config_run.yml")

    def nocs(center):
        return NocsTransferGraspSampler(
            scene.gripper, can["canonical_grasps"], can["canonical_grasp_scores"],
            score_larger_than=float(cfg.get("nocs_grasp_sampler_score_larger_than", 0.95)),
            max_n_grasp=int(cfg.get("nocs_grasp_sampler_max_n_grasp", 10000)),
            center_ob_between_gripper=center)

    combined = CombinedGraspSampler([nocs(False), nocs(True)])
    bg_t = torch.as_tensor(bg, device=dev)
    bg_mask = torch.ones(len(bg), dtype=torch.bool, device=dev)
    calls, entry = [], collision.box_hits_depths

    def recorder(*args):
        calls.append((args, entry(*args)))
        return calls[-1][1]

    launch_counts(zero=True)
    collision.box_hits_depths = recorder
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        poses, valid, stats = combined.sample_grasps(
            nocs_pose=torch.as_tensor(f.nocs_pose, device=dev), symmetry_tfs=scene.sym,
            background_cloud=bg_t, background_mask=bg_mask, collision_cloud=f.pts[ids],
            collision_mask=np.ones(len(ids), bool), cam_in_world=scene.cam_in_base,
            filter_ik=True, adjust_depth=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        collision.box_hits_depths = entry
    launches = launch_counts()
    half = poses.shape[0] // 2
    n_valid = [int(valid[:half].sum()), int(valid[half:].sum())]
    print(f"CombinedGraspSampler (2 NOCS-transfer samplers, the second centred) on segment "
          f"{f.target}: {poses.shape[0]:,} candidates, valid {n_valid}, {wall:.3f} s; stats "
          f"{json.dumps([{k: int(v) for k, v in s.items()} for s in stats])}; launches "
          f"{json.dumps(launches)}", flush=True)
    if launches["box_hits"] != 4 or len(calls) != 4 or launches["march_csg"] != 0:
        fail(f"the combined sampler launched K1 {launches['box_hits']} times: expected 4")
    if not isinstance(stats, list) or len(stats) != 2 or sum(n_valid) == 0:
        fail("the combined sampler gave no valid candidates")
    names = ("plain, open gripper", "plain, closing volume", "centred, open gripper",
             "centred, closing volume")
    parts = [measure_box_hits(f"combined sampler, {name}", collision, *args, hit_k=hit)
             for name, (args, hit) in zip(names, calls)]
    gate = add_up(parts)
    bound, bound_by = bound_of(gate["ops"], gate["bytes"])
    print(f"K1 box_hits, the combined sampler's 4 launches: kernel {gate['ms']:.4f} ms, "
          f"plain {gate['plain_ms']:.3f} ms, bound {bound:.4f} ms ({bound_by})", flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    n0 = collision.box_hits.launches
    cone = scene.cone.sample_grasps(
        torch.as_tensor(f.pts[ids], device=dev), torch.as_tensor(f.nrm[ids], device=dev),
        background_cloud=bg_t, background_mask=bg_mask, generator=gen,
        cam_in_world=scene.cam_in_base, filter_ik=True, adjust_depth=True,
        center_ob_between_gripper=True)
    torch.cuda.synchronize()
    cone_launches = collision.box_hits.launches - n0
    print(f"the cone sampler with center_ob_between_gripper on segment {f.target}: "
          f"{cone[0].shape[0]:,} candidates, {int(cone[1].sum())} valid, {cone_launches} K1 "
          f"launches", flush=True)
    if cone_launches != 2 or not torch.isfinite(cone[0]).all():
        fail("the centred cone sampler did not run its filter's 2 K1 launches")
    return {"launches": launches, "n_candidates": int(poses.shape[0]), "n_valid": n_valid,
            "wall_s": wall, "cone_centred_valid": int(cone[1].sum()),
            "k1": {"shapes": f"the combined sampler's 4 launches on the front half's segment: "
                             f"P={half:,} a sampler, the collision subsample ({len(ids)} "
                             f"points, 3 open boxes) and the background ({len(bg):,} points, "
                             f"closing box); A=7, D=4",
                   "mismatch_frac": gate["n_diff"] / gate["n_entries"], "ms": gate["ms"],
                   "wrapper_ms": gate["wrapper_ms"], "plain_ms": gate["plain_ms"],
                   "bound_ms": bound, "bound_by": bound_by}}


def scene_tools_phase(dev, scene, state, params, scenes_dir: str) -> dict:
    """``add_duplicate_object_on_pile`` on the front half's settled pile
    (two free slots made active as nut duplicates), then 100 engine steps;
    ``save_state`` and ``restore_state`` (on the card) and the largest
    difference between the two futures of 100 steps (the engine's float
    scatter-adds may not be deterministic on the card); ``scene_from_record``
    on a scene record that the training-data phase wrote."""
    from catgrasp_tpu_torch.core import transforms as tf
    from catgrasp_tpu_torch.pipelines import generate_pile_data as gpd
    from catgrasp_tpu_torch.sim import engine, env_pile, snapshot
    from catgrasp_tpu_torch.sim.types import SceneParams, SceneState

    n_free = 2

    def grow(t, row):  # n_free more body slots holding ``row``
        return torch.cat([t, row.expand((n_free,) + t.shape[1:])])

    st = SceneState(pos=grow(state.pos, torch.zeros(3, device=dev)),
                    quat=grow(state.quat, torch.tensor([1.0, 0, 0, 0], device=dev)),
                    linvel=grow(state.linvel, torch.zeros(3, device=dev)),
                    angvel=grow(state.angvel, torch.zeros(3, device=dev)),
                    active=grow(state.active, torch.zeros((), dtype=torch.bool, device=dev)))
    par = SceneParams(**{k: grow(getattr(params, k), getattr(params, k)[0])
                         for k in ("shape_id", "scale", "mass", "inertia", "friction")})
    n_active = int(st.active.sum())
    gen = torch.Generator(device=dev).manual_seed(0)
    st, par = env_pile.add_duplicate_object_on_pile(gen, st, par, int(params.shape_id[0]), 1.0,
                                                    n_free, scene.pile_cfg, scene.lib)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    settled = engine.rollout(st, par, scene.lib, scene.env_bin, 100)
    torch.cuda.synchronize()
    dup_s = time.perf_counter() - t0
    new = settled.pos[-n_free:]
    print(f"add_duplicate_object_on_pile: {n_active} -> {int(st.active.sum())} active bodies, "
          f"spawned at z {[round(float(z), 4) for z in st.pos[-n_free:, 2]]}; after 100 steps "
          f"({dup_s:.2f} s) at z {[round(float(z), 4) for z in new[:, 2]]}", flush=True)
    if int(st.active.sum()) != n_active + n_free or not torch.isfinite(settled.pos).all():
        fail("add_duplicate_object_on_pile did not add two settling bodies")

    snap = snapshot.save_state(settled)
    later = engine.rollout(settled, par, scene.lib, scene.env_bin, 100)
    restored = snapshot.restore_state(snap)
    same = all(torch.equal(getattr(restored, k).cpu(), getattr(snap, k))
               for k in ("pos", "quat", "linvel", "angvel", "active"))
    later2 = engine.rollout(restored, par, scene.lib, scene.env_bin, 100)
    future_diff = float((later.pos - later2.pos).abs().max())
    print(f"save_state / restore_state: the restored state equals the snapshot: {same} (on "
          f"{restored.pos.device}); the two futures of 100 steps differ by at most "
          f"{future_diff:.3e} m", flush=True)
    if not same or restored.pos.device.type != "cuda" or not np.isfinite(future_diff):
        fail("restore_state did not give the snapshot back on the card")

    path = sorted(p for p in os.listdir(scenes_dir) if p.endswith(".npz"))[0]
    rec = dict(np.load(os.path.join(scenes_dir, path)))
    lib = gpd.category_lib("nut", "train", device=dev)
    rs, rp = snapshot.scene_from_record(rec, lib)
    pose_err = float((tf.pose_from_qt(rs.quat, rs.pos).cpu()
                      - torch.as_tensor(rec["ob_in_world"])).abs().max())
    print(f"scene_from_record on {path} ({int(rs.active.sum())} of {rs.pos.shape[0]} bodies "
          f"active, at rest): poses within {pose_err:.2e} of the record's", flush=True)
    if pose_err > 1e-5 or not torch.equal(rp.shape_id.cpu(), torch.as_tensor(rec["shape_id"]).long()):
        fail("scene_from_record does not restore the record's bodies")
    return {"duplicate_settle_s": dup_s, "future_max_diff_m": future_diff,
            "record_pose_err": pose_err}


def rescore_phase(dev, work: str) -> dict:
    """``rescore_grasp_db --write --rebalance`` on a copy of ``nut_train_0``
    holding the 256 poses of the drift probe (12,800 rollouts of 100
    steps), written under the work directory: the row, the written keys,
    ``score_version`` and the balanced DB."""
    from catgrasp_tpu_torch.pipelines import rescore_grasp_db as rdb

    src = os.path.join(REPO, "dataset", "grasps", "nut_train_0_complete_grasp.npz")
    d = dict(np.load(src, allow_pickle=True))
    ids = np.random.default_rng(0).choice(len(d["scores"]), 256, replace=False)
    d.update(grasp_poses=d["grasp_poses"][ids], scores=d["scores"][ids])
    os.makedirs(os.path.join(work, "grasps_in"))
    db = os.path.join(work, "grasps_in", os.path.basename(src))
    np.savez_compressed(db, **d)
    out_dir, rows = os.path.join(work, "grasps_out"), os.path.join(work, "rescore.jsonl")
    launch_counts(zero=True)
    t0 = time.perf_counter()
    rdb.main(["--db", db, "--write", "--rebalance", "--out_dir", out_dir, "--out", rows])
    wall = time.perf_counter() - t0
    launches = launch_counts()
    row = json.loads(open(rows).read().splitlines()[-1])
    written = np.load(os.path.join(out_dir, os.path.basename(src)))
    bal = np.load(os.path.join(out_dir, "nut_train_0_balanced_grasp.npz"))
    keys = sorted(written.files)
    print(f"rescore_grasp_db --write --rebalance on 256 poses of nut_train_0 ({wall:.2f} s, "
          f"launches {json.dumps(launches)}): written keys {keys}, score_version "
          f"{int(written['score_version'])} ({written['score_version'].dtype}), "
          f"{row['n_balanced']} balanced; Spearman against the stored v3 scores "
          f"{row['spearman']}, mean |diff| {row['mean_abs_diff']}; row {json.dumps(row)}",
          flush=True)
    if keys != sorted(d) or int(written["score_version"]) != 3 \
            or written["scores"].dtype != np.float32 or len(bal["scores"]) != row["n_balanced"] \
            or not row["written"] or row["spearman"] < 0.90 or row["mean_abs_diff"] > 0.07:
        fail("the rescore's written DB is not the DB with fresh v3 scores")
    return {"wall_s": wall, "launches": launches, "row": row, "keys": keys}


def calibration_phase(dev, work: str, scenes_dir: str) -> dict:
    """``calibrate_bandwidth`` with the tracked nut seg net (a copy under the
    work directory, where it writes calib.json) on the training-data
    phase's first 6 scenes."""
    from catgrasp_tpu_torch.pipelines import calibrate_bandwidth as cb

    art = os.path.join(work, "calib", "nut")
    os.makedirs(os.path.join(art, "seg"))
    shutil.copy(os.path.join(REPO, "artifacts_tracked", "nut", "seg", "best_val.ckpt"),
                os.path.join(art, "seg"))
    torch.cuda.synchronize()
    launch_counts(zero=True)
    t0 = time.perf_counter()
    out = cb.main(["--class_name", "nut", "--artifacts", art, "--val_dir", scenes_dir])
    wall = time.perf_counter() - t0
    launches = launch_counts()
    if out is None or not os.path.exists(os.path.join(art, "seg", "calib.json")):
        fail("calibrate_bandwidth wrote no calib.json")
    with open(os.path.join(art, "seg", "calib.json")) as fh:
        written = json.load(fh)
    print(f"calibrate_bandwidth (the tracked nut seg net, {written['n_scenes']} training-data "
          f"scenes, {wall:.2f} s): bandwidth {written['bandwidth']}, stats "
          f"{json.dumps(written['stats'])} (the tracked calib.json: 0.01); launches "
          f"{json.dumps(launches)}", flush=True)
    if written != out or not 0.006 <= written["bandwidth"] <= 0.02:
        fail("calibrate_bandwidth's calib.json is not what it computed")
    if launches["row_group_norm_relu"] == 0:
        fail("calibrate_bandwidth: the seg net's forwards launched no R1")
    return {"wall_s": wall, "launches": launches, **written}


def reducers_phase(dev) -> dict:
    """``connected_components`` and the ``segment_*`` reducers on 4,096
    points in 12 blobs on the card against the same calls on the CPU:
    labels equal, reductions within 1e-6."""
    from catgrasp_tpu_torch.nn import cluster

    rng = np.random.default_rng(0)
    centers = rng.uniform(-0.2, 0.2, (12, 3))
    pts = (centers[rng.integers(0, 12, 4096)] + rng.normal(0, 0.004, (4096, 3))).astype(
        np.float32)
    mask = rng.uniform(size=4096) > 0.05
    vals = rng.normal(size=(4096, 3)).astype(np.float32)
    res = {}
    for d in (dev, torch.device("cpu")):
        p, m, v = (torch.as_tensor(x, device=d) for x in (pts, mask, vals))
        lab = cluster.connected_components(p, 0.01, m)
        seg = torch.unique(lab[lab >= 0], return_inverse=True)[1]
        dense = torch.full_like(lab, -1)
        dense[lab >= 0] = seg
        n = int(seg.max()) + 1
        res[d.type] = [lab] + [getattr(cluster, f"segment_{r}")(v, dense, n).cpu()
                               for r in ("mean", "min", "max")]
    same = torch.equal(res["cuda"][0].cpu(), res["cpu"][0])
    err = max(float((a - b).abs().max()) for a, b in zip(res["cuda"][1:], res["cpu"][1:]))
    n_comp = int(res["cpu"][1].shape[0])
    print(f"connected_components on 4,096 points (12 blobs, 5% masked): {n_comp} components, "
          f"labels on the card equal the CPU's: {same}; segment mean/min/max max |diff| "
          f"{err:.2e}", flush=True)
    if not same or err > 1e-6:
        fail("the cluster reducers on the card disagree with the CPU")
    return {"components": n_comp, "labels_equal": same, "max_abs_diff": err}


def remaining_modules_phase(dev, scene, state, params, work: str, scenes_dir: str) -> dict:
    """Every module of the last slice on the card, each with its launch
    counts set to 0 just before and read just after."""
    t0 = time.perf_counter()
    out = {"fullres": fullres_frame(scene, state, params),
           "samplers": sampler_phase(dev, scene, state, params),
           "scene_tools": scene_tools_phase(dev, scene, state, params, scenes_dir),
           "rescore": rescore_phase(dev, work),
           "calibration": calibration_phase(dev, work, scenes_dir),
           "reducers": reducers_phase(dev)}
    out["wall_s"] = time.perf_counter() - t0
    print(f"remaining modules: {out['wall_s']:.1f} s", flush=True)
    return out


# --------------------------------------------------------------------------
# parallel/: the device mesh, the sharded rollout and map, the mesh train step
# --------------------------------------------------------------------------

PARALLEL_SCENES, PARALLEL_SHARDS, PARALLEL_NET_SHARDS = 64, 4, 2


def parallel_phase(dev, scene, packed_dir: str) -> dict:
    """``parallel/`` on the card, with every launch count set to 0 just
    before and read just after (R1 in the seg net's steps, no other kernel):
    ``make_mesh()`` over the real devices; ``sharded_rollout`` of 64 nut
    piles of the front half's pile config on the real mesh and on a virtual
    mesh of 4 x the card, against one ``rollout_batch`` (within 1e-5 m after 10 steps; after
    50, the largest difference and the share of active bodies within 1e-4
    m); ``sharded_map`` of a per-scene function; one mesh train step of each
    net at its config's width and batch on a virtual mesh of 2 x the card
    against the one-device step from the same parameters (the PointNet nets'
    parameters within 1e-4 of each leaf's norm with TF32 off, the grasp net
    with dropout off; the seg net's gradients at cosine >= 0.999 a leaf),
    with ms a step of both."""
    import copy

    from catgrasp_tpu_torch.config.loader import load_config
    from catgrasp_tpu_torch.data import packed
    from catgrasp_tpu_torch.parallel import mesh as pmesh
    from catgrasp_tpu_torch.parallel import rollout as prollout
    from catgrasp_tpu_torch.pipelines import train_grasp, train_nunocs, train_seg
    from catgrasp_tpu_torch.sim import engine, env_pile
    from catgrasp_tpu_torch.sim.types import SceneParams
    from catgrasp_tpu_torch.train import trainer as T

    t_phase = time.perf_counter()
    launch_counts(zero=True)
    real = pmesh.make_mesh()
    virtual = pmesh.make_mesh(devices=[dev] * PARALLEL_SHARDS)
    print(f"parallel: make_mesh() over the real devices: {real.shape} "
          f"{[str(d) for d in pmesh.dp_sharding(real)]}; virtual mesh {virtual.shape}",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(12)
    states, params = env_pile.reset_batch(gen, scene.lib, scene.pile_cfg, PARALLEL_SCENES,
                                          n_objects=scene.pile_cfg.max_bodies)
    params = SceneParams.create(scene.lib, params.shape_id % scene.n_inst, params.scale)
    lib, env = scene.lib, scene.env_bin

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    rec = {"scenes": PARALLEL_SCENES, "bodies": scene.pile_cfg.max_bodies,
           "mesh_real": real.shape, "mesh_virtual": virtual.shape}
    for n in (10, 50):
        whole, whole_s = wall(lambda: engine.rollout_batch(states, params, lib, env, n))
        chunked, chunked_s = wall(
            lambda: prollout.sharded_rollout(virtual, states, params, lib, env, n))
        on_real = prollout.sharded_rollout(real, states, params, lib, env, n)
        d = (chunked.pos - whole.pos).norm(dim=-1)
        err = float(d.max())
        within = float((d[whole.active] <= 1e-4).float().mean())
        bit_equal = all(torch.equal(getattr(chunked, k), getattr(whole, k))
                        for k in ("pos", "quat", "linvel", "angvel", "active"))
        real_err = float((on_real.pos - whole.pos).abs().max())
        rec[f"steps_{n}"] = {"max_abs_err_m": err, "active_within_1e-4": within,
                             "bit_equal": bit_equal, "real_mesh_max_abs_err_m": real_err,
                             "whole_s": whole_s, "chunked_s": chunked_s}
        print(f"parallel: {PARALLEL_SCENES} piles x {n} steps, {PARALLEL_SHARDS} shards against "
              f"one rollout_batch: max |diff| {err:.3e} m, active bodies within 1e-4 m "
              f"{100 * within:.2f}%, bit-equal {bit_equal}; the real mesh max |diff| "
              f"{real_err:.3e} m; wall {chunked_s:.3f} s chunked, {whole_s:.3f} s whole", flush=True)
        if n == 10 and err > 1e-5:
            fail(f"parallel: the sharded rollout is {err:.3e} m off the whole batch after 10 steps")
        if real_err > 1e-5 and n == 10:
            fail("parallel: the sharded rollout on the real mesh differs from the whole batch")

    def motion(a, b, active):  # one scene: its largest body displacement
        return torch.amax(torch.where(active, (b - a).norm(dim=-1), 0.0))

    whole = engine.rollout_batch(states, params, lib, env, 10)
    mapped = prollout.sharded_map(virtual, motion, states.pos, whole.pos, whole.active)
    direct = engine.max_body_motion(states, whole)
    map_err = float((mapped - direct).abs().max())
    rec["sharded_map_max_abs_err"] = map_err
    print(f"parallel: sharded_map of a scene's largest displacement ({tuple(mapped.shape)}) "
          f"against engine.max_body_motion: max |diff| {map_err:.3e}", flush=True)
    if map_err > 1e-6:
        fail("parallel: sharded_map differs from the batched function")

    net_mesh = pmesh.make_mesh(devices=[dev] * PARALLEL_NET_SHARDS)
    nets = {
        "nunocs": (load_config("config_nunocs.yml"), lambda c: train_nunocs.build(c, "nut"),
                   packed.PackedNunocs),
        "grasp": (load_config("config_grasp.yml"), train_grasp.build, packed.PackedGrasp),
        "seg": (load_config("config_seg.yml"), train_seg.build, packed.PackedSeg)}
    nets["seg"][0]["batch_size"] = 4  # a short run's batch, not the config's 110
    rec["nets"] = {}
    for net, (cfg, build, data) in nets.items():
        torch.cuda.empty_cache()
        bs = cfg["batch_size"]
        ds = data(packed_dir, cfg)
        batch = T.to_device(next(iter(ds.batches(bs))), dev)
        model, loss_fn = build(cfg)
        if net == "grasp":
            model.dropout = 0.0
        one = T.create_state(model, cfg, 100, device=dev)
        sharded = T.TrainState(model=copy.deepcopy(model), tx=None)
        sharded.tx = T.make_optimizer(sharded.model, cfg, 100)
        step_one, step_mesh = T.make_train_step(loss_fn), T.make_train_step(loss_fn, net_mesh)
        _, l_one, _ = step_one(one, batch)
        _, l_mesh, _ = step_mesh(sharded, batch)
        named = dict(sharded.model.named_parameters())
        grad_rel, param_rel, cos_min = 0.0, 0.0, 1.0
        for k, p in one.model.named_parameters():
            q = named[k]
            scale = max(float(p.grad.norm()), 1e-12)
            grad_rel = max(grad_rel, float((q.grad - p.grad).abs().max()) / scale)
            cos = float(torch.nn.functional.cosine_similarity(
                q.grad.flatten(), p.grad.flatten(), dim=0)) if float(p.grad.norm()) > 0 else 1.0
            cos_min = min(cos_min, cos)
            param_rel = max(param_rel, float((q - p).detach().abs().max())
                            / max(float(p.detach().norm()), 1e-12))
        ms_one = cuda_ms(lambda: step_one(one, batch), 5)
        ms_mesh = cuda_ms(lambda: step_mesh(sharded, batch), 5)
        r = {"batch": bs, "shards": PARALLEL_NET_SHARDS, "loss": float(l_one),
             "loss_rel_diff": abs(float(l_mesh) - float(l_one)) / abs(float(l_one)),
             "grad_max_rel_err": grad_rel, "grad_min_cosine": cos_min,
             "param_max_rel_err": param_rel, "ms_one_device": ms_one, "ms_mesh": ms_mesh}
        rec["nets"][net] = r
        print(f"parallel [{net}] batch {bs} on {PARALLEL_NET_SHARDS} shards: loss "
              f"{float(l_mesh):.6f} vs {float(l_one):.6f}; gradients max |diff| "
              f"{grad_rel:.3e} of a leaf's norm, least cosine {cos_min:.6f}; parameters after "
              f"the step {param_rel:.3e} of a leaf's norm; a step {ms_mesh:.3f} ms on the mesh, "
              f"{ms_one:.3f} ms on one device (CUDA events)", flush=True)
        if net == "seg" and cos_min < 0.999:
            fail(f"parallel [seg]: a gradient leaf at cosine {cos_min:.6f} < 0.999")
        if net != "seg" and param_rel > 1e-4:
            fail(f"parallel [{net}]: the mesh step's parameters are {param_rel:.3e} of a leaf's "
                 f"norm off the one-device step's")
        del one, sharded, model, batch
    rec["launches"] = launch_counts()
    rec["wall_s"] = time.perf_counter() - t_phase
    print(f"parallel: launches {json.dumps(rec['launches'])} (R1 in the seg net's steps); "
          f"{rec['wall_s']:.1f} s", flush=True)
    if rec["launches"]["row_group_norm_relu"] == 0:
        fail("parallel: the seg net's mesh and one-device steps launched no R1")
    return rec


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
    work = tempfile.mkdtemp(prefix="catgrasp_smoke_")
    try:
        run_all(dev, logs, card, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


def run_all(dev, logs, card, work) -> None:
    """Every phase, then the ``nets``, ``grasp_db``, ``training``,
    ``train_parity``, ``affordance``, ``arm_dynamics``, ``paired_pick``,
    ``remaining_modules``, ``parallel`` and ``kernels`` lines."""
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
    td_launches, tdata, packed_dir = training_data_phase(dev, work)
    r1 = check_row_group_norm(dev)
    training = training_phase(dev, packed_dir, work)
    train_parity = train_parity_phase(dev, card, packed_dir, work)
    aff_launches, affordance = affordance_phase(dev, card)
    dyn_launches, dyn = dynamics_round(dev, card)
    paired = paired_pick_phase(dev, card)
    remaining = remaining_modules_phase(dev, scene, state, params, work,
                                        os.path.join(work, "train"))
    par = parallel_phase(dev, scene, packed_dir)

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
         "launches_training_data": td_launches["box_hits"],
         "launches_affordance": aff_launches["box_hits"],
         "launches_dynamics_round": dyn_launches["box_hits"],
         "launches_parallel": par["launches"]["box_hits"],
         "at_nocs_gate_dynamics": nocs_gate_row("arm-dynamics round", "nut", dyn["k1"]),
         "launches_combined_sampler": remaining["samplers"]["launches"]["box_hits"],
         "at_combined_sampler": remaining["samplers"]["k1"],
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
             "shapes", "seg_agree", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
         "launches_training_data": td_launches["march_csg"],
         "launches_affordance": aff_launches["march_csg"],
         "launches_dynamics_round": dyn_launches["march_csg"],
         "launches_parallel": par["launches"]["march_csg"],
         "at_dynamics_round": {k: dyn["k2"][k] for k in (
             "shapes", "seg_agree", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
         "launches_fullres_frame": remaining["fullres"]["launches"],
         "at_fullres_frame": {k: remaining["fullres"][k] for k in (
             "shapes", "seg_agree", "max_abs_err", "ms", "ms_per_strip", "timing", "wrapper_ms",
             "plain_ms", "bound_ms", "bound_by", "label_pass_ms")},
         "at_training_data": {
             "frames": {k: tdata["k2_frames"][k] for k in (
                 "shapes", "seg_agree", "seg_agree_bodies", "bodies_seen_equal",
                 "max_abs_err", "ms", "wrapper_ms", "timing", "plain_ms", "bound_ms",
                 "bound_by")},
             "visibility": {k: tdata["k2_visibility"][k] for k in (
                 "shapes", "counts", "max_abs_err", "ms", "wrapper_ms", "timing", "plain_ms",
                 "bound_ms", "bound_by")}}},
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
         "launches_training_data": td_launches["rollout_fused"],
         "launches_affordance": aff_launches["rollout_fused"],
         "launches_dynamics_round": dyn_launches["rollout_fused"],
         "launches_parallel": par["launches"]["rollout_fused"],
         "launches_combined_sampler": remaining["samplers"]["launches"]["rollout_fused"],
         "launches_rescore": remaining["rescore"]["launches"]["rollout_fused"],
         "max_abs_err": k3["max_abs_err"], "within_tol_frac": k3["within_tol_frac"],
         "ms": k3["ms"], "wrapper_ms": k3["wrapper_ms"], "prepare_ms": k3["prepare_ms"],
         "timing": k3["timing"], "plain_ms": k3["plain_ms"], "engine_ms": k3["engine_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"], "library_ms": None,
         "regimes_ms": k3["regimes_ms"], "footprint": k3["footprint"],
         "shapes": k3["shapes"]},
        {"name": "row_group_norm_relu", "route": "cuda",
         "source": "catgrasp_tpu_torch/csrc/row_group_norm.cu",
         "replaces": None,  # the JAX package leaves the head's norm to XLA
         **{f"launches_{k}": v["row_group_norm_relu"] for k, v in (
             ("main_path", launches), ("bench_path", bench_launches),
             ("pickplace_path", pp_launches), ("screw_round", screw_launches),
             ("hnm_round", hnm_launches), ("floating_attempt", float_launches),
             ("grid_round", grid_launches), ("learned_round", learned_launches),
             ("grasp_db", db_launches), ("training_data", td_launches),
             ("train_parity", train_parity["launches"]), ("affordance", aff_launches),
             ("dynamics_round", dyn_launches), ("paired_pick", paired["launches"]),
             ("parallel", par["launches"]),
             ("combined_sampler", remaining["samplers"]["launches"]),
             ("rescore", remaining["rescore"]["launches"]),
             ("calibration", remaining["calibration"]["launches"]))},
         "launches_training_fit": {k: v["r1_launches_fit"] for k, v in training.items()},
         **r1, "library_ms": None},
    ]
    print(json.dumps({"nets": nets}), flush=True)
    print(json.dumps({"grasp_db": {k: v for k, v in grasp_db.items() if k != "k1"}}), flush=True)
    print(json.dumps({"training": {"data": {k: v for k, v in tdata.items()
                                            if not k.startswith("k2_")},
                                   "nets": training}}), flush=True)
    print(json.dumps({"train_parity": train_parity}), flush=True)
    print(json.dumps({"affordance": affordance}), flush=True)
    print(json.dumps({"arm_dynamics": {k: dyn[k] for k in (
        "tally", "attempts", "stage_s", "wall_s", "launches", "dynamicize")}}), flush=True)
    print(json.dumps({"paired_pick": paired}), flush=True)
    print(json.dumps({"remaining_modules": {
        "fullres": remaining["fullres"],
        "samplers": {k: v for k, v in remaining["samplers"].items() if k != "k1"},
        **{k: remaining[k] for k in ("scene_tools", "rescore", "calibration", "reducers",
                                     "wall_s")}}}), flush=True)
    print(json.dumps({"parallel": par}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)


if __name__ == "__main__":
    main()
