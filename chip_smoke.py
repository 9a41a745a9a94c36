#!/usr/bin/env python3
"""Drive the PyTorch port (``catgrasp_tpu_torch``) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:

1. the card's name and power limit (``nvidia-smi``);
2. build both CUDA kernels with ``nvcc`` from ``catgrasp_tpu_torch/csrc``;
3. kernel K1 ``box_hits`` against its plain PyTorch version at the grasp
   filter's shapes (254,848 poses; 512 points x 3 open-gripper boxes and
   4,096 points x the closing box; 7 offsets): agreement, times, bound;
4. the main path, once, at the eval's full size: nut scene set-up, pile
   reset and a 500-step settle, render at 384x512, occupancy, cone sampling
   and the filter — with every kernel's launch count set to 0 just before
   and read just after;
5. kernel K2 ``march_csg`` against its plain version on that settled
   scene at 384x512: agreement, times, bound;
6. a device-time profile (torch.profiler) of 20 settle steps and of one
   attempt, by kernel;
7. a ``kernels`` JSON line, the card line, then ``{"ok": true, ...}``.

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
N_POSES = 254_848  # 64 samples x 181 rotations x 22 depths


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int) -> float:
    """Median wall time of ``fn`` on the device, in ms, from CUDA events
    around each call (after one warm-up call)."""
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
    """Mean device time of the CUDA kernel named ``kernel`` per call of
    ``fn``, in ms, from torch.profiler's CUPTI trace; None when the trace
    shows no device time for it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for evt in prof.key_averages():
        if kernel in evt.key:
            t = getattr(evt, "device_time_total", None)
            total_us += t if t is not None else getattr(evt, "cuda_time_total", 0.0)
    return total_us / reps / 1e3 if total_us > 0 else None


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


def box_hits_work(collision, t_inv, cloud, mask, boxes, offsets, margin):
    """Operations this run's data needs: a pose examines points in order
    until all its offsets are hit (the kernel's early exit), each examined
    point costs the 3x4 transform (9 FMA = 18 ops) and per box the x/z test
    (4 ops), and each x/z pass costs the y test per offset (3 ops)."""
    centers, halves, offs = collision._static_arrays(boxes, offsets, cloud.device)
    P, C, K, A = t_inv.shape[0], cloud.shape[0], len(boxes), len(offsets)
    R, t = t_inv[:, :3, :3], t_inv[:, :3, 3]
    chunk = max(1, (1 << 20) // C)
    ops = 0.0
    for s in range(0, P, chunk):
        pts = torch.einsum("pij,cj->pci", R[s:s + chunk], cloud) + t[s:s + chunk, None, :]
        rel = pts[:, :, None, :] - centers
        ok_xz = ((torch.abs(rel[..., 0]) - halves[:, 0] < margin)
                 & (torch.abs(rel[..., 2]) - halves[:, 2] < margin) & mask[None, :, None])
        q_y = torch.abs(rel[..., 1][..., None] - offs) - halves[:, 1, None]
        hit = (ok_xz[..., None] & (q_y < margin)).any(dim=2)  # (B,C,A)
        first = torch.where(hit.any(dim=1), hit.to(torch.uint8).argmax(dim=1), C)
        need = torch.where((first < C).all(dim=1), first.amax(dim=1) + 1, C)  # (B,)
        xz_cum = torch.cumsum(ok_xz.sum(dim=2), dim=1)  # (B,C)
        xz_need = xz_cum.gather(1, (need - 1)[:, None])[:, 0]
        ops += float(need.sum()) * (18 + 4 * K) + float(xz_need.sum()) * 3 * A
    return ops


def check_box_hits(dev):
    from catgrasp_tpu_torch.grasp import filter as gfilter
    from catgrasp_tpu_torch.ops import collision
    from catgrasp_tpu_torch.sim.env_grasp import GripperSpec

    rng = np.random.default_rng(0)
    T = torch.from_numpy(random_poses(rng, N_POSES)).to(dev)
    t_inv = collision.pose_inverse_batch(T).contiguous()
    offsets = tuple(float(o) for o in gfilter.ADJUST_OFFSETS)
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
    res = {"n_diff": 0, "n_entries": 0, "ms": 0.0, "wrapper_ms": 0.0, "plain_ms": 0.0,
           "bytes": 0.0, "ops": 0.0}
    for name, pts, boxes in cases:
        C = len(pts)
        cloud = torch.from_numpy(pts.astype(np.float32)).to(dev)
        mask = torch.from_numpy(rng.uniform(size=C) > 0.05).to(dev)
        hit_k = collision.box_hits(t_inv, cloud, mask, boxes, offsets, margin)
        hit_p = collision.box_hits_plain(t_inv, cloud, mask, boxes, offsets, margin)
        torch.cuda.synchronize()
        if hit_k.shape != (N_POSES, len(offsets)) or hit_k.dtype != torch.bool:
            fail(f"box_hits {name}: shape {tuple(hit_k.shape)} dtype {hit_k.dtype}")
        n_diff = int((hit_k != hit_p).sum())
        frac_hit = float(hit_p.float().mean())
        ms, wrapper_ms, how = timed(
            lambda: collision.box_hits(t_inv, cloud, mask, boxes, offsets, margin),
            "box_hits_kernel")
        plain_ms = cuda_ms(lambda: collision.box_hits_plain(t_inv, cloud, mask, boxes, offsets,
                                                            margin), 3)
        nbytes = N_POSES * 64 + C * 13 + N_POSES * len(offsets)
        ops = box_hits_work(collision, t_inv, cloud, mask, boxes, offsets, margin)
        bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
        print(f"K1 box_hits [{name}] P={N_POSES} C={C} K={len(boxes)} A={len(offsets)}: "
              f"{n_diff} of {hit_k.numel()} (pose, offset) entries differ from the plain "
              f"version (hit rate {frac_hit:.4f}); kernel {ms:.4f} ms ({how}), wrapper "
              f"{wrapper_ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound:.4f} ms "
              f"({ops:.3e} ops, {nbytes:.3e} bytes)", flush=True)
        if n_diff > 1e-5 * hit_k.numel():
            fail(f"box_hits {name}: {n_diff} entries differ (limit 1e-5 of entries)")
        res["n_diff"] += n_diff
        res["n_entries"] += hit_k.numel()
        res["ms"] += ms
        res["wrapper_ms"] += wrapper_ms
        res["timing"] = how
        res["plain_ms"] += plain_ms
        res["bytes"] += nbytes
        res["ops"] += ops
    return res


# --------------------------------------------------------------------------
# K2 march_csg
# --------------------------------------------------------------------------

# ops of one slot's primitive SDF as the kernel writes it, plus 5 for the
# slot offset and the union/subtract combine (csrc/march_csg.cu)
_SLOT_OPS = {1: 20 + 5, 2: 16 + 5, 3: 36 + 5}
_BODY_OPS = 23  # move the point into the body frame, scale, min-combine
_ENV_OPS = 39  # one env box: move into its frame, box SDF, min
_STEP_OPS = 11  # ray point (3 FMA) and the step update


def march_work(rm, lib, state, params, o_w, d_w, tmax, env, n_steps, hit_eps):
    """Operations this run's data needs: each ray evaluates the scene at
    every step until it converges, over the bodies its tile's cull kept and
    the enabled env boxes (step counts from the plain march's rule)."""
    P = d_w.shape[0]
    t = torch.full((P,), 0.05, device=d_w.device)
    done = torch.zeros((P,), dtype=torch.bool, device=d_w.device)
    evals = torch.zeros((P,), device=d_w.device)
    for _ in range(n_steps):
        evals += (~done).float()
        x = o_w + t[:, None] * d_w
        phi = torch.minimum(torch.amin(rm.scene_sdf(lib, state, params, x)[0], dim=-1),
                            rm.env_sdf(env, x))
        newly = phi < hit_eps
        t = torch.where(done | newly, t, torch.minimum(t + torch.clamp(phi, min=hit_eps / 2),
                                                       tmax))
        done = done | newly | (t >= tmax)
    types = lib.csg.types[params.shape_id].cpu().numpy()
    body_ops = np.array([_BODY_OPS + sum(_SLOT_OPS.get(int(c), 0) for c in row)
                         for row in types], np.float64)
    n_tiles = -(-P // rm.TILE)
    pad = n_tiles * rm.TILE - P
    d_pad = torch.cat([d_w, d_w[-1:].expand(pad, 3)]) if pad else d_w
    radius_w = lib.radius[params.shape_id] * params.scale
    visidx, visn = rm.tile_visibility(o_w, d_pad, state.pos, radius_w, state.active)
    visidx, visn = visidx.cpu().numpy(), visn.cpu().numpy()
    tile_ops = np.array([body_ops[visidx[k, :visn[k]]].sum() for k in range(n_tiles)])
    per_ray = np.repeat(tile_ops, rm.TILE)[:P] + _STEP_OPS \
        + _ENV_OPS * int(env.enabled.sum())
    return float((evals.cpu().numpy() * per_ray).sum())


def check_march(dev, scene, state, params):
    from catgrasp_tpu_torch.ops import render_march as rm
    from catgrasp_tpu_torch.render import raymarch

    cam = torch.as_tensor(scene.cam, device=dev)
    env = scene.env_bin
    o_w, d_w, d_cam, tmax = raymarch.camera_rays(scene.K, cam, scene.H, scene.W)
    kw = dict(env=env, n_steps=64, hit_eps=raymarch.HIT_EPS)
    t_k = rm.march_csg(scene.lib, state, params, o_w, d_w, tmax, **kw)
    t_p = rm.march_csg_plain(scene.lib, state, params, o_w, d_w, tmax, **kw)
    out_k = raymarch.shade(scene.lib, state, params, cam, scene.H, scene.W, env, d_w, d_cam,
                           tmax, t_k)
    out_p = raymarch.shade(scene.lib, state, params, cam, scene.H, scene.W, env, d_w, d_cam,
                           tmax, t_p)
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
        lambda: rm.march_csg(scene.lib, state, params, o_w, d_w, tmax, **kw), "march_csg_kernel")
    plain_ms = cuda_ms(lambda: rm.march_csg_plain(scene.lib, state, params, o_w, d_w, tmax,
                                                  **kw), 3)
    P = d_w.shape[0]
    nbytes = P * (12 + 4 + 4)
    ops = march_work(rm, scene.lib, state, params, o_w, d_w, tmax, env, 64, raymarch.HIT_EPS)
    bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    print(f"K2 march_csg {scene.H}x{scene.W} ({P} rays), {state.pos.shape[0]} bodies, "
          f"{env.center.shape[0]} env boxes: seg agrees on {agree:.6f} of pixels, depth max "
          f"|err| {err:.3e} m where it agrees, bodies seen {sorted(visible_k)} vs "
          f"{sorted(visible_p)}; kernel {ms:.4f} ms ({how}), wrapper {wrapper_ms:.4f} ms, "
          f"plain {plain_ms:.3f} ms, bound "
          f"{bound:.4f} ms ({ops:.3e} ops, {nbytes:.3e} bytes)", flush=True)
    if agree <= 0.995 or err > 2e-3 or visible_k != visible_p:
        fail("march_csg disagrees with its plain version")
    return {"max_abs_err": err, "ms": ms, "wrapper_ms": wrapper_ms, "timing": how,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if ops / F32_OPS_PER_S > nbytes / HBM_BYTES_PER_S
            else "bytes"}


# --------------------------------------------------------------------------
# the main path
# --------------------------------------------------------------------------


def main_path(dev):
    from catgrasp_tpu_torch.ops import collision, render_march
    from catgrasp_tpu_torch.pipelines import run_grasp_simulation as rgs

    collision.box_hits.launches = 0
    render_march.march_csg.launches = 0
    t0 = time.perf_counter()
    scene = rgs.setup_scene("nut", n_objects=5, render_hw=(384, 512), device=dev)
    torch.cuda.synchronize()
    times = {"setup_s": time.perf_counter() - t0}
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    state, params = rgs.make_round_pile(scene, rng, gen, settle_steps=500, timings=times)
    res = rgs.oracle_cone_attempt(scene, state, params, rng, gen)
    torch.cuda.synchronize()
    launches = {"box_hits": collision.box_hits.launches,
                "march_csg": render_march.march_csg.launches}
    times.update(res.timings)
    times["total_s"] = time.perf_counter() - t0
    print("main path stage times (s, synchronised): "
          + json.dumps({k: round(v, 6) for k, v in times.items()}), flush=True)
    print(f"main path launches: {json.dumps(launches)}; bodies active after settle "
          f"{state.active.int().tolist()}; segments tried {len(res.tried)}", flush=True)
    for t in res.tried:
        s = t["stats"]
        print(f"  segment {t['seg']}: G={t['n_candidates']} candidates, {t['n_valid']} valid, "
              f"fstats {json.dumps(s)}", flush=True)
        total = s["n_approach_dir_rej"] + s["n_ik_rej"] + s["n_collision_rej"] + t["n_valid"]
        if total != t["n_candidates"]:
            fail(f"filter counters sum to {total}, not G={t['n_candidates']}")
    if not res.tried:
        fail("no segment was large enough to sample")
    if res.found is None:
        fail("no segment yielded grasp candidates")
    if res.tried[-1]["n_candidates"] != N_POSES:
        fail(f"G={res.tried[-1]['n_candidates']}, expected {N_POSES}")
    if launches["box_hits"] != 8 * len(res.tried):
        fail(f"box_hits launched {launches['box_hits']} times for {len(res.tried)} filter calls")
    if launches["march_csg"] < 1:
        fail("march_csg was not launched on the main path")
    out = res.out
    if out["depth"].shape != (384, 512) or not all(torch.isfinite(v).all() for v in out.values()):
        fail("render output has the wrong shape or non-finite values")
    if not np.isfinite(res.found[4]).all():
        fail("non-finite candidate poses")
    print(f"candidates: {len(res.found[4])} grasps on body {res.found[1]} "
          f"(fstats {json.dumps(res.fstats)})", flush=True)
    return scene, state, params, launches, times


def device_profile(label: str, fn, wall_s: float) -> None:
    """Print the device time of ``fn`` by CUDA kernel (torch.profiler) and
    its busy share of ``wall_s``, the same work's wall time unprofiled."""
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

    k1 = check_box_hits(dev)
    scene, state, params, launches, times = main_path(dev)
    k2 = check_march(dev, scene, state, params)

    # where the main path's time goes on the device (launches made here are
    # outside the counted run)
    from catgrasp_tpu_torch.pipelines import run_grasp_simulation as rgs
    from catgrasp_tpu_torch.sim import engine
    device_profile("20 settle steps",
                   lambda: engine.rollout(state, params, scene.lib, scene.env_bin, 20),
                   times["settle_s"] * 20 / 500)
    device_profile("one attempt: render, occupancy, sample + filter",
                   lambda: rgs.oracle_cone_attempt(scene, state, params,
                                                   np.random.default_rng(0),
                                                   torch.Generator(device=dev).manual_seed(0)),
                   times["render_s"] + times["occupancy_s"] + times["sample_filter_s"])

    k1_bound = max(k1["bytes"] / HBM_BYTES_PER_S, k1["ops"] / F32_OPS_PER_S) * 1e3
    kernels = [
        {"name": "box_hits", "route": "cuda", "source": "catgrasp_tpu_torch/csrc/box_hits.cu",
         "replaces": "catgrasp_tpu/ops/collision.py:81", "launches": launches["box_hits"],
         "max_abs_err": float(k1["n_diff"] > 0), "mismatch_frac": k1["n_diff"] / k1["n_entries"],
         "ms": k1["ms"], "wrapper_ms": k1["wrapper_ms"], "timing": k1["timing"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1_bound,
         "bound_by": "operations" if k1["ops"] / F32_OPS_PER_S > k1["bytes"] / HBM_BYTES_PER_S
         else "bytes", "library_ms": None,
         "shapes": f"P={N_POSES}; C=512 (3 open boxes) + C=4096 (closing box); A=7"},
        {"name": "march_csg", "route": "cuda", "source": "catgrasp_tpu_torch/csrc/march_csg.cu",
         "replaces": "catgrasp_tpu/ops/render_march.py:223", "launches": launches["march_csg"],
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"], "wrapper_ms": k2["wrapper_ms"],
         "timing": k2["timing"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"], "library_ms": None,
         "shapes": f"{scene.H}x{scene.W} rays, {state.pos.shape[0]} bodies, "
                   f"{scene.env_bin.center.shape[0]} env boxes, 64 steps"},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
