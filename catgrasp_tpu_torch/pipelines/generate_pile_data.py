"""Synthetic pile scenes for training (``catgrasp_tpu/pipelines/
generate_pile_data.py`` in PyTorch).

Per batch of scenes: drop random piles and settle them for a fixed number
of engine steps, jitter a camera per scene keeping the bin in frame, render
the labeled frames (depth, instance seg, NUNOCS, normals, rgb) and the
per-body visibility, and write one ``.npz`` per scene:

  rgb (H,W,3) u8        depth (H,W) u16 in 0.1 mm      seg (H,W) i16
  nocs (H,W,3) f16      normal (H,W,3) f16 (camera frame)
  ob_in_world (N,4,4)   scales (N,)   shape_id (N,)   active (N,)
  vis_ratio (N,)        K (3,3)       cam_in_world (4,4)   class_name

The cloud (xyz) is not stored: ``data.labels.load_scene`` rebuilds it from
the depth.  On the GPU the frames of a batch are marched in one K2 launch
and the visibility's full and solo frames in another.  The next batch is
queued on the device before the previous one is copied to the host (pinned
memory on a side stream), and level-1 deflate writer threads compress the
files while the device works.

    python -m catgrasp_tpu_torch.pipelines.generate_pile_data --class_name nut \\
        --split train --n_scenes 64
"""
from __future__ import annotations

import argparse
import math
import os
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from numpy.lib import format as npformat

from ..config.loader import load_config
from ..core import transforms as tf
from ..device import resolve_device
from ..geom import csg as csglib
from ..geom import primitives as prim
from ..render import raymarch
from ..sim import engine, env_pile
from ..sim.types import build_shape_lib
from ..utils.metrics import StageClock
from ..utils.outputs import refuse_tracked

DEFAULT_OUT_DIR = "dataset/torch"
N_CANDIDATES = 8  # camera poses drawn a scene; the first with the bin in frame wins
VIS_DOWNSCALE = 4  # the visibility frames' resolution divisor
LOOK_DOWN = ((1.0, 0.0, 0.0), (0.0, -1.0, 0.0), (0.0, 0.0, -1.0))
# the bin's 8 top and bottom corners (its inner 0.3 m box)
BIN_CORNERS = tuple((sx * 0.15, sy * 0.15, z) for sx in (-1, 1) for sy in (-1, 1)
                    for z in (0.0, 0.12))


def default_out_dir(class_name: str, split: str) -> str:
    return f"{DEFAULT_OUT_DIR}/{class_name}/{split}"


def category_lib(class_name: str, split: str, n_surf: int = 48, device=None):
    """The shapes a split renders: train and val scenes the train
    instances, test scenes the test instances."""
    inst_split = "test" if split == "test" else "train"
    n = prim.num_instances(class_name, inst_split)
    meshes = [prim.make_instance(class_name, inst_split, i) for i in range(n)]
    csgs = [csglib.make_csg_instance(class_name, inst_split, i) for i in range(n)]
    return build_shape_lib(meshes, csgs, n_surf=n_surf, device=device)


def camera_candidates(generator: torch.Generator, batch: int, jitter: float = 0.05,
                      max_rot_deg: float = 10.0, n: int = N_CANDIDATES):
    """The draws of ``n`` jittered cameras a scene: (dxy (B, n, 2), dz (B,
    n), rotation axis (B, n, 3), angle (B, n)); ±``jitter`` m and up to
    ``max_rot_deg`` about a uniform axis (the reference's
    ``random_uniform_magnitude(max_T=0.05, max_R=10)``)."""
    dxy = tf._uniform(generator, (batch, n, 2), -jitter, jitter)
    dz = tf._uniform(generator, (batch, n), -jitter, jitter)
    axis = tf.random_direction(generator, (batch, n))
    ang = tf._uniform(generator, (batch, n), -1.0, 1.0) * math.radians(max_rot_deg)
    return dxy, dz, axis, ang


def pick_camera(dxy, dz, axis, ang, K, hw, base_height: float = 0.6):
    """Cameras (B, 4, 4) from the candidate draws: each scene's first
    candidate whose 8 bin corners all project inside the (H, W) frame in
    front of the camera, else the straight-down camera at ``base_height``.
    The pick stays on the device."""
    dev = dxy.device
    H, W = hw
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    look = torch.tensor(LOOK_DOWN, device=dev)
    R = look @ tf.axis_angle_to_matrix(axis, ang)  # (B, n, 3, 3)
    t = torch.cat([dxy, (base_height + dz)[..., None]], dim=-1)
    cams = tf.pose_from_rt(R, t)
    corners = torch.tensor(BIN_CORNERS, device=dev)
    pc = tf.transform_points(tf.pose_inverse(cams), corners)  # (B, n, 8, 3)
    z = torch.clamp(pc[..., 2], min=1e-6)
    u = K[0, 0] * pc[..., 0] / z + K[0, 2]
    v = K[1, 1] * pc[..., 1] / z + K[1, 2]
    ok = ((u >= 0) & (u < W) & (v >= 0) & (v < H) & (pc[..., 2] > 0)).all(dim=-1)  # (B, n)
    first = torch.argmax(ok.to(torch.int32), dim=-1)  # the first valid candidate
    pick = torch.take_along_dim(cams, first[:, None, None, None], dim=1)[:, 0]
    fallback = tf.pose_from_rt(look, torch.tensor([0.0, 0.0, base_height], device=dev))
    return torch.where(ok.any(dim=-1)[:, None, None], pick, fallback)


def random_camera(generator: torch.Generator, batch: int, K, hw, **kw):
    """``batch`` jittered top-down cameras keeping the bin in frame."""
    return pick_camera(*camera_candidates(generator, batch, **kw), K, hw)


def frame_geometry(cfg: dict):
    """(K (3, 3) f32, H, W) of the rendered frames: the config's camera at
    ``render_downscale``."""
    ds = cfg.get("render_downscale", 0.25)
    K = np.array(cfg["K"], np.float32).reshape(3, 3).copy()
    K[:2] *= ds
    return K, int(cfg["H"] * ds), int(cfg["W"] * ds)


def pile_config(cfg: dict) -> env_pile.PileConfig:
    return env_pile.PileConfig(max_bodies=int(cfg["dataset"]["num_pile_objects"][1]),
                               scale_range=tuple(cfg["dataset"]["object_scales"]))


def draw_batch(generator: torch.Generator, lib, pile_cfg, batch: int, K, hw):
    """Every draw of one batch, from the generator in a fixed order: the
    piles' resets, then the cameras.  Returns (states, params, cams)."""
    states, params = env_pile.reset_batch(generator, lib, pile_cfg, batch)
    return states, params, random_camera(generator, batch, K, hw)


def make_batch(generator: torch.Generator, lib, pile_cfg, env, K, hw, batch: int,
               settle_steps: int = 400, timings: dict | None = None) -> dict:
    """One batch on the device: reset, a fixed ``settle_steps`` settle
    through the engine, the cameras, the full frames (one K2 launch on the
    GPU) and their label passes, the visibility (one more launch), encoded
    for the disk.  With ``timings`` each stage is timed (the device
    synchronised at its end): settle_s, render_s, label_s, visibility_s."""
    H, W = hw
    clock = StageClock(timings, lib.device)
    states, params, cams = draw_batch(generator, lib, pile_cfg, batch, K, hw)
    states = env_pile.settle_fixed(states, params, lib, env, pile_cfg, settle_steps)
    clock.lap("settle_s")
    Kt = torch.as_tensor(K, dtype=torch.float32, device=lib.device)
    t, d_cam, tmax = raymarch.march_frames(lib, states, params, Kt, cams, H, W, env=env)
    clock.lap("render_s")
    outs = raymarch.shade_frames(lib, states, params, cams, H, W, env, d_cam, tmax, t)
    clock.lap("label_s")
    Kv = Kt.clone()
    Kv[:2] /= VIS_DOWNSCALE
    vis = raymarch.visibility_ratio_batch(lib, states, params, Kv, cams, H // VIS_DOWNSCALE,
                                          W // VIS_DOWNSCALE)
    clock.lap("visibility_s")
    return encode_batch(outs, states, params, cams, vis)


def encode_batch(outs: dict, states, params, cams, vis) -> dict:
    """A batch's frames and labels in the on-disk encoding, on the device:
    rgb u8, depth in 0.1 mm counts (int32 here, u16 in the file), seg i16,
    nocs and normal f16 (the xyz cloud is not stored)."""
    return {
        "rgb": (outs["rgb"] * 255).to(torch.uint8),
        "depth": torch.round(outs["depth"] * 1e4).to(torch.int32),
        "seg": outs["seg"].to(torch.int16),
        "nocs": outs["nocs"].half(),
        "normal": outs["normal"].half(),
        "ob_in_world": tf.pose_from_qt(states.quat, states.pos),
        "scales": params.scale,
        "shape_id": params.shape_id.to(torch.int32),
        "active": states.active,
        "vis_ratio": vis,
        "cam_in_world": cams,
    }


class HostCopy:
    """A batch's tensors copied to the host.  On the GPU the copy runs on a
    side stream into pinned memory once the device has made them, so it
    overlaps the next batch's work; ``result`` waits for it alone."""

    _streams: dict = {}

    def __init__(self, tensors: dict):
        dev = next(iter(tensors.values())).device
        self.event = None
        if dev.type != "cuda":
            self.host = tensors
            return
        stream = HostCopy._streams.setdefault(dev, torch.cuda.Stream(dev))
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self.host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                         .copy_(v, non_blocking=True) for k, v in tensors.items()}
            for v in tensors.values():
                v.record_stream(stream)
            self.event = torch.cuda.Event()
            self.event.record(stream)

    def result(self) -> dict:
        if self.event is not None:
            self.event.synchronize()
        return {k: v.numpy() for k, v in self.host.items()}


def write_scene(path: str, payload: dict) -> float:
    """One scene's ``.npz`` at deflate level 1 (``np.load`` reads it as any
    ``.npz``); returns the seconds it took."""
    t0 = time.perf_counter()
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED, compresslevel=1) as zf:
        for k, v in payload.items():
            with zf.open(k + ".npy", "w") as f:
                npformat.write_array(f, np.asarray(v), allow_pickle=False)
    return time.perf_counter() - t0


def check_range(start: int, n_scenes: int, batch: int) -> None:
    if start % batch != 0:
        raise ValueError(f"--start must be a multiple of batch={batch}")
    if start >= n_scenes:
        # n_scenes is the END id, not a count
        raise ValueError(
            f"--n_scenes ({n_scenes}) is the exclusive END scene id, which "
            f"must exceed --start ({start}); to append K scenes pass "
            f"--n_scenes {start}+K")


def generate_scenes(class_name: str, split: str, n_scenes: int, out_dir: str,
                    cfg: dict | None = None, seed: int = 0, settle_steps: int = 400,
                    batch: int = 16, start: int = 0, device=None,
                    timings: dict | None = None) -> str:
    """Scenes ``start`` .. ``n_scenes - 1`` (an exclusive END id) of a split,
    written to ``out_dir/{id:07d}.npz``.  Draws come from one
    ``torch.Generator`` seeded with ``seed``; a resumed run (``start`` > 0,
    a multiple of ``batch``) makes the skipped batches' draws first, so it
    continues the stream of an uninterrupted run.  With ``timings`` the
    stages are timed (``make_batch``) and ``write_s``, the writer threads'
    seconds, is added."""
    check_range(start, n_scenes, batch)
    dev = resolve_device(device)
    cfg = cfg or load_config("config.yml")
    K, H, W = frame_geometry(cfg)
    lib = category_lib(class_name, split, device=dev)
    pile_cfg = pile_config(cfg)
    env = engine.StaticEnv.open_bin(pile_cfg.bin_inner, device=dev)
    os.makedirs(out_dir, exist_ok=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for _ in range(start // batch):
        draw_batch(gen, lib, pile_cfg, batch, K, (H, W))
    n_batches = -(-(n_scenes - start) // batch)
    scene_id = start
    futures = []

    def drain(pending, pool):
        nonlocal scene_id
        host = pending.result()
        for b in range(min(batch, n_scenes - scene_id)):
            payload = {k: host[k][b] for k in ("rgb", "depth", "seg", "nocs", "normal")}
            payload["depth"] = payload["depth"].astype(np.uint16)
            payload.update(ob_in_world=host["ob_in_world"][b], scales=host["scales"][b],
                           shape_id=host["shape_id"][b], active=host["active"][b],
                           vis_ratio=host["vis_ratio"][b], K=K,
                           cam_in_world=host["cam_in_world"][b], class_name=class_name)
            futures.append(pool.submit(write_scene, f"{out_dir}/{scene_id:07d}.npz", payload))
            scene_id += 1
        while len(futures) > 64:  # bound the host copies in flight
            _record_write(timings, futures.pop(0).result())
        print(f"{scene_id}/{n_scenes} scenes", flush=True)

    with ThreadPoolExecutor(max_workers=2) as pool:
        pending = None
        for _ in range(n_batches):
            nxt = HostCopy(make_batch(gen, lib, pile_cfg, env, K, (H, W), batch, settle_steps,
                                      timings))
            if pending is not None:
                drain(pending, pool)
            pending = nxt
        drain(pending, pool)
        for f in futures:
            _record_write(timings, f.result())  # surface any writer exception
    return out_dir


def _record_write(timings, seconds: float) -> None:
    if timings is not None:
        timings["write_s"] = timings.get("write_s", 0.0) + seconds


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--class_name", default="nut")
    ap.add_argument("--split", default="train")
    ap.add_argument("--n_scenes", type=int, default=64,
                    help="exclusive END scene id (NOT a count): generates "
                         "ids [start, n_scenes)")
    ap.add_argument("--out_dir", default=None,
                    help=f"default {DEFAULT_OUT_DIR}/<class>/<split>")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--start", type=int, default=0,
                    help="resume: first scene id to generate (multiple of 16)")
    ap.add_argument("--device", default=device)
    args = ap.parse_args(argv)
    out = args.out_dir or default_out_dir(args.class_name, args.split)
    refuse_tracked(out)
    return generate_scenes(args.class_name, args.split, args.n_scenes, out, seed=args.seed,
                           start=args.start, device=args.device)


if __name__ == "__main__":
    main()
