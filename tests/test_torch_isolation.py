"""The port stands alone: no JAX, no flax, no msgpack, nothing of
``catgrasp_tpu``;
GPU by default, never a quiet fall back to the CPU.  This file imports no
JAX either, so it also runs on a GPU machine without it
(``python -m pytest --noconftest tests/test_torch_isolation.py``)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from catgrasp_tpu_torch import bench, convert
from catgrasp_tpu_torch.geom import collision_manager, csg, primitives, sdf, sdf_io
from catgrasp_tpu_torch.grasp.gripper import Gripper
from catgrasp_tpu_torch.ops import collision, fused_rollout, render_march
from catgrasp_tpu_torch.pipelines import generate_grasp, make_sdf, rescore_grasp_db
from catgrasp_tpu_torch.pipelines import run_grasp_simulation as rgs
from catgrasp_tpu_torch.predict.artifacts import load_predicters
from catgrasp_tpu_torch.sim import engine, env_pile
from catgrasp_tpu_torch.sim.types import SceneState, build_shape_lib, stack_scenes

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import catgrasp_tpu_torch
for m in pkgutil.walk_packages(catgrasp_tpu_torch.__path__, "catgrasp_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
names = {"jax", "flax", "msgpack", "catgrasp_tpu"}
bad = sorted(n for n in sys.modules
             if n in names or any(n.startswith(p + ".") for p in names))
print("\\n".join(bad))
print("port", " ".join(sorted(n for n in sys.modules if n.startswith("catgrasp_tpu_torch"))))
print("modules", len([n for n in sys.modules if n.startswith("catgrasp_tpu_torch")]))
"""
# modules the probe must reach, the baked-SDF geometry, the floating
# baseline's place and learned perception among them
NEEDED = ("catgrasp_tpu_torch.geom.sdf", "catgrasp_tpu_torch.geom.sdf_io",
          "catgrasp_tpu_torch.geom.mesh", "catgrasp_tpu_torch.sim.env_semantic",
          "catgrasp_tpu_torch.render.raymarch", "catgrasp_tpu_torch.pipelines.run_grasp_simulation",
          "catgrasp_tpu_torch.nn.pointnet", "catgrasp_tpu_torch.nn.voxelnet",
          "catgrasp_tpu_torch.nn.cluster", "catgrasp_tpu_torch.predict.ckpt",
          "catgrasp_tpu_torch.predict.ransac", "catgrasp_tpu_torch.predict.predicter",
          "catgrasp_tpu_torch.predict.artifacts", "catgrasp_tpu_torch.data.augment",
          "catgrasp_tpu_torch.pipelines.generate_grasp", "catgrasp_tpu_torch.pipelines.make_sdf",
          "catgrasp_tpu_torch.pipelines.rescore_grasp_db", "catgrasp_tpu_torch.grasp.contacts",
          "catgrasp_tpu_torch.geom.collision_manager")


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert lines[-1].startswith("modules") and int(lines[-1].split()[1]) >= 20
    assert lines[-2].startswith("port ")
    assert set(NEEDED) <= set(lines[-2].split()[1:])
    assert lines[:-2] == [], f"imported: {lines[:-2]}"


def test_the_ports_outputs_default_to_untracked_directories():
    """``generate_grasp`` and ``make_sdf`` write where git tracks nothing by
    default (directories ``.gitignore`` lists), never over the JAX
    package's DBs and grids."""
    from catgrasp_tpu_torch.pipelines import generate_grasp, make_sdf
    with open(os.path.join(REPO, ".gitignore")) as fh:
        ignored = {line.strip().rstrip("/") for line in fh if line.strip()}
    for out in (generate_grasp.DEFAULT_OUT_DIR, make_sdf.DEFAULT_OUT_DIR):
        assert out in ignored, out
        if os.path.isdir(os.path.join(REPO, ".git")):
            r = subprocess.run(["git", "ls-files", "--", out], cwd=REPO, capture_output=True,
                               text=True, timeout=60)
            assert r.returncode == 0 and r.stdout == "", r.stdout


def test_entry_points_raise_without_a_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh = primitives.make_instance("nut", "test", 0)
    calls = [
        lambda: rgs.setup_scene("nut", n_objects=2, render_hw=(8, 8)),
        lambda: build_shape_lib([mesh], [csg.make_csg_instance("nut", "test", 0)], n_surf=8),
        lambda: engine.StaticEnv.open_bin(),
        lambda: engine.StaticEnv.boxes([[0, 0, 0]], [[1, 1, 1]]),
        lambda: SceneState.create(3),
        lambda: convert.scene_state_from_numpy(
            {"pos": np.zeros((1, 3)), "quat": np.eye(4)[:1], "linvel": np.zeros((1, 3)),
             "angvel": np.zeros((1, 3)), "active": np.ones(1, bool)}),
        lambda: bench.run(),
        lambda: bench.bench_env_steps(batch=2, max_bodies=2, n_surf=8, steps_per_call=1,
                                      n_calls=1),
        lambda: bench.bench_collision_gate(n_poses=4, n_points=4, n_calls=1),
        lambda: bench.bench_ik_gate(n_poses=4, n_calls=1),
        lambda: bench.bench_render(batch=1, hw=(4, 4), n_calls=1),
        lambda: rgs.simulate_grasp_rounds("nut", n_rounds=1, n_objects=2, render_hw=(8, 8),
                                          verbose=False),
        lambda: rgs.main(["--class_name", "nut", "--n_rounds", "1", "--oracle", "1"]),
        lambda: rgs.setup_scene("nut", n_objects=2, render_hw=(8, 8),
                                obj_path=os.path.join(REPO, "assets", "nut_demo.obj")),
        lambda: sdf.bake_sdf(mesh.vertices, mesh.faces, dims=8),
        lambda: build_shape_lib([mesh], n_surf=8, bake_grids=True),
        lambda: sdf_io.grid_from_file(os.path.join(REPO, "assets", "nut_demo.obj")),
        lambda: load_predicters(os.path.join(REPO, "artifacts_tracked", "nut"), "nut"),
        lambda: generate_grasp.generate_complete_grasps(
            "nut", "train", 0, Gripper.default(), {"max_num_surface_points": 2}),
        lambda: generate_grasp.main(["--index", "0", "--out_dir", str(tmp_path)]),
        lambda: make_sdf.make_sdf_one(mesh.vertices, mesh.faces),
        lambda: rescore_grasp_db.rescore(
            os.path.join(REPO, "dataset", "grasps", "nut_train_0_complete_grasp.npz"), 2, 1),
        lambda: collision_manager.CollisionManager(),
        lambda: rgs.main(["--class_name", "nut", "--n_rounds", "1", "--oracle", "0",
                          "--artifacts", os.path.join(REPO, "artifacts_tracked", "nut")]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # the same calls run when the caller asks for the CPU
    assert rgs.setup_scene("nut", n_objects=2, render_hw=(8, 8),
                           device="cpu").lib.device.type == "cpu"


def test_kernel_wrappers_launch_nothing_for_cpu_tensors():
    lib = build_shape_lib([primitives.make_instance("nut", "test", 0)],
                          [csg.make_csg_instance("nut", "test", 0)], n_surf=8, device="cpu")
    from catgrasp_tpu_torch.sim.types import SceneParams
    params = SceneParams.create(lib, [0])
    state = SceneState.create(1, device="cpu")
    state.active[:] = True
    d = torch.tensor([[0.0, 0.0, -1.0]])
    n0 = (collision.box_hits.launches, render_march.march_csg.launches,
          fused_rollout.rollout_fused.launches)
    t = render_march.march_csg(lib, state, params, torch.tensor([0.008, 0.0, 0.5]), d,
                               torch.tensor([3.0]))
    assert abs(float(t[0]) - (0.5 - 0.00375)) < 1e-3  # the nut's top face, off the hole
    collision.box_hits(torch.eye(4)[None], torch.zeros((1, 3)), torch.ones(1, dtype=torch.bool),
                       ((((0.0, 0.0, 0.0)), (1.0, 1.0, 1.0)),), (0.0,), 5e-4)
    state.pos[0, 2] = 0.1
    out = fused_rollout.rollout_fused(stack_scenes([state]), stack_scenes([params]), lib,
                                      engine.StaticEnv.open_bin(device="cpu"), 2)
    assert out.pos.shape == (1, 1, 3) and float(out.pos[0, 0, 2]) < 0.1  # it falls
    assert (collision.box_hits.launches, render_march.march_csg.launches,
            fused_rollout.rollout_fused.launches) == n0


def test_cuda_tensors_launch_the_kernels(monkeypatch):
    """On CUDA tensors every wrapper builds and launches its kernel (each
    launch counted); the plain versions are never taken there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from catgrasp_tpu_torch.ops import build

    def no_plain(*a, **k):
        raise AssertionError("plain version taken for CUDA tensors")

    monkeypatch.setattr(collision, "box_hits_plain", no_plain)
    monkeypatch.setattr(collision, "box_hits_depths_plain", no_plain)
    monkeypatch.setattr(render_march, "march_csg_plain", no_plain)
    monkeypatch.setattr(fused_rollout, "rollout_fused_plain", no_plain)
    build.build_all()
    dev = torch.device("cuda")
    n0 = (collision.box_hits.launches, render_march.march_csg.launches)
    hit = collision.box_hits(torch.eye(4, device=dev)[None], torch.zeros((1, 3), device=dev),
                             torch.ones(1, dtype=torch.bool, device=dev),
                             (((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),), (0.0,), 5e-4)
    lib = build_shape_lib([primitives.make_instance("nut", "test", 0)],
                          [csg.make_csg_instance("nut", "test", 0)], n_surf=8, device=dev)
    from catgrasp_tpu_torch.sim.types import SceneParams
    state = SceneState.create(1, device=dev)
    state.active[:] = True
    t = render_march.march_csg(lib, state, SceneParams.create(lib, [0]),
                               torch.tensor([0.008, 0.0, 0.5], device=dev),
                               torch.tensor([[0.0, 0.0, -1.0]], device=dev),
                               torch.tensor([3.0], device=dev))
    torch.cuda.synchronize()
    assert bool(hit[0, 0]) and abs(float(t[0]) - (0.5 - 0.00375)) < 1e-3
    assert (collision.box_hits.launches, render_march.march_csg.launches) == (n0[0] + 1,
                                                                              n0[1] + 1)
    n3 = fused_rollout.rollout_fused.launches
    cfg = env_pile.PileConfig(max_bodies=3)
    states, bparams = env_pile.reset_batch(torch.Generator(device=dev).manual_seed(0), lib, cfg, 5)
    out = fused_rollout.rollout_fused(states, bparams, lib,
                                      engine.StaticEnv.open_bin(device=dev), 3)
    torch.cuda.synchronize()
    assert fused_rollout.rollout_fused.launches == n3 + 1
    assert bool((out.pos[..., 2][out.active] < states.pos[..., 2][out.active]).all())
