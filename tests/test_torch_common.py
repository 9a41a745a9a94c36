"""Shared helpers of the PyTorch-port parity tests (no tests here).

The parity tests run a JAX function and its ``catgrasp_tpu_torch``
counterpart on the same numpy inputs in one process and compare.  JAX state
crosses over as numpy dicts through ``catgrasp_tpu_torch.convert``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from catgrasp_tpu.geom import csg as jcsg
from catgrasp_tpu.geom import primitives as jprim
from catgrasp_tpu.sim import engine as jengine
from catgrasp_tpu.sim import env_pile as jpile
from catgrasp_tpu.sim.types import SceneParams as JSceneParams
from catgrasp_tpu.sim.types import SceneState as JSceneState
from catgrasp_tpu.sim.types import build_shape_lib as jbuild_shape_lib
from catgrasp_tpu_torch import convert

CPU = torch.device("cpu")


def np_fields(tree, prefix: str = "") -> dict:
    """Flatten a JAX pytree dataclass to {field: numpy array}; nested
    dataclasses get dotted keys, None fields are skipped."""
    out = {}
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        if v is None:
            continue
        if dataclasses.is_dataclass(v):
            out.update(np_fields(v, prefix + f.name + "."))
        else:
            out[prefix + f.name] = np.asarray(v)
    return out


def port_lib(jlib):
    return convert.shape_lib_from_numpy(np_fields(jlib), device=CPU)


def port_state(jstate):
    return convert.scene_state_from_numpy(np_fields(jstate), device=CPU)


def port_params(jparams):
    return convert.scene_params_from_numpy(np_fields(jparams), device=CPU)


def port_env(jenv):
    return convert.static_env_from_numpy(np_fields(jenv), device=CPU)


def t2n(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def pile_scene_jax():
    """3 bodies (nut/screw/hnm) at scattered poses + bin env — the scene of
    ``tests/test_render_kernel.py``."""
    classes = ("nut", "screw", "hnm")
    meshes = [jprim.make_instance(c, "train", 0) for c in classes]
    csgs = [jcsg.make_csg_instance(c, "train", 0) for c in classes]
    lib = jbuild_shape_lib(meshes, csgs, n_surf=32)
    params = JSceneParams.create(lib, jnp.arange(3, dtype=jnp.int32),
                                 jnp.array([1.0, 1.1, 0.9], jnp.float32))
    qs = jnp.array([[1.0, 0, 0, 0],
                    [0.9238795, 0.3826834, 0, 0],
                    [0.9238795, 0, 0.3826834, 0]], jnp.float32)
    state = JSceneState(
        pos=jnp.array([[0.0, 0.0, 0.02], [0.04, 0.02, 0.03], [-0.04, -0.03, 0.025]]),
        quat=qs, linvel=jnp.zeros((3, 3)), angvel=jnp.zeros((3, 3)),
        active=jnp.ones((3,), bool))
    env = jengine.StaticEnv.open_bin((0.18, 0.18, 0.08))
    return lib, state, params, env


def pile_batch_jax(batch: int = 8, max_bodies: int = 4, n_surf: int = 16, lower: float = 0.05):
    """The fixture of ``tests/test_fused_rollout.py``: ``batch`` scenes of up
    to ``max_bodies`` bodies (nut, screw) reset by JAX over the open bin.
    Returns (cfg, lib, env, states, low, params); ``low`` is ``states``
    dropped ``lower`` m, so that contacts start within a few steps."""
    import jax

    cfg = jpile.PileConfig(max_bodies=max_bodies)
    specs = [("nut", 0), ("screw", 0)]
    meshes = [jprim.make_instance(c, "train", i) for c, i in specs]
    csgs = [jcsg.make_csg_instance(c, "train", i) for c, i in specs]
    lib = jbuild_shape_lib(meshes, csgs, n_surf=n_surf)
    env = jengine.StaticEnv.open_bin(cfg.bin_inner)
    keys = jax.random.split(jax.random.PRNGKey(0), batch)
    states, params = jax.vmap(lambda k: jpile.reset(k, lib, cfg))(keys)
    low = states.replace(pos=states.pos.at[..., 2].add(-lower))
    return cfg, lib, env, states, low, params


def top_camera(z: float = 0.3) -> np.ndarray:
    cam = np.eye(4, dtype=np.float32)
    cam[:3, :3] = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32)
    cam[:3, 3] = [0, 0, z]
    return cam


def random_poses(rng, n: int, spread: float = 0.08) -> np.ndarray:
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    R = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                  2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                  2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                 axis=-1).reshape(n, 3, 3)
    T = np.zeros((n, 4, 4), np.float32)
    T[:, :3, :3] = R
    T[:, :3, 3] = rng.uniform(-spread, spread, (n, 3))
    T[:, 3, 3] = 1.0
    return T


def small_scene_cfg() -> dict:
    """``config.yml`` with a 120x120 camera of long focal length and piles of
    1-4 bodies: each nut covers enough pixels for the isolated-cloud and
    grasp-label passes, at a size the CPU renders in seconds."""
    from catgrasp_tpu_torch.config.loader import load_config
    cfg = load_config("config.yml")
    cfg.update(H=120, W=120, render_downscale=1.0,
               K=[260.0, 0.0, 60.0, 0.0, 260.0, 60.0, 0.0, 0.0, 1.0])
    cfg["dataset"] = dict(cfg["dataset"], num_pile_objects=[1, 4])
    return cfg
