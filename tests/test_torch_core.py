"""Port parity: transforms, CSG distances and normals, the shape library,
the sampling table and the occupancy grid against the JAX package, on the
same numpy inputs (f32; atol 1e-6 unless stated)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgrasp_tpu.core import sampling as jsampling
from catgrasp_tpu.core import transforms as jtf
from catgrasp_tpu.geom import csg as jcsg
from catgrasp_tpu.geom import occupancy as jocc
from catgrasp_tpu.geom import primitives as jprim
from catgrasp_tpu.sim.types import build_shape_lib as jbuild
from catgrasp_tpu_torch.core import sampling as psampling
from catgrasp_tpu_torch.core import transforms as ptf
from catgrasp_tpu_torch.geom import csg as pcsg
from catgrasp_tpu_torch.geom import occupancy as pocc
from catgrasp_tpu_torch.geom import primitives as pprim
from catgrasp_tpu_torch.sim.types import build_shape_lib as pbuild
from test_torch_common import CPU, np_fields, t2n

torch.set_num_threads(2)
ATOL = 1e-6


def _both(jfn, pfn, *arrays):
    j = np.asarray(jfn(*[jnp.asarray(a) for a in arrays]))
    p = t2n(pfn(*[torch.from_numpy(np.array(a)) for a in arrays]))
    return j, p


@pytest.fixture
def quats(rng):
    q = rng.normal(size=(64, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.mark.parametrize("name", [
    "quat_to_matrix", "quat_normalize", "matrix_to_quat", "pose_inverse",
    "quat_mul", "quat_rotate", "transform_points", "direction_vec_to_rotation",
    "axis_angle_to_matrix", "quat_from_axis_angle"])
def test_transforms_match_jax(rng, quats, name):
    R = np.asarray(jtf.quat_to_matrix(jnp.asarray(quats)))
    T = np.zeros((64, 4, 4), np.float32)
    T[:, :3, :3] = R
    T[:, :3, 3] = rng.uniform(-0.2, 0.2, (64, 3))
    T[:, 3, 3] = 1
    v = rng.normal(size=(64, 3)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, 64).astype(np.float32)
    pts = rng.normal(size=(64, 5, 3)).astype(np.float32)
    args = {
        "quat_to_matrix": (quats,), "quat_normalize": (quats * 3.0,),
        "matrix_to_quat": (R,), "pose_inverse": (T,),
        "quat_mul": (quats, quats[::-1].copy()), "quat_rotate": (quats, v),
        "transform_points": (T, pts), "direction_vec_to_rotation": (v, v[::-1].copy()),
        "axis_angle_to_matrix": (v, ang), "quat_from_axis_angle": (v, ang),
    }[name]
    j, p = _both(getattr(jtf, name), getattr(ptf, name), *args)
    np.testing.assert_allclose(p, j, atol=ATOL)


def test_direction_rotation_degenerate_cases():
    # parallel and antiparallel inputs take the branch-free fallback
    d = np.array([[1, 0, 0], [-1, 0, 0], [0, 0, 1], [0, 0, -1]], np.float32)
    ref = np.array([[1, 0, 0], [1, 0, 0], [0, 0, 1], [0, 0, 1]], np.float32)
    j, p = _both(jtf.direction_vec_to_rotation, ptf.direction_vec_to_rotation, d, ref)
    np.testing.assert_allclose(p, j, atol=ATOL)


SHAPES = [("nut", "train", 0), ("nut", "test", 1), ("screw", "train", 3),
          ("hnm", "test", 0), ("fixture", "nut", None), ("fixture", "screw", None),
          ("fixture", "hnm", None)]


def _shape_pair(spec):
    a, b, i = spec
    if a == "fixture":
        return jcsg.csg_place_fixture(b), pcsg.csg_place_fixture(b)
    return jcsg.make_csg_instance(a, b, i), pcsg.make_csg_instance(a, b, i)


@pytest.mark.parametrize("spec", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_csg_sdf_and_normals_match_jax(rng, spec):
    js, ps = _shape_pair(spec)
    for f in ("types", "ops", "params", "offsets"):
        np.testing.assert_array_equal(t2n(getattr(ps, f)), np.asarray(getattr(js, f)))
    pts = rng.uniform(-0.03, 0.05, (2000, 3)).astype(np.float32)
    d_j = np.asarray(jcsg.csg_sdf(js, jnp.asarray(pts)))
    d_p = t2n(pcsg.csg_sdf(ps, torch.from_numpy(pts)))
    np.testing.assert_allclose(d_p, d_j, atol=ATOL)
    dn_j, n_j = jcsg.csg_sdf_and_normal(js, jnp.asarray(pts))
    dn_p, n_p = pcsg.csg_sdf_and_normal(ps, torch.from_numpy(pts))
    np.testing.assert_allclose(t2n(dn_p), np.asarray(dn_j), atol=ATOL)
    np.testing.assert_allclose(t2n(n_p), np.asarray(n_j), atol=ATOL)


def test_csg_broadcasts_per_point_shapes(rng):
    """A stacked library evaluated with one shape per point equals the
    per-shape evaluation (the renderer's winning-body normal pass)."""
    shapes = [_shape_pair(s)[1] for s in SHAPES]
    lib = pcsg.stack_shapes(shapes)
    sid = torch.from_numpy(rng.integers(0, len(shapes), 500))
    pts = torch.from_numpy(rng.uniform(-0.03, 0.05, (500, 3)).astype(np.float32))
    d, n = pcsg.csg_sdf_and_normal(pcsg.select_shape(lib, sid), pts)
    for k, s in enumerate(shapes):
        m = sid == k
        dk, nk = pcsg.csg_sdf_and_normal(s, pts[m])
        np.testing.assert_allclose(t2n(d[m]), t2n(dk), atol=ATOL)
        np.testing.assert_allclose(t2n(n[m]), t2n(nk), atol=ATOL)


def test_shape_lib_and_tables_match_jax():
    classes = [("nut", 0), ("screw", 1), ("hnm", 0)]
    jm = [jprim.make_instance(c, "test", i) for c, i in classes]
    pm = [pprim.make_instance(c, "test", i) for c, i in classes]
    jl = jbuild(jm, [jcsg.make_csg_instance(c, "test", i) for c, i in classes], n_surf=32)
    pl = pbuild(pm, [pcsg.make_csg_instance(c, "test", i) for c, i in classes], n_surf=32,
                device=CPU)
    jf = np_fields(jl)
    for k, v in jf.items():
        obj = pl
        for part in k.split("."):
            obj = getattr(obj, part)
        np.testing.assert_array_equal(t2n(obj), v, err_msg=k)
    np.testing.assert_array_equal(psampling.cone_directions(120, 60.0),
                                  jsampling.cone_directions(120, 60.0))


def test_occupancy_matches_jax(rng):
    H, W = 24, 32
    depth = rng.uniform(0.25, 0.35, (H, W)).astype(np.float32)
    depth[rng.uniform(size=(H, W)) < 0.2] = 0.0
    seg = rng.integers(-1, 3, (H, W)).astype(np.int32)
    K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
    center = np.array([0.01, -0.02, 0.3], np.float32)
    for kw in (dict(center=center, reach=0.1), dict()):
        cj, oj = jocc.background_cloud_from_depth(
            jnp.asarray(depth), jnp.asarray(K), jnp.asarray(seg), 1,
            grid_dims=(20, 18, 16), pad=1e-3,
            **{k: (jnp.asarray(v) if k == "center" else v) for k, v in kw.items()})
        cp, op = pocc.background_cloud_from_depth(
            torch.from_numpy(depth), torch.from_numpy(K), torch.from_numpy(seg), 1,
            grid_dims=(20, 18, 16), pad=1e-3,
            **{k: (torch.from_numpy(v) if k == "center" else v) for k, v in kw.items()})
        np.testing.assert_allclose(t2n(cp), np.asarray(cj), atol=ATOL)
        assert 0 < np.asarray(oj).sum() < oj.size
        np.testing.assert_array_equal(t2n(op), np.asarray(oj))
