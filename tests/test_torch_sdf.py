"""Port parity for the baked-SDF geometry: ``geom/mesh.py``'s OBJ loader,
``geom/sdf.py`` (bake, trilinear lookups, gradients), ``geom/sdf_io.py``
(SDFGen files) and ``build_shape_lib(bake_grids=True)``.

The bake is exact point-triangle distance signed by the winding number, in
f32 on both sides: values are held within 2e-6 m on >= 99.9% of grid points,
and a sign may differ only where |phi| < 1e-5 m.  Lookups run on JAX's own
grid, carried across by ``convert.py``, and are held within 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgrasp_tpu.geom import csg as jcsg
from catgrasp_tpu.geom import primitives as jprim
from catgrasp_tpu.geom import sdf as jsdf
from catgrasp_tpu.geom import sdf_io as jsdf_io
from catgrasp_tpu.geom.mesh import TriMesh as JTriMesh
from catgrasp_tpu.sim.types import build_shape_lib as jbuild
from catgrasp_tpu_torch.geom import csg as pcsg
from catgrasp_tpu_torch.geom import primitives as pprim
from catgrasp_tpu_torch.geom import sdf as psdf
from catgrasp_tpu_torch.geom import sdf_io as psdf_io
from catgrasp_tpu_torch.geom.mesh import TriMesh as PTriMesh
from catgrasp_tpu_torch.sim.types import build_shape_lib as pbuild
from test_torch_common import port_lib, t2n

torch.set_num_threads(2)
DEMOS = [f"assets/{c}_demo.obj" for c in ("nut", "screw", "hnm")]


def _assert_bake_close(vj, vp):
    d = np.abs(vj - vp)
    assert (d <= 2e-6).mean() >= 0.999, f"max |diff| {d.max():.3e}"
    flipped = np.sign(vj) != np.sign(vp)
    assert np.all(np.abs(vj[flipped]) < 1e-5)


@pytest.mark.parametrize("path", DEMOS)
def test_load_obj_matches_jax(path):
    mj, mp = JTriMesh.load_obj(path), PTriMesh.load_obj(path)
    np.testing.assert_array_equal(mp.vertices, mj.vertices)
    np.testing.assert_array_equal(mp.faces, mj.faces)
    assert len(mp.faces) >= 8


@pytest.mark.parametrize("mesh,dims", [("nut_demo", 24), ("nut_demo", 32), ("nut", 24),
                                       ("nut", 32), ("screw_demo", 28)])
def test_bake_matches_jax(mesh, dims):
    """The bake of a demo mesh and of a procedural nut: the grid frame
    equal, the values as stated above."""
    if mesh == "nut":
        m = jprim.make_instance("nut", "test", 0)
    else:
        m = JTriMesh.load_obj(f"assets/{mesh}.obj")
    gj = jsdf.bake_sdf(m.vertices, m.faces, dims=dims, padding=0.003)
    gp = psdf.bake_sdf(m.vertices, m.faces, dims=dims, padding=0.003, chunk=1000,
                       device="cpu")
    assert gp.dims == (dims,) * 3
    np.testing.assert_allclose(t2n(gp.lower), np.asarray(gj.lower), atol=1e-9)
    assert float(gp.spacing) == float(gj.spacing)
    _assert_bake_close(np.asarray(gj.values), t2n(gp.values))


def test_mesh_sdf_points_matches_jax():
    m = jprim.screw()
    pts = np.random.default_rng(0).uniform(-0.03, 0.03, (777, 3)).astype(np.float32)
    pts[0] = [0.0, 0.0, 0.0005]  # inside the head-shaft overlap: negative in both
    dj = np.asarray(jsdf.mesh_sdf_points(jnp.asarray(pts), m.vertices, m.faces, chunk=256))
    dp = t2n(psdf.mesh_sdf_points(torch.as_tensor(pts), m.vertices, m.faces, chunk=100))
    assert dj[0] < 0 and dp[0] < 0
    _assert_bake_close(dj, dp)


@pytest.fixture(scope="module")
def jax_grid():
    m = jprim.make_instance("nut", "train", 0)
    g = jsdf.bake_sdf(m.vertices, m.faces, dims=32, padding=0.004)
    rng = np.random.default_rng(1)
    lo, sp = np.asarray(g.lower), float(g.spacing)
    # 400 inside the grid with the gradient's stencil, then 100 well
    # outside it (the exterior push)
    pts = np.concatenate([rng.uniform(lo + sp, lo + 30 * sp, (400, 3)),
                          rng.uniform(-0.2, 0.2, (100, 3))]).astype(np.float32)
    return g, pts


def test_query_and_grad_match_jax(jax_grid):
    g, pts = jax_grid
    vals, lower, spacing = (torch.as_tensor(np.array(x)) for x in (g.values, g.lower,
                                                                    g.spacing))
    p = torch.as_tensor(pts)
    np.testing.assert_allclose(t2n(psdf.query(vals, lower, spacing, p)),
                               np.asarray(jsdf.query(g.values, g.lower, g.spacing,
                                                     jnp.asarray(pts))), atol=1e-6)
    vj, nj = jsdf.query_and_grad(g.values, g.lower, g.spacing, jnp.asarray(pts))
    vp, npn = psdf.query_and_grad(vals, lower, spacing, p)
    np.testing.assert_allclose(t2n(vp), np.asarray(vj), atol=1e-6)
    np.testing.assert_allclose(t2n(npn), np.asarray(nj), atol=1e-6)
    gp = t2n(psdf.grad(vals, lower, spacing, p))
    gj = np.asarray(jsdf.grad(g.values, g.lower, g.spacing, jnp.asarray(pts)))
    np.testing.assert_allclose(gp[:400], gj[:400], atol=1e-6)
    # outside the grid the central difference subtracts two exterior pushes
    # of ~0.2 m over a 1 mm stencil: one f32 ulp of either is ~1e-5 of it
    np.testing.assert_allclose(gp[400:], gj[400:], atol=1e-4)


def test_query_shapes_on_a_carried_library_matches_jax():
    """``build_shape_lib(bake_grids=True)`` on both sides: the grids equal as
    the bake test holds them, and the port's lookups in JAX's library carried
    across by ``convert.py`` (a shape index per point) equal JAX's."""
    meshes = [jprim.make_instance("nut", "train", 0), jprim.make_instance("screw", "train", 0)]
    csgs = [jcsg.make_csg_instance("nut", "train", 0), jcsg.make_csg_instance("screw", "train", 0)]
    lj = jbuild(meshes, csgs, n_surf=16, dims=24, bake_grids=True)
    pm = [pprim.make_instance("nut", "train", 0), pprim.make_instance("screw", "train", 0)]
    pc = [pcsg.make_csg_instance("nut", "train", 0), pcsg.make_csg_instance("screw", "train", 0)]
    lp = pbuild(pm, pc, n_surf=16, dims=24, bake_grids=True, device="cpu")
    assert lp.sdf_values.shape == (2, 24, 24, 24)
    np.testing.assert_allclose(t2n(lp.sdf_lower), np.asarray(lj.sdf_lower), atol=1e-9)
    np.testing.assert_array_equal(t2n(lp.sdf_spacing), np.asarray(lj.sdf_spacing))
    _assert_bake_close(np.asarray(lj.sdf_values), t2n(lp.sdf_values))
    carried = port_lib(lj)
    assert torch.equal(carried.sdf_values, torch.as_tensor(np.asarray(lj.sdf_values)))
    pts = np.random.default_rng(2).uniform(-0.04, 0.04, (2, 300, 3)).astype(np.float32)
    sid = np.array([0, 1])
    qj = np.stack([np.asarray(jsdf.query_shapes(lj.sdf_values, lj.sdf_lower, lj.sdf_spacing,
                                                jnp.int32(k), jnp.asarray(pts[k])))
                   for k in range(2)])
    qp = psdf.query_shapes(carried.sdf_values, carried.sdf_lower, carried.sdf_spacing,
                           torch.as_tensor(sid)[:, None], torch.as_tensor(pts))
    np.testing.assert_allclose(t2n(qp), qj, atol=1e-6)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sdf_files_cross_read(tmp_path, writer):
    """A file written by one package is read by the other: the same values,
    origin and cell size, and the grid from it answers the same lookups."""
    m = jprim.make_instance("nut", "train", 0)
    gj = jsdf.bake_sdf(m.vertices, m.faces, dims=16)
    path = str(tmp_path / "nut.sdf")
    if writer == "jax":
        jsdf_io.grid_to_file(path, gj)
        back = psdf_io.grid_from_file(path, device="cpu")
        vals, origin, dx = jsdf_io.read_sdf(path)
        vp, op, dxp = psdf_io.read_sdf(path)
        np.testing.assert_array_equal(vp, vals)
        np.testing.assert_array_equal(op, origin)
        assert dxp == dx
        ref = jsdf_io.grid_from_file(path)
    else:
        gp = psdf.SdfGrid(values=torch.as_tensor(np.asarray(gj.values)),
                          lower=torch.as_tensor(np.asarray(gj.lower)),
                          spacing=torch.as_tensor(np.asarray(gj.spacing)))
        psdf_io.grid_to_file(path, gp)
        ref = jsdf_io.grid_from_file(path)
        back = psdf_io.grid_from_file(path, device="cpu")
    np.testing.assert_array_equal(t2n(back.values), np.asarray(ref.values))
    np.testing.assert_array_equal(t2n(back.lower), np.asarray(ref.lower))
    assert float(back.spacing) == float(ref.spacing)
    # %.6g on disk: the values survive to 6 significant digits
    np.testing.assert_allclose(t2n(back.values), np.asarray(gj.values), rtol=1e-5, atol=1e-9)
    pts = np.random.default_rng(0).uniform(-0.02, 0.02, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(t2n(psdf.query(back.values, back.lower, back.spacing,
                                              torch.as_tensor(pts))),
                               np.asarray(jsdf.query_grid(ref, jnp.asarray(pts))), atol=1e-6)
