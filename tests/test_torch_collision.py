"""Port parity: kernel K1 ``box_hits``.  On the CPU the wrapper runs K1's
plain version, which must equal the Pallas kernel in interpret mode exactly
on the unaligned 37-pose / 40-point scene of ``tests/test_ops.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgrasp_tpu.grasp import filter as jfilter
from catgrasp_tpu.ops import collision as jcollision
from catgrasp_tpu.sim.env_grasp import GripperSpec as JSpec
from catgrasp_tpu_torch.grasp import filter as pfilter
from catgrasp_tpu_torch.ops import collision as pcollision
from catgrasp_tpu_torch.sim.env_grasp import GripperSpec as PSpec
from test_torch_common import random_poses, t2n

torch.set_num_threads(2)
OFFSETS = tuple(float(o) for o in jfilter.ADJUST_OFFSETS)
MARGIN = 5e-4


def _scene(rng, n_pose=37, n_pts=40):
    T = random_poses(rng, n_pose)
    cloud = rng.uniform(-0.15, 0.15, (n_pts, 3)).astype(np.float32)
    mask = rng.uniform(size=n_pts) > 0.2
    return T, cloud, mask


@pytest.mark.parametrize("which", ["open", "enclosed", "open_deep"])
def test_box_hits_plain_equals_pallas_interpret(rng, which):
    T, cloud, mask = _scene(rng)
    jboxes = {"open": jfilter._static_open_boxes(JSpec()),
              "enclosed": jfilter._static_enclosed_box(JSpec()),
              "open_deep": jfilter._static_open_boxes(JSpec(), 0.003)}[which]
    pboxes = {"open": pfilter._static_open_boxes(PSpec()),
              "enclosed": pfilter._static_enclosed_box(PSpec()),
              "open_deep": pfilter._static_open_boxes(PSpec(), 0.003)}[which]
    assert pboxes == jboxes
    T_inv_j = jcollision.pose_inverse_batch(jnp.asarray(T))
    hit_j = np.asarray(jcollision.box_hits(T_inv_j, jnp.asarray(cloud), jnp.asarray(mask),
                                           jboxes, OFFSETS, MARGIN, interpret=True))
    T_inv_p = pcollision.pose_inverse_batch(torch.from_numpy(T))
    np.testing.assert_allclose(t2n(T_inv_p), np.asarray(T_inv_j), atol=1e-6)
    n0 = pcollision.box_hits.launches
    hit_p = t2n(pcollision.box_hits(T_inv_p, torch.from_numpy(cloud), torch.from_numpy(mask),
                                    pboxes, OFFSETS, MARGIN))
    assert pcollision.box_hits.launches == n0  # the CPU path launches nothing
    assert hit_p.shape == (37, len(OFFSETS)) and hit_p.dtype == np.bool_
    np.testing.assert_array_equal(hit_p, hit_j)
    assert 0 < hit_p.sum() < hit_p.size  # both outcomes present


def test_box_hits_masked_points_never_hit(rng):
    T, cloud, _ = _scene(rng)
    none = torch.zeros(len(cloud), dtype=torch.bool)
    hit = pcollision.box_hits(pcollision.pose_inverse_batch(torch.from_numpy(T)),
                              torch.from_numpy(cloud), none,
                              pfilter._static_open_boxes(PSpec()), OFFSETS, MARGIN)
    assert not hit.any()


DEPTHS = tuple(float(d) for d in jfilter.DEPTH_OFFSETS)


@pytest.mark.parametrize("which", ["open", "enclosed"])
def test_box_hits_depths_plain_equals_a_loop_over_depths_and_pallas(rng, which):
    """The multi-depth entry transforms the cloud once and shifts the boxes
    +x per depth: each depth must equal the single-depth plain version on
    boxes built at that depth, and the Pallas kernel in interpret mode,
    exactly."""
    T, _, _ = _scene(rng, n_pose=61)
    cloud = rng.uniform(-0.15, 0.15, (250, 3)).astype(np.float32)  # dense enough that 3 mm matters
    mask = rng.uniform(size=len(cloud)) > 0.2
    pmake = {"open": pfilter._static_open_boxes, "enclosed": pfilter._static_enclosed_box}[which]
    jmake = {"open": jfilter._static_open_boxes, "enclosed": jfilter._static_enclosed_box}[which]
    T_inv_p = pcollision.pose_inverse_batch(torch.from_numpy(T))
    T_inv_j = jcollision.pose_inverse_batch(jnp.asarray(T))
    args = (T_inv_p, torch.from_numpy(cloud), torch.from_numpy(mask))
    n0 = pcollision.box_hits.launches
    hit = pcollision.box_hits_depths(*args, pmake(PSpec()), OFFSETS, DEPTHS, MARGIN)
    assert pcollision.box_hits.launches == n0  # the CPU path launches nothing
    assert hit.shape == (61, len(DEPTHS), len(OFFSETS)) and hit.dtype == torch.bool
    for k, d in enumerate(DEPTHS):
        one = pcollision.box_hits_plain(*args, pmake(PSpec(), d), OFFSETS, MARGIN)
        assert torch.equal(hit[:, k], one), f"depth {d}"
        hit_j = np.asarray(jcollision.box_hits(T_inv_j, jnp.asarray(cloud), jnp.asarray(mask),
                                               jmake(JSpec(), d), OFFSETS, MARGIN,
                                               interpret=True))
        np.testing.assert_array_equal(t2n(hit[:, k]), hit_j, err_msg=f"depth {d}")
    assert 0 < int(hit.sum()) < hit.numel()
    assert not torch.equal(hit[:, 0], hit[:, -1])  # the depths do differ on this scene


def test_box_hits_is_the_depth_zero_case(rng):
    T, cloud, mask = _scene(rng)
    args = (pcollision.pose_inverse_batch(torch.from_numpy(T)), torch.from_numpy(cloud),
            torch.from_numpy(mask), pfilter._static_open_boxes(PSpec()), OFFSETS)
    assert torch.equal(pcollision.box_hits(*args, MARGIN),
                       pcollision.box_hits_depths(*args, (0.0,), MARGIN)[:, 0])


def test_pack_cloud_pads_to_whole_chunks_at_the_sentinel(rng):
    """The kernel's cloud: 4 floats a point, a multiple of 128 points, masked
    points and padding where no box reaches."""
    _, cloud, mask = _scene(rng, n_pts=300)
    pts = pcollision.pack_cloud(torch.from_numpy(cloud), torch.from_numpy(mask))
    assert pts.shape == (384, 4) and pts.dtype == torch.float32 and pts.is_contiguous()
    np.testing.assert_array_equal(t2n(pts[:300, :3])[mask], cloud[mask])
    assert (pts[:300][~torch.from_numpy(mask)] == 1e6).all() and (pts[300:] == 1e6).all()
    assert pcollision.pack_cloud(torch.zeros((0, 3)), torch.zeros(0, dtype=torch.bool)).shape \
        == (0, 4)
