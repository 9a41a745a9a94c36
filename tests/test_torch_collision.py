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
