"""Learned perception in the eval loop: the front half of one attempt with
the seg net's segments and the NUNOCS net's pose against the JAX loop's
lines 495-607 inline, ``rebind_target_to_channel`` against JAX's, and the
port's ``main --oracle 0 --artifacts`` on the CPU on a short schedule.

Both sides load the tracked nut checkpoints (the port through its own
reader).  The device draws (MeanShift seeds, RANSAC hypotheses) are JAX's,
carried into the port as data (``test_torch_predict.jax_draws``); numpy
draws come from one seed in the loop's order on both sides.  The cone
sampler is off on both sides (its parity is ``tests/test_torch_slice.py``'s):
a segment is found on the NOCS-transfer candidates alone.

Tolerances: the seg net's convolutions run in bfloat16 on both sides, so
the shifted points differ by bf16 rounding (a few 1e-4 m) and a point at a
cluster's edge can change label; the found segment's pixels are held equal
on >= 99%, its body, the segments tried and the pose (the same RANSAC
hypothesis) equal, the pose within 1e-5 and the candidate masks on >= 99.9%
(the filter's tie rule of ``tests/test_torch_slice.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgrasp_tpu.core.symmetry import get_symmetry_tfs
from catgrasp_tpu.geom import occupancy as jocc
from catgrasp_tpu.grasp.gripper import Gripper as JGripper
from catgrasp_tpu.grasp.sampler import NocsTransferGraspSampler as JNocs
from catgrasp_tpu.pipelines import run_grasp_simulation as jrgs
from catgrasp_tpu.predict.artifacts import load_predicters as jload_predicters
from catgrasp_tpu_torch.grasp.sampler import NocsTransferGraspSampler
from catgrasp_tpu_torch.pipelines import run_grasp_simulation as rgs
from catgrasp_tpu_torch.predict.artifacts import load_predicters
from test_torch_common import port_params, port_state, t2n
from test_torch_predict import eval_pile, jax_draws

torch.set_num_threads(2)
ART = "artifacts_tracked/nut"
N_CODEBOOK = 256  # the canonical's best grasps the NOCS sampler starts from


class _NoCone:
    """A cone sampler that samples nothing: the front half finds its
    segment on the NOCS-transfer candidates."""

    def sample_grasps(self, points, normals, **kw):
        stats = {"n_approach_dir_rej": 0, "n_ik_rej": 0, "n_collision_rej": 0}
        return torch.zeros((0, 4, 4)), torch.zeros(0, dtype=torch.bool), stats


@pytest.fixture(scope="module")
def nets():
    return jload_predicters(ART, "nut"), load_predicters(ART, "nut", device="cpu")


def _jax_learned_front(sc, out, active, J, can, rng):
    """Lines 483-607 of the JAX loop, learned (seg net, NUNOCS net), the
    cone sampler off: the segments tried (seg id, target, pixel mask,
    NUNOCS pose, NOCS-transfer valid mask) up to the found one."""
    seg_body, xyz, normal = out["seg"], out["xyz"], out["normal"]
    Kc = jnp.asarray(t2n(sc.K))
    n = sc.n_objects
    min_px = max(20, (sc.H * sc.W) // 2500)
    sampler = JNocs(JGripper.default(), can["canonical_grasps"], can["canonical_grasp_scores"],
                    score_larger_than=0.95, max_n_grasp=N_CODEBOOK)
    tried = []
    for bw_scale in rgs.BANDWIDTH_RETRIES:
        vm = seg_body >= 0
        labels, n_seg = J["seg"].predict(xyz[vm], normal[vm], bandwidth_scale=bw_scale)
        seg = np.full(seg_body.shape, -1, np.int64)
        seg[vm] = labels
        seg_ids = sorted(range(max(n_seg, 1)), key=lambda i: -(seg == i).sum())
        for sid in seg_ids:
            m = seg == sid
            if m.sum() < min_px:
                break
            inside = seg_body[m & (seg_body >= 0)]
            if len(inside) == 0:
                continue
            target = int(np.bincount(inside, minlength=n).argmax())
            if not active[target]:
                continue
            pts, nrm = xyz[m], normal[m]
            bg_m = ~m & (seg_body != -1)
            occ_c, occ_m = jocc.background_cloud_from_depth(
                jnp.asarray(np.where(m, 0.0, out["depth"])), Kc, jnp.asarray(seg), -1,
                grid_dims=sc.grid_dims, pad=1e-3, center=jnp.asarray(pts.mean(0)), reach=0.1)
            bg = np.concatenate([xyz[bg_m], np.asarray(occ_c)[np.asarray(occ_m)]])
            if len(bg) > rgs.MAX_BACKGROUND_PTS:
                bg = bg[rng.choice(len(bg), rgs.MAX_BACKGROUND_PTS, replace=False)]
            res = J["nocs"].predict(pts, nrm)
            if not res["valid"]:
                continue
            nocs_pose = res["nocs_pose"].astype(np.float32)
            n_sub = min(len(pts), rgs.MAX_COLLISION_PTS)
            ids = rng.choice(len(pts), n_sub, replace=False)
            _, valid, _ = sampler.sample_grasps(
                jnp.asarray(nocs_pose), jnp.asarray(get_symmetry_tfs("nut")), bg,
                np.ones(len(bg), bool), pts[ids], np.ones(n_sub, bool),
                cam_in_world=jnp.asarray(t2n(sc.cam_in_base)), filter_ik=True, chunk=128,
                adjust_depth=True, backend="xla")
            valid = np.asarray(valid)
            tried.append({"seg": int(sid), "target": target, "mask": m, "nocs_pose": nocs_pose,
                          "valid": valid})
            if valid.any():
                return tried
    return tried


def test_learned_front_half_matches_jax(nets, monkeypatch):
    """One attempt's learned front half on a rendered 3-nut pile: the
    segments tried and their bodies equal, the found segment's pixels on
    >= 99%, the NUNOCS pose within 1e-5, the NOCS-transfer candidate masks
    on >= 99.9%, and the seg net, MeanShift, NUNOCS net and RANSAC stage
    times reported."""
    J, P = nets
    can = dict(np.load("dataset/nut_canonical.npz"))
    sc, state, params, out = eval_pile("nut")
    sc.cone = _NoCone()
    sc.nocs = NocsTransferGraspSampler(sc.gripper, can["canonical_grasps"],
                                       can["canonical_grasp_scores"], score_larger_than=0.95,
                                       max_n_grasp=N_CODEBOOK)
    active = np.asarray(state.active)[:sc.n_objects]
    tried_j = _jax_learned_front(sc, out, active, J, can, np.random.default_rng(0))
    assert tried_j and tried_j[-1]["valid"].any(), "the JAX side found no segment"
    jax_draws(monkeypatch)
    timings = {}
    res = rgs.attempt_front(sc, port_state(state), port_params(params),
                            np.random.default_rng(0), torch.Generator().manual_seed(0),
                            oracle=False, predicters=P, timings=timings)
    assert [t["seg"] for t in res.tried] == [t["seg"] for t in tried_j]
    assert res.found is not None and res.found.target == tried_j[-1]["target"]
    both = tried_j[-1]["mask"] | res.found.mask
    assert (res.found.mask == tried_j[-1]["mask"])[both].mean() >= 0.99
    np.testing.assert_allclose(res.found.nocs_pose, tried_j[-1]["nocs_pose"], atol=1e-5)
    for tp, tj in zip(res.tried, tried_j):
        assert (tp["nocs"]["valid"] == tj["valid"]).mean() >= 0.999
    for k in ("render_s", "seg_net_s", "meanshift_s", "nocs_net_s", "ransac_s",
              "occupancy_s", "nocs_filter_s"):
        assert timings[k] > 0, k


def test_rebind_target_to_channel_matches_jax():
    """Per grasp, the body the port rebinds to is JAX's, on a rendered pile
    with grasps centred on visible points of each body and on empty space
    (where the channel is empty and the target stays)."""
    sc, state, params, out = eval_pile("nut")
    spec = sc.gripper.spec
    jspec = JGripper.default().spec
    rng = np.random.default_rng(4)
    vis = np.argwhere(out["seg"] >= 0)
    active = np.array([True, False, True])
    n_rebound = 0
    for k in range(24):
        g = np.eye(4, dtype=np.float32)
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        g[:3, :3] = t2n(rgs.tf.quat_to_matrix(torch.as_tensor(q, dtype=torch.float32)))
        r, c = vis[rng.integers(len(vis))]
        g[:3, 3] = out["xyz"][r, c] + (0.0 if k < 20 else 0.3)
        for target in (0, 2):
            tj = jrgs.rebind_target_to_channel(out["xyz"], out["seg"], g, target, active, jspec,
                                               sc.n_objects)
            tp = rgs.rebind_target_to_channel(out["xyz"], out["seg"], g, target, active, spec,
                                              sc.n_objects)
            assert tp == tj
            n_rebound += tp != target
            if k >= 20:
                assert tp == target
    assert n_rebound > 0  # some grasps do rebind


def test_learned_main_runs(monkeypatch, capsys):
    """``main --oracle 0 --artifacts artifacts_tracked/nut`` on the CPU with
    the short schedules, small sampler and render of
    ``tests/test_torch_eval_modes.py``, one round of 2 nuts and one
    attempt: the three nets load through the port's reader, the seg and
    NUNOCS nets run in the front half and the grasp net scores the
    candidates; the tallies it prints are the ones it returns."""
    from test_torch_eval_modes import _check_tallies, _short_main
    calls = []
    for cls, meth in ((rgs.load_predicters.__globals__["SegPredicter"], "predict"),
                      (rgs.load_predicters.__globals__["NunocsPredicter"], "predict"),
                      (rgs.load_predicters.__globals__["GraspPredicter"], "predict_batch")):
        orig = getattr(cls, meth)
        monkeypatch.setattr(cls, meth, lambda self, *a, _o=orig, _n=cls.__name__, **k:
                            calls.append(_n) or _o(self, *a, **k))
    c, printed = _short_main(monkeypatch, capsys,
                             ["--oracle", "0", "--artifacts", ART])
    _check_tallies(c, printed)
    assert "SegPredicter" in calls and "NunocsPredicter" in calls
    assert c.num_attempts == 0 or "GraspPredicter" in calls
