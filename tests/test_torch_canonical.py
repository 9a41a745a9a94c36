"""Port parity for the category canonical (``pipelines/make_canonical.py``).

``compute_canonical`` on the tracked inputs of all three classes
(``dataset/grasps/*_complete_grasp.npz``, ``dataset/affordance/*.npz``)
against JAX's on the same inputs: every field equal, the codebook within
1e-6 (the medoid, the neighbours and so the affordance codebook bit for
bit: the port sums the squared distances in numpy's order).  For screw and
hnm the output also equals the tracked ``dataset/<class>_canonical.npz``.
The tracked nut canonical's codebook predates the nut DBs' v3 re-score, so
for the nut only the other fields equal the file (JAX's own rerun gives
20,717 codebook grasps where the file has 10,791).
"""
import numpy as np
import pytest
import torch

from catgrasp_tpu.pipelines import make_canonical as jmc
from catgrasp_tpu_torch.pipelines import make_canonical as mc

torch.set_num_threads(2)
FIELDS = ("canonical_cloud", "canonical_affordance", "canonical_grasps",
          "canonical_grasp_scores", "transforms_to_nocs", "medoid_index", "class_name",
          "affordance_version")


def _equal(a, b, key):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, key
    if key == "canonical_grasps":
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=key)
    else:
        np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.mark.parametrize("cls", ["nut", "screw", "hnm"])
def test_compute_canonical_matches_jax_on_tracked_inputs(cls):
    dbs, affs = mc.load_inputs(cls, "dataset/grasps", "dataset/affordance")
    assert all(d is not None for d in dbs) and all(a is not None for a in affs)
    j = jmc.compute_canonical(cls, dbs, affs)
    p = mc.compute_canonical(cls, dbs, affs, device="cpu")
    assert sorted(p) == sorted(j) == sorted(FIELDS)
    for k in FIELDS:
        _equal(p[k], j[k], k)
        assert np.asarray(p[k]).dtype == np.asarray(j[k]).dtype, k
    tracked = np.load(f"dataset/{cls}_canonical.npz")
    stale = {"canonical_grasps", "canonical_grasp_scores"} if cls == "nut" else set()
    for k in set(FIELDS) - stale:
        _equal(p[k], tracked[k], k)
    if cls == "nut":
        assert (len(p["canonical_grasps"]), len(tracked["canonical_grasps"])) == (20717, 10791)


def test_compute_canonical_without_affordances_matches_jax():
    dbs, _ = mc.load_inputs("hnm", "dataset/grasps", "dataset/affordance")
    j = jmc.compute_canonical("hnm", dbs, None)
    p = mc.compute_canonical("hnm", dbs, None, device="cpu")
    for k in FIELDS:
        _equal(p[k], j[k], k)
    assert not p["canonical_affordance"].any() and int(p["affordance_version"]) == 0


@pytest.mark.parametrize("n", [(64, 64), (256, 100)])
def test_mutual_chamfer_matches_jax(n):
    rng = np.random.default_rng(n[1])
    a = rng.random((n[0], 3)).astype(np.float32)
    b = (rng.random((n[1], 3)) * 0.9 + 0.05).astype(np.float32)
    assert mc.mutual_chamfer(torch.as_tensor(a), torch.as_tensor(b)) == jmc.mutual_chamfer(a, b)
    # over leading axes, as compute_canonical takes every pair at once
    clouds = rng.random((4, 32, 3)).astype(np.float32)
    ii, jj = np.triu_indices(4, 1)
    D = mc.mutual_chamfer(torch.as_tensor(clouds[ii]), torch.as_tensor(clouds[jj]))
    assert D.shape == (6,) and D.dtype == np.float64
    for d, i, k in zip(D, ii, jj):
        assert d == jmc.mutual_chamfer(clouds[i], clouds[k])


def test_main_writes_the_ports_own_canonical(tmp_path, monkeypatch):
    """``main`` with its defaults but the input directories: the output is
    ``dataset/canonical_torch/<class>_canonical.npz``, never over the JAX
    package's ``dataset/<class>_canonical.npz``, and holds what JAX's
    ``compute_canonical`` computes."""
    import os
    grasps, affs = os.path.abspath("dataset/grasps"), os.path.abspath("dataset/affordance")
    monkeypatch.chdir(tmp_path)
    path = mc.main(["--class_name", "screw", "--grasp_dir", grasps, "--affordance_dir", affs,
                    "--device", "cpu"])
    assert path == "dataset/canonical_torch/screw_canonical.npz"
    assert mc.DEFAULT_OUT_DIR == "dataset/canonical_torch"
    out = dict(np.load(path))
    assert not (tmp_path / "dataset" / "screw_canonical.npz").exists()
    dbs, la = mc.load_inputs("screw", grasps, affs)
    j = jmc.compute_canonical("screw", dbs, la)
    for k in FIELDS:
        _equal(out[k], j[k], k)
