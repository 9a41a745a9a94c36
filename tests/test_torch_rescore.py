"""Port parity: the two data tools whose outputs the trainers and the eval
read, against the JAX scripts — ``rescore_grasp_db``'s ``--write``,
``--rebalance`` and ``--noise_floor`` (``scripts/rescore_grasp_db.py``) and
``calibrate_bandwidth`` (``scripts/calibrate_bandwidth.py``).

``jax.random`` cannot be reproduced in torch, so the rescore's perturbation
offsets are JAX's, carried in as data; physics is chaotic, so the fresh
scores are held as ``tests/test_torch_grasp_db.py`` holds them (within
2/trials on >= 90% of grasps).  The files written are held array for array
with the same fresh scores injected on both sides.  The calibration is held
exactly on JAX's own jitted seg-net outputs carried in as data, and the
port's seg net separately within the bf16 tolerances of
``tests/test_torch_predict.py``."""
import importlib.util
import json
import os
import shutil
import types

import jax
import numpy as np
import pytest
import torch

from catgrasp_tpu.core import transforms as jtf
from catgrasp_tpu_torch.nn import voxelnet as pvoxelnet
from catgrasp_tpu_torch.pipelines import calibrate_bandwidth as pcb
from catgrasp_tpu_torch.pipelines import rescore_grasp_db as prdb
from catgrasp_tpu_torch.render import raymarch as praymarch
from catgrasp_tpu_torch.sim import env_grasp as peg
from test_torch_common import (pile_scene_jax, port_env, port_lib, port_params, port_state,
                               t2n, top_camera)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DB = os.path.join(REPO, "dataset", "grasps", "nut_train_0_complete_grasp.npz")


def jax_script(name):
    spec = importlib.util.spec_from_file_location(f"{name}_jax",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def script_args(tmp_path, **kw):
    """The JAX script's parsed arguments, its row appended to a file of the
    test's own (its default ``--out`` is a tracked log)."""
    base = dict(n=256, trials=50, seed=1234, out=str(tmp_path / "jax_rows.jsonl"), write=False,
                rebalance=False, noise_floor=False)
    return types.SimpleNamespace(**(base | kw))


def fake_rescore(fresh_of):
    """``rescore`` that scores nothing: the stored DB, every pose (or the
    subsample's indices) and the injected fresh scores ``fresh_of(seed)``."""
    def rescore(db_path, n=None, trials=50, seed=1234, **_):
        d = dict(np.load(db_path, allow_pickle=True))
        ids = np.arange(len(d["scores"]))
        if n is not None and n < len(ids):
            ids = np.random.default_rng(0).choice(len(ids), n, replace=False)
        return d, ids, np.asarray(d["scores"], np.float32)[ids], fresh_of(seed)[ids], 1.25
    return rescore


def test_fresh_scores_match_the_jax_script_on_its_offsets(monkeypatch):
    """4 poses of nut_train_0 (the script's own subsample) x 8 trials through
    each package's ``rescore``, the port fed JAX's perturbation offsets (the
    script's first split of ``PRNGKey(seed)``)."""
    jscript = jax_script("rescore_grasp_db")
    n, trials, seed = 4, 8, 1234
    d, ids, stored, j_fresh, _ = jscript.rescore(DB, n=n, trials=trials, seed=seed)
    _, sub = jax.random.split(jax.random.PRNGKey(seed))
    offsets = np.asarray(jtf.random_uniform_magnitude(sub, max_t=0.005, max_r_deg=10.0,
                                                      shape=(n, trials)))
    monkeypatch.setattr(peg.tf, "random_uniform_magnitude",
                        lambda *a, **k: torch.tensor(offsets))
    _, p_ids, p_stored, p_fresh, _ = prdb.rescore(DB, n=n, trials=trials, seed=seed,
                                                  device="cpu")
    np.testing.assert_array_equal(p_ids, ids)
    np.testing.assert_array_equal(p_stored, stored)
    assert p_fresh.dtype == np.float32 and p_fresh.shape == (n,)
    assert (np.abs(p_fresh - j_fresh) <= 2 / trials).mean() >= 0.9, (p_fresh, j_fresh)


@pytest.mark.parametrize("rebalance", [False, True])
def test_write_matches_the_jax_script_array_for_array(tmp_path, monkeypatch, rebalance):
    """``--write`` (and ``--rebalance``) with the same fresh scores injected
    on both sides: the JAX script rewrites a copy of the DB in place, the
    port writes under ``--out_dir``; the DBs, the balanced files and the rows
    are equal (the row's wall time apart), and the input is untouched."""
    rng = np.random.default_rng(3)
    # half the grasps at 1.0: that bin holds more than max_per_score_bin (1,000)
    fresh = np.where(rng.uniform(size=4096) < 0.5, 1.0,
                     rng.integers(0, 51, 4096) / 50).astype(np.float32)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    jdb = str(jdir / os.path.basename(DB))
    shutil.copy(DB, jdb)
    before = open(DB, "rb").read()

    jscript = jax_script("rescore_grasp_db")
    monkeypatch.setattr(jscript, "rescore", fake_rescore(lambda seed: fresh))
    jscript.run_one(script_args(tmp_path, write=True, rebalance=rebalance), jdb, None, 3)
    jrow = json.loads(open(tmp_path / "jax_rows.jsonl").read().splitlines()[-1])

    monkeypatch.setattr(prdb, "rescore", fake_rescore(lambda seed: fresh))
    out = str(tmp_path / "rows.jsonl")
    argv = ["--db", DB, "--write", "--out_dir", str(pdir), "--out", out, "--device", "cpu"]
    prdb.main(argv + (["--rebalance"] if rebalance else []))
    prow = json.loads(open(out).read().splitlines()[-1])
    assert open(DB, "rb").read() == before
    assert set(prow) == set(jrow)
    assert {k: v for k, v in prow.items() if k != "db"} == \
        {k: v for k, v in jrow.items() if k != "db"}
    names = ["nut_train_0_complete_grasp.npz"]
    if rebalance:
        names.append("nut_train_0_balanced_grasp.npz")
        assert prow["rebalanced"] == names[1] and 0 < prow["n_balanced"] < 4096
    assert sorted(os.listdir(pdir)) == sorted(names)
    for name in names:
        j, p = np.load(jdir / name), np.load(pdir / name)
        assert sorted(p.files) == sorted(j.files)
        for k in j.files:
            assert p[k].dtype == j[k].dtype and p[k].shape == j[k].shape, (name, k)
            np.testing.assert_array_equal(p[k], j[k], err_msg=f"{name}:{k}")
        assert p["score_version"] == np.int32(3) and p["score_version"].dtype == np.int32
    np.testing.assert_array_equal(np.load(pdir / names[0])["scores"], fresh)


def test_noise_floor_row_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    """``--noise_floor`` re-scores with ``seed + 777``: the row's two extra
    keys equal the JAX script's on the same two injected score sets."""
    rng = np.random.default_rng(4)
    sets = {s: (rng.integers(0, 51, 4096) / 50).astype(np.float32) for s in (1234, 2011)}
    jscript = jax_script("rescore_grasp_db")
    monkeypatch.setattr(jscript, "rescore", fake_rescore(sets.__getitem__))
    jscript.run_one(script_args(tmp_path, noise_floor=True), DB, 256, 3)
    jrow = json.loads(open(tmp_path / "jax_rows.jsonl").read().splitlines()[-1])
    monkeypatch.setattr(prdb, "rescore", fake_rescore(sets.__getitem__))
    capsys.readouterr()
    prdb.main(["--db", DB, "--noise_floor", "--device", "cpu"])
    prow = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert prow == jrow
    assert {"noise_floor_spearman", "noise_floor_mean_abs_diff", "pearson",
            "score_version_new"} <= set(prow)


def test_write_never_goes_into_the_tracked_dbs(tmp_path, monkeypatch):
    """The default probe writes nothing; ``--write`` refuses the tracked
    ``dataset/grasps`` (the input's own directory) as its ``--out_dir``."""
    monkeypatch.setattr(prdb, "rescore", fake_rescore(
        lambda seed: np.linspace(0, 1, 4096, dtype=np.float32)))
    before = sorted(os.listdir(os.path.dirname(DB)))
    prdb.main(["--db", DB, "--device", "cpu"])
    with pytest.raises(ValueError, match="tracked"):
        prdb.main(["--db", DB, "--write", "--out_dir", os.path.dirname(DB), "--device", "cpu"])
    assert sorted(os.listdir(os.path.dirname(DB))) == before
    assert prdb.DEFAULT_OUT_DIR == "dataset/grasps_torch"


# --------------------------------------------------------------------------
# calibrate_bandwidth
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def val_scenes(tmp_path_factory):
    """Two val scene records of the three-body pile, rendered by the port on
    the CPU from two cameras at 128x160 (seg, xyz, normal, depth, K)."""
    lib, state, params, env = (f(x) for f, x in zip(
        (port_lib, port_state, port_params, port_env), pile_scene_jax()))
    d = tmp_path_factory.mktemp("val")
    H, W = 128, 160
    K = np.array([[300.0, 0, W / 2], [0, 300.0, H / 2], [0, 0, 1]], np.float32)
    for i, (z, dx) in enumerate(((0.3, 0.0), (0.32, 0.015))):
        cam = top_camera(z)
        cam[0, 3] = dx
        out = praymarch.render(lib, state, params, torch.from_numpy(K), torch.from_numpy(cam),
                               H, W, env=env)
        np.savez(d / f"{i:06d}.npz", K=K, **{k: t2n(out[k]) for k in
                                             ("seg", "xyz", "normal", "depth")})
    return str(d)


def jax_calibration(tmp_path, monkeypatch, val_dir):
    """The JAX script on the scenes with the tracked nut seg net (a copy):
    (its calib.json, each call of its jitted net as (inputs, offsets))."""
    art = tmp_path / "jax_art"
    (art / "seg").mkdir(parents=True)
    shutil.copy(os.path.join(REPO, "artifacts_tracked", "nut", "seg", "best_val.ckpt"),
                art / "seg")
    jscript = jax_script("calibrate_bandwidth")
    calls = []

    def recording_jit(f):
        jf = jax.jit(f)

        def call(*a):
            out = jf(*a)
            calls.append(([np.asarray(v) for v in a[1:]], np.asarray(out[0])))
            return out
        return call

    monkeypatch.setattr(jscript, "jax", types.SimpleNamespace(jit=recording_jit))
    monkeypatch.setattr("sys.argv", ["calibrate_bandwidth.py", "--class_name", "nut",
                                     "--artifacts", str(art), "--val_dir", val_dir])
    jscript.main()
    monkeypatch.undo()
    return json.load(open(art / "seg" / "calib.json")), calls


def test_calibration_equals_the_jax_script_on_its_net_outputs(tmp_path, monkeypatch,
                                                              val_scenes):
    """``main`` with JAX's jitted seg-net outputs carried in as data: the
    same points drawn, and the written calib.json equal to the JAX
    script's, key for key and bit for bit."""
    jcalib, calls = jax_calibration(tmp_path, monkeypatch, val_scenes)
    assert len(calls) == 2 and jcalib["n_scenes"] == 2
    seen = iter(calls)

    def jax_outputs(self, x, n, origin):
        (xj, nj, oj), off = next(seen)
        np.testing.assert_array_equal(t2n(x), xj)
        np.testing.assert_array_equal(t2n(n), nj)
        np.testing.assert_array_equal(t2n(origin), oj)
        return torch.as_tensor(np.array(off)), None

    monkeypatch.setattr(pvoxelnet.SegNet, "forward", jax_outputs)
    art = tmp_path / "port_art"
    (art / "seg").mkdir(parents=True)
    shutil.copy(os.path.join(REPO, "artifacts_tracked", "nut", "seg", "best_val.ckpt"),
                art / "seg")
    out = pcb.main(["--class_name", "nut", "--artifacts", str(art), "--val_dir", val_scenes,
                    "--device", "cpu"])
    pcalib = json.load(open(art / "seg" / "calib.json"))
    assert pcalib == jcalib == out
    assert set(pcalib) == {"bandwidth", "stats", "n_scenes", "formula"}
    assert 0.006 <= pcalib["bandwidth"] <= 0.02


def test_calibration_net_forward_within_bf16_tolerance(tmp_path, monkeypatch, val_scenes):
    """The port's own seg net on the JAX script's first scene's inputs,
    against JAX's jitted outputs: within the bf16 tolerances of the
    predicter test; its residual stats within 1e-3 m of JAX's."""
    jcalib, calls = jax_calibration(tmp_path, monkeypatch, val_scenes)
    from catgrasp_tpu_torch.predict.artifacts import load_predicters
    pred = load_predicters(os.path.join(REPO, "artifacts_tracked", "nut"), "nut", device="cpu",
                           roles=("seg",))
    assert set(pred) == {"seg"}
    offsets = []
    for (x, n, origin), off_j in calls:
        with torch.inference_mode():
            off = t2n(pred["seg"].model(torch.tensor(x), torch.tensor(n),
                                        torch.tensor(origin))[0])
        d = np.abs(off - off_j)
        assert d.max() <= 2e-3 and np.percentile(d, 99) <= 5e-4, (d.max(),
                                                                  np.percentile(d, 99))
        offsets.append(off)
    import glob
    files = sorted(glob.glob(f"{val_scenes}/*.npz"))
    it = iter(offsets)
    stats, bw = pcb.calibration(pcb.shifted_residuals(
        files, pred["seg"].n_pts, lambda x, n, o: torch.as_tensor(next(it)), "cpu"))
    for k, v in jcalib["stats"].items():
        assert abs(stats[k] - v) <= 1e-3, (k, stats[k], v)


def test_calibration_refuses_the_tracked_artifacts(val_scenes):
    with pytest.raises(ValueError, match="tracked"):
        pcb.main(["--artifacts", os.path.join(REPO, "artifacts_tracked", "nut"),
                  "--val_dir", val_scenes, "--device", "cpu"])
    before = open(os.path.join(REPO, "artifacts_tracked", "nut", "seg", "calib.json")).read()
    dry = pcb.main(["--artifacts", os.path.join(REPO, "artifacts_tracked", "nut"),
                    "--val_dir", val_scenes, "--device", "cpu", "--dry"])
    assert set(dry) == {"bandwidth", "stats", "n_scenes", "formula"}
    assert open(os.path.join(REPO, "artifacts_tracked", "nut", "seg",
                             "calib.json")).read() == before
