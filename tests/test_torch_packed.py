"""Training rows: the port's ``data/`` (labels, packed rows, datasets,
augmentations; host numpy, copied from the JAX package) and
``pipelines/pack_training_data.py`` against JAX's on the same scene files,
which the port's ``generate_scenes`` makes on the CPU.  Rows, files and
batches must be identical, byte for byte."""
import json
import os

import numpy as np
import pytest
import torch

from catgrasp_tpu.data import augment as jaugment
from catgrasp_tpu.data import datasets as jdatasets
from catgrasp_tpu.data import labels as jlabels
from catgrasp_tpu.data import packed as jpacked
from catgrasp_tpu.pipelines import pack_training_data as jptd
from catgrasp_tpu_torch.config.loader import load_config
from catgrasp_tpu_torch.data import augment, datasets, labels, packed
from catgrasp_tpu_torch.pipelines import generate_pile_data as gpd
from catgrasp_tpu_torch.pipelines import pack_training_data as ptd
from test_torch_common import small_scene_cfg

torch.set_num_threads(2)
BINS = {"nunocs.bin", "seg.bin", "grasp_cloud.bin", "meta.json"}


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scenes"))
    gpd.generate_scenes("nut", "train", 4, root, cfg=small_scene_cfg(), seed=1,
                        settle_steps=40, batch=2, device="cpu")
    return root


@pytest.fixture(scope="module")
def packs(scenes, tmp_path_factory):
    out_j = str(tmp_path_factory.mktemp("packed_jax"))
    out_p = str(tmp_path_factory.mktemp("packed_port"))
    meta_j = jpacked.pack_split(scenes, out_j, grasp_db=jptd.load_grasp_dbs("nut"), seed=0,
                                log_every=0)
    meta_p = ptd.main(["--root", scenes, "--out_dir", out_p, "--seed", "0"])
    return out_j, out_p, meta_j, meta_p


def test_pack_split_is_byte_identical(packs):
    """The port's ``pack_training_data`` (the 12 nut DBs, matched by
    shape_id) against JAX's ``pack_split``: the same meta and byte-identical
    rows."""
    out_j, out_p, meta_j, meta_p = packs
    assert meta_p == meta_j
    assert meta_j["n_nunocs"] >= 4 and meta_j["n_seg"] == 4 and meta_j["n_grasp_keys"] >= 8
    for name in BINS:
        with open(os.path.join(out_j, name), "rb") as a, open(os.path.join(out_p, name), "rb") as b:
            assert a.read() == b.read(), name
    kj = np.load(os.path.join(out_j, "grasp_keys.npz"))
    kp = np.load(os.path.join(out_p, "grasp_keys.npz"))
    assert sorted(kj.files) == sorted(kp.files) == ["cloud_row", "pose", "score"]
    for k in kj.files:
        assert kj[k].dtype == kp[k].dtype and kj[k].tobytes() == kp[k].tobytes(), k
    with open(os.path.join(out_p, "meta.json")) as f:
        assert json.load(f) == meta_j


def test_grasp_dbs_load_as_jax():
    dj, dp = jptd.load_grasp_dbs("nut"), ptd.load_grasp_dbs("nut")
    assert len(dp) == len(dj) == 12
    assert [d["shape_id"] for d in dp] == [d["shape_id"] for d in dj]
    assert sorted(d["shape_id"] for d in dp) == list(range(12))
    assert ptd.default_packed_dir("nut", "train") == "dataset/torch/nut/packed_train"


def _assert_batches_equal(it_j, it_p):
    n = 0
    for bj, bp in zip(it_j, it_p, strict=True):
        assert sorted(bj) == sorted(bp)
        for k in bj:
            assert bj[k].dtype == bp[k].dtype and bj[k].tobytes() == bp[k].tobytes(), k
        n += 1
    return n


@pytest.mark.parametrize("kind,cfg_name,bs", [("PackedNunocs", "config_nunocs.yml", 2),
                                              ("PackedSeg", "config_seg.yml", 2),
                                              ("PackedGrasp", "config_grasp.yml", 4)])
@pytest.mark.parametrize("phase", ["train", "val"])
def test_packed_batches_are_identical(packs, kind, cfg_name, bs, phase):
    """Two epochs of each ``Packed*`` dataset from one seed: the same
    batches (augmentations, the bin-balanced grasp draws, dropout)."""
    out_j, out_p = packs[:2]
    cfg = load_config(cfg_name)
    dj = getattr(jpacked, kind)(out_j, cfg, phase=phase, seed=7)
    dp = getattr(packed, kind)(out_p, cfg, phase=phase, seed=7)
    assert len(dj) == len(dp)
    n = sum(_assert_batches_equal(dj.batches(bs), dp.batches(bs)) for _ in range(2))
    assert n >= 2


@pytest.fixture(scope="module")
def grasp_split(tmp_path_factory):
    """A grasp split written by hand at the training shape: 24 clouds of
    8,192 x 6 f16 and 480 keys, rigid poses with non-zero translations (one
    with none), scores over all ten bins.  Some points are exact zeros, and
    some normals, where a sum of signed zero products must read as einsum's."""
    out = tmp_path_factory.mktemp("grasp_split")
    rng = np.random.default_rng(11)
    rows = rng.normal(0, 0.05, (24, 8192, 6))
    rows[..., 3:] /= np.linalg.norm(rows[..., 3:], axis=-1, keepdims=True)
    rows[:, :64, 3:] = 0
    rows[:, 64:96] = 0
    rows.astype(np.float16).tofile(out / "grasp_cloud.bin")
    q, _ = np.linalg.qr(rng.normal(size=(480, 3, 3)))
    pose = np.tile(np.eye(4), (480, 1, 1))
    pose[:, :3, :3] = q
    pose[:, :3, 3] = rng.normal(0, 0.3, (480, 3))
    pose[0, :3, 3] = 0
    np.savez(out / "grasp_keys.npz", pose=pose.astype(np.float32),
             score=((np.arange(480) % 10 + rng.uniform(0.05, 0.95, 480)) / 10).astype(np.float32),
             cloud_row=rng.integers(0, 24, 480).astype(np.int64))
    (out / "meta.json").write_text(json.dumps({"n_grasp_cloud": 24, "grasp_scene_pts": 8192,
                                               "n_grasp_keys": 480}))
    return str(out)


@pytest.mark.parametrize("phase", ["train", "val"])
def test_packed_grasp_batches_are_identical_at_training_shape(grasp_split, phase):
    """Two epochs of ``PackedGrasp`` at the grasp net's batch, 240 x 2,048
    points of 8,192-point rows (the flip and the bin-balanced draws in
    training): the same bytes as JAX's einsum frame transform."""
    cfg = load_config("config_grasp.yml")
    assert (cfg["batch_size"], cfg["n_pts"]) == (240, 2048)
    dj = jpacked.PackedGrasp(grasp_split, cfg, phase=phase, seed=5)
    dp = packed.PackedGrasp(grasp_split, cfg, phase=phase, seed=5)
    n = sum(_assert_batches_equal(dj.batches(240), dp.batches(240)) for _ in range(2))
    assert n == 4


def test_unpacked_datasets_are_identical(scenes):
    cfg_n, cfg_s, cfg_g = (load_config(f"config_{n}.yml") for n in ("nunocs", "seg", "grasp"))
    cfg_s["n_pts"] = 2000
    db = dict(np.load("dataset/grasps/nut_train_0_balanced_grasp.npz", allow_pickle=True))
    pairs = [(jdatasets.NunocsDataset(scenes, cfg_n, seed=3),
              datasets.NunocsDataset(scenes, cfg_n, seed=3), 2),
             (jdatasets.SegDataset(scenes, cfg_s, seed=3), datasets.SegDataset(scenes, cfg_s, seed=3), 2),
             (jdatasets.GraspDataset(scenes, db, cfg_g, seed=3),
              datasets.GraspDataset(scenes, db, cfg_g, seed=3), 4)]
    for dj, dp, bs in pairs:
        assert len(dj) == len(dp) > 0
        _assert_batches_equal(dj.batches(bs), dp.batches(bs))


def test_labels_are_identical(scenes):
    f = sorted(os.listdir(scenes))[0]
    sj = jlabels.load_scene(os.path.join(scenes, f))
    sp = labels.load_scene(os.path.join(scenes, f))
    for a, b in zip(jlabels.isolated_object_clouds(sj), labels.isolated_object_clouds(sp),
                    strict=True):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    for k, v in jlabels.scene_cloud(sj).items():
        np.testing.assert_array_equal(labels.scene_cloud(sp)[k], v)
    db = dict(np.load("dataset/grasps/nut_train_0_balanced_grasp.npz", allow_pickle=True))
    lj = jlabels.dense_clutter_grasp_labels(sj, db, min_vis=0.0, rng=np.random.default_rng(2))
    lp = labels.dense_clutter_grasp_labels(sp, db, min_vis=0.0, rng=np.random.default_rng(2))
    assert len(lj) == len(lp) > 0
    for (gj, scj, bj), (gp, scp, bp) in zip(lj, lp):
        np.testing.assert_array_equal(gp, gj)
        assert (scp, bp) == (scj, bj)


@pytest.mark.parametrize("fn", ["rotate_cloud_z", "flip_cloud", "dropout_cloud", "resample",
                                "normalize_cloud"])
def test_augmentations_are_identical(fn):
    rng = np.random.default_rng(0)
    cloud = {"cloud_xyz": rng.normal(size=(300, 3)).astype(np.float32),
             "cloud_normal": rng.normal(size=(300, 3)).astype(np.float32),
             "cloud_nocs": rng.uniform(size=(300, 3)).astype(np.float32)}
    for seed in range(6):
        a = {k: v.copy() for k, v in cloud.items()}
        b = {k: v.copy() for k, v in cloud.items()}
        if fn == "normalize_cloud":
            oj, op = jaugment.normalize_cloud(a), augment.normalize_cloud(b)
        elif fn == "resample":
            oj = jaugment.resample(a, 512, np.random.default_rng(seed))
            op = augment.resample(b, 512, np.random.default_rng(seed))
        else:
            oj = getattr(jaugment, fn)(a, np.random.default_rng(seed))
            op = getattr(augment, fn)(b, np.random.default_rng(seed))
        assert sorted(oj) == sorted(op)
        for k in oj:
            np.testing.assert_array_equal(np.asarray(op[k]), np.asarray(oj[k]))
