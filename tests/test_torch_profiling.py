"""The port's spans (``utils/profiling.py``): the registry by path, the
profiler ranges of host-only spans, the readers' spans between yields, a
``Trainer.fit``'s totals and its trace."""
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from catgrasp_tpu_torch.data import packed
from catgrasp_tpu_torch.pipelines import train_grasp
from catgrasp_tpu_torch.train import trainer as T
from catgrasp_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = [0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.01]
READ_PARTS = ("input.read", "input.resample", "input.transform")


def test_span_paths_self_time_and_calls():
    start = profiling.begin_fit()
    for _ in range(3):
        with profiling.span("outer"):
            time.sleep(0.002)
            with profiling.span("inner"):
                time.sleep(0.004)
            with profiling.span("launch", device_work=True):
                pass
    with profiling.span("inner"):
        pass
    got = profiling.end_fit(start)
    assert set(got) == {"outer", "outer/inner", "outer/launch", "inner"}
    paths = ("outer", "outer/inner", "outer/launch", "inner")
    assert [got[k]["calls"] for k in paths] == [3, 3, 3, 1]
    outer, inner, launch = got["outer"], got["outer/inner"], got["outer/launch"]
    assert inner["seconds"] >= 3 * 0.004 and inner["self_seconds"] == inner["seconds"]
    assert outer["self_seconds"] == pytest.approx(
        outer["seconds"] - inner["seconds"] - launch["seconds"], abs=1e-9)
    assert outer["self_seconds"] >= 3 * 0.002
    assert profiling.last_fit() == got


def test_record_function_only_under_a_profiler_and_off_device_work():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("host.part"):
            with profiling.span("host.child"):
                torch.ones(4).add_(1)
            with profiling.span("device.part", device_work=True):
                torch.ones(4).mul_(2)
    names = [e.name for e in prof.events()]
    assert names.count("host.part") == 1 and names.count("host.child") == 1
    assert "device.part" not in names
    parent = next(e for e in prof.events() if e.name == "host.part")
    assert parent.cpu_parent is None
    assert [c.name for c in parent.cpu_children if c.name.startswith("host.")] == ["host.child"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass
    with profiling.span("unprofiled"):
        pass
    assert "unprofiled" not in [e.name for e in prof.events()]


_SWAPS = """
import torch
from torch.profiler import ProfilerActivity, profile
from catgrasp_tpu_torch.utils import profiling

def prof():
    p = profile(activities=[ProfilerActivity.CPU])
    p.__enter__()
    return p

names, start = [], profiling.begin_fit()
for _ in range(200):
    a = prof()
    with profiling.span("swapped"):      # a stops and b starts inside
        torch.ones(8).add_(1)
        a.__exit__(None, None, None)
        b = prof()
        torch.ones(8).mul_(2)
    with profiling.span("after"):
        pass
    b.__exit__(None, None, None)
    with profiling.span("stopped"):      # b2 stops inside
        b2 = prof()
        with profiling.span("inside"):
            pass
        b2.__exit__(None, None, None)
    with profiling.span("started"):      # c starts inside
        c = prof()
    c.__exit__(None, None, None)
    names = [e.name for e in b.events()]
print("calls", profiling.end_fit(start)["swapped"]["calls"], "after" in names, "swapped" in names)
"""


def test_a_profiler_started_or_stopped_inside_a_span_is_harmless():
    """A range closed under a profiler other than the one it opened under
    would write into that one's freed records: the process would crash."""
    env = {**os.environ, "PYTHONPATH": REPO}
    r = subprocess.run([sys.executable, "-c", _SWAPS], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "calls 200 True False"


# ---- the readers ----------------------------------------------------------


def _grasp_split(root, n_clouds=4, n_keys=24, pts=96, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(root)
    cloud = np.concatenate([rng.uniform(-0.1, 0.1, (n_clouds, pts, 3)),
                            rng.normal(size=(n_clouds, pts, 3))], -1)
    cloud.astype(np.float16).tofile(os.path.join(root, "grasp_cloud.bin"))
    pose = np.tile(np.eye(4, dtype=np.float32), (n_keys, 1, 1))
    q, _ = np.linalg.qr(rng.normal(size=(n_keys, 3, 3)))
    pose[:, :3, :3], pose[:, :3, 3] = q, rng.uniform(-0.05, 0.05, (n_keys, 3))
    np.savez(os.path.join(root, "grasp_keys.npz"), pose=pose,
             score=rng.uniform(0, 1, n_keys).astype(np.float32),
             cloud_row=np.arange(n_keys) % n_clouds)
    with open(os.path.join(root, "meta.json"), "w") as f:
        json.dump({"n_grasp_cloud": n_clouds, "grasp_scene_pts": pts, "n_grasp_keys": n_keys}, f)
    return root


def _rows_split(root, name, shape, seed=0):
    os.makedirs(root)
    np.random.default_rng(seed).normal(size=shape).astype(np.float16).tofile(
        os.path.join(root, f"{name}.bin"))
    keys = {"nunocs": ("n_nunocs", "nunocs_pts"), "seg": ("n_seg", "seg_pts")}[name]
    with open(os.path.join(root, "meta.json"), "w") as f:
        json.dump({keys[0]: shape[0], keys[1]: shape[1]}, f)
    return root


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    base = tmp_path_factory.mktemp("splits")
    return {"grasp": _grasp_split(str(base / "grasp")),
            "nunocs": _rows_split(str(base / "nunocs"), "nunocs", (12, 48, 9)),
            "seg": _rows_split(str(base / "seg"), "seg", (8, 80, 10))}


def _readers(splits, seed=3):
    grasp_cfg = {"n_pts": 32, "classes": CLASSES}
    return {"grasp": packed.PackedGrasp(splits["grasp"], grasp_cfg, seed=seed),
            "nunocs": packed.PackedNunocs(splits["nunocs"], {"n_pts": 64}, seed=seed),
            "seg": packed.PackedSeg(splits["seg"], {"n_pts": 40}, seed=seed)}


@pytest.mark.parametrize("net,parts", [("grasp", READ_PARTS), ("nunocs", READ_PARTS),
                                       ("seg", READ_PARTS[:2])])
def test_reader_spans_close_before_each_yield(splits, net, parts):
    start = profiling.begin_fit()
    n = 0
    for _batch in _readers(splits)[net].batches(4):
        assert profiling._open == []
        n += 1
    assert n >= 2
    got = profiling.end_fit(start)
    assert {k for k in got if k.startswith("input.")} == set(parts)
    assert all(got[p]["calls"] == n for p in parts)


@pytest.mark.parametrize("net", ["grasp", "nunocs", "seg"])
def test_reader_batches_equal_with_spans_inert(splits, net, monkeypatch):
    live = [b for b in _readers(splits)[net].batches(4)]
    monkeypatch.setattr(packed.profiling, "span", contextlib.nullcontext)
    inert = [b for b in _readers(splits)[net].batches(4)]
    assert len(live) == len(inert) >= 2
    for a, b in zip(live, inert):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


# ---- a fit ----------------------------------------------------------------


def _tiny_fit(tmp_path, splits, n_epochs=2):
    cfg = {"n_epochs": n_epochs, "start_lr": 0.01, "batch_size": 4, "lr_milestones": [],
           "random_seed": 0, "n_pts": 32, "classes": CLASSES}
    model, loss_fn = train_grasp.build(cfg)
    state = T.create_state(model, cfg, device="cpu")
    ds = packed.PackedGrasp(splits["grasp"], cfg, seed=1)
    val = packed.PackedGrasp(splits["grasp"], cfg, phase="val", seed=2)
    tr = T.Trainer(model=model, cfg=cfg, loss_fn=loss_fn, train_data=lambda: ds.batches(4),
                   val_data=lambda: val.batches(8, shuffle=False), ckpt_dir=str(tmp_path))
    return tr, state


def test_fit_spans_counts_timing_event_and_trace(tmp_path, splits, monkeypatch):
    torch.manual_seed(0)
    saves = []
    save = T.save_checkpoint
    monkeypatch.setattr(T, "save_checkpoint", lambda *a: (saves.append(a[0]), save(*a)))
    tr, state = _tiny_fit(tmp_path, splits)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.fit(state, verbose=False)
    got = profiling.last_fit()
    steps, val_batches = 2 * (24 // 4), 2 * (24 // 8)
    assert got["input.next"]["calls"] == steps + 2  # and each epoch's end
    for p in READ_PARTS:
        assert got[f"input.next/{p}"]["calls"] == steps
        assert got[f"train.evaluate/{p}"]["calls"] == val_batches
    assert got["input.to_device"]["calls"] == got["train.step"]["calls"] == steps
    assert got["train.evaluate"]["calls"] == 2
    assert got["ckpt.save"]["calls"] == len(saves) >= 2
    assert {k.split("/")[0] for k in got} == {"input.next", "input.to_device", "train.step",
                                              "train.evaluate", "ckpt.save"}
    parts = sum(got[f"input.next/{p}"]["seconds"] for p in READ_PARTS)
    assert parts <= got["input.next"]["seconds"]

    events = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    timing = [e for e in events if e["kind"] == "timing"]
    assert len(timing) == 1 and all(timing[0][k] == v for k, v in got.items())

    nexts = [e for e in prof.events() if e.name == "input.next"]
    assert len(nexts) == steps + 2 and all(e.cpu_parent is None for e in nexts)
    full = [e for e in nexts if e.cpu_children]
    assert len(full) == steps
    for e in full:
        assert [c.name for c in e.cpu_children] == list(READ_PARTS)
    names = {e.name for e in prof.events()}
    assert not names & {"input.to_device", "train.step", "train.evaluate", "ckpt.save"}
    evaluated = [e for e in prof.events() if e.name == "input.read" and e.cpu_parent is None]
    assert len(evaluated) == val_batches


def test_last_fit_holds_the_last_fit_only(tmp_path, splits):
    tr, state = _tiny_fit(tmp_path / "a", splits, n_epochs=2)
    tr.fit(state, verbose=False)
    first = profiling.last_fit()
    with profiling.span("between"):
        pass
    tr, state = _tiny_fit(tmp_path / "b", splits, n_epochs=1)
    tr.fit(state, verbose=False)
    second = profiling.last_fit()
    assert first["train.step"]["calls"] == 12 and second["train.step"]["calls"] == 6
    assert "between" not in second and second["train.evaluate"]["calls"] == 1
    with contextlib.suppress(ZeroDivisionError):
        tr.train_data = lambda: iter([1 / 0])
        tr.fit(state, n_epochs=1, verbose=False)
    assert profiling.last_fit() is second
