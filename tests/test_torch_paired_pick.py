"""The port's arm-executed pick on paired scenes: committed records of JAX's
``execute_pick_arm`` (``scripts/paired_pick_jax.py``: the eval's piles,
320-waypoint schedules, ``--arm_dynamics 1``) replayed by the port on the
CPU, with no JAX run here.

A record holds JAX's run on its dynamicized schedule and JAX's run of the
same schedule from positions nudged 1e-6 m (the chaos floor).  The port
keeps the target within 1e-4 m of JAX's trajectory up to the step at which
JAX parts from its nudged self; where JAX's pick agrees with the nudged
one, the port's pick equals it, and where JAX's width does, the port's
width lies within 0.2 mm.  The statistics of
``scripts/paired_pick_protocol.py`` are held to their definitions, and the
committed protocol files to their own rows.
"""
import glob
import json
import multiprocessing as mp
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest
import torch

from scripts import paired_pick_protocol as ppp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORDS_DIR = os.path.join(REPO, "logs", "paired_pick")
# the first three nut records (piles of the eval matrix: 8 objects, CSG)
# and the first demo record whose JAX pick held (a grid pile of 4)
RECORDS = ("nut_seed00_seg0.npz", "nut_seed00_seg1.npz", "nut_seed01_seg0.npz",
           "demo_nut_seed00_seg1.npz")


def _replay_dyn(path: str) -> dict:
    torch.set_num_threads(1)
    return ppp.replay(path, "cpu", runs=("dyn",))


@pytest.fixture(scope="module")
def rows():
    """Each record's ``dyn`` run through the port on the CPU, the records
    side by side in processes of their own (spawned: nothing of this
    process, JAX included, is inherited)."""
    paths = [os.path.join(RECORDS_DIR, r) for r in RECORDS]
    with ProcessPoolExecutor(len(paths), mp_context=mp.get_context("spawn")) as pool:
        out = list(pool.map(_replay_dyn, paths))
    return dict(zip(RECORDS, out))


@pytest.mark.parametrize("record", RECORDS)
def test_pick_follows_jax_to_the_floor_horizon(rows, record):
    row = rows[record]
    # the scene as restored from the record: JAX's quaternions within f32
    # rounding of the matrix round trip
    assert row["quat0_err"] < 1e-6
    assert ppp.horizon_breaches(row) == []


def test_records_hold_the_eval_schedules():
    """The committed records: at least 48 nut pairs and 12 demo pairs, each
    at the eval's 320-waypoint split with both schedules and three runs."""
    paths = sorted(glob.glob(os.path.join(RECORDS_DIR, "*.npz")))
    nut = [p for p in paths if os.path.basename(p).startswith("nut_")]
    demo = [p for p in paths if os.path.basename(p).startswith("demo_")]
    assert len(nut) >= 48 and len(demo) >= 12
    for p in nut[:2] + demo[:2]:
        rec = np.load(p)
        assert (int(rec["n_app"]), int(rec["n_close"]), int(rec["n_hold"])) == (140, 50, 80)
        assert rec["sched_kin"].shape == rec["sched_dyn"].shape == (320, 7)
        for run in ("kin", "dyn", "nudge"):
            assert rec[f"{run}_traj"].shape == (320, 3)
        assert np.allclose(np.linalg.norm(rec["nudge"], axis=1), 1e-6)


def test_mcnemar_and_part_step():
    assert ppp.mcnemar_p(0, 0) == 1.0
    assert ppp.mcnemar_p(5, 0) == pytest.approx(2 / 32)
    assert ppp.mcnemar_p(6, 0) == pytest.approx(2 / 64)
    assert ppp.mcnemar_p(3, 4) == 1.0
    assert ppp.mcnemar_p(1, 9) == pytest.approx(2 * 11 / 1024)
    a = np.zeros((10, 3))
    b = a.copy()
    assert ppp.part_step(a, b) == 10
    b[4:, 0] = 2e-4
    assert ppp.part_step(a, b) == 4


@pytest.mark.parametrize("name", ("port_cuda.jsonl", "port_cpu.jsonl"))
def test_protocol_summaries_are_those_of_their_rows(name):
    """A committed protocol file's summary lines are ``summarize`` of its
    attempt lines, one attempt a record."""
    lines = [json.loads(x) for x in open(os.path.join(RECORDS_DIR, name))]
    rows = [r for r in lines if not r.get("summary")]
    assert len({r["record"] for r in rows}) == len(rows)
    assert [s for s in lines if s.get("summary")] == ppp.summarize(rows)
