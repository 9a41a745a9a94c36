"""``BENCHMARK.json`` and every file it names, found by name."""
import json
import os
import re

import pytest

from benchmark import harness

SPEC = harness.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
PORT_CONFIG = {"grasp": "config_grasp.yml", "nunocs": "config_nunocs.yml"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = harness.make_cell(SPEC, cell, 1, 1.0, False, None, 0.0)
    assert harness.driver(c).run
    assert set(c.limits) and all(v >= 0 for v in c.limits.values())
    e2e = [m["name"] for m in SPEC["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in SPEC["per_layer"] if cell in m.get("workloads", [cell])]
    assert layer and all(m["moves"] in e2e for m in layer)


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_reader_resolves_and_reads_nothing_from_nothing(metric):
    read = harness.reader(metric)
    assert read({"instances": [], "steps": 0, "trace": None}) is None


def test_names_units_and_bounds():
    entries = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + SPEC["per_layer"]
    names = [e["name"] for e in entries]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in SPEC[group]}) == len(SPEC[group])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert all("\n" not in x for x in layers)
    assert all(w["chips"] == 1 for w in SPEC["workloads"])
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) < 64 * 1024


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_is_the_port_s_as_it_runs(cfg):
    """The net's settings are the port's config file's, and the symmetry
    count the port's."""
    from catgrasp_tpu_torch.config.loader import load_config
    from catgrasp_tpu_torch.core.symmetry import get_symmetry_tfs

    c = harness.load_json(harness.ROOT, cfg["file"])
    nets = {harness.load_json(harness.HERE, "traffic", f"{w['traffic']}.json").get("net")
            for w in SPEC["workloads"] if w["config"] == cfg["name"]} - {None}
    for net in nets:
        assert c["net"] == load_config(PORT_CONFIG[net])
    assert c["symmetries"] == len(get_symmetry_tfs(c["class_name"]))
    assert c["source"] == cfg["source"] and cfg["reduced"] == []


def test_mixes_are_data():
    for w in SPEC["workloads"]:
        mix = harness.load_json(harness.HERE, "traffic", f"{w['traffic']}.json")
        assert os.path.exists(os.path.join(harness.HERE, "drivers", f"{mix['driver']}.py"))
        json.dumps(mix)
