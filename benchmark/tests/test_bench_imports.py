"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
references load nothing of the port; without a CUDA device a run exits
non-zero and prints no result."""
import os
import shutil
import subprocess
import sys

from benchmark import harness

_RUN_TINY = """
import sys
from benchmark import harness
from benchmark.tests.conftest import tiny_cell
for name in sys.argv[1:]:
    cell = tiny_cell(name)
    harness.driver(cell).run(cell)
print("forbidden:", *harness.forbidden_modules())
"""

_REFERENCE_ONLY = """
import importlib, pkgutil, sys
import benchmark.reference
for m in pkgutil.walk_packages(benchmark.reference.__path__, "benchmark.reference."):
    importlib.import_module(m.name)
print(" ".join(sorted({n.partition(".")[0] for n in sys.modules} & {"catgrasp_tpu_torch", "catgrasp_tpu", "jax", "flax", "jaxlib"})))
"""


def _python(code, *args, cwd=harness.ROOT):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", code, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "catgrasp_tpu_torch_x", sys)
    assert "catgrasp_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "catgrasp_tpu.sim", sys)
    assert harness.forbidden_modules() == ["catgrasp_tpu"]


def test_runs_load_no_jax():
    out = _python(_RUN_TINY, "nut.train_grasp", "screw.train_nunocs")
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.splitlines()[-1] == "forbidden:", out.stdout[-500:]


def test_references_load_nothing_of_the_port():
    out = _python(_REFERENCE_ONLY)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == ""


def _run(cwd):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "nut.train_grasp",
                           "--seed", "3", "--seconds", "1"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_cuda_exits_non_zero_without_a_result():
    out = _run(harness.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_alone_exits_non_zero_without_a_result(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
