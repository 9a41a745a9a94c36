"""Run one cell of ``BENCHMARK.json`` on this machine's GPU and print its
result as the last line of standard output.

    python -m benchmark.run --workload nut.train_grasp --seed 7 --seconds 30 --trace 0

``--trace 0`` prints the cell's end-to-end metrics; ``--trace 1`` runs a
bounded part of the window under ``torch.profiler`` and prints the cell's
per-layer metrics, the device's busy and traced seconds and a breakdown.
Every run compares what its timed path produced with the plain reference
and prints each number compared beside its limit, on standard error and
under ``checks`` in the result.  Without a CUDA device it exits 1 and
prints no result."""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
# caches at fixed paths inside the checkout, so only a cell's first run
# there builds; the port's own CUDA kernels build into
# catgrasp_tpu_torch/build/
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(HERE, ".cache", "torch_extensions")
os.environ["USE_FLAX"] = "0"
# one process with few threads: the host's work is one Python thread, and
# idle pool threads that spin take cores from it
for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(var, "1")

import torch  # noqa: E402

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = harness.benchmark_spec()
    chips = harness.find(spec["workloads"], args.workload, "workload")["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's default: float32 as stated
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.make_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda"), T_START)
    result = harness.driver(cell).run(cell)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark runs the port alone", file=sys.stderr)
        return 1
    correct, lines = harness.check(result.readings, cell.limits)
    out = {"correct": correct, "attempted": result.attempted, "failed": result.failed,
           "metrics": harness.metrics_of(spec, args.workload, result, cell.trace),
           "device": result.device}
    if cell.trace:
        trace = result.layer.get("trace") or {}
        out["device"].update(busy_s=trace.get("busy_s", 0.0), window_s=trace.get("window_s", 0.0))
        out["breakdown"] = {"device_ops": trace.get("device_ops", []),
                            "idle_gaps": trace.get("idle_gaps", [])}
    out["checks"] = {k: {"value": result.readings.get(k), "limit": v}
                     for k, v in cell.limits.items()}
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
