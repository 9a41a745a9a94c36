"""The readings a training cell's limits are set from, on the card at the
cell's own size: for each seed, the numbers compared of one run of the
program (its window cut to ``--seconds``), of the control (the plain
reference computed with float32 products in TF32, put in the program's
place) and of the reference with a fault planted in it (``half``: the loss
over half of each batch; ``label``: the first sample's label altered;
``unchanged``: each step leaves the state as it was).  Each side's line
also gives each step's loss gap, the median leaf's gap of the change and
the worst leaves, which are not compared.  One JSON line a seed and a
side.

    python -m benchmark.readings --workload nut.train_grasp --seeds 1-12 --seconds 1 \\
        --out nut.train_grasp.readings.jsonl
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from benchmark import harness  # noqa: E402


def seeds_of(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 1-12 or 3,5,9")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control", type=int, default=1, help="also read the control (and faults)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the readings are taken on a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    spec = harness.benchmark_spec()
    with open(args.out, "a") as out:
        for seed in seeds_of(args.seeds):
            cell = harness.make_cell(spec, args.workload, seed, args.seconds, False,
                                     torch.device("cuda"), time.monotonic())
            drv, keep = harness.driver(cell), {}
            t = time.monotonic()
            result = drv.run(cell, keep=keep)
            rows = [{"side": "program", "readings": result.readings, "e2e": result.e2e,
                     "setup_s": result.setup_s, "s": time.monotonic() - t,
                     "detail": drv.reference_readings(cell, keep["split"], keep["weights"],
                                                      keep["program"], detail=True)}]
            if args.control:
                rows += controls(cell, drv, keep)
            for row in rows:
                row.update(workload=args.workload, seed=seed)
                out.write(json.dumps(row) + "\n")
                print(json.dumps(row), flush=True)
            if "tmp" in keep:
                keep["tmp"].cleanup()
    return 0


def controls(cell, drv, keep: dict) -> list[dict]:
    rows = []
    for side, kw in (("control_tf32", {"tf32": True}), ("fault_half", {"fault": "half"}),
                     ("fault_label", {"fault": "label"}),
                     ("fault_unchanged", {"fault": "unchanged"})):
        t = time.monotonic()
        got = drv.reference_readings(cell, keep["split"], keep["weights"], keep["program"],
                                     detail=True, **kw)
        rows.append({"side": side, "readings": got, "s": time.monotonic() - t})
    return rows


if __name__ == "__main__":
    sys.exit(main())
