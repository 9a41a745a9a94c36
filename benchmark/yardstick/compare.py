"""The numbers that decide ``correct``: each is a gap between what the timed
path produced and what the plain reference works out again, and each is
held to a limit of its own (``benchmark/limits/<cell>.json``)."""
from __future__ import annotations

import statistics

import torch

# a record of another length than the reference's: nothing to compare
SIZE_MISMATCH = 10.0
# leaves whose reference gradient lies under this share of the median
# leaf's move by round-off alone under Adam: left out of the change
STILL_LEAF = 1e-3


def loss_gap(program: list[float], reference: list[float]) -> float:
    """The widest gap between the steps' losses, as a share of the
    reference's."""
    if len(program) != len(reference):
        return SIZE_MISMATCH
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(program, reference))


def _norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def moving_leaves(reference_grad: dict) -> list[str]:
    """The leaves whose reference gradient is at least ``STILL_LEAF`` of
    the median leaf's."""
    norms = _norms(reference_grad)
    floor = STILL_LEAF * statistics.median(norms.values())
    return [k for k, v in norms.items() if v >= floor]


def _gaps(program: dict, reference: dict, names: list[str] | None) -> dict | None:
    """Each leaf's gap between the program's norm and the reference's,
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger; None where the program lacks a leaf."""
    names = list(reference) if names is None else names
    if not names or any(k not in program for k in names):
        return None
    p, r = _norms({k: program[k] for k in names}), _norms({k: reference[k] for k in names})
    med = statistics.median(r.values())
    return {k: abs(p[k] - r[k]) / max(r[k], med, 1e-30) for k in names}


def leaf_gap(program: dict, reference: dict, names: list[str] | None = None) -> float:
    """The worst leaf's gap."""
    gaps = _gaps(program, reference, names)
    return SIZE_MISMATCH if gaps is None else max(gaps.values())


def median_leaf_gap(program: dict, reference: dict, names: list[str] | None = None) -> float:
    """The median leaf's gap."""
    gaps = _gaps(program, reference, names)
    return SIZE_MISMATCH if gaps is None else statistics.median(gaps.values())


def worst_leaves(program: dict, reference: dict, names: list[str] | None = None,
                 n: int = 3) -> list:
    """The ``n`` leaves with the widest gaps, with their gaps."""
    gaps = _gaps(program, reference, names) or {}
    return sorted(gaps.items(), key=lambda kv: -kv[1])[:n]


def change(after: dict, before: dict) -> dict:
    return {k: after[k].double() - before[k].double() for k in after}
