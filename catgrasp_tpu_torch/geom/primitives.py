"""Procedural watertight meshes for the CaTGrasp object categories and rig.

The port's own numpy copy of ``catgrasp_tpu.geom.primitives`` (the two
packages must build the same instances, so the parameter tables match).

The reference ships no mesh assets in-repo (``data/object_models`` is a
download, ``README.md:68-75``).  The framework therefore generates its own
parametric instances of each category — hex nuts, screws, male connectors
("hnm") — plus the parallel-jaw gripper and bin, so every pipeline stage is
runnable and testable end to end without external data.  Real .obj assets
drop in through :meth:`catgrasp_tpu_torch.geom.mesh.TriMesh.load_obj`.
"""
from __future__ import annotations

import numpy as np

from .mesh import TriMesh


def _ring(radius: float, n: int, z: float, phase: float = 0.0) -> np.ndarray:
    a = np.arange(n) / n * 2 * np.pi + phase
    return np.stack([radius * np.cos(a), radius * np.sin(a), np.full(n, z)], axis=-1)


def _wall(faces: list, lo: np.ndarray, hi: np.ndarray, flip: bool = False):
    """Quad strip between two same-length vertex rings (index arrays)."""
    n = len(lo)
    for i in range(n):
        j = (i + 1) % n
        if not flip:
            faces.append([lo[i], lo[j], hi[j]])
            faces.append([lo[i], hi[j], hi[i]])
        else:
            faces.append([lo[i], hi[j], lo[j]])
            faces.append([lo[i], hi[i], hi[j]])


def box(extents, center=(0.0, 0.0, 0.0)) -> TriMesh:
    e = np.asarray(extents, dtype=np.float32) / 2
    c = np.asarray(center, dtype=np.float32)
    v = np.array(
        [[x, y, z] for x in (-e[0], e[0]) for y in (-e[1], e[1]) for z in (-e[2], e[2])],
        dtype=np.float32,
    ) + c
    f = np.array(
        [
            [0, 1, 3], [0, 3, 2],  # -x
            [4, 7, 5], [4, 6, 7],  # +x
            [0, 5, 1], [0, 4, 5],  # -y
            [2, 3, 7], [2, 7, 6],  # +y
            [0, 2, 6], [0, 6, 4],  # -z
            [1, 5, 7], [1, 7, 3],  # +z
        ],
        dtype=np.int32,
    )
    return TriMesh(v, f)


def cylinder(radius: float, height: float, n: int = 24, center=(0, 0, 0)) -> TriMesh:
    z0, z1 = -height / 2, height / 2
    bot = _ring(radius, n, z0)
    top = _ring(radius, n, z1)
    verts = np.concatenate([bot, top, [[0, 0, z0]], [[0, 0, z1]]]).astype(np.float32)
    cb, ct = 2 * n, 2 * n + 1
    faces: list = []
    _wall(faces, np.arange(n), np.arange(n) + n)
    for i in range(n):
        j = (i + 1) % n
        faces.append([cb, j, i])          # bottom cap (normal -z)
        faces.append([ct, n + i, n + j])  # top cap (normal +z)
    m = TriMesh(verts, np.array(faces, dtype=np.int32))
    return m.transformed(_translate(center))


def tube(outer_r: float, inner_r: float, height: float, n: int = 6, n_inner: int | None = None,
         phase: float = 0.0) -> TriMesh:
    """Watertight prism ring with a coaxial hole: nut body.  ``n=6`` gives a
    hex outer wall; ``n_inner`` (default 4*n) rounds the hole.
    """
    n_inner = n_inner or max(n, 12)
    # Use a common vertex count ring for caps triangulation: triangulate the
    # annulus between outer ring (n) and inner ring (n_inner) by resampling
    # both to lcm-ish count. Simpler: resample outer polygon to n_inner
    # points lying ON the polygon so the outer shape is preserved.
    t = np.arange(n_inner) / n_inner * n  # position along polygon edges
    seg = np.floor(t).astype(int) % n
    frac = (t - np.floor(t))[:, None]
    poly = _ring(outer_r, n, 0.0, phase)[:, :2]
    outer_xy = poly[seg] * (1 - frac) + poly[(seg + 1) % n] * frac
    z0, z1 = -height / 2, height / 2
    ob = np.concatenate([outer_xy, np.full((n_inner, 1), z0)], axis=1)
    ot = np.concatenate([outer_xy, np.full((n_inner, 1), z1)], axis=1)
    ib = _ring(inner_r, n_inner, z0)
    it = _ring(inner_r, n_inner, z1)
    verts = np.concatenate([ob, ot, ib, it]).astype(np.float32)
    OB, OT, IB, IT = (np.arange(n_inner), np.arange(n_inner) + n_inner,
                      np.arange(n_inner) + 2 * n_inner, np.arange(n_inner) + 3 * n_inner)
    faces: list = []
    _wall(faces, OB, OT)              # outer wall, outward
    _wall(faces, IB, IT, flip=True)   # inner wall, inward
    _wall(faces, OB, IB, flip=True)   # bottom annulus (normal -z)
    _wall(faces, OT, IT)              # top annulus (normal +z)
    return TriMesh(verts, np.array(faces, dtype=np.int32))


def _translate(t) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = t
    return T


# ---------------------------------------------------------------------------
# Category instances (parametric families -> training/test splits)
# ---------------------------------------------------------------------------


def hex_nut(outer_r: float = 0.012, inner_r: float = 0.006, height: float = 0.008) -> TriMesh:
    """Hex nut with a through-hole; z is the hole axis (matches the nut
    category convention implied by its symmetry group, ``Utils.py:82-85``)."""
    return tube(outer_r, inner_r, height, n=6)


def screw(shaft_r: float = 0.004, shaft_len: float = 0.03, head_r: float = 0.007,
          head_h: float = 0.005, n: int = 16) -> TriMesh:
    """Screw pointing -z with head on top (+z), axis = z (symmetry:
    ``Utils.py:91-94``).  Union of two watertight solids; the SDF bake uses
    winding numbers so overlapping unions stay correctly signed."""
    shaft = cylinder(shaft_r, shaft_len, n, center=(0, 0, -shaft_len / 2))
    head = cylinder(head_r, head_h, 6, center=(0, 0, head_h / 2))
    return TriMesh.concatenate([shaft, head])


def hnm_connector(body=(0.016, 0.010, 0.030), pin_r: float = 0.0025, pin_len: float = 0.012,
                  n_pin: int = 2) -> TriMesh:
    """Male connector: box body with cylindrical pins sticking out of +z.
    180° z-symmetric like the reference hnm class (``Utils.py:87-90``)."""
    parts = [box(body, center=(0, 0, 0))]
    xs = np.linspace(-body[0] / 4, body[0] / 4, n_pin)
    for x in xs:
        parts.append(cylinder(pin_r, pin_len, 12, center=(x, 0, body[2] / 2 + pin_len / 2 - 1e-4)))
    return TriMesh.concatenate(parts)


# Parametric splits: same spirit as config.yml's train/test instance lists.
NUT_TRAIN = [dict(outer_r=r, inner_r=r * hr, height=h)
             for r in (0.009, 0.012, 0.015) for hr in (0.45, 0.55) for h in (0.006, 0.009)]
NUT_TEST = [dict(outer_r=0.011, inner_r=0.005, height=0.0075),
            dict(outer_r=0.014, inner_r=0.008, height=0.010)]
SCREW_TRAIN = [dict(shaft_r=r, shaft_len=l, head_r=r * 1.8, head_h=r * 1.2)
               for r in (0.003, 0.004, 0.005) for l in (0.02, 0.03, 0.04)]
SCREW_TEST = [dict(shaft_r=0.0035, shaft_len=0.025, head_r=0.0063, head_h=0.0042),
              dict(shaft_r=0.0045, shaft_len=0.035, head_r=0.0081, head_h=0.0054)]
HNM_TRAIN = [dict(body=(bx, by, bz)) for bx in (0.014, 0.018) for by in (0.008, 0.012) for bz in (0.026, 0.034)]
HNM_TEST = [dict(body=(0.016, 0.010, 0.030)), dict(body=(0.020, 0.009, 0.028))]

_BUILDERS = {"nut": hex_nut, "screw": screw, "hnm": hnm_connector}
_SPLITS = {
    ("nut", "train"): NUT_TRAIN, ("nut", "test"): NUT_TEST,
    ("screw", "train"): SCREW_TRAIN, ("screw", "test"): SCREW_TEST,
    ("hnm", "train"): HNM_TRAIN, ("hnm", "test"): HNM_TEST,
}


def make_instance(class_name: str, split: str = "train", index: int = 0) -> TriMesh:
    params = _SPLITS[(class_name, split)]
    return _BUILDERS[class_name](**params[index % len(params)])


def instance_params(class_name: str, split: str = "train", index: int = 0) -> dict:
    """The parametric description of one instance (for fixture matching)."""
    params = _SPLITS[(class_name, split)]
    return dict(params[index % len(params)])


def num_instances(class_name: str, split: str = "train") -> int:
    return len(_SPLITS[(class_name, split)])


# ---------------------------------------------------------------------------
# Rig: parallel-jaw gripper + bin + place fixtures
# ---------------------------------------------------------------------------


def parallel_jaw_gripper(max_width: float = 0.05, finger_len: float = 0.045,
                         finger_thickness: float = 0.012, finger_depth: float = 0.02,
                         palm_depth: float = 0.03):
    """Robotiq Hand-E-like gripper in the GRASP frame (x = approach,
    y = closing axis; ``gripper.py:52-53``): palm behind the fingers on -x,
    fingers extend along +x, close along ±y.

    Returns (open_mesh, enclosed_mesh, params) — mirroring the reference's
    ``gripper_air_tight.obj`` / ``gripper_enclosed_air_tight.obj`` pair
    (``gripper.py:57-58``).  ``enclosed`` is the swept closing volume between
    the fingers, used for the "would the closing gripper hit background"
    test (``common.cpp:181,241-249``).
    """
    half_w = max_width / 2
    palm = box((palm_depth, max_width + 2 * finger_thickness + 0.02, finger_depth + 0.02),
               center=(-palm_depth / 2, 0, 0))
    f1 = box((finger_len, finger_thickness, finger_depth),
             center=(finger_len / 2, half_w + finger_thickness / 2, 0))
    f2 = box((finger_len, finger_thickness, finger_depth),
             center=(finger_len / 2, -half_w - finger_thickness / 2, 0))
    open_mesh = TriMesh.concatenate([palm, f1, f2])
    enclosed = box((finger_len, max_width + 2 * finger_thickness, finger_depth),
                   center=(finger_len / 2, 0, 0))
    params = dict(max_width=max_width, finger_len=finger_len,
                  finger_thickness=finger_thickness, finger_depth=finger_depth,
                  palm_depth=palm_depth,
                  # dexnet-style params (gripper params.json semantics)
                  hand_depth=finger_len, init_bite=-0.005)
    return open_mesh, enclosed, params


def open_bin(inner=(0.30, 0.30, 0.12), wall: float = 0.01) -> TriMesh:
    """Open-top bin: floor + 4 walls, interior origin at floor center."""
    ix, iy, iz = inner
    floor = box((ix + 2 * wall, iy + 2 * wall, wall), center=(0, 0, -wall / 2))
    w1 = box((wall, iy + 2 * wall, iz), center=(ix / 2 + wall / 2, 0, iz / 2))
    w2 = box((wall, iy + 2 * wall, iz), center=(-ix / 2 - wall / 2, 0, iz / 2))
    w3 = box((ix, wall, iz), center=(0, iy / 2 + wall / 2, iz / 2))
    w4 = box((ix, wall, iz), center=(0, -iy / 2 - wall / 2, iz / 2))
    return TriMesh.concatenate([floor, w1, w2, w3, w4])


def fixture_fit(class_name: str, instance_params: dict | None = None) -> float:
    """Radial fit of the place fixture to an object instance — the analog of
    the reference's per-model ``{ob_name}_place.obj`` being built to mate
    with that exact model (``README.md:68-75``; the eval loads the fixture
    matched to ``cfg_run['ob_name']``, ``run_grasp_simulation.py:487``).
    Returns the peg radius (nut), hole radius (screw), or socket inner
    radius (hnm).  Feature heights never change, so TASK_POSES stay valid."""
    p = instance_params or {}
    if class_name == "nut":
        # peg clears the thread hole with ~45% radial clearance
        return 0.55 * p.get("inner_r", 0.006)
    if class_name == "screw":
        # hole passes the shaft but not the head
        return p.get("shaft_r", 0.004) + 0.0025
    if class_name == "hnm":
        # square socket circumradius such that the socket's inscribed
        # half-width clears the body's largest half-extent by 2 mm
        bx, by, _ = p.get("body", (0.016, 0.010, 0.030))
        return (max(bx, by) / 2 + 0.002) / float(np.cos(np.pi / 4))
    raise ValueError(class_name)


def place_fixture(class_name: str, instance_params: dict | None = None) -> TriMesh:
    """Placement fixture ("*_place.obj" analog): a peg for nuts, a hole block
    for screws, a socket block for hnm — radially matched to the instance
    via :func:`fixture_fit` (the reference ships one ``_place.obj`` per
    object model)."""
    fit = fixture_fit(class_name, instance_params)
    if class_name == "nut":
        return TriMesh.concatenate([
            box((0.06, 0.06, 0.01), center=(0, 0, 0.005)),
            cylinder(fit, 0.06, 16, center=(0, 0, 0.04)),
        ])
    if class_name == "screw":
        return tube(0.02, fit, 0.02, n=12, n_inner=16).transformed(_translate((0, 0, 0.01)))
    if class_name == "hnm":
        return tube(fit + 0.011, fit, 0.025, n=4, n_inner=12, phase=np.pi / 4).transformed(_translate((0, 0, 0.0125)))
    raise ValueError(class_name)
