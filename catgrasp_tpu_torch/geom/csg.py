"""Analytic CSG signed-distance shapes (``catgrasp_tpu/geom/csg.py`` in
PyTorch).

Every CaTGrasp category object is a small CSG composition of convex
primitives: a fixed number of slots, each a box, z-cylinder or z-hex-prism,
combined by union or subtraction and evaluated left to right.  The
evaluators broadcast: a shape's fields may carry leading dimensions (one
shape per body, or per pixel) that broadcast against the points' leading
dimensions, which is how the engine evaluates every body at once and the
renderer evaluates each pixel's winning body.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# primitive type codes
NONE, BOX, CYLINDER, HEXPRISM = 0, 1, 2, 3
MAX_SLOTS = 4
COS30 = float(np.cos(np.pi / 6))


@dataclass
class CsgShape:
    """Fixed-slot CSG tree (evaluated left to right).

    types (..., S) int32; ops (..., S) int32 (+1 union, -1 subtract);
    params (..., S, 3): box half-extents / (radius, half-height, _);
    offsets (..., S, 3): primitive center in shape frame.
    """

    types: torch.Tensor
    ops: torch.Tensor
    params: torch.Tensor
    offsets: torch.Tensor

    def to(self, device) -> "CsgShape":
        return CsgShape(self.types.to(device), self.ops.to(device),
                        self.params.to(device), self.offsets.to(device))


def _safe_norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1) + 1e-18)


def _max3(q):
    return torch.amax(q, dim=-1)


def _sd_box(p, half):
    q = torch.abs(p) - half
    return _safe_norm(torch.clamp(q, min=0.0)) + torch.clamp(_max3(q), max=0.0)


def _sd_cylinder(p, r, hh):
    dxy = torch.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2 + 1e-18) - r
    dz = torch.abs(p[..., 2]) - hh
    q = torch.stack(torch.broadcast_tensors(dxy, dz), dim=-1)
    return _safe_norm(torch.clamp(q, min=0.0)) + torch.clamp(_max3(q), max=0.0)


def _sd_hexprism(p, apothem, hh):
    """Hexagonal prism, z axis, vertex on +x (circumradius = apothem/cos30);
    Inigo Quilez's exact formulation."""
    kx, ky, kz = -COS30, 0.5, 0.57735
    px = torch.abs(p[..., 0])
    py = torch.abs(p[..., 1])
    pz = torch.abs(p[..., 2])
    dot2 = torch.clamp(kx * px + ky * py, max=0.0)
    px = px - 2.0 * dot2 * kx
    py = py - 2.0 * dot2 * ky
    lim = kz * apothem
    lx = px - torch.minimum(torch.maximum(px, -lim), lim)
    ly = py - apothem
    dx = torch.sqrt(lx * lx + ly * ly + 1e-18) * torch.sign(py - apothem)
    dz = pz - hh
    q = torch.stack(torch.broadcast_tensors(dx, dz), dim=-1)
    return _safe_norm(torch.clamp(q, min=0.0)) + torch.clamp(_max3(q), max=0.0)


def csg_sdf(shape: CsgShape, pts: torch.Tensor) -> torch.Tensor:
    """Signed distance of points (..., 3) to a CsgShape — branch-free."""
    d = None
    for s in range(shape.types.shape[-1]):
        p = pts - shape.offsets[..., s, :]
        t = shape.types[..., s]
        par = shape.params[..., s, :]
        db = _sd_box(p, par)
        dc = _sd_cylinder(p, par[..., 0], par[..., 1])
        dh = _sd_hexprism(p, par[..., 0], par[..., 1])
        ds = torch.where(t == BOX, db, torch.where(t == CYLINDER, dc, dh))
        if d is None:
            d = torch.full_like(ds, 1e9)
        d_new = torch.where(shape.ops[..., s] > 0, torch.minimum(d, ds),
                            torch.maximum(d, -ds))
        d = torch.where(t == NONE, d, d_new)
    return d


def _sign(x):
    return torch.sign(x)


def _box_sdf_normal(p, half):
    q = torch.abs(p) - half
    out = torch.clamp(q, min=0.0)
    d_out = _safe_norm(out)
    d_in = torch.clamp(_max3(q), max=0.0)
    n_out = _sign(p) * out / d_out[..., None]
    # interior face pick: one-hot of the max component, ties broken evenly
    qmax = torch.amax(q, dim=-1, keepdim=True)
    oh = (q >= qmax).to(p.dtype)
    oh = oh / torch.sum(oh, dim=-1, keepdim=True)
    n_in = oh * _sign(p)
    # selector is the true inside test: _safe_norm never returns 0
    outside = torch.any(q > 0.0, dim=-1)
    n = torch.where(outside[..., None], n_out, n_in)
    return d_out + d_in, n


def _cyl_sdf_normal(p, r, hh):
    rxy = torch.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2 + 1e-18)
    zero = torch.zeros_like(rxy)
    e_r = torch.stack([p[..., 0] / rxy, p[..., 1] / rxy, zero], dim=-1)
    e_z = torch.stack([zero, zero, _sign(p[..., 2])], dim=-1)
    dxy = rxy - r
    dz = torch.abs(p[..., 2]) - hh
    ox = torch.clamp(dxy, min=0.0)
    oz = torch.clamp(dz, min=0.0)
    d_out = torch.sqrt(ox * ox + oz * oz + 1e-18)
    d_in = torch.clamp(torch.maximum(dxy, dz), max=0.0)
    n_out = (ox[..., None] * e_r + oz[..., None] * e_z) / d_out[..., None]
    n_in = torch.where((dxy > dz)[..., None], e_r, e_z)
    out = (torch.clamp(dxy, min=0.0) + torch.clamp(dz, min=0.0)) > 0.0
    n = torch.where(out[..., None], n_out, n_in)
    return torch.where(out, d_out, 0.0) + d_in, n


def _hex_sdf_normal(p, apothem, hh):
    """Analytic gradient of the IQ hex-prism SDF: reflections are tracked by
    their Jacobians (sign flips + one Householder fold)."""
    kx, ky, kz = -COS30, 0.5, 0.57735
    s1 = _sign(p[..., 0])
    s2 = _sign(p[..., 1])
    sz = _sign(p[..., 2])
    px = torch.abs(p[..., 0])
    py = torch.abs(p[..., 1])
    pz = torch.abs(p[..., 2])
    dot = kx * px + ky * py
    folded = dot < 0.0
    px2 = px - 2.0 * torch.clamp(dot, max=0.0) * kx
    py2 = py - 2.0 * torch.clamp(dot, max=0.0) * ky
    lim = kz * apothem
    clipped = torch.minimum(torch.maximum(px2, -lim), lim)
    lx = px2 - clipped
    ly = py2 - apothem
    llen = torch.sqrt(lx * lx + ly * ly + 1e-18)
    side_sign = _sign(py2 - apothem)
    dx = llen * side_sign
    dz = pz - hh
    # 2D gradient of dx in the folded frame (clip zeroes the x contribution)
    active = (px2 != clipped).to(p.dtype)
    gx = side_sign * lx / llen * active
    gy = side_sign * ly / llen
    # unfold the Householder reflection: J^T g (J = I - 2 k k^T when folded)
    kg = kx * gx + ky * gy
    gx = torch.where(folded, gx - 2.0 * kx * kg, gx)
    gy = torch.where(folded, gy - 2.0 * ky * kg, gy)
    ox = torch.clamp(dx, min=0.0)
    oz = torch.clamp(dz, min=0.0)
    d_out = torch.sqrt(ox * ox + oz * oz + 1e-18)
    outside = (ox + oz) > 0.0
    d_in = torch.clamp(torch.maximum(dx, dz), max=0.0)
    zero = torch.zeros_like(gx)
    g2d = torch.stack([s1 * gx, s2 * gy, zero], dim=-1)
    e_z = torch.stack([zero, zero, sz.expand_as(gx)], dim=-1)
    n_out = (ox[..., None] * g2d + oz[..., None] * e_z) / d_out[..., None]
    n_in = torch.where((dx > dz)[..., None], g2d, e_z)
    n = torch.where(outside[..., None], n_out, n_in)
    n = n / (_safe_norm(n)[..., None])
    return torch.where(outside, d_out, 0.0) + d_in, n


def csg_sdf_and_normal(shape: CsgShape, pts: torch.Tensor):
    """(φ, outward normal), fully analytic: each slot contributes its
    primitive's closed-form gradient, selected where that slot wins."""
    d = n = None
    for s in range(shape.types.shape[-1]):
        p = pts - shape.offsets[..., s, :]
        t = shape.types[..., s]
        par = shape.params[..., s, :]
        db, nb = _box_sdf_normal(p, par)
        dc, nc = _cyl_sdf_normal(p, par[..., 0], par[..., 1])
        dh, nh = _hex_sdf_normal(p, par[..., 0], par[..., 1])
        is_box, is_cyl = t == BOX, t == CYLINDER
        ds = torch.where(is_box, db, torch.where(is_cyl, dc, dh))
        ns = torch.where(is_box[..., None], nb,
                         torch.where(is_cyl[..., None], nc, nh))
        if d is None:
            d = torch.full_like(ds, 1e9)
            n = torch.zeros_like(ns)
        is_union = shape.ops[..., s] > 0
        take_u = is_union & (ds < d)
        take_s = ~is_union & (-ds > d)
        d_new = torch.where(is_union, torch.minimum(d, ds), torch.maximum(d, -ds))
        n_new = torch.where(take_u[..., None], ns,
                            torch.where(take_s[..., None], -ns, n))
        is_none = t == NONE
        d = torch.where(is_none, d, d_new)
        n = torch.where(is_none[..., None], n, n_new)
    n = n / (_safe_norm(n)[..., None])
    return d, n


# ---------------------------------------------------------------------------
# Builders matching geom.primitives' procedural meshes (host tensors;
# ShapeLib moves them to its device)
# ---------------------------------------------------------------------------


def _pad(types, ops, params, offsets) -> CsgShape:
    S = MAX_SLOTS

    def pad(a, fill, dtype):
        a = np.asarray(a, dtype)
        out = np.full((S,) + a.shape[1:], fill, dtype=dtype)
        out[: len(a)] = a
        return torch.from_numpy(out)

    return CsgShape(
        types=pad(types, NONE, np.int32),
        ops=pad(ops, 1, np.int32),
        params=pad(params, 0.0, np.float32),
        offsets=pad(offsets, 0.0, np.float32),
    )


def csg_hex_nut(outer_r=0.012, inner_r=0.006, height=0.008) -> CsgShape:
    return _pad(
        [HEXPRISM, CYLINDER],
        [1, -1],
        [[outer_r * COS30, height / 2, 0], [inner_r, height, 0]],
        [[0, 0, 0], [0, 0, 0]],
    )


def csg_screw(shaft_r=0.004, shaft_len=0.03, head_r=0.007, head_h=0.005) -> CsgShape:
    return _pad(
        [CYLINDER, HEXPRISM],
        [1, 1],
        [[shaft_r, shaft_len / 2, 0], [head_r * COS30, head_h / 2, 0]],
        [[0, 0, -shaft_len / 2], [0, 0, head_h / 2]],
    )


def csg_hnm(body=(0.016, 0.010, 0.030), pin_r=0.0025, pin_len=0.012, n_pin=2) -> CsgShape:
    types = [BOX]
    ops = [1]
    params = [[body[0] / 2, body[1] / 2, body[2] / 2]]
    offsets = [[0, 0, 0]]
    xs = np.linspace(-body[0] / 4, body[0] / 4, n_pin)
    for x in xs[: MAX_SLOTS - 1]:
        types.append(CYLINDER)
        ops.append(1)
        params.append([pin_r, pin_len / 2, 0])
        offsets.append([x, 0, body[2] / 2 + pin_len / 2 - 1e-4])
    return _pad(types, ops, params, offsets)


def csg_box(extents, center=(0, 0, 0)) -> CsgShape:
    e = np.asarray(extents) / 2
    return _pad([BOX], [1], [list(e)], [list(center)])


def csg_cylinder(radius, height, center=(0, 0, 0)) -> CsgShape:
    return _pad([CYLINDER], [1], [[radius, height / 2, 0]], [list(center)])


def csg_place_fixture(class_name: str, instance_params: dict | None = None) -> CsgShape:
    """Analytic placement fixtures matching ``primitives.place_fixture``:
    nut -> base plate + peg; screw -> block with a vertical hole; hnm ->
    square socket, radially matched via ``primitives.fixture_fit``."""
    from . import primitives as _prim
    fit = _prim.fixture_fit(class_name, instance_params)
    if class_name == "nut":
        return _pad(
            [BOX, CYLINDER],
            [1, 1],
            [[0.03, 0.03, 0.005], [fit, 0.03, 0]],
            [[0, 0, 0.005], [0, 0, 0.04]],
        )
    if class_name == "screw":
        return _pad(
            [CYLINDER, CYLINDER],
            [1, -1],
            [[0.02, 0.01, 0], [fit, 0.02, 0]],
            [[0, 0, 0.01], [0, 0, 0.01]],
        )
    if class_name == "hnm":
        hw = (fit + 0.011) * float(np.cos(np.pi / 4))
        return _pad(
            [BOX, CYLINDER],
            [1, -1],
            [[hw, hw, 0.0125], [fit, 0.03, 0]],
            [[0, 0, 0.0125], [0, 0, 0.0125]],
        )
    raise ValueError(class_name)


_CSG_BUILDERS = {"nut": csg_hex_nut, "screw": csg_screw, "hnm": csg_hnm}


def make_csg_instance(class_name: str, split: str = "train", index: int = 0) -> CsgShape:
    """CSG shape matching ``primitives.make_instance`` parameters."""
    from .primitives import _SPLITS

    params = _SPLITS[(class_name, split)]
    kw = dict(params[index % len(params)])
    if class_name == "hnm" and "body" in kw:
        return csg_hnm(**kw)
    return _CSG_BUILDERS[class_name](**kw)


def stack_shapes(shapes: list[CsgShape]) -> CsgShape:
    """Stack K shapes into one batched CsgShape (leading K axis)."""
    return CsgShape(
        types=torch.stack([s.types for s in shapes]),
        ops=torch.stack([s.ops for s in shapes]),
        params=torch.stack([s.params for s in shapes]),
        offsets=torch.stack([s.offsets for s in shapes]),
    )


def select_shape(stacked: CsgShape, idx) -> CsgShape:
    """Gather shapes by index; ``idx`` may be a scalar or an index tensor of
    any shape (the result then carries its leading dimensions)."""
    return CsgShape(
        types=stacked.types[idx],
        ops=stacked.ops[idx],
        params=stacked.params[idx],
        offsets=stacked.offsets[idx],
    )
