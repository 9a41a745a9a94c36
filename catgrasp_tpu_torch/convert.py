"""Build the port's types from dicts of numpy arrays, one field per key.

The JAX package's state lives in pytrees (``ShapeLib``, ``SceneState``,
``SceneParams``, ``StaticEnv``).  Flattening one with ``np.asarray`` per
field and handing the dict over gives the port the same scene, so both
sides can compute on identical inputs.  ``ShapeLib``'s nested CSG tree
takes the keys ``csg.types``, ``csg.ops``, ``csg.params`` and
``csg.offsets``; its baked grids, where the dict has them, the keys
``sdf_values``, ``sdf_lower`` and ``sdf_spacing``.

The nets' weights cross over the same way: ``flax_state_dict`` turns a
flax parameter tree (numpy arrays, as ``predict.ckpt.read_params`` reads
it from a checkpoint) into the ``state_dict`` of the port's module, whose
submodules carry the flax names
(``PointNetEncoder_0.STN_1.MLPStack_0.Dense_2``); ``flax_params`` is its
inverse, a module's tensors (or any tensors of its parameters' shapes, as
the optimizer's moments) as a flax parameter tree of numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .geom.csg import CsgShape
from .sim.engine import StaticEnv
from .sim.types import SceneParams, SceneState, ShapeLib


def _t(d: dict, key: str, dev, dtype=None) -> torch.Tensor:
    a = np.asarray(d[key])
    if dtype is None:
        dtype = {np.dtype(bool): torch.bool}.get(a.dtype)
        if dtype is None:
            dtype = torch.int64 if a.dtype.kind in "iu" else torch.float32
    return torch.tensor(a, dtype=dtype, device=dev)


def shape_lib_from_numpy(d: dict, device=None) -> ShapeLib:
    dev = resolve_device(device)
    return ShapeLib(
        csg=CsgShape(types=_t(d, "csg.types", dev, torch.int32),
                     ops=_t(d, "csg.ops", dev, torch.int32),
                     params=_t(d, "csg.params", dev),
                     offsets=_t(d, "csg.offsets", dev)),
        surf_pts=_t(d, "surf_pts", dev),
        surf_normals=_t(d, "surf_normals", dev),
        volume=_t(d, "volume", dev),
        inertia_unit=_t(d, "inertia_unit", dev),
        radius=_t(d, "radius", dev),
        bounds=_t(d, "bounds", dev),
        **{k: _t(d, k, dev) for k in ("sdf_values", "sdf_lower", "sdf_spacing") if k in d},
    )


def scene_state_from_numpy(d: dict, device=None) -> SceneState:
    dev = resolve_device(device)
    return SceneState(pos=_t(d, "pos", dev), quat=_t(d, "quat", dev),
                      linvel=_t(d, "linvel", dev), angvel=_t(d, "angvel", dev),
                      active=_t(d, "active", dev, torch.bool))


def scene_params_from_numpy(d: dict, device=None) -> SceneParams:
    dev = resolve_device(device)
    return SceneParams(shape_id=_t(d, "shape_id", dev, torch.int64),
                       scale=_t(d, "scale", dev), mass=_t(d, "mass", dev),
                       inertia=_t(d, "inertia", dev), friction=_t(d, "friction", dev))


def static_env_from_numpy(d: dict, device=None) -> StaticEnv:
    dev = resolve_device(device)
    return StaticEnv(center=_t(d, "center", dev), half=_t(d, "half", dev),
                     quat=_t(d, "quat", dev), vel=_t(d, "vel", dev),
                     friction=_t(d, "friction", dev),
                     enabled=_t(d, "enabled", dev, torch.bool),
                     imp_budget=_t(d, "imp_budget", dev),
                     grip=_t(d, "grip", dev, torch.bool))


def flax_state_dict(params: dict, prefix: str = "") -> dict:
    """The port module's state from a flax parameter tree, the layout of
    each kernel picked by its rank and module name: Dense (in, out) ->
    Linear (out, in); Conv DHWIO -> OIDHW; ConvTranspose DHWIO -> (I, O,
    D, H, W) with the spatial axes flipped (flax's transposed conv,
    ``transpose_kernel=False``, applies the kernel unflipped, torch's
    ``conv_transpose3d`` flipped); GroupNorm ``scale`` -> ``weight``."""
    out = {}
    for name, v in params.items():
        if isinstance(v, dict):
            out.update(flax_state_dict(v, f"{prefix}{name}."))
            continue
        a = np.asarray(v)
        module = prefix[:-1].rsplit(".", 1)[-1]
        if name == "kernel":
            name = "weight"
            if a.ndim == 2:
                a = a.T
            elif a.ndim == 5 and module.startswith("ConvTranspose"):
                a = np.flip(a, (0, 1, 2)).transpose(3, 4, 0, 1, 2)
            elif a.ndim == 5 and module.startswith("Conv"):
                a = a.transpose(4, 3, 0, 1, 2)
            else:
                raise ValueError(f"unexpected kernel {prefix}{name} of shape {a.shape}")
        elif name == "scale":
            name = "weight"
        out[prefix + name] = torch.tensor(np.ascontiguousarray(a))
    return out


def flax_params(state_dict: dict) -> dict:
    """The flax parameter tree of a port module's tensors (``flax_state_dict``
    inverted): nested dicts keyed by the module names, numpy arrays in
    flax's layouts (Dense (in, out), Conv and ConvTranspose DHWIO, GroupNorm
    ``scale``)."""
    tree = {}
    for key, v in state_dict.items():
        *path, name = key.split(".")
        a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        module = path[-1] if path else ""
        if name == "weight" and module.startswith("GroupNorm"):
            name = "scale"
        elif name == "weight":
            name = "kernel"
            if a.ndim == 2:
                a = a.T
            elif a.ndim == 5 and module.startswith("ConvTranspose"):
                a = np.flip(a.transpose(2, 3, 4, 0, 1), (0, 1, 2))
            elif a.ndim == 5 and module.startswith("Conv"):
                a = a.transpose(2, 3, 4, 1, 0)
            else:
                raise ValueError(f"unexpected weight {key} of shape {a.shape}")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(a)
    return tree
