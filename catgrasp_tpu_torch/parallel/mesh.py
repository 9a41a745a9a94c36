"""Device mesh and batch sharding (``catgrasp_tpu/parallel/mesh.py`` in
PyTorch).

A mesh is a grid of devices with named axes, as JAX's: ``dp`` (data
parallel: training batches and scene batches split their leading axis over
it, with ``slice`` before it on a multi-slice mesh) and ``mp`` (model
parallel, which nothing in the package shards over).  One process drives
every device of the mesh: a sharded call takes the global batch and
returns the global batch.

JAX's ``NamedSharding`` has no counterpart here: ``dp_sharding`` gives the
devices of the batch shards, one per shard in ``("slice", "dp")`` order,
``shard_batch`` splits a batch into its shards on those devices and
``gather`` joins them again.  A mesh may name one device many times (tests
use ``[torch.device("cpu")] * 8``; on one GPU, ``[cuda:0] * 4``): the
shards then run one after another on it, the counterpart of JAX's
``xla_force_host_platform_device_count``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

BATCH_AXES = ("slice", "dp")


@dataclass
class Mesh:
    devices: np.ndarray  # object array of torch.device, one axis per name
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


def _device_grid(devices, shape) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return arr.reshape(shape)


def _cuda_devices() -> list:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("make_mesh: no CUDA device; pass devices=[...] for a mesh of "
                           "other devices (the tests pass [torch.device('cpu')] * 8)")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_devices: int | None = None, mp: int = 1, devices=None) -> Mesh:
    """A ``("dp", "mp")`` mesh over ``devices`` (default every CUDA
    device), truncated to the first ``n_devices``."""
    devices = list(devices) if devices is not None else _cuda_devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    assert n % mp == 0, f"{n} devices not divisible by mp={mp}"
    return Mesh(_device_grid(devices, (n // mp, mp)), ("dp", "mp"))


def make_multislice_mesh(n_slices: int, mp: int = 1, devices=None) -> Mesh:
    """A ``("slice", "dp", "mp")`` mesh: batch work splits over slice and
    dp jointly, as on JAX's multi-slice mesh."""
    devices = list(devices) if devices is not None else _cuda_devices()
    n = len(devices)
    assert n % (n_slices * mp) == 0, f"{n} devices !~ {n_slices} slices x mp={mp}"
    return Mesh(_device_grid(devices, (n_slices, n // (n_slices * mp), mp)),
                ("slice", "dp", "mp"))


def dp_sharding(mesh: Mesh) -> list:
    """The devices of the batch shards, one per shard in ``("slice",
    "dp")`` order.  A shard is replicated over ``mp`` and runs on the first
    device of its ``mp`` group (JAX computes it on each, to the same
    result)."""
    idx = tuple(slice(None) if a in BATCH_AXES else 0 for a in mesh.axis_names)
    return list(mesh.devices[idx].reshape(-1))


def replicated(mesh: Mesh) -> list:
    """Every device of the mesh."""
    return list(mesh.devices.reshape(-1))


def tree_map(fn, tree, *rest):
    """``fn`` over the tensor and array leaves of a dict, tuple, list or
    dataclass (``SceneState``, ``SceneParams``, ``ShapeLib``, ...), with
    ``rest`` trees of the same structure beside it; other leaves (None,
    numbers) are kept from ``tree``."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return tree


def to_device(tree, device):
    """A tree on ``device``; host arrays and CPU tensors bound for a GPU go
    through pinned memory without making the host wait."""
    dev = torch.device(device)

    def move(x):
        t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
        if dev.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(dev, non_blocking=True)
        return t.to(dev)

    return tree_map(move, tree)


def split(tree, n: int) -> list:
    """``n`` equal chunks of the leading axis of every leaf; raises when
    ``n`` does not divide it (JAX's ``device_put`` refuses such a batch)."""
    sizes = set()
    tree_map(lambda x: sizes.add(x.shape[0]), tree)
    for size in sizes:
        if size % n:
            raise ValueError(f"a leading axis of {size} does not split into {n} equal shards")
    return [tree_map(lambda x, i=i: x[i * (x.shape[0] // n):(i + 1) * (x.shape[0] // n)],
                     tree) for i in range(n)]


def shard_batch(mesh: Mesh, batch) -> list:
    """A batch (a dict of tensors or arrays, a ``SceneState``, a
    ``SceneParams``) as its shards, each on its device of
    ``dp_sharding(mesh)``."""
    devs = dp_sharding(mesh)
    return [to_device(chunk, d) for chunk, d in zip(split(batch, len(devs)), devs)]


def gather(mesh: Mesh, shards: list):
    """The shards joined back in order, on the first batch device."""
    dev = dp_sharding(mesh)[0]
    return tree_map(lambda *xs: torch.cat([x.to(dev) for x in xs]), *shards)
