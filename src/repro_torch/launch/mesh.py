"""Device meshes: named axes over an explicit array of ``torch.device``s.
Counterpart of ``repro.launch.mesh``.

The port is single-controller (``core.distributed``): one host process
drives every device of a mesh, and a mesh is only the layout that the
sharding rules (``launch.shardings``) and the split-K decode
(``serve.sp_attention``) read. :func:`make_local_mesh` repeats one device,
so shards of a tensor are ``narrow`` views of it; :func:`make_production_mesh`
lays out the JAX package's 16 × 16 (or 2 × 16 × 16) mesh, on ``meta`` for
the dry-runs or over as many distinct devices as it needs, which it refuses
to build without (as ``jax.make_mesh`` does).

Functions, not module-level meshes: importing this module touches no
device.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from repro_torch.core.distributed import ShardPlan
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: a numpy object array of ``torch.device``s whose shape is
    the axis sizes, in the order of ``axis_names``."""
    devices: np.ndarray
    axis_names: tuple

    def __post_init__(self):
        assert self.devices.ndim == len(self.axis_names), \
            (self.devices.shape, self.axis_names)

    @property
    def shape(self) -> collections.OrderedDict:
        """Axis name → size, in axis order (as ``jax.sharding.Mesh``)."""
        return collections.OrderedDict(zip(self.axis_names,
                                           self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def distinct_devices(self) -> tuple:
        """The mesh's devices, each once, in mesh order."""
        return tuple(dict.fromkeys(self.devices.flat))


def _mesh(shape: tuple, axes: tuple, devices: list) -> Mesh:
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(devices=arr.reshape(shape), axis_names=tuple(axes))


def make_local_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """A (data, model) mesh whose every position is one device (``None``:
    the card), as ``core.distributed.local_plan``: shards are views of one
    tensor on it."""
    dev = resolve_device(device)
    return _mesh((data, model), ("data", "model"), [dev] * (data * model))


def _devices_of(device) -> list:
    """The distinct devices of ``device``'s type: every CUDA device for the
    card (``None``), the one CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The production mesh: (16, 16) over (data, model), or (2, 16, 16)
    over (pod, data, model). ``device="meta"`` builds it on ``meta`` (the
    dry-runs: shapes only). On real devices it needs as many distinct
    devices of that type as the mesh has positions and raises otherwise,
    naming both counts, as ``jax.make_mesh`` does."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = int(np.prod(shape))
    if device is not None and torch.device(device).type == "meta":
        return _mesh(shape, axes, [torch.device("meta")] * need)
    devs = _devices_of(device)
    if len(devs) < need:
        raise ValueError(f"Number of devices {len(devs)} must be >= the "
                         f"product of mesh_shape {shape}")
    return _mesh(shape, axes, devs[:need])


def dp_axes(mesh: Mesh) -> tuple:
    """The data-parallel axes of a mesh ('pod' folds into DP)."""
    return tuple(n for n in mesh.axis_names if n in ("pod", "data"))


def dp_size(mesh: Mesh) -> int:
    s = 1
    for n in dp_axes(mesh):
        s *= mesh.shape[n]
    return s


def shard_plan(mesh: Mesh, shard_axes: tuple | None = None) -> ShardPlan:
    """The record-store plan over ``shard_axes`` (all axes by default), as
    ``repro``'s ``ShardPlan(mesh, shard_axes)``: one shard per position of
    those axes, in mesh order, each on the device at that position (the
    first index of every other axis)."""
    axes = tuple(mesh.axis_names) if shard_axes is None else tuple(shard_axes)
    idx = tuple(slice(None) if n in axes else 0 for n in mesh.axis_names)
    return ShardPlan(devices=tuple(mesh.devices[idx].reshape(-1)))
