"""Device meshes for the port: a named grid of device slots.

The reference builds a `jax.sharding.Mesh` over real devices; the port's
`Mesh` is a numpy grid of `torch.device` slots with named axes, driven
from one process (the `distributed` backend runs every slot's work from
one controller, a thread and a CUDA stream a slot). A slot may repeat a
device: the port's counterpart of XLA's
`--xla_force_host_platform_device_count`, so a test on the CPU, or one
card, can run a mesh of several slots.

The `model` axis carries graph parallelism (partitions shard over it, the
paper's §6.3) and the LM's TP / EP; `data` / `pod` carry query
parallelism and the LM's DP / FSDP. Functions, not module constants:
importing this module touches no device.

The reference's production meshes:
  Single pod : (16, 16)    = 256 chips, axes (data, model)
  Multi-pod  : (2, 16, 16) = 512 chips, axes (pod, data, model)
`make_production_mesh` gives them as slots on "meta" (the dry runs price
them without a device), and `enter_mesh` gives a mesh's axis sizes to
`models.shard_ctx`, as `jax.set_mesh` does for the reference.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import shard_ctx

__all__ = ["Mesh", "dp_axes", "enter_mesh", "make_mesh",
           "make_production_mesh", "mesh_shape"]


class Mesh:
    """`devices`: an object array of `torch.device`, one per slot, of the
    mesh's shape; `axis_names`: one name per axis; `shape`: {axis: size}."""

    def __init__(self, devices: np.ndarray, axis_names):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"{devices.ndim}-d device grid for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"{[str(d) for d in self.devices.flat]})")


def make_mesh(shape, axes, devices=None) -> Mesh:
    """A mesh of `shape` over `axes`.

    devices: None -> every visible CUDA device, one a slot (their count
    must equal the mesh's size, as `jax.make_mesh` demands; raises without
    CUDA); one device (e.g. "cpu" or "cuda:0") -> that device in every
    slot; a sequence -> one device a slot, in row-major slot order."""
    shape = tuple(int(s) for s in shape)
    size = int(np.prod(shape, dtype=np.int64))
    if devices is None:
        resolve_device(None)                  # raises without CUDA
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    elif isinstance(devices, (str, torch.device)):
        devs = [torch.device(devices)] * size
    else:
        devs = [torch.device(d) for d in devices]
    if len(devs) != size:
        raise ValueError(f"a mesh of shape {shape} has {size} slots; got "
                         f"{len(devs)} devices")
    grid = np.empty(size, dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(16, 16) over ("data", "model"), or with `multi_pod` (2, 16, 16)
    over ("pod", "data", "model"), every slot on "meta"."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices="meta")


@contextlib.contextmanager
def enter_mesh(mesh: Mesh):
    """Inside the block, `models.shard_ctx` reads `mesh`'s axis sizes
    (`shard_ctx.mesh_context`); the sizes before are restored on leaving
    it."""
    with shard_ctx.mesh_context(mesh.shape):
        yield mesh


def dp_axes(mesh) -> tuple[str, ...]:
    """Axes usable for batch/data parallelism."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def mesh_shape(mesh) -> dict[str, int]:
    """The reference's name for `Mesh.shape`."""
    return mesh.shape
