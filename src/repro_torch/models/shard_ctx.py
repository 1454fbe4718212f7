"""Ambient activation-sharding context for model code (the reference's
`models/shard_ctx.py`).

The launcher gives the mesh's axis sizes (`mesh_context`, which
`launch.mesh.enter_mesh(mesh)` enters) and declares its data- and
model-parallel axes (`activation_sharding`); model code reads their
extents (`dp_size`, `tp_size`) where its arithmetic depends on them: the
MoE dispatch's group factors (`models/moe.py _factor_groups`) and the
train step's microbatch count (`models/model.py train_step`). With no
context set (unit tests, one device) both are 1. Nothing in the port's
own paths enters a context: the dry run (`launch/dryrun.py`) traces no
step, so these readers run under one only where a caller enters it.

`constrain(x, dims)` is the reference's hint to its compiler (GSPMD) of
how an activation is sharded. The port runs no sharding compiler, so
`constrain` returns `x` itself, with a context or without one; the
reference's call sites are not ported (ROADMAP.md, "Not queued").
"""

from __future__ import annotations

import contextlib

# "shape": {axis: size} (mesh_context); "dp", "tp": the axes
# (activation_sharding)
_CTX: dict = {}

__all__ = ["activation_sharding", "constrain", "dp", "dp_size",
           "mesh_context", "tp", "tp_size"]


@contextlib.contextmanager
def _bind(**entries):
    global _CTX
    prev = _CTX
    _CTX = {**prev, **entries}
    try:
        yield
    finally:
        _CTX = prev


def mesh_context(shape: dict[str, int]):
    """Inside the block, the mesh's axis sizes are `shape` (axis name ->
    size), as `jax.set_mesh` makes a mesh ambient for the reference."""
    return _bind(shape=dict(shape))


def activation_sharding(dp_axes: tuple[str, ...], model_axis: str = "model"):
    """Inside the block, `dp_axes` are the data-parallel axes and
    `model_axis` the model-parallel one."""
    return _bind(dp=tuple(dp_axes), tp=model_axis)


def _mesh_shape() -> dict[str, int]:
    """Axis name -> size of the mesh `mesh_context` gave."""
    if "shape" not in _CTX:
        raise RuntimeError("activation_sharding needs a mesh: enter it with "
                           "launch.mesh.enter_mesh(mesh)")
    return _CTX["shape"]


def dp():
    return _CTX.get("dp")


def tp():
    return _CTX.get("tp")


def dp_size() -> int:
    """The product of the data-parallel axes' sizes; 1 with no context."""
    if "dp" not in _CTX:
        return 1
    shape = _mesh_shape()
    n = 1
    for a in _CTX["dp"]:
        n *= shape[a]
    return n


def tp_size() -> int:
    """The model axis's size; 1 with no context."""
    if "tp" not in _CTX:
        return 1
    return _mesh_shape()[_CTX["tp"]]


def constrain(x, dims):
    """`x` itself. dims: over x's axes, 'dp' | 'tp' | 'dpt' (dp + tp
    combined) | None, the reference's sharding hint; the port has no
    compiler to give it to."""
    return x
