"""Rank meshes: the port of ``repro/launch/mesh.py``.

A :class:`Mesh` is an array of global ranks (one process each, joined by
``torch.distributed``) with named axes, the counterpart of a JAX device
mesh: ("data", "model") for serving, ("pod", "data", "model") for the
multi-pod production shape. Rank ``r`` is the process that owns device
``r`` of the reference's mesh.

Single pod : (16, 16)    -> ("data", "model")      256 ranks
Multi-pod  : (2, 16, 16) -> ("pod", "data", "model") 512 ranks

Importing this module touches no device and no process group; only
:func:`make_smoke_mesh` asks ``distributed/context.py`` for the world
size, and that reads the process group without creating one.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


class Mesh:
    """Global ranks laid out over named axes. ``devices`` is the rank
    array (the name the reference's ``Mesh`` uses), ``shape`` maps each
    axis to its size."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-d rank array needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def ranks(self) -> List[int]:
        return [int(r) for r in self.devices.reshape(-1)]

    def coords(self, rank: int) -> Dict[str, int]:
        """The index of ``rank`` along each axis."""
        where = np.argwhere(self.devices == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in the mesh {self}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def _key(self):
        return (self.axis_names, self.devices.shape,
                tuple(self.devices.reshape(-1).tolist()))

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        dims = "x".join(str(n) for n in self.devices.shape)
        return f"Mesh({dims} {self.axis_names} ranks={self.ranks})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh's shape and axes (a description: no process
    group of 256 or 512 ranks is made)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(np.arange(int(np.prod(shape))).reshape(shape), axes)


def make_smoke_mesh(model: int = 1, world: int = None) -> Mesh:
    """A (world // model, model) mesh over every rank of the process
    group (``world`` ranks when given; one without a group)."""
    if world is None:
        from repro_torch.distributed.context import world_size
        world = world_size()
    if model < 1 or world % model:
        raise ValueError(
            f"model axis size {model} does not divide the {world} available "
            "rank(s); pick a tp degree that divides the world size "
            "(launch more ranks: serve.py --mesh DxM spawns D*M)")
    return Mesh(np.arange(world).reshape(world // model, model),
                ("data", "model"))


def make_submeshes(mesh: Mesh, tp_degree: int) -> List[Mesh]:
    """Carve ``mesh`` into engine-replica submeshes of ``tp_degree``
    ranks each: consecutive rank groups, every submesh shaped ``(1,
    tp_degree)`` over ``("data", "model")``, so a serving replica
    tensor-parallelizes over its own ranks and shares nothing with its
    neighbours."""
    ranks = mesh.devices.reshape(-1)
    if tp_degree < 1 or ranks.size % tp_degree:
        raise ValueError(
            f"tp_degree {tp_degree} does not divide the mesh's "
            f"{ranks.size} device(s)")
    return [Mesh(ranks[i:i + tp_degree].reshape(1, tp_degree),
                 ("data", "model"))
            for i in range(0, ranks.size, tp_degree)]


def parse_mesh(text: str) -> Mesh:
    """``"DxM"`` -> a (D, M) ("data", "model") mesh over ranks 0..D*M-1
    ("" is 1x1)."""
    d, m = (int(x) for x in (text or "1x1").split("x"))
    if d < 1 or m < 1:
        raise ValueError(f"--mesh {text!r}: both sizes must be >= 1")
    return Mesh(np.arange(d * m).reshape(d, m), ("data", "model"))
