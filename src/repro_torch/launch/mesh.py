"""The model mesh: named axes (``pod``, ``data``, ``model``) over an n-d
array of devices, as the JAX package's ``repro/launch/mesh.py`` builds
with ``jax.make_mesh``.

The port is single-controller: one process holds every position of the
mesh and runs each position's local program in a fixed order
(:mod:`repro_torch.nn.collectives`). A device may repeat, giving virtual
shards: the debug meshes here put every position on one device.
:func:`make_production_mesh` is a shape with no devices: it resolves specs
(``nn.sharding.spec_for``) and cannot run a step.
"""
from __future__ import annotations

import itertools
from typing import Dict, Iterator, Sequence, Tuple

import numpy as np
import torch


class ModelMesh:
    """``axis_names`` over ``devices``, an object array of that many
    dimensions (``torch.device``s, or None for a shape-only mesh).
    Positions are tuples of axis indices, in row-major order."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(f"devices of {arr.ndim} dimensions for axes "
                             f"{tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.devices.shape)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    def axis_size(self, name: str) -> int:
        return self.sizes.get(name, 1)

    def positions(self) -> Iterator[Tuple[int, ...]]:
        return itertools.product(*(range(n) for n in self.shape))

    def device(self, pos) -> torch.device:
        dev = self.devices[tuple(pos)]
        if dev is None:
            raise ValueError("a shape-only mesh (make_production_mesh) has "
                             "no devices and cannot run a step")
        return dev

    def index(self, pos, name: str) -> int:
        """The position's index on axis ``name`` (0 without that axis)."""
        return pos[self.axis_names.index(name)] if name in self.axis_names \
            else 0

    @property
    def distinct_devices(self) -> int:
        """How many different devices the positions lie on."""
        return len({str(d) for d in self.devices.flat})

    @property
    def home(self) -> torch.device:
        """The first position's device: where gathered results land."""
        return self.device((0,) * len(self.shape))

    def __repr__(self):
        devs = sorted({str(d) for d in self.devices.flat})
        return f"ModelMesh({dict(self.sizes)}, devices={devs})"


def _devices(shape, device) -> np.ndarray:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    arr = np.empty(shape, dtype=object)
    for pos in itertools.product(*(range(n) for n in shape)):
        arr[pos] = dev
    return arr


def make_debug_mesh(data: int = 2, model: int = 2, pod: int = 0,
                    device="cuda") -> ModelMesh:
    """A (data, model) mesh, or (pod, data, model) with ``pod``, every
    position a virtual shard of ``device``."""
    if pod:
        return ModelMesh(_devices((pod, data, model), device),
                         ("pod", "data", "model"))
    return ModelMesh(_devices((data, model), device), ("data", "model"))


def make_mesh(devices: Sequence, data: int, model: int,
              pod: int = 0) -> ModelMesh:
    """A mesh over distinct ``devices`` (row-major), one a position."""
    shape = (pod, data, model) if pod else (data, model)
    if len(devices) != int(np.prod(shape)):
        raise ValueError(f"{len(devices)} devices for a mesh of {shape}")
    arr = np.empty(shape, dtype=object)
    for pos, d in zip(itertools.product(*(range(n) for n in shape)),
                      devices):
        arr[pos] = torch.device(d)
    names = ("pod", "data", "model") if pod else ("data", "model")
    return ModelMesh(arr, names)


def make_production_mesh(*, multi_pod: bool = False) -> ModelMesh:
    """16 x 16 = 256 positions a pod, 2 pods for the multi-pod shape: a
    shape with no devices, for resolving specs."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return ModelMesh(np.full(shape, None, dtype=object), names)


def data_mesh_of(mesh: ModelMesh, model: int = 0, pod: int = 0):
    """The ``data`` axis of ``mesh`` (at model index ``model`` and pod
    ``pod``) as the multi-device layer's ``kernels.shard.DataMesh``."""
    from repro_torch.kernels.shard import DataMesh
    devs = []
    for d in range(mesh.axis_size("data")):
        idx = {"pod": pod, "data": d, "model": model}
        devs.append(mesh.device(tuple(idx[a] for a in mesh.axis_names)))
    return DataMesh(tuple(devs))

