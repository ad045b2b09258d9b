"""Meshes — the port's counterpart of ``repro.launch.mesh``.

Spec functions (``parallel.sharding``, ``train.optim.zero_spec``) take a
mesh's axis names and sizes only: an :class:`AbstractMesh` (the
production meshes, ``jax.sharding.AbstractMesh``'s counterpart), a
:class:`LocalMesh` (one device, every axis of size 1), a :class:`Mesh`
(axes with a device for every position, as the pipeline mesh places its
stages) or a ``torch.distributed`` ``DeviceMesh`` (one rank a position;
:func:`device_mesh`). :func:`mesh_axes` reads any of them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from ..core.fbtree import resolve_target

__all__ = ["AbstractMesh", "LocalMesh", "Mesh", "mesh_axes",
           "make_production_mesh", "make_mesh", "make_local_mesh",
           "make_pipeline_mesh", "device_mesh"]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, no devices."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.axis_sizes)} sizes")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in the mesh's order (``Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


@dataclasses.dataclass(frozen=True)
class Mesh(AbstractMesh):
    """An :class:`AbstractMesh` with a device at every position, row-major
    over the axes."""
    devices: Tuple[torch.device, ...] = ()

    def __post_init__(self):
        super().__post_init__()
        if len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.size} positions")


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """One device with the reference mesh's axis names, each of size 1."""
    device: torch.device
    axis_names: Tuple[str, ...]

    @property
    def axis_sizes(self) -> Tuple[int, ...]:
        return (1,) * len(self.axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict.fromkeys(self.axis_names, 1)


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size of any mesh of this module or of a
    ``DeviceMesh`` (whose ``shape`` is a tuple)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.axis_sizes))


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model"): abstract, as no host of the port holds 256 cards."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(axes, shape)


def make_mesh(shape, axes) -> AbstractMesh:
    return AbstractMesh(tuple(axes), tuple(int(s) for s in shape))


def make_local_mesh(axes=("data", "model"), device: Optional[str] = None
                    ) -> LocalMesh:
    """1-device mesh with production axis names: the card, unless
    ``device`` names another (``"cpu"`` for the CPU)."""
    return LocalMesh(resolve_target(device), tuple(axes))


def make_pipeline_mesh(n_stages: int = 4, device: Optional[str] = None
                       ) -> Mesh:
    """One ``"stage"`` axis of ``n_stages``, every stage on ``device``:
    the card unless ``device`` names another (``"cpu"``)."""
    dev = resolve_target(device)
    return Mesh(("stage",), (n_stages,), (dev,) * n_stages)


def device_mesh(mesh, device_type: Optional[str] = None):
    """The ``torch.distributed`` ``DeviceMesh`` with ``mesh``'s axis names
    and sizes, rank r at row-major position r. Needs a default process
    group of exactly that many ranks (``init_process_group``); raises
    otherwise. ``device_type`` defaults to ``"cuda"`` under NCCL, else
    ``"cpu"``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    axes = mesh_axes(mesh)
    n = math.prod(axes.values())
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"device_mesh: no process group; a mesh of {n} positions needs "
            f"init_process_group with world_size={n}")
    if dist.get_world_size() != n:
        raise RuntimeError(
            f"device_mesh: the process group has {dist.get_world_size()} "
            f"ranks, the mesh {dict(axes)} needs {n}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(n).reshape(tuple(axes.values()))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes))
