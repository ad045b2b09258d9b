"""The local mesh — the port's counterpart of
``repro.launch.mesh.make_local_mesh``: one device under the production
axis names. The production and pipeline meshes wait for the multi-card
slice and the launch-tools decision (ROADMAP)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..core.fbtree import resolve_target

__all__ = ["LocalMesh", "make_local_mesh"]


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """One device with the reference mesh's axis names, each of size 1."""
    device: torch.device
    axis_names: Tuple[str, ...]


def make_local_mesh(axes=("data", "model"), device: Optional[str] = None
                    ) -> LocalMesh:
    """1-device mesh with production axis names: the card, unless
    ``device`` names another (``"cpu"`` for the CPU)."""
    return LocalMesh(resolve_target(device), tuple(axes))
