"""Shard meshes and device placement (DESIGN.md §7) — the port's counterpart
of ``repro.shard.mesh``.

The reference's 1-D ``jax.sharding.Mesh`` becomes an ordered tuple of
``torch.device``s. Shards are assigned to its devices round-robin, so
with fewer devices than shards several shards share one device with the
same semantics (DESIGN.md §7's single-device case: on one H100 every
shard lives on ``cuda:0``).

Importing this module touches no device; devices are only enumerated when
a mesh is made.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..core.fbtree import FBTree, Level, resolve_target

__all__ = ["make_shard_mesh", "shard_devices", "place_shard"]


def make_shard_mesh(n_shards: int, devices: Optional[Sequence] = None,
                    target: Optional[str] = None) -> Tuple[torch.device, ...]:
    """The first ``min(n_shards, len(devices))`` of ``devices`` (at least
    one) as a tuple of ``torch.device``. ``devices=None`` means every
    local card (one H100: ``(cuda:0,)``), or ``(cpu,)`` with
    ``target="cpu"``; with no card and no ``target`` it raises."""
    if devices is None:
        dev = resolve_target(target)
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if dev.type == "cuda" and dev.index is None else [dev])
    devices = [torch.device(d) for d in devices]
    n = max(1, min(int(n_shards), len(devices)))
    return tuple(devices[:n])


def shard_devices(mesh: Optional[Sequence], n_shards: int) -> Tuple:
    """Round-robin device per shard (``None`` per shard when there is no
    mesh: the shards stay where they were built)."""
    if mesh is None:
        return (None,) * n_shards
    devs = list(mesh)
    return tuple(devs[s % len(devs)] for s in range(n_shards))


def place_shard(tree: FBTree, device) -> FBTree:
    """A copy of ``tree`` with every array on ``device`` (new tensors, so
    writing one never touches the other); ``tree`` itself when
    ``device`` is None."""
    if device is None:
        return tree
    a = tree.arrays
    mv = lambda t: t.to(device, copy=True)
    flat = {f: mv(getattr(a, f)) for f in a._fields
            if f not in ("levels", "stacked")}
    return FBTree(tree.config, a._replace(
        levels=tuple(Level(*map(mv, lv)) for lv in a.levels),
        stacked=Level(*map(mv, a.stacked)), **flat))
