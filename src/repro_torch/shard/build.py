"""Sharded bulk build (DESIGN.md §7) — the port's counterpart of
``repro.shard.build``: the §5 pipeline with step 1, the global sort, going
distributed, steps 2–3 unchanged per shard.

``fbtree.sharded_partition`` sorts the key set once and splits it into
balanced contiguous runs; each run feeds an ordinary per-shard
``bulk_build`` (host or device build: the §5 parity holds shard by shard),
and the runs' minimum keys become the router. Every shard shares one
``TreeConfig`` planned for ``per_shard_max_keys`` (default: the full
``max_keys``, so any one shard can absorb the whole key set before a
``rebalance`` — skew-safe, at S× pool memory).
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..core import keys as K
from ..core.fbtree import (TreeConfig, build_sorted, bulk_build,
                           resolve_target, sharded_partition)
from .mesh import make_shard_mesh, shard_devices
from .router import make_router
from .tree import ShardedTree

__all__ = ["sharded_build"]


def sharded_build(ks: K.KeySet, vals, n_shards: int,
                  max_keys: Optional[int] = None,
                  per_shard_max_keys: Optional[int] = None,
                  device: bool = False, mesh: Any = "auto",
                  cfg: Optional[TreeConfig] = None, presorted: bool = False,
                  target: Optional[str] = None, **plan_kw) -> ShardedTree:
    """Bulk-load a :class:`ShardedTree` from (possibly unsorted) unique keys.

    Arguments mirror ``bulk_build`` + ``TreeConfig.plan``:

    * ``n_shards``            number of range partitions (``ks.n >=
      n_shards``).
    * ``max_keys``            global capacity plan (default ``ks.n``).
    * ``per_shard_max_keys``  per-shard capacity (default ``max_keys``).
    * ``device``              per-shard device build (§5) instead of the
      host build; both are bit-identical per shard.
    * ``mesh``                ``"auto"`` makes a mesh over the local devices
      (:func:`make_shard_mesh` with ``target``); ``None`` builds every
      shard on ``target``; or an explicit sequence of devices. Shards go
      to its devices round-robin; the router lives on the first.
    * ``cfg``                 explicit shared per-shard ``TreeConfig``
      (overrides the plan).
    * ``presorted``           the keys are already in the global sort order
      — skip step 1's sort.
    * ``target``              where to build: the card unless ``"cpu"`` is
      asked for.
    * ``plan_kw``             forwarded to ``TreeConfig.plan``.
    """
    if n_shards < 1:
        raise ValueError(
            f"sharded_build: n_shards must be >= 1, got {n_shards}")
    if ks.n < n_shards:
        raise ValueError(
            f"sharded_build: need at least one key per shard to define "
            f"the range partition (n={ks.n} < n_shards={n_shards}) — "
            f"lower n_shards or seed per-shard sentinel keys the way "
            f"serving.PrefixCache does")
    nv = np.asarray(vals).shape[0]
    if nv != ks.n:
        raise ValueError(
            f"sharded_build: {nv} values for {ks.n} keys — one value per "
            f"key")
    if cfg is not None and cfg.key_width != ks.width:
        raise ValueError(
            f"sharded_build: TreeConfig.key_width={cfg.key_width} but the "
            f"key set is packed to width {ks.width} — plan the config "
            f"with key_width={ks.width} (routing and descent compare "
            f"fixed-width padded rows)")
    if cfg is None:
        if max_keys is None:
            max_keys = ks.n
        if per_shard_max_keys is None:
            per_shard_max_keys = max_keys
        cfg = TreeConfig.plan(max_keys=int(per_shard_max_keys),
                              key_width=ks.width, **plan_kw)
    parts, split_keys = sharded_partition(ks, vals, n_shards,
                                          presorted=presorted)
    mesh, devices, home = _placement(mesh, n_shards, target)
    shards = tuple(bulk_build(cfg, pks, np.asarray(pvals), device=device,
                              target=dev or home)
                   for (pks, pvals), dev in zip(parts, devices))
    return ShardedTree(shards=shards, router=make_router(split_keys, home),
                       devices=devices, mesh=mesh)


def _placement(mesh, n_shards: int, target):
    """``(mesh, per-shard devices, router device)`` for a build."""
    if isinstance(mesh, str) and mesh == "auto":
        mesh = make_shard_mesh(n_shards, target=target)
    elif mesh is not None:
        mesh = tuple(torch.device(d) for d in mesh)
    devices = shard_devices(mesh, n_shards)
    home = mesh[0] if mesh else resolve_target(target)
    return mesh, devices, home


def sharded_build_sorted(kb: torch.Tensor, kl: torch.Tensor,
                         vals: torch.Tensor, n_shards: int, cfg: TreeConfig,
                         mesh: Optional[Sequence]) -> ShardedTree:
    """:func:`sharded_build` of unique keys already in the global sort
    order, held in tensors on one device (``rebalance``'s concatenated
    shard snapshots): ``sharded_partition``'s balanced split, done by
    slicing on the device, then :func:`fbtree.build_sorted` per shard on
    the shard's device. Each shard equals the device build of its
    ``sharded_partition`` run; only the ``n_shards`` split keys go
    through the host."""
    n = kb.shape[0]
    if n < n_shards:
        raise ValueError(
            f"sharded_partition needs at least one key per shard "
            f"(n={n} < n_shards={n_shards}): an empty shard has no "
            f"minimum key for the router — lower n_shards or seed "
            f"sentinel keys")
    mesh, devices, home = _placement(mesh, n_shards, kb.device)
    base, rem = divmod(n, n_shards)
    sizes = [base + (1 if s < rem else 0) for s in range(n_shards)]
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    first = torch.from_numpy(starts).to(kb.device)
    sb, sl = kb[first].cpu().numpy(), kl[first].cpu().numpy()
    shards = []
    for lo, k, dev in zip(starts, sizes, devices):
        dev = dev or kb.device
        run = slice(int(lo), int(lo) + k)
        shards.append(build_sorted(cfg, kb[run].to(dev), kl[run].to(dev),
                                   vals[run].to(dev)))
    split_keys = [(sb[s], int(sl[s])) for s in range(n_shards)]
    return ShardedTree(shards=tuple(shards),
                       router=make_router(split_keys, home),
                       devices=devices, mesh=mesh)
