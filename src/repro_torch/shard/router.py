"""Replicated split-key router (DESIGN.md §7) — the port's counterpart of
``repro.shard.router``.

The router is the sharded tree's only global state: the per-shard minimum
keys from the build's balanced partition (``fbtree.sharded_partition``).
Shard ``s`` owns the key range ``[split[s], split[s+1])``; shard 0 also
owns everything below ``split[0]``, so the router never rejects a key.

Routing uses the packed-word compares the tree descends with
(``core.keys.pack_words_t``): split keys are packed once into
order-preserving int32 words, and :func:`route` resolves a query batch
with one ``[B, S, W]`` three-way compare — the first differing word
decides, equal padded words fall back to the length tie-break, exactly
``core.keys.compare_padded``'s order.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.fbtree import resolve_target
from ..core.keys import pack_words_t

__all__ = ["ShardRouter", "make_router", "route"]


class ShardRouter(NamedTuple):
    """Routing table: one row per shard, ascending, on one device.

    ``split_bytes[s]`` / ``split_lens[s]`` are shard ``s``'s minimum key;
    ``split_words`` is their packed form, which :func:`route` compares.
    """
    split_bytes: torch.Tensor   # uint8 [S, L]
    split_lens: torch.Tensor    # int32 [S]
    split_words: torch.Tensor   # int32 [S, W] — pack_words_t(split_bytes)

    @property
    def n_shards(self) -> int:
        return int(self.split_bytes.shape[0])

    @property
    def device(self) -> torch.device:
        return self.split_words.device


def make_router(split_keys, target: Optional[str] = None) -> ShardRouter:
    """A router from ``fbtree.sharded_partition``'s ``split_keys`` (one
    ``(bytes_row, len)`` per shard, ascending), on ``target`` (the card
    unless ``"cpu"`` or another device is asked for)."""
    dev = resolve_target(target)
    sb = torch.from_numpy(np.stack([np.asarray(b, dtype=np.uint8)
                                    for b, _ in split_keys])).to(dev)
    sl = torch.tensor([int(l) for _, l in split_keys], dtype=torch.int32,
                      device=dev)
    return ShardRouter(split_bytes=sb, split_lens=sl,
                       split_words=pack_words_t(sb))


def route(router: ShardRouter, qb, ql) -> torch.Tensor:
    """Owning shard id per query: ``int32 [B]`` on the router's device.

    ``owner[i]`` is the largest ``s`` with ``q_i >= split[s]`` (0 when the
    query sorts below every split key). The compare is lexicographic over
    packed words with the length tie-break, the order the leaves use.
    """
    dev = router.device
    qw = pack_words_t(torch.as_tensor(qb, device=dev))      # [B, W]
    ql = torch.as_tensor(ql, device=dev).to(torch.int32)
    sw, sl = router.split_words, router.split_lens
    d = ((qw[:, None, :] > sw[None]).to(torch.int32)
         - (qw[:, None, :] < sw[None]).to(torch.int32))     # [B, S, W]
    # the first differing word decides: fold from the last word to the
    # first, starting from the length tie-break
    cmp = torch.sign(ql[:, None] - sl[None, :])
    for w in range(d.shape[-1] - 1, -1, -1):
        cmp = torch.where(d[..., w] != 0, d[..., w], cmp)
    ge = (cmp >= 0).to(torch.int32)                         # splits ascending
    return torch.clamp(ge.sum(-1, dtype=torch.int32) - 1, min=0)
