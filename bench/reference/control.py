"""The control: the reference put in the program's place with one
guarantee broken, to show that the comparison that decides ``correct``
catches a wrong answer of the kind a faster index would be tempted into.

The guarantee broken is exactness. A lookup here finds the leaf its key
sits in (the bulk load's leaves, ``bench/geometry.py``) and answers with
the first key of that leaf whose one-byte hash tag equals the query's,
without comparing the whole key: the FB+-tree's hashtag probe with its
full-key verify left out. Writes are exact.
"""
import torch

from ..geometry import BulkLoad
from .index import SortedKeys, last_wins


def tags(words: torch.Tensor) -> torch.Tensor:
    """A one-byte hash of each packed key row."""
    h = torch.zeros(words.shape[0], dtype=torch.int64, device=words.device)
    for c in range(words.shape[1]):
        h = (h * 1000003 + words[:, c] % 2147483647) % 2147483647
    return h & 0xFF


class HashtagOnly:
    """Lookups by leaf and hash tag alone; updates exact."""

    name = "control"

    def __init__(self, kb, kl, vals, config: dict, device):
        self.ref = SortedKeys(kb.to(device), kl.to(device), vals.to(device))
        self.tag = tags(self.ref.words)
        self.shape = BulkLoad(self.ref.n, config["leaf_fill"],
                              config["inner_fill"], config["inner_levels"])

    def lookup(self, qb, ql):
        rank, found = self.ref.search(qb, ql)
        rank = torch.clamp(rank, max=self.ref.n - 1)
        first, size = self.shape.leaf_span(self.shape.leaf_of(rank))
        slot = torch.arange(int(size.max()), device=rank.device)[None, :]
        cand = torch.clamp(first[:, None] + slot, max=self.ref.n - 1)
        hit = (self.tag[cand] == self.tag[rank][:, None]) & (slot < size[:, None])
        pick = cand.gather(1, hit.to(torch.int8).argmax(1, keepdim=True))[:, 0]
        return self.ref.vals[pick].to(torch.int32), found

    def update(self, qb, ql, vals):
        rank, found = self.ref.search(qb, ql)
        keep = last_wins(rank) & found
        self.ref.vals[rank[keep]] = vals[keep].to(torch.int64)
        return found

    def save(self):
        return self.ref.vals.clone()

    def restore(self, state):
        self.ref.vals = state

    def close(self):
        self.ref = None
