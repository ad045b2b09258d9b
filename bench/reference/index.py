"""The sorted key table the answers are judged by.

Keys are zero-padded byte rows with a length. They are ordered by their
bytes, then by their length (the order of a byte string among keys that
hold no zero byte), packed into int64 words of seven bytes each, most
significant first, with the length as the last word. Sorting and searching
run on whatever device the tensors are on.
"""
import torch

WORD_BYTES = 7


def pack(kb: torch.Tensor, kl: torch.Tensor) -> torch.Tensor:
    """``int64 [n, ceil(L / 7) + 1]``: the key bytes seven to a word, then
    the length; rows compare lexicographically as the keys do."""
    n, L = kb.shape
    nw = -(-L // WORD_BYTES)
    words = torch.zeros((n, nw + 1), dtype=torch.int64, device=kb.device)
    for i in range(L):
        w, j = divmod(i, WORD_BYTES)
        words[:, w] |= kb[:, i].to(torch.int64) << (8 * (WORD_BYTES - 1 - j))
    words[:, nw] = kl.to(torch.int64)
    return words


def lex_order(words: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts the rows of ``words``."""
    perm = torch.arange(words.shape[0], device=words.device)
    for c in range(words.shape[1] - 1, -1, -1):
        perm = perm[torch.argsort(words[perm, c], stable=True)]
    return perm


def lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row by row, whether ``a`` sorts before ``b``."""
    ne = a != b
    first = ne.to(torch.int8).argmax(1, keepdim=True)
    return ne.any(1) & (a.gather(1, first) < b.gather(1, first))[:, 0]


def last_wins(rank: torch.Tensor) -> torch.Tensor:
    """For a batch of writes to ``rank``, the lanes whose write stands: the
    last lane of each key."""
    B = rank.shape[0]
    order = torch.argsort(rank, stable=True)
    r = rank[order]
    last = torch.ones(B, dtype=torch.bool, device=rank.device)
    last[:-1] = r[1:] != r[:-1]
    keep = torch.zeros(B, dtype=torch.bool, device=rank.device)
    keep[order] = last
    return keep


class SortedKeys:
    """Distinct keys in ascending order with one value each (by rank)."""

    def __init__(self, kb: torch.Tensor, kl: torch.Tensor,
                 vals: torch.Tensor):
        words = pack(kb, kl)
        order = lex_order(words)
        self.words = words[order]
        self.vals = vals[order].to(torch.int64)
        self.order = order          # rank -> position in the given keys
        self.version = 0            # counts the inserts, which move ranks

    @property
    def n(self) -> int:
        return self.words.shape[0]

    def search(self, qb: torch.Tensor, ql: torch.Tensor, block: int = 1 << 20):
        """Lower bound of each query: ``(rank int64 [B], found bool [B])``;
        ``rank`` is the first key not below the query."""
        ranks, found = [], []
        for s in range(0, qb.shape[0], block):
            q = pack(qb[s:s + block], ql[s:s + block])
            lo = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
            hi = torch.full_like(lo, self.n)
            for _ in range(self.n.bit_length()):
                mid = torch.div(lo + hi, 2, rounding_mode="floor")
                live = lo < hi
                below = lex_less(self.words[torch.clamp(mid, max=self.n - 1)],
                                 q)
                lo = torch.where(live & below, mid + 1, lo)
                hi = torch.where(live & ~below, mid, hi)
            at = self.words[torch.clamp(lo, max=self.n - 1)]
            ranks.append(lo)
            found.append((lo < self.n) & (at == q).all(1))
        return torch.cat(ranks), torch.cat(found)

    def rows(self, rank: torch.Tensor, count: int):
        """``(words [.., count, W], vals [.., count], valid [.., count])`` of
        the ``count`` keys from ``rank`` on, as far as the table goes."""
        pos = rank[..., None] + torch.arange(count, device=rank.device)
        valid = pos < self.n
        pos = torch.clamp(pos, max=self.n - 1)
        return self.words[pos], self.vals[pos], valid

    def insert(self, kb: torch.Tensor, kl: torch.Tensor, vals: torch.Tensor):
        """Upsert distinct keys: a key present takes the new value, the
        others are merged into the table in order."""
        rank, found = self.search(kb, kl)
        self.vals[rank[found]] = vals[found].to(torch.int64)
        new = pack(kb[~found], kl[~found])
        order = lex_order(new)
        new, nv, lb = new[order], vals[~found][order].to(torch.int64), rank[~found][order]
        m = new.shape[0]
        at_new = lb + torch.arange(m, device=lb.device)
        old = torch.arange(self.n, device=lb.device)
        at_old = old + torch.searchsorted(lb, old, right=True)
        words = torch.empty((self.n + m, self.words.shape[1]),
                            dtype=torch.int64, device=lb.device)
        v = torch.empty((self.n + m,), dtype=torch.int64, device=lb.device)
        words[at_old], v[at_old] = self.words, self.vals
        words[at_new], v[at_new] = new, nv
        self.words, self.vals = words, v
        self.version += 1
