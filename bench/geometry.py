"""Where a key sits in a bulk-loaded FB+-tree, from its rank alone.

A bulk load (the paper's, and the port's ``bulk_build``) cuts the sorted
keys into balanced runs of at most ``leaf_fill`` keys, one leaf each, then
groups each level's nodes into balanced runs of at most ``inner_fill``
children until one node is left, and pads the height with one-child nodes.
Balanced: ``n`` items in ``c = ceil(n / fill)`` runs, the first ``n % c``
runs one item longer. Nothing here reads the program's tree.
"""
import torch


def runs(n_items: int, fill: int):
    """``(n_runs, base, rem)`` of a balanced cut of ``n_items``."""
    c = max(1, -(-n_items // fill))
    return c, n_items // c, n_items % c


def run_of(pos: torch.Tensor, base: int, rem: int) -> torch.Tensor:
    """The run that holds item ``pos``."""
    cut = (base + 1) * rem
    return torch.where(pos < cut, torch.div(pos, base + 1, rounding_mode="floor"),
                       rem + torch.div(pos - cut, max(base, 1),
                                       rounding_mode="floor"))


def run_start(c: torch.Tensor, base: int, rem: int) -> torch.Tensor:
    """The first item of run ``c``."""
    return torch.where(c <= rem, c * (base + 1), rem * (base + 1) + (c - rem) * base)


class BulkLoad:
    """The shape of a tree bulk-loaded from ``n`` keys."""

    def __init__(self, n: int, leaf_fill: int, inner_fill: int, levels: int):
        self.n = n
        self.leaf = runs(n, leaf_fill)
        self.inner = []                      # bottom-up: (n_nodes, base, rem)
        c = self.leaf[0]
        while True:
            self.inner.append(runs(c, inner_fill))
            c = self.inner[-1][0]
            if c == 1:
                break
        self.chain = levels - len(self.inner)   # one-child nodes above the root
        if self.chain < 0:
            raise ValueError(f"{n} keys need {len(self.inner)} inner levels, "
                             f"more than the {levels} given")

    def leaf_of(self, rank: torch.Tensor) -> torch.Tensor:
        _, base, rem = self.leaf
        return run_of(rank, base, rem)

    def leaf_span(self, leaf: torch.Tensor):
        """``(first rank, keys)`` of each leaf."""
        c, base, rem = self.leaf
        return run_start(leaf, base, rem), base + (leaf < rem).to(leaf.dtype)

    def path_of(self, leaf: torch.Tensor):
        """Node ids above each leaf, one tensor a level, bottom level
        first (the levels of :attr:`inner`)."""
        out, child = [], leaf
        for _, base, rem in self.inner:
            child = run_of(child, base, rem)
            out.append(child)
        return out

    def children(self, level: int, node: torch.Tensor) -> torch.Tensor:
        """How many children each ``node`` of inner level ``level`` (bottom
        first) has."""
        _, base, rem = self.inner[level]
        return base + (node < rem).to(node.dtype)
