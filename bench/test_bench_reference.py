"""The reference against brute force, the bulk load's shape against the
port's own tree, and the K1 roofline count on a tree worked by hand."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bench.geometry import BulkLoad
from bench.metrics import k1_roofline as k1
from bench.reference.index import SortedKeys, last_wins

ROOT = Path(__file__).resolve().parents[1]


def random_keys(n, width, seed):
    """Distinct zero-padded keys of random lengths over a small alphabet,
    so that many share prefixes."""
    rng = np.random.default_rng(seed)
    seen, kb, kl = set(), [], []
    while len(kb) < n:
        k = bytes(rng.integers(97, 101, size=rng.integers(1, width + 1),
                               dtype=np.uint8))
        if k not in seen:
            seen.add(k)
            kb.append(list(k) + [0] * (width - len(k)))
            kl.append(len(k))
    return (torch.tensor(kb, dtype=torch.uint8),
            torch.tensor(kl, dtype=torch.int32))


def test_search_matches_brute_force():
    kb, kl = random_keys(3000, 9, 1)
    keys = [bytes(r[:n].tolist()) for r, n in zip(kb, kl)]
    ref = SortedKeys(kb[:2500], kl[:2500], torch.arange(2500))
    table = sorted(keys[:2500])
    rank, found = ref.search(kb, kl, block=700)
    for i, k in enumerate(keys):
        lo = sum(1 for t in table if t < k)
        assert int(rank[i]) == lo
        assert bool(found[i]) == (i < 2500)
    assert [keys[int(v)] for v in ref.vals] == table


def test_insert_and_rows_match_brute_force():
    kb, kl = random_keys(2000, 7, 2)
    keys = [bytes(r[:n].tolist()) for r, n in zip(kb, kl)]
    ref = SortedKeys(kb[:1200], kl[:1200], torch.arange(1200))
    ref.insert(kb[1000:], kl[1000:], torch.arange(5000, 6000))
    want = {k: i for i, k in enumerate(keys[:1200])}
    want.update({k: 5000 + i for i, k in enumerate(keys[1000:])})
    table = sorted(want)
    assert [int(v) for v in ref.vals] == [want[k] for k in table]
    rank, _ = ref.search(kb[:5], kl[:5])
    words, vals, valid = ref.rows(rank, 4)
    for i in range(5):
        r = table.index(keys[i])
        assert valid[i].tolist() == [r + j < len(table) for j in range(4)]
        assert vals[i][valid[i]].tolist() == [want[k] for k in table[r:r + 4]]


def test_last_wins_keeps_the_last_lane_of_each_key():
    rank = torch.tensor([4, 1, 4, 2, 1, 4])
    assert last_wins(rank).tolist() == [False, False, False, True, True, True]


@pytest.mark.parametrize("n", [1, 47, 48, 49, 2305, 20000])
def test_bulk_load_shape_matches_the_port(n):
    """Where the count puts a key is where the port's bulk load put it."""
    from repro_torch.core import fbtree
    from repro_torch.core.keys import KeySet
    kb, kl = random_keys(n, 12, n)
    cfg = fbtree.TreeConfig.plan(max_keys=int(n * 2.5), key_width=12)
    tree = fbtree.bulk_build(cfg, KeySet(kb.numpy(), kl.numpy()),
                             np.arange(n, dtype=np.int32), target="cpu")
    shape = BulkLoad(n, cfg.leaf_fill, cfg.inner_fill, cfg.n_levels)
    ref = SortedKeys(kb, kl, torch.arange(n))
    rank = torch.arange(n)
    leaf = shape.leaf_of(rank)
    a = tree.arrays
    slot_of = {int(k): (li, s) for li in range(int(a.leaf_count))
               for s, k in enumerate(a.leaf_keyid[li].tolist()) if k >= 0}
    for r in range(0, n, max(1, n // 200)):
        kid = int(ref.order[r])                  # generation index of rank r
        pool_id = int(torch.nonzero(
            (a.key_bytes[:n] == kb[kid]).all(1) & (a.key_lens[:n] == kl[kid]))[0])
        assert slot_of[pool_id][0] == int(leaf[r])
    first, size = shape.leaf_span(torch.arange(shape.leaf[0]))
    assert size.tolist() == a.leaf_occ[:shape.leaf[0]].sum(1).tolist()
    nodes = shape.path_of(leaf)
    for lvl, node in enumerate(nodes):           # bottom level first
        level = a.levels[cfg.n_levels - 1 - lvl]
        u = torch.unique(node)
        assert shape.children(lvl, u).tolist() == level.knum[u].tolist()
    assert shape.chain == cfg.n_levels - len(shape.inner)


def test_k1_count_on_a_tree_worked_by_hand():
    """Ten keys, leaves of at most 3 (runs of 3, 3, 2, 2), inner nodes of
    at most 3 children (two nodes of 2 leaves, then a root of 2), and one
    one-child level above the root: three inner levels.

    Queries of width L = 8 at ranks 0, 1, 9 and a miss at rank 4 (found
    flags 1, 1, 1, 0), a lookup:
    * queries 4 x (8 + 4) = 48, answers 4 x 5 = 20;
    * leaves reached: 0 (ranks 0, 1), 1 (rank 4), 3 (rank 9): 3 x (2 x 4
      + 8) = 48 at ns = 4;
    * bottom inner level: nodes 0 (leaves 0, 1) and 1 (leaf 3), both of two
      children: 2 x 8 + 2 x (4 + 8 + 2 x 4) = 56 at fs = 2;
    * the root: one node of two children: 8 + 20 = 28; the chain: 8;
    * keys matched: ranks 0, 1, 9: 3 x (8 + 8 + 4) = 60.
    Total 268.
    """
    shape = BulkLoad(10, 3, 3, 3)
    assert shape.leaf == (4, 2, 2) and shape.inner == [(2, 2, 0), (1, 2, 0)]
    assert shape.chain == 1
    rank = torch.tensor([0, 1, 9, 4])
    found = torch.tensor([True, True, True, False])
    assert k1.least_bytes(rank, found, shape, L=8, ns=4, fs=2,
                          op="lookup") == 268
    assert k1.least_bytes(rank, found, shape, L=8, ns=4, fs=2,
                          op="update") == 268 + 4 * 4


def test_the_count_and_the_reference_load_nothing_of_the_program():
    code = ("import sys; import bench.metrics.k1_roofline, "
            "bench.reference.control, bench.reference.index, bench.geometry;"
            " bad = {m.split('.')[0] for m in sys.modules} & {'repro_torch', "
            "'repro', 'jax', 'jaxlib', 'flax', 'benchmarks', 'chip_smoke'};"
            " print(sorted(bad))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "[]"
