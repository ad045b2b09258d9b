"""Keys that order-preserving packed words can get wrong, and the dirtied
scan trees built from them.

:func:`tie_keys` and :func:`tie_scan_tree` feed the range-scan tests:
``tests/test_torch_scan.py`` (the port's scan against the JAX package's
fused scan, on the CPU) and ``tests/test_torch_cuda.py`` (the scan kernel
against its plain version and the planted rank faults, on a card). The
tests here hold the generator to what it promises. The module imports no
JAX, so the card's tests can import it.
"""
import numpy as np
import pytest

TIE_BYTES = np.array([0x00, 0x01, 0x7F, 0x80, 0xFE, 0xFF], np.uint8)
TIE_PREFIXES = (4, 8, 16)   # lengths of the shared leading bytes
TIE_KEYS = 3000             # keys of a tie-key scan tree
TIE_STARTS = 600            # drawn scan starts, besides every twin


def tie_keys(n: int, width: int, seed: int):
    """``n`` distinct keys of width ``width`` that packed words can get
    wrong, in random order: each starts with one of 4 shared prefixes of
    4, 8 or 16 bytes (keys that tie on their first 4, 8 and 16 bytes), and
    every other byte is 0x00, 0x01, 0x7F, 0x80, 0xFE or 0xFF, so 0x00 and
    0xFF sit at every word boundary; a third of the keys shorter than the
    width come with a twin, the same bytes one longer, whose last byte is
    the 0x00 padding (equal padded bytes, lengths that differ: only the
    length tie-break orders them)."""
    rng = np.random.default_rng(seed)
    plens = [p for p in TIE_PREFIXES if p < width]
    fams = {p: rng.choice(TIE_BYTES, size=(4, p)) for p in plens}
    rows = np.zeros((0, width + 1), np.uint8)        # bytes, then length
    while rows.shape[0] < n:
        m = n
        kb = rng.choice(TIE_BYTES, size=(m, width))
        pl = rng.choice(plens, size=m)
        for p in plens:
            sel = pl == p
            kb[sel, :p] = fams[p][rng.integers(0, 4, sel.sum())]
        kl = rng.integers(pl + 1, width + 1)
        kb[np.arange(width)[None, :] >= kl[:, None]] = 0
        twin = (rng.random(m) < 1 / 3) & (kl < width)
        new = np.concatenate([
            np.concatenate([kb, kl[:, None].astype(np.uint8)], 1),
            np.concatenate([kb[twin], (kl[twin] + 1)[:, None].astype(np.uint8)],
                           1)])
        rows = np.unique(np.concatenate([rows, new]), axis=0)
    rows = rows[rng.permutation(rows.shape[0])[:n]]
    return rows[:, :width].copy(), rows[:, width].astype(np.int32)


def tie_scan_tree(width: int, ns: int, seed: int, device, n_ins: int = 700):
    """A tree of ``TIE_KEYS`` :func:`tie_keys` dirtied by the port's own
    ``insert_batch`` (all but ``n_ins`` keys built, ``n_ins`` inserted: fit
    and split paths; ``n_ins`` 0 leaves the tree clean), scan starts on and
    between its keys (``TIE_STARTS`` drawn, a third with their last byte
    flipped, and every key whose twin is in the tree), and the number of
    twin pairs (equal padded bytes, lengths that differ) that share a dirty
    leaf. Returns ``(tree, qb, ql, twins_in_dirty_leaves)``."""
    import torch
    from repro_torch.core import batch_ops, fbtree
    from repro_torch.core.keys import KeySet
    from repro_torch.core.traverse import TraversalEngine
    n = TIE_KEYS
    kb, kl = tie_keys(n, width, seed)
    cfg = fbtree.TreeConfig.plan(max_keys=2 * n, key_width=width, ns=ns)
    m = n - n_ins
    tree = fbtree.bulk_build(cfg, KeySet(kb[:m], kl[:m]),
                             np.arange(m, dtype=np.int32), target=device)
    if n_ins:
        tree, _, _ = batch_ops.insert_batch(
            tree, kb[m:], kl[m:], np.arange(m, n, dtype=np.int32),
            engine=TraversalEngine("fused"))
    a = tree.arrays
    occ = a.leaf_occ.cpu().numpy()
    kid = a.leaf_keyid.cpu().numpy()
    dirty = ~a.leaf_ordered.cpu().numpy()
    pool = a.key_bytes.cpu().numpy()
    lens = a.key_lens.cpu().numpy()
    twins = 0
    for leaf in np.nonzero(dirty[:int(a.leaf_count)])[0]:
        ids = kid[leaf][occ[leaf]]
        keys = {}
        for k in ids:
            keys.setdefault(pool[k].tobytes(), []).append(lens[k])
        twins += sum(len(v) - 1 for v in keys.values())
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, n, TIE_STARTS)
    padded = {}
    for i in range(n):
        padded.setdefault(kb[i].tobytes(), []).append(i)
    paired = [i for v in padded.values() if len(v) > 1 for i in v]
    idx = np.concatenate([pick, np.asarray(paired, np.int64)])
    qb = torch.from_numpy(kb[idx]).to(device)
    ql = torch.from_numpy(kl[idx]).to(device)
    qb[:TIE_STARTS:3, -1] ^= 0xA5
    return tree, qb, ql, twins


@pytest.mark.parametrize("width", (21, 24, 28, 37, 100, 160))
def test_tie_keys_hold_what_packed_words_get_wrong(width):
    """Distinct keys, zero past their length, with twins (equal padded
    bytes, lengths one apart), keys that tie on their first 4, 8 and 16
    bytes and differ after, and 0x00 and 0xFF on both sides of every
    8-byte word boundary inside the width."""
    kb, kl = tie_keys(TIE_KEYS, width, seed=width)
    assert kb.shape == (TIE_KEYS, width) and kb.dtype == np.uint8
    assert ((kl >= 1) & (kl <= width)).all()
    assert not kb[np.arange(width)[None, :] >= kl[:, None]].any()
    rows = np.concatenate([kb, kl[:, None].astype(np.uint8)], 1)
    assert np.unique(rows, axis=0).shape[0] == TIE_KEYS
    _, inv, cnt = np.unique(kb, axis=0, return_inverse=True,
                            return_counts=True)
    twin = cnt[inv.ravel()] > 1
    assert twin.sum() >= TIE_KEYS // 10
    for p in TIE_PREFIXES:
        if p >= width:
            continue
        _, inv, cnt = np.unique(kb[:, :p], axis=0, return_inverse=True,
                                return_counts=True)
        tied = cnt[inv.ravel()] > 1
        # keys tied on their first p bytes and apart on the next ones
        assert np.unique(kb[tied][:, p:], axis=0).shape[0] > 100, p
    for w in range(8, width, 8):
        for pos in (w - 1, w):
            have = set(kb[kl > pos, pos].tolist())
            assert {0x00, 0xFF} <= have, (w, pos)


@pytest.mark.parametrize("ns,width", ((64, 24), (128, 37), (64, 160)))
def test_tie_scan_tree_dirty_leaves_hold_twins(ns, width):
    """The port's own inserts dirty the tie-key tree, its dirty leaves hold
    twin pairs, every key of the set is found with its value, and the scan
    starts include every twin."""
    import torch
    from repro_torch.core import batch_ops
    from repro_torch.core.traverse import TraversalEngine
    tree, qb, ql, twins = tie_scan_tree(width, ns, seed=ns + width,
                                        device="cpu")
    a = tree.arrays
    nl = int(a.leaf_count)
    assert twins > 0 and not bool(a.leaf_ordered[:nl].all())
    kb, kl = tie_keys(TIE_KEYS, width, seed=ns + width)
    vals, rep = batch_ops.lookup_batch(tree, torch.from_numpy(kb),
                                       torch.from_numpy(kl),
                                       engine=TraversalEngine("fused"))
    assert bool(rep.found.all())
    assert torch.equal(vals, torch.arange(TIE_KEYS, dtype=torch.int32))
    _, cnt = np.unique(kb, axis=0, return_counts=True)
    assert qb.shape == (TIE_STARTS + int(cnt[cnt > 1].sum()), width)
