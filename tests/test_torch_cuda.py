"""The CUDA kernels on a card: each held against its plain torch version
bit for bit, launched once per call, and strict about its inputs; and the
mutations on the card equal to the same mutations on the CPU.

Every test here is marked ``cuda`` and skips where no card is present (a
CUDA kernel has no CPU mode). The file imports no JAX, so it runs on a
machine with a card and no JAX:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import batch_ops as B
from repro_torch.core.fbtree import TreeConfig, bulk_build
from repro_torch.core.keys import KeySet
from repro_torch.core.traverse import TraversalEngine
from repro_torch.kernels.fused_descent import cuda as kcuda
from repro_torch.kernels.fused_descent import ops
from repro_torch.kernels.fused_scan import ops as scan_ops

from chip_smoke import (int_keys, kernel_vs_plain, scan_kernel_vs_plain,
                        stale_parents, tree_diffs, tree_to, url_keys,
                        ycsb_keys)

GEN = {"ycsb": ycsb_keys, "url": url_keys, "int": int_keys}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _tree_and_queries(kind, ns, n=4000, seed=3):
    kb, kl = GEN[kind](n, seed)
    cfg = TreeConfig.plan(max_keys=int(2.5 * n), key_width=kb.shape[1], ns=ns)
    tree = bulk_build(cfg, KeySet(kb, kl), np.arange(n, dtype=np.int32) * 7,
                      target="cuda")
    tree, moved = stale_parents(tree, [2, 7, 11], double=(ns == 128))
    rng = np.random.default_rng(seed)
    idx = np.concatenate([np.asarray(moved), rng.integers(0, n, 509)])
    a = tree.arrays
    qi = torch.from_numpy(idx).cuda()
    qb, ql = a.key_bytes[qi].clone(), a.key_lens[qi].clone()
    qb[len(moved)::3, -1] ^= 0xA5
    return tree, qb, ql


@pytest.mark.cuda
@pytest.mark.parametrize("kind,ns", (("ycsb", 64), ("url", 64), ("int", 128)))
def test_cuda_kernel_matches_plain(cuda_device, kind, ns):
    tree, qb, ql = _tree_and_queries(kind, ns)
    n0 = ops.LAUNCHES
    assert kernel_vs_plain(tree, qb, ql) == 0
    assert ops.LAUNCHES == n0 + 8       # 2 entries x stats x sibling check
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_lookup_batch_is_one_launch(cuda_device):
    tree, qb, ql = _tree_and_queries("ycsb", 64)
    n0 = ops.LAUNCHES
    vals, rep = B.lookup_batch(tree, qb, ql, engine=TraversalEngine("fused"))
    assert ops.LAUNCHES == n0 + 1
    assert vals.is_cuda and rep.found.is_cuda
    # the plain "torch" engine on the same tree gives the same values/report
    ref_vals, ref_rep = B.lookup_batch(tree, qb, ql,
                                       engine=TraversalEngine("torch"))
    assert ops.LAUNCHES == n0 + 1
    assert torch.equal(vals, ref_vals)
    for f in rep._fields:
        assert torch.equal(getattr(rep, f), getattr(ref_rep, f)), f


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    tree, qb, ql = _tree_and_queries("int", 64, n=500)
    a = tree.arrays
    kw = dict(sibling_check=True, with_probe=True, collect_stats=False)
    with pytest.raises(TypeError, match="ql"):
        kcuda.launch(a, qb, ql.long(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        kcuda.launch(a, qb.t().contiguous().t(), ql, **kw)
    with pytest.raises(ValueError, match="on"):
        kcuda.launch(a._replace(leaf_high=a.leaf_high.cpu()), qb, ql, **kw)
    with pytest.raises(ValueError, match="shape"):
        kcuda.launch(a, qb[:, :-1].contiguous(), ql, **kw)
    empty = kcuda.launch(a, qb[:0], ql[:0], **kw)
    assert all(t.shape[-1] == 0 or t.shape[0] == 0 for t in empty)


def _scan_tree(kind, ns, dirty, n=4000, seed=5):
    """A tree on the card, dirtied by the port's own inserts (fit and split
    paths) when asked, and scan starts on and between its keys."""
    kb, kl = GEN[kind](n + 1200, seed)
    perm = np.random.default_rng(seed).permutation(n + 1200)
    kb, kl = kb[perm], kl[perm]        # the inserts spread over the tree
    cfg = TreeConfig.plan(max_keys=int(2.5 * n), key_width=kb.shape[1], ns=ns)
    tree = bulk_build(cfg, KeySet(kb[:n], kl[:n]),
                      np.arange(n, dtype=np.int32), target="cuda")
    if dirty:
        more = np.arange(n, n + 1200)
        tree, _, _ = B.insert_batch(tree, kb[more], kl[more],
                                    more.astype(np.int32),
                                    engine=TraversalEngine("fused"))
    idx = torch.from_numpy(np.random.default_rng(seed).integers(
        0, n, 700)).cuda()
    qb = torch.from_numpy(kb).cuda()[idx].clone()
    ql = torch.from_numpy(kl).cuda()[idx]
    qb[::3, -1] ^= 0xA5
    return tree, qb, ql


@pytest.mark.cuda
@pytest.mark.parametrize("dirty", (False, True), ids=("clean", "dirty"))
@pytest.mark.parametrize("kind,ns", (("ycsb", 64), ("url", 64), ("int", 128)))
def test_cuda_scan_kernel_matches_plain(cuda_device, kind, ns, dirty):
    tree, qb, ql = _scan_tree(kind, ns, dirty)
    if dirty:
        assert not bool(tree.arrays.leaf_ordered[
            :int(tree.arrays.leaf_count)].all())
    n0 = scan_ops.LAUNCHES
    for max_items in (1, 50, 300):
        assert scan_kernel_vs_plain(tree, qb, ql, max_items) == 0
    assert scan_ops.LAUNCHES == n0 + 6          # 3 sizes x stats on/off
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_range_scan_is_one_launch(cuda_device):
    tree, qb, ql = _scan_tree("ycsb", 64, dirty=True)
    n0 = scan_ops.LAUNCHES
    got = B.range_scan(tree, qb, ql, max_items=50,
                       engine=TraversalEngine("fused"))
    assert scan_ops.LAUNCHES == n0 + 1
    want = B.range_scan(tree, qb, ql, max_items=50,
                        engine=TraversalEngine("torch"))
    assert scan_ops.LAUNCHES == n0 + 1
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)
    assert int(got[3].sum()) > 0                # dirty leaves were ranked


@pytest.mark.cuda
@pytest.mark.parametrize("ns", (64, 128))
def test_cuda_insert_matches_cpu(cuda_device, ns):
    """The same inserts (fit and split paths), update and remove on the
    card and on the CPU give bit-equal trees and reports."""
    kb, kl = ycsb_keys(4500, 9)                          # sorted
    fresh = np.arange(1, 4500, 3)                        # spread over the tree
    rows = np.setdiff1d(np.arange(4500), fresh)          # 3,000 tree keys
    near = np.repeat(kb[rows[100:600]], 2, axis=0)       # a run of neighbours,
    near[:, 23] = np.tile([ord("}"), ord("~")], 500)     # two after each base
    ins_kb = np.concatenate([near, kb[fresh]])
    ins_kl = np.concatenate([np.full(1000, 24, np.int32), kl[fresh]])
    cfg = TreeConfig.plan(max_keys=8000, key_width=24, ns=ns)
    card = bulk_build(cfg, KeySet(kb[rows], kl[rows]),
                      np.arange(rows.size, dtype=np.int32), target="cuda")
    mask = np.random.default_rng(ns).random(1000) < 0.7
    out = []
    for t in (card, tree_to(card, "cpu")):
        eng = TraversalEngine("fused")
        reps, rounds = [], []
        for lo in (0, 1000):
            sl = slice(lo, lo + 1000)
            t, rep, r = B.insert_batch(t, ins_kb[sl], ins_kl[sl],
                                       np.arange(lo, lo + 1000, dtype=np.int32),
                                       engine=eng)
            reps.append(rep)
            rounds.append(r)
        t, rep = B.update_batch(t, kb[rows[:1000]], kl[rows[:1000]],
                                np.arange(1000, dtype=np.int32), engine=eng,
                                mask=mask)
        reps.append(rep)
        t, rep = B.remove_batch(t, ins_kb[500:1500], ins_kl[500:1500],
                                engine=eng)
        reps.append(rep)
        out.append((t, reps, rounds))
    (card, rc, nc), (host, rh, nh) = out
    assert tree_diffs(card, host) == []
    assert nc == nh and int(rc[0].splits) > 0
    for x, y in zip(rc, rh):
        for f in x._fields:
            assert torch.equal(getattr(x, f).cpu(), getattr(y, f)), f
