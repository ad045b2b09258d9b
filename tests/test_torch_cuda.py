"""The CUDA kernels on a card: each held against its plain torch version
bit for bit, launched once per call, and strict about its inputs; and the
mutations, the device build and the rebuild on the card equal to the same
calls on the CPU.

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
from repro_torch.kernels.feature_branch import cuda as k3cuda
from repro_torch.kernels.feature_branch import ops as k3
from repro_torch.kernels.fused_scan import ops as scan_ops
from repro_torch.kernels.leaf_probe import cuda as k4cuda
from repro_torch.kernels.leaf_probe import ops as k4

from chip_smoke import (int_keys, k3_vs_plain, k4_vs_plain, kernel_vs_plain,
                        scan_kernel_vs_plain, stale_parents, tree_diffs,
                        tree_to, url_keys, ycsb_keys)

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


@pytest.mark.cuda
@pytest.mark.parametrize("ns,fs", ((64, 4), (128, 2), (128, 8)))
def test_cuda_feature_branch_matches_plain(cuda_device, ns, fs):
    """K3 on random rows: trivial nodes (knum 0 and 1), full nodes, both
    prefix overrides, skewed bytes so that runs survive several rounds."""
    rng = np.random.default_rng(ns + fs)
    B = 3001
    feats = np.sort(rng.integers(0, 6, size=(B, fs, ns), dtype=np.uint8), -1)
    qfeat = rng.integers(0, 6, size=(B, fs), dtype=np.uint8)
    knum = rng.integers(0, ns + 1, size=B, dtype=np.int32)
    knum[:300] = rng.choice([0, 1, ns], size=300)
    pcmp = rng.choice(np.array([-1, 0, 0, 1], np.int32), size=B)
    args = [torch.from_numpy(x).cuda() for x in (feats, qfeat, knum, pcmp)]
    n0 = k3.LAUNCHES
    assert k3_vs_plain(*args) == 0
    assert k3.LAUNCHES == n0 + 2                # stats on and off
    out = k3.feature_branch(*args)
    assert int(out[4].max()) > 1                # some runs survive a row
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("ns", (64, 128))
def test_cuda_leaf_probe_matches_plain(cuda_device, ns):
    rng = np.random.default_rng(ns)
    B = 2049
    tags = torch.from_numpy(rng.integers(0, 3, size=(B, ns),
                                         dtype=np.uint8)).cuda()
    occ = torch.from_numpy(rng.random((B, ns)) < 0.6).cuda()
    occ[:5] = False
    qtag = torch.from_numpy(rng.integers(0, 4, size=B, dtype=np.uint8)).cuda()
    n0 = k4.LAUNCHES
    assert k4_vs_plain(tags, occ, qtag) == 0
    assert k4.LAUNCHES == n0 + 1
    _, first, count = k4.leaf_probe(tags, occ, qtag)
    assert (first[:5] == ns).all() and (count[:5] == 0).all()
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("kind,ns", (("ycsb", 64), ("url", 64), ("int", 128)))
def test_cuda_level_engine_matches_torch(cuda_device, kind, ns):
    """Engine "cuda" (K3 once a level) equals "torch" on leaf ids, paths and
    counters in both layouts, stats on and off, over stale parents; its
    lookups equal K1's; probe_cuda (K4 once) equals leaf.probe."""
    from repro_torch.core.leaf import probe
    tree, qb, ql = _tree_and_queries(kind, ns)
    n_levels = tree.config.n_levels
    for stats in (True, False):
        for layout in ("tuple", "stacked"):
            n0 = k3.LAUNCHES
            got = TraversalEngine("cuda", layout, stats).traverse(tree, qb, ql)
            assert k3.LAUNCHES == n0 + n_levels
            want = TraversalEngine("torch", layout, stats).traverse(tree, qb,
                                                                    ql)
            assert torch.equal(got[0], want[0])
            for p, q in zip(got[1], want[1]):
                assert torch.equal(p, q)
            for f in got[2]._fields:
                assert torch.equal(getattr(got[2], f), getattr(want[2], f)), f
    v_c, r_c = B.lookup_batch(tree, qb, ql, engine=TraversalEngine("cuda"))
    v_f, r_f = B.lookup_batch(tree, qb, ql, engine=TraversalEngine("fused"))
    assert torch.equal(v_c, v_f)
    for f in r_c._fields:
        assert torch.equal(getattr(r_c, f), getattr(r_f, f)), f
    leaf = got[0]
    n0 = k4.LAUNCHES
    got_p = k4.probe_cuda(tree, leaf, qb, ql)
    assert k4.LAUNCHES == n0 + 1
    want_p = probe(tree, leaf, qb, ql)
    for g, w in zip(got_p[:3], want_p[:3]):
        assert torch.equal(g, w)
    for f in got_p[3]._fields:
        assert torch.equal(getattr(got_p[3], f), getattr(want_p[3], f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("ns", (64, 128))
def test_cuda_device_build_and_rebuild_match_cpu(cuda_device, ns):
    """bulk_build(device=True) and rebuild (after inserts that split and a
    remove) on the card equal the same calls on the CPU, array for array,
    and the rebuilt tree equals the card's host build of the live set."""
    kb, kl = url_keys(4000, 13)
    n = 3000
    cfg = TreeConfig.plan(max_keys=8000, key_width=kb.shape[1], ns=ns)
    vals = np.arange(n, dtype=np.int32)
    trees = [bulk_build(cfg, KeySet(kb[:n], kl[:n]), vals, device=True,
                        target=t) for t in ("cuda", "cpu")]
    assert tree_diffs(*trees) == []
    host = bulk_build(cfg, KeySet(kb[:n], kl[:n]), vals, target="cuda")
    assert tree_diffs(trees[0], host) == []
    out = []
    for t in trees:
        eng = TraversalEngine("fused")
        t, rep, _ = B.insert_batch(t, kb[n:], kl[n:],
                                   np.arange(n, 4000, dtype=np.int32),
                                   engine=eng)
        assert int(rep.splits) > 0
        t, _ = B.remove_batch(t, kb[::7], kl[::7], engine=eng)
        out.append(B.rebuild(t))
    (card, crep), (cpu, hrep) = out
    assert tree_diffs(card, cpu) == []
    for f in crep._fields:
        assert torch.equal(getattr(crep, f).cpu(), getattr(hrep, f)), f
    live = np.setdiff1d(np.arange(4000), np.arange(0, 4000, 7))
    fresh = bulk_build(cfg, KeySet(kb[live], kl[live]),
                       live.astype(np.int32), target="cuda")
    assert tree_diffs(card, fresh) == []
    assert int(crep.reclaimed) == 4000 - live.size
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_level_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    feats = torch.zeros((8, 4, 64), dtype=torch.uint8, device="cuda")
    qfeat = torch.zeros((8, 4), dtype=torch.uint8, device="cuda")
    knum = torch.ones(8, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError, match="knum"):
        k3cuda.launch(feats, qfeat, knum.long(), knum, collect_stats=True)
    with pytest.raises(ValueError, match="ns"):
        k3cuda.launch(feats[..., :32].contiguous(), qfeat, knum, knum,
                      collect_stats=True)
    with pytest.raises(ValueError, match="contiguous"):
        k3cuda.launch(feats.transpose(1, 2).contiguous().transpose(1, 2),
                      qfeat, knum, knum, collect_stats=False)
    tags = torch.zeros((8, 64), dtype=torch.uint8, device="cuda")
    occ = torch.zeros((8, 64), dtype=torch.bool, device="cuda")
    with pytest.raises(TypeError, match="occ"):
        k4cuda.launch(tags, occ.to(torch.uint8), qfeat[:, 0].contiguous())
    with pytest.raises(ValueError, match="on"):
        k4cuda.launch(tags, occ.cpu(), qfeat[:, 0].contiguous())
    empty = k4cuda.launch(tags[:0], occ[:0], qfeat[:0, 0].contiguous())
    assert all(t.shape[0] == 0 for t in empty)
