"""The CUDA kernels on a card: each held against its plain torch version
(bit for bit for the tree kernels K1-K4 and the write path's dedupe
kernel, within the stated bound for the flash-attention forward K5),
launched once per call, and strict about its inputs; and the mutations,
the device build and the rebuild on the card equal to the same calls on
the CPU.

Every test here is marked ``cuda`` and skips where no card is present (a
CUDA kernel has no CPU mode). The file imports no JAX, so it runs on a
machine with a card and no JAX:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import batch_ops as B
from repro_torch.core.fbtree import TreeConfig, bulk_build
from repro_torch.core.keys import KeySet
from repro_torch.core.traverse import TraversalEngine
from repro_torch.kernels.dedupe import cuda as ddcuda
from repro_torch.kernels.dedupe import ops as dd
from repro_torch.kernels.fused_descent import cuda as kcuda
from repro_torch.kernels.fused_descent import ops
from repro_torch.kernels.feature_branch import cuda as k3cuda
from repro_torch.kernels.feature_branch import ops as k3
from repro_torch.kernels.fused_scan import ops as scan_ops
from repro_torch.kernels.leaf_probe import cuda as k4cuda
from repro_torch.kernels.leaf_probe import ops as k4
from repro_torch.shard import place_shard

from chip_smoke import (K5_BOUND, K5_CASES, dedupe_cases, dedupe_vs_plain,
                        int_keys, k3_vs_plain, k4_vs_plain, k5_grad_check,
                        k5_sweep, k5_vs_plain, kernel_vs_plain,
                        scan_kernel_vs_plain, stale_parents, train_parity,
                        tree_diffs, url_keys, ycsb_keys, zipf_indices)
from test_torch_level_edges import K3_SHAPES, k3_edge_inputs, k4_edge_inputs
from test_torch_tie_keys import tie_scan_tree

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
def test_cuda_two_stripe_build_on_tpcc_name_keys(cuda_device):
    """K1's S = 2 build through ``lookup_batch`` on 99,000 keys of TPC-C's
    customer-name index (``bench/keysets/tpcc_customer.py``: 32-40 bytes
    behind 8-24 shared ones, long equal feature runs), built as the
    benchmark builds it, equals the plain version bit for bit on found and
    absent keys; the launch is counted under its build."""
    from bench.keysets import tpcc_customer as tpcc
    from repro_torch import obs
    kb, kl = tpcc.generate(99000, 0, "cuda")
    n = kb.shape[0]
    cfg = TreeConfig.plan(max_keys=int(2.5 * n), key_width=kb.shape[1])
    tree = bulk_build(cfg, KeySet(kb.cpu().numpy(), kl.cpu().numpy()),
                      np.arange(n, dtype=np.int32), device=True,
                      target="cuda")
    g = torch.Generator().manual_seed(29)
    idx = torch.randint(0, n, (6144,), generator=g).cuda()
    qb, ql = kb[idx].clone(), kl[idx].clone()
    lanes = torch.arange(qb.shape[0], device="cuda")
    changed, shorter = lanes[0::3], lanes[1::3]
    qb[changed, ql[changed].long() - 1] = ord("~")   # no C_FIRST holds it
    ql[shorter] -= 1                                 # C_FIRST one shorter
    qb[shorter, ql[shorter].long()] = 0
    assert kcuda.stripes(qb.shape[1]) == 2
    n0 = ops.LAUNCHES
    obs.disable(), obs.reset()
    obs.enable()
    try:
        vals, rep = B.lookup_batch(
            tree, qb, ql, engine=TraversalEngine("fused", collect_stats=False))
        launches = obs.get_metric("kernel.launches", kernel="fused_descent",
                                  stripes=2,
                                  lanes=kcuda.lanes(64, qb.shape[1])).value
    finally:
        obs.disable(), obs.reset()
    assert ops.LAUNCHES == n0 + 1 and launches == 1
    ref_vals, ref_rep = B.lookup_batch(
        tree, qb, ql, engine=TraversalEngine("torch", collect_stats=False))
    assert torch.equal(vals, ref_vals)
    for f in rep._fields:
        assert torch.equal(getattr(rep, f), getattr(ref_rep, f)), f
    assert rep.found[2::3].all() and not rep.found[0::3].any()
    assert not rep.found[1::3].any()
    assert torch.equal(vals[2::3], idx[2::3].to(torch.int32))
    assert kernel_vs_plain(tree, qb, ql) == 0
    torch.cuda.synchronize()


# K1's builds, one test tree each: (key set, ns, the stripes S the library
# picks for its width). ``wide`` is the url keys behind a 100-byte shared
# prefix (172 bytes, the S = 8 build), ``tpcc`` TPC-C's customer-name keys
# (32-40 bytes behind 8-24 shared ones, long equal feature runs).
K1_BUILDS = (("ycsb", 64, 1), ("tpcc", 64, 2), ("url", 64, 3),
             ("int", 128, 1), ("wide", 64, 8))
K1_IDS = [f"{k}-ns{ns}-S{s}" for k, ns, s in K1_BUILDS]


def _k1_keys(kind, n, seed):
    if kind == "tpcc":
        from bench.keysets import tpcc_customer as tpcc
        kb, kl = tpcc.generate(n, seed, "cpu")
        return kb.numpy(), kl.numpy()
    if kind == "wide":
        kb, kl = url_keys(n, seed)
        pre = np.tile(np.arange(1, 101, dtype=np.uint8), (n, 1))
        return np.concatenate([pre, kb], 1), kl + 100
    return GEN[kind](n, seed)


@functools.lru_cache(maxsize=None)
def _k1_tree(kind, ns, n=30_000, seed=11, device="cuda"):
    """A host-built tree of ``n`` keys on ``device`` with stale parents
    (one hop for three keys; two at ns 128) and the moved keys' ids."""
    kb, kl = _k1_keys(kind, n, seed)
    cfg = TreeConfig.plan(max_keys=int(2.5 * n), key_width=kb.shape[1], ns=ns)
    tree = bulk_build(cfg, KeySet(kb, kl), np.arange(n, dtype=np.int32) * 3,
                      target=device)
    tree, moved = stale_parents(tree, [5, 40, 77], double=(ns == 128))
    return tree, torch.tensor(moved, device=device)


def _k1_lanes(tree, moved, n_lanes):
    """``n_lanes`` queries in runs of four kinds, every order of the four
    in turn, so each warp of 32 / G queries mixes them whatever G: a lane
    that hops to a sibling (a moved key), a lane whose descent ends in a
    suffix binary search (a present key the plain version bills one; any
    present key where the tree has none), a lane that resolves at a node's
    prefix (a key above every key: byte 0 raised to 0xff) and an absent
    lane (a present key with its last byte changed). Returns ``(qb, ql,
    number of suffix-search keys found)``."""
    import itertools
    from repro_torch.kernels.fused_descent import ref
    a = tree.arrays
    live = a.leaf_keyid[a.leaf_occ].long()
    pool = live[torch.randperm(live.numel(), generator=torch.Generator(
        ).manual_seed(1))[:8192].to(live.device)]
    _, _, st = ref.fused_traverse_ref(tree, a.key_bytes[pool],
                                      a.key_lens[pool])
    suffix = pool[st.suffix_bs > 0]
    kinds = {"hop": moved.long(),
             "suffix": suffix if suffix.numel() else pool,
             "prefix": pool, "absent": pool}
    picks, rows = dict.fromkeys(kinds, 0), []
    while len(rows) < n_lanes:
        for order in itertools.permutations(kinds):
            for k in order:
                rows.append((k, int(kinds[k][picks[k] % kinds[k].numel()])))
                picks[k] += 1
    rows = rows[:n_lanes]
    kid = torch.tensor([r for _, r in rows], device=live.device)
    qb, ql = a.key_bytes[kid].clone(), a.key_lens[kid].clone()
    for i, (k, _) in enumerate(rows):
        if k == "prefix":
            qb[i, 0] = 0xFF
        elif k == "absent":
            qb[i, ql[i] - 1] ^= 0xA5
    return qb, ql, int(suffix.numel())


@pytest.mark.cuda
@pytest.mark.parametrize("B", (1, 31, 4013))
@pytest.mark.parametrize("kind,ns,S", K1_BUILDS, ids=K1_IDS)
def test_cuda_k1_builds_match_plain_at_ragged_batches(cuda_device, kind, ns,
                                                      S, B):
    """Every (ns, S) build of K1 equals its plain version bit for bit at
    batch sizes that are no multiple of the queries a block (1, 31 and
    4,013), on the mixed lanes of ``_k1_lanes``; the build is the one the
    library names for the width, at the lanes a query it names."""
    tree, moved = _k1_tree(kind, ns)
    qb, ql, _ = _k1_lanes(tree, moved, B)
    L = qb.shape[1]
    assert kcuda.stripes(L) == S
    assert kcuda.lanes(ns, L) in (2, 4, 8, 16)
    assert kernel_vs_plain(tree, qb, ql) == 0
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("kind,ns,S", K1_BUILDS, ids=K1_IDS)
def test_cuda_k1_warps_mix_prefix_suffix_hop_and_absent_lanes(cuda_device,
                                                              kind, ns, S):
    """Each warp of K1 mixes lanes that resolve at a node's prefix, end in
    a suffix binary search, hop to a sibling or find nothing; every build
    equals its plain version bit for bit on them (stats on and off,
    sibling check on and off), and the lanes do what they are built to
    (the plain version's counters and answers say so)."""
    from repro_torch.kernels.fused_descent import ref
    tree, moved = _k1_tree(kind, ns)
    qb, ql, n_suffix = _k1_lanes(tree, moved, 2048)
    if kind == "tpcc":
        assert n_suffix > 0
    _, _, found, _, _, bst, _ = ref.fused_traverse_probe_ref(tree, qb, ql)
    assert int(bst.sibling_hops.sum()) > 0
    assert not found[qb[:, 0] == 0xFF].any() and found.any()
    assert kernel_vs_plain(tree, qb, ql) == 0
    torch.cuda.synchronize()


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
    paths) when asked, and scan starts on and between its keys. ``tieW`` is
    ``test_torch_tie_keys.tie_keys`` at width W (twins that only the length
    tie-break orders, ties on the first 4, 8 and 16 bytes, 0x00/0xFF at
    word boundaries)."""
    if kind.startswith("tie"):
        tree, qb, ql, twins = tie_scan_tree(int(kind[3:]), ns, seed, "cuda",
                                            n_ins=700 if dirty else 0)
        assert twins > 0 or not dirty
        return tree, qb, ql
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


# widths no multiple of 8 and one that is, over every stripe build of K1
# and K2 (csrc/cmp.cuh::stripes_for: S = 1, 2, 4 and 8; url is S = 3)
TIE_CASES = tuple((f"tie{w}", ns) for w in (21, 24, 28, 37, 100, 160)
                  for ns in (64, 128))


@pytest.mark.cuda
@pytest.mark.parametrize("dirty", (False, True), ids=("clean", "dirty"))
@pytest.mark.parametrize("kind,ns", (("ycsb", 64), ("url", 64), ("int", 128))
                         + TIE_CASES)
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


# Faults planted in K2's dirty-leaf rank (csrc/fused_scan.cu), each (what
# the source says, what the mutant says): the tie-key trees of TIE_CASES
# must catch every one.
K2_MUTANTS = {
    # twins (equal padded bytes) compare equal: two pairs take one column
    "length_tie_break_dropped": (
        "return lt || (eq && xl < yl);", "return lt;"),
    # words compare from their last byte
    "word_little_endian": ("  return bswap64(x);", "  return x;"),
    # the last word of a width that is no multiple of 8 takes the next
    # pool row's first bytes: twins are ordered by those, not by length
    "partial_word_not_zeroed": (
        "x |= static_cast<uint64_t>(p < L ? row[p] : 0) << (8 * j);",
        "x |= static_cast<uint64_t>(row[p]) << (8 * j);"),
}


@pytest.fixture(scope="module")
def k2_mutants():
    """Each mutant's csrc copy under ``build/k2_mutants/`` (never the
    checkout's), built with one ``nvcc`` per mutant, all at once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.fused_scan import cuda as k2cuda
    src = k2cuda.SOURCE.read_text()
    out = {}
    for name, (old, new) in K2_MUTANTS.items():
        assert src.count(old) == 1, name
        d = nvcc.BUILD_DIR.parent / "k2_mutants" / name
        d.mkdir(parents=True, exist_ok=True)
        for h in nvcc.CSRC.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        out[name] = d / k2cuda.SOURCE.name
        out[name].write_text(src.replace(old, new))
    nvcc.build(out.values())
    return out


@pytest.fixture(scope="module")
def tie_trees():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return {(kind, ns): _scan_tree(kind, ns, dirty=True)
            for kind, ns in TIE_CASES}


@pytest.mark.cuda
@pytest.mark.parametrize("kind,ns", TIE_CASES)
def test_cuda_kernel_matches_plain_on_tie_keys(cuda_device, tie_trees, kind,
                                               ns):
    """K1 on the dirtied tie-key trees, one for each stripe build, equals
    its plain version bit for bit (stats on and off, sibling check on and
    off)."""
    tree, qb, ql = tie_trees[(kind, ns)]
    assert kernel_vs_plain(tree, qb, ql) == 0
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(K2_MUTANTS))
def test_cuda_k2_tie_keys_reject_planted_faults(cuda_device, k2_mutants,
                                                tie_trees, name,
                                                monkeypatch):
    """The tie-key trees are hard enough to see a wrong rank: each mutant of
    ``K2_MUTANTS``, swapped in for the kernel, differs from the plain
    version on some of them (max_items 1, 50 and 300, stats on and off).
    The cases each mutant fails are printed."""
    import json
    from repro_torch.kernels.fused_scan import cuda as k2cuda
    monkeypatch.setattr(k2cuda, "SOURCE", k2_mutants[name])
    monkeypatch.setattr(k2cuda, "_FN", None)
    failed = []
    for (kind, ns), (tree, qb, ql) in tie_trees.items():
        for max_items in (1, 50, 300):
            try:
                scan_kernel_vs_plain(tree, qb, ql, max_items)
            except AssertionError:
                failed.append(f"{kind}-ns{ns}-m{max_items}")
    torch.cuda.synchronize()
    print(json.dumps({"mutant": name, "cases_failed": failed}))
    assert failed, name


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
    for t in (card, place_shard(card, "cpu")):
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


def _k3_cases(ns, fs, device="cuda"):
    """K3's card inputs at (ns, fs): random rows (trivial nodes, full
    nodes, both prefix overrides, skewed bytes so that runs survive
    several rounds) followed by ``k3_edge_inputs`` (knum around 32 and 64,
    runs ending at word boundaries, runs that survive to the last round);
    B = 3,301, no multiple of a block's queries."""
    rng = np.random.default_rng(ns + fs)
    B = 3001
    feats = np.sort(rng.integers(0, 6, size=(B, fs, ns), dtype=np.uint8), -1)
    qfeat = rng.integers(0, 6, size=(B, fs), dtype=np.uint8)
    knum = rng.integers(0, ns + 1, size=B, dtype=np.int32)
    knum[:300] = rng.choice([0, 1, ns], size=300)
    pcmp = rng.choice(np.array([-1, 0, 0, 1], np.int32), size=B)
    edges = k3_edge_inputs(ns * fs, 300, fs, ns)
    return [torch.from_numpy(np.concatenate([x, e])).to(device)
            for x, e in zip((feats, qfeat, knum, pcmp), edges)]


def _k4_cases(ns, device="cuda"):
    """K4's card inputs at ns: random rows (the first five with no slot
    occupied) followed by ``k4_edge_inputs`` (lone candidates in slots 0,
    31, 32, 63, 64 and 127, pairs across the word boundaries, none, all);
    B = 2,349."""
    rng = np.random.default_rng(ns)
    B = 2049
    tags = rng.integers(0, 3, size=(B, ns), dtype=np.uint8)
    occ = rng.random((B, ns)) < 0.6
    occ[:5] = False
    qtag = rng.integers(0, 4, size=B, dtype=np.uint8)
    edges = k4_edge_inputs(ns + 7, 300, ns)
    return [torch.from_numpy(np.concatenate([x, e])).to(device)
            for x, e in zip((tags, occ, qtag), edges)]


@pytest.mark.cuda
@pytest.mark.parametrize("fs,ns", K3_SHAPES)
def test_cuda_feature_branch_matches_plain(cuda_device, ns, fs):
    """K3 equals its plain version bit for bit, stats on and off, at fs 1,
    2, 4, 8 (each a build with every row in registers) and 12 (rows past
    the eighth loaded as their round comes), ns 64 and 128."""
    args = _k3_cases(ns, fs)
    n0 = k3.LAUNCHES
    assert k3_vs_plain(*args) == 0
    assert k3.LAUNCHES == n0 + 2                # stats on and off
    out = k3.feature_branch(*args)
    assert int(out[4].max()) == fs              # some runs survive every row
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("ns", (64, 128))
def test_cuda_leaf_probe_matches_plain(cuda_device, ns):
    tags, occ, qtag = _k4_cases(ns)
    n0 = k4.LAUNCHES
    assert k4_vs_plain(tags, occ, qtag) == 0
    assert k4.LAUNCHES == n0 + 1
    _, first, count = k4.leaf_probe(tags, occ, qtag)
    assert (first[:5] == ns).all() and (count[:5] == 0).all()
    assert {0, 31, 32, 63} <= set(first.tolist())
    torch.cuda.synchronize()


# Faults planted in K3 and K4 (``csrc/feature_branch.cu``,
# ``csrc/leaf_probe.cu`` and the headers they share), each (file, what the
# source says, what the mutant says): the cases of
# test_cuda_feature_branch_matches_plain / test_cuda_leaf_probe_matches_plain
# must catch every one.
_GATHER = "const Packed<W> x = __shfl_sync(gmask, mine, k, G);"
_FIRST = ("  for (int i = 0; i < SlotMask<NS>::kWords; ++i)\n"
          "    if (m.w[i]) return 64 * i + __ffsll")
K3_MUTANTS = {
    # the group's masks take each lane's flags from the next lane
    "group_lane_shifted_by_one": (
        "slots.cuh", _GATHER,
        "const Packed<W> x = __shfl_sync(gmask, mine, (k + 1) % G, G);"),
    # a lane's flags shifted within 32 slots, not 64: slots 32-63 of each
    # word land on 0-31
    "word_shift_mod_32": (
        "slots.cuh", "<< (s % 64);\n    hi.w", "<< (s % 32);\n    hi.w"),
    # run_lo and the resolved index from the highest word that has a bit
    "first_from_highest_word": (
        "slots.cuh", _FIRST,
        "  for (int i = SlotMask<NS>::kWords - 1; i >= 0; --i)\n"
        "    if (m.w[i]) return 64 * i + __ffsll"),
    # a node of one anchor runs the rounds: its rounds are not zeroed
    "trivial_rounds_not_zeroed": (
        "feature_rounds.cuh", "if (knum <= 1) {  // trivial",
        "if (knum <= 0) {  // trivial"),
    # the unsigned less-than compares signed bytes (0x80-0xff below 0)
    "less_than_signed": (
        "slots.cuh", "return ((~a & b) | (~(a ^ b) & ~d)) & 0x80808080u;",
        "return ((a & ~b) | (~(a ^ b) & ~d)) & 0x80808080u;"),
}
K4_MUTANTS = {
    "occ_mask_dropped": (
        "leaf_probe.cu", "eq_hi(tw[w], q4) & nonzero_hi(ow[w])",
        "eq_hi(tw[w], q4)"),
    "group_lane_shifted_by_one": K3_MUTANTS["group_lane_shifted_by_one"],
    "first_from_highest_word": K3_MUTANTS["first_from_highest_word"],
    # cand holds the compare's 0x80, not 1
    "cand_byte_not_one": ("leaf_probe.cu", "cw[w] = hi >> 7;", "cw[w] = hi;"),
}


# Faults planted in K1's group body (``csrc/fused_descent.cu`` and the
# group compares of ``csrc/cmp.cuh``), each (file, what the source says,
# what the mutant says): the mixed lanes of every build in K1_BUILDS must
# catch every one. Each keeps every load inside its table.
K1_MUTANTS = {
    # the group's ballot in a compare read one lane wide (its first lane)
    "compare_mask_one_lane_wide": (
        "cmp.cuh", "const unsigned hit = __ballot_sync(gmask, d != 0) & gmask;",
        "const unsigned hit = __ballot_sync(gmask, d != 0) & gmask & "
        "(gmask & (0u - gmask));"),
    # a word's bytes compared from its last (highest-address) byte
    "word_bytes_high_first": (
        "cmp.cuh", "const int sh = (__ffs(static_cast<int>(x)) - 1) & ~7;",
        "const int sh = (31 - __clz(static_cast<int>(x))) & ~7;"),
    # the group's last differing lane taken for its first
    "last_lane_first": (
        "cmp.cuh", "__shfl_sync(gmask, d, __ffs(static_cast<int>(hit)) - 1)",
        "__shfl_sync(gmask, d, 31 - __clz(static_cast<int>(hit)))"),
    # a slot's key id shuffled from the next lane of the group
    "key_id_from_next_lane": (
        "fused_descent.cu", "pick(r.kid, s % W), s / W, G)",
        "pick(r.kid, s % W), s / W + 1, G)"),
    # the query's feature byte shuffled from the next lane of the group
    "key_byte_from_next_lane": (
        "cmp.cuh", "pick(q.w, word % KW), word / KW, G)",
        "pick(q.w, word % KW), word / KW + 1, G)"),
    # the prefix compare reads past the node's prefix length
    "prefix_length_ignored": (
        "cmp.cuh", "(n >= 4 ? ~0u : (1u << (8 * max(n, 0))) - 1u)", "~0u"),
}


def _build_mutants(kind, mutants, source):
    """Each mutant's copy of ``csrc`` under ``build/<kind>_mutants/`` (never
    the checkout's), built with one ``nvcc`` per mutant, all at once.
    Returns {name: the mutant's copy of ``source``}."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import nvcc
    out = {}
    for name, (fname, old, new) in mutants.items():
        d = nvcc.BUILD_DIR.parent / f"{kind}_mutants" / name
        d.mkdir(parents=True, exist_ok=True)
        for f in list(nvcc.CSRC.glob("*.cuh")) + [source]:
            (d / f.name).write_text(f.read_text())
        text = (d / fname).read_text()
        assert text.count(old) == 1, name
        (d / fname).write_text(text.replace(old, new))
        out[name] = d / source.name
    nvcc.build(out.values())
    return out


@pytest.fixture(scope="module")
def k3_mutants():
    return _build_mutants("k3", K3_MUTANTS, k3cuda.SOURCE)


@pytest.fixture(scope="module")
def k4_mutants():
    return _build_mutants("k4", K4_MUTANTS, k4cuda.SOURCE)


@pytest.fixture(scope="module")
def k1_mutants():
    return _build_mutants("k1", K1_MUTANTS, kcuda.SOURCE)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(K1_MUTANTS))
def test_cuda_k1_cases_reject_planted_faults(cuda_device, k1_mutants, name,
                                             monkeypatch):
    """Each mutant of ``K1_MUTANTS``, swapped in for the kernel, differs
    from the plain version on the mixed lanes of some build of
    ``K1_BUILDS``; the builds it fails are printed."""
    import json
    monkeypatch.setattr(kcuda, "SOURCE", k1_mutants[name])
    monkeypatch.setattr(kcuda, "_FN", None)
    failed = []
    for (kind, ns, S), case in zip(K1_BUILDS, K1_IDS):
        tree, moved = _k1_tree(kind, ns)
        qb, ql, _ = _k1_lanes(tree, moved, 2048)
        try:
            kernel_vs_plain(tree, qb, ql)
        except AssertionError:
            failed.append(case)
    torch.cuda.synchronize()
    print(json.dumps({"mutant": name, "cases_failed": failed}))
    assert failed, name


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(K3_MUTANTS))
def test_cuda_k3_cases_reject_planted_faults(cuda_device, k3_mutants, name,
                                             monkeypatch):
    """Each mutant of ``K3_MUTANTS``, swapped in for the kernel, differs
    from the plain version on some (fs, ns) case; the cases it fails are
    printed."""
    import json
    monkeypatch.setattr(k3cuda, "SOURCE", k3_mutants[name])
    monkeypatch.setattr(k3cuda, "_FN", None)
    failed = []
    for fs, ns in K3_SHAPES:
        try:
            k3_vs_plain(*_k3_cases(ns, fs))
        except AssertionError:
            failed.append(f"fs{fs}-ns{ns}")
    torch.cuda.synchronize()
    print(json.dumps({"mutant": name, "cases_failed": failed}))
    assert failed, name


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(K4_MUTANTS))
def test_cuda_k4_cases_reject_planted_faults(cuda_device, k4_mutants, name,
                                             monkeypatch):
    """Each mutant of ``K4_MUTANTS``, swapped in for the kernel, differs
    from the plain version at ns 64 or 128; the cases it fails are
    printed."""
    import json
    monkeypatch.setattr(k4cuda, "SOURCE", k4_mutants[name])
    monkeypatch.setattr(k4cuda, "_FN", None)
    failed = []
    for ns in (64, 128):
        try:
            k4_vs_plain(*_k4_cases(ns))
        except AssertionError:
            failed.append(f"ns{ns}")
    torch.cuda.synchronize()
    print(json.dumps({"mutant": name, "cases_failed": failed}))
    assert failed, name


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


# ------------------------------------------------------------ K5 (flash)

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_cuda_flash_attention_matches_plain(cuda_device, dtype):
    """K5 against its plain version over ``chip_smoke.K5_CASES``: ragged S
    and T, every mask kind, GQA n_rep in {1, 4, 8}, kv_len < T, rows with
    no valid key (exactly 0); bound ``chip_smoke.k5_tolerance`` (float32:
    1e-4 of max(1, max|v|); bf16: per element, 2^-6 of |out| + 2^-5 of
    sqrt(sum w^2 v^2) + kv_len 2^-24 of sum w|v|)."""
    from repro_torch.kernels.flash_attention import ops as k5
    n0 = k5.LAUNCHES
    out = k5_sweep(cuda_device, dtype, seed=5)
    assert out["failures"] == [], out["failures"]
    # the "flat" cases go to cuda.launch directly, past the counter
    assert k5.LAUNCHES == n0 + sum(c["api"] == "sdpa" for c in K5_CASES)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_sdpa_above_flash_thresh_is_one_k5_launch(cuda_device):
    from repro_torch.kernels.flash_attention import ops as k5
    from repro_torch.models import attention as A
    g = torch.Generator(device="cuda").manual_seed(0)
    S = 2100
    q = torch.randn((1, S, 8, 64), generator=g, device="cuda").bfloat16()
    k = torch.randn((1, S, 2, 64), generator=g, device="cuda").bfloat16()
    v = torch.randn((1, S, 2, 64), generator=g, device="cuda").bfloat16()
    n0 = k5.LAUNCHES
    out = A.sdpa(q, k, v, A.CAUSAL, 4)
    assert k5.LAUNCHES == n0 + 1 and out.shape == (1, S, 8 * 64)
    assert k5_vs_plain(q, k, v, A.CAUSAL, 4, 64 ** -0.5)[
        "max_err_over_tol"] <= 1.0
    small = A.sdpa(q[:, :64], k[:, :64], v[:, :64], A.CAUSAL, 4)
    assert k5.LAUNCHES == n0 + 2 and small.shape == (1, 64, 8 * 64)


@pytest.mark.cuda
def test_cuda_flash_sdpa_counts_only_launches(cuda_device):
    """Empty work launches nothing and counts nothing: no query rows (an
    empty output) and no keys (an output of zeros)."""
    from repro_torch.kernels.flash_attention import ops as k5
    from repro_torch.models.attention import CAUSAL
    q = torch.ones((1, 8, 4, 16), device="cuda", dtype=torch.bfloat16)
    kv = torch.ones((1, 8, 2, 16), device="cuda", dtype=torch.bfloat16)
    n0 = k5.LAUNCHES
    assert k5.flash_sdpa(q[:, :0], kv, kv, CAUSAL, 2, 0.25).shape == (1, 0, 64)
    none = k5.flash_sdpa(q, kv[:, :0], kv[:, :0], CAUSAL, 2, 0.25)
    assert none.shape == (1, 8, 64) and bool((none == 0).all())
    assert k5.LAUNCHES == n0
    k5.flash_sdpa(q, kv, kv, CAUSAL, 2, 0.25)
    assert k5.LAUNCHES == n0 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("hd,causal", ((128, False), (128, True), (64, False),
                                       (112, False), (112, True)))
def test_cuda_k5_p_layout_with_identity_v(cuda_device, hd, causal):
    """v = the identity makes the output the softmax weights themselves,
    column j the weight of key j: a wrong register layout of p (the A
    operand of p·v) or a wrong descriptor of the transposed v moves
    weights to other columns and breaks the bound. At 112 (zamba2's head
    dim, the (128, 128) build zero-padded by TMA) a store of o past column
    112 would overwrite the next row's first columns, and a padded column
    reaching the softmax would move every weight."""
    from chip_smoke import _err_over_tol, k5_tolerance
    from repro_torch.kernels.flash_attention import cuda as k5cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    g = torch.Generator(device="cuda").manual_seed(hd + causal)
    S, T = 200, hd
    q = torch.randn((1, S, hd), generator=g, device="cuda").bfloat16()
    k = torch.randn((1, T, hd), generator=g, device="cuda").bfloat16()
    v = torch.eye(T, hd, device="cuda", dtype=torch.bfloat16)[None]
    kw = dict(scale=hd ** -0.5, kv_len=T, causal=causal, window=0,
              prefix_len=0)
    got, launched = k5cuda.launch(q[:, None], k[:, None], v[:, None],
                                  n_rep=1, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    r = _err_over_tol(got[:, :, 0], want, k5_tolerance(q, k, v, want, **kw))
    assert launched and r["max_err_over_tol"] <= 1.0, r


@pytest.mark.cuda
@pytest.mark.parametrize("causal", (False, True))
def test_cuda_k5_p_layout_with_identity_v_at_192_128(cuda_device, causal):
    """The identity-v check of the (192, 128) build: q/k head dim 192, v =
    the 128 x 128 identity, so the output is the softmax weights of the
    128 keys (12 k-steps of q kᵀ, one q buffer)."""
    from chip_smoke import _err_over_tol, k5_tolerance
    from repro_torch.kernels.flash_attention import cuda as k5cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    g = torch.Generator(device="cuda").manual_seed(192 + causal)
    S, T, hd = 200, 128, 192
    q = torch.randn((1, S, hd), generator=g, device="cuda").bfloat16()
    k = torch.randn((1, T, hd), generator=g, device="cuda").bfloat16()
    v = torch.eye(T, device="cuda", dtype=torch.bfloat16)[None]
    kw = dict(scale=hd ** -0.5, kv_len=T, causal=causal, window=0,
              prefix_len=0)
    got, launched = k5cuda.launch(q[:, None], k[:, None], v[:, None],
                                  n_rep=1, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    r = _err_over_tol(got[:, :, 0], want, k5_tolerance(q, k, v, want, **kw))
    assert launched and r["max_err_over_tol"] <= 1.0, r


@pytest.mark.cuda
@pytest.mark.parametrize("causal", (False, True))
def test_cuda_k5_p_layout_with_identity_v_at_256(cuda_device, causal):
    """The identity-v check of the (256, 256) build: v = the 256 x 256
    identity over 256 keys (four 64-key tiles), so the output is the
    softmax weights themselves (p·v as m64n256k16, v read transposed from
    four 64-column boxes)."""
    from chip_smoke import _err_over_tol, k5_tolerance
    from repro_torch.kernels.flash_attention import cuda as k5cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    g = torch.Generator(device="cuda").manual_seed(256 + causal)
    S, T, hd = 200, 256, 256
    q = torch.randn((1, S, hd), generator=g, device="cuda").bfloat16()
    k = torch.randn((1, T, hd), generator=g, device="cuda").bfloat16()
    v = torch.eye(T, device="cuda", dtype=torch.bfloat16)[None]
    kw = dict(scale=hd ** -0.5, kv_len=T, causal=causal, window=0,
              prefix_len=0)
    got, launched = k5cuda.launch(q[:, None], k[:, None], v[:, None],
                                  n_rep=1, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    r = _err_over_tol(got[:, :, 0], want, k5_tolerance(q, k, v, want, **kw))
    assert launched and r["max_err_over_tol"] <= 1.0, r


# Faults planted in the bf16 kernel (the served path's flash_fwd_wgmma),
# each (what the source says, what the mutant says): the bound of
# chip_smoke.k5_tolerance must reject every one on K5_CASES.
K5_MUTANTS = {
    # items from row 2048 on skip the kv tile of keys 256-383 (producer and
    # consumers alike, through next_live): about 4% of their rows' weight,
    # only in the S = 3072 case
    "late_rows_drop_a_tile": (
        "if (tile_live(a, q0, q_last, kt * bk, min(kt * bk + bk, a.kv_len) "
        "- 1))",
        "if (tile_live(a, q0, q_last, kt * bk, min(kt * bk + bk, a.kv_len) "
        "- 1) && !(kt == 2 && q0 >= 2048))"),
    "sum_not_corrected": ("l_r[r] = l_r[r] * corr[r] + sum[r];",
                          "l_r[r] = l_r[r] + sum[r];"),
    "correction_in_base_e": ("corr[r] = exp2f(m_r[r] - m_new);",
                             "corr[r] = __expf(m_r[r] - m_new);"),
    "window_one_key_wide": (
        "lo[r] = a.causal && a.window ? qi - a.window + 1 : 0;",
        "lo[r] = a.causal && a.window ? qi - a.window : 0;"),
    "diagonal_dropped": (
        "hi[r] = a.causal ? min(qi + 1, a.kv_len) : a.kv_len;",
        "hi[r] = a.causal ? min(qi, a.kv_len) : a.kv_len;"),
    # the (256, 256) build's q kᵀ (64-key tiles, m64n64) adds to the last
    # tile's p instead of starting from 0: only that build's cases may fail
    "qk_accumulates_in_64_key_tiles": ("    wgmma_ss_n64(s, a, b, acc);",
                                       "    wgmma_ss_n64(s, a, b, 1);"),
}
ONLY_256 = {"qk_accumulates_in_64_key_tiles"}


def _build_256(c) -> bool:
    """Whether ``K5_CASES`` case ``c`` runs the (256, 256) build."""
    return c["hd"] > 192 or c.get("hv", c["hd"]) > 128


@pytest.fixture(scope="module")
def k5_mutants():
    """Each mutant's source under ``build/k5_mutants/`` (never the
    checkout's), built with one ``nvcc`` per mutant, all at once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.flash_attention import cuda as k5cuda
    src = k5cuda.SOURCE.read_text()
    out = {}
    for name, (old, new) in K5_MUTANTS.items():
        assert src.count(old) == 1, name
        d = nvcc.BUILD_DIR.parent / "k5_mutants" / name
        d.mkdir(parents=True, exist_ok=True)
        out[name] = d / k5cuda.SOURCE.name
        out[name].write_text(src.replace(old, new))
    nvcc.build(out.values())
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(K5_MUTANTS))
def test_cuda_k5_bound_rejects_planted_faults(cuda_device, k5_mutants, name,
                                              monkeypatch):
    """The bf16 bound is tight enough to see a wrong kernel: each mutant of
    ``K5_MUTANTS``, swapped in for the kernel, fails ``k5_sweep``, and
    fails one of its cases of q/k head dim above 128 (the (192, 128) or
    (256, 256) build) too; a mutant of the (256, 256) build alone
    (``ONLY_256``) fails that build's cases and no other. The worst error, the worst error over the bound and,
    beside them, the largest |v| of 2^-6 (the size of a bound scaled to
    max|v|) are printed."""
    import json
    from repro_torch.kernels.flash_attention import cuda as k5cuda
    monkeypatch.setattr(k5cuda, "SOURCE", k5_mutants[name])
    monkeypatch.setattr(k5cuda, "_FN", None)
    out = k5_sweep(cuda_device, torch.bfloat16, seed=5)
    print(json.dumps({"mutant": name, "bound": K5_BOUND,
                      "max_abs_err": out["max_abs_err"],
                      "max_err_over_tol": out["max_err_over_tol"],
                      "cases_failed": len(out["failures"]),
                      "cases": out["cases"],
                      "failed_cases": out["failed_cases"]}))
    assert out["failures"], name
    assert out["max_err_over_tol"] > 1.0
    assert any(K5_CASES[i]["hd"] > 128 for i in out["failed_cases"]), name
    if name in ONLY_256:
        assert all(_build_256(K5_CASES[i]) for i in out["failed_cases"]), \
            out["failed_cases"]


@pytest.mark.cuda
def test_cuda_flash_attention_rejects_what_the_kernel_does_not_take(
        cuda_device):
    from repro_torch.kernels.flash_attention import cuda as k5cuda
    from repro_torch.kernels.flash_attention import ops as k5
    from repro_torch.models.attention import CAUSAL
    q = torch.zeros((1, 8, 4, 16), device="cuda")
    kv = torch.zeros((1, 8, 2, 16), device="cuda")
    with pytest.raises(TypeError):
        k5.flash_sdpa(q.half(), kv.half(), kv.half(), CAUSAL, 2, 0.25)
    with pytest.raises(TypeError):
        k5.flash_sdpa(q, kv.bfloat16(), kv, CAUSAL, 2, 0.25)
    with pytest.raises(ValueError):
        k5.flash_sdpa(q, kv, kv, CAUSAL, 4, 0.25)      # 4 heads != 2 x 4
    with pytest.raises(ValueError):
        k5.flash_sdpa(q, kv, kv.cpu(), CAUSAL, 2, 0.25)
    big = torch.zeros((1, 8, 2, 264), device="cuda")
    with pytest.raises(ValueError):
        k5.flash_sdpa(big, big, big, CAUSAL, 1, 0.25)  # head dim > 256
    wide = torch.zeros((1, 8, 2, 320), device="cuda")
    with pytest.raises(ValueError):
        k5.flash_sdpa(q, kv, wide, CAUSAL, 2, 0.25)  # v head dim > 256
    buf = torch.zeros(1 + 8 * 4 * 16, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="TMA"):   # base 2 bytes off
        k5.flash_sdpa(buf[1:].view(1, 8, 4, 16), kv.bfloat16(),
                      kv.bfloat16(), CAUSAL, 2, 0.25)
    with pytest.raises(ValueError):     # kv_len past T
        k5cuda.launch(q.permute(0, 2, 1, 3), kv.permute(0, 2, 1, 3),
                      kv.permute(0, 2, 1, 3), n_rep=2, scale=0.25, kv_len=9,
                      causal=True, window=0, prefix_len=0)


# ------------------------------------------------------------------ shards

def _shard_pair(kind, n=6000, seed=9):
    """The same keys in 4 range shards on the card and on the CPU (device
    build, one shared config), and fresh keys to insert."""
    from repro_torch import shard as S
    kb, kl = GEN[kind](n + 800, seed)
    perm = np.random.default_rng(seed).permutation(n + 800)
    kb, kl = kb[perm], kl[perm]
    cfg = TreeConfig.plan(max_keys=int(2.5 * n), key_width=kb.shape[1])
    vals = np.arange(n, dtype=np.int32)
    out = [S.sharded_build(KeySet(kb[:n], kl[:n]), vals, 4, device=True,
                           cfg=cfg, target=d) for d in ("cuda", "cpu")]
    return out, kb, kl, n


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ("ycsb", "url"))
def test_cuda_sharded_ops_match_cpu(cuda_device, kind):
    """Routed lookups, inserts, updates, removes, cross-shard scans and
    rebalance on 4 shards on ``cuda:0`` (K1 and K2) equal the same ops on
    the CPU copy (their plain versions): every output, report and shard
    array."""
    from repro_torch import shard as S
    (card, cpu), kb, kl, n = _shard_pair(kind)
    eng = TraversalEngine("fused")
    rng = np.random.default_rng(1)
    q = rng.integers(0, n + 800, 2048)
    qb, ql = kb[q].copy(), kl[q]
    qb[::5, -1] ^= 0xA5
    new = np.arange(n, n + 800)

    def same(a, b):
        if isinstance(a, torch.Tensor):
            assert a.is_cuda and torch.equal(a.cpu(), b)
        elif hasattr(a, "_fields"):
            for f in a._fields:
                same(getattr(a, f), getattr(b, f))
        elif isinstance(a, tuple):
            for x, y in zip(a, b):
                same(x, y)
        else:
            assert a == b

    def trees(a, b):
        for x, y in zip(a.shards, b.shards):
            assert tree_diffs(x, y) == []

    outs = []
    for st in (card, cpu):
        o = [S.lookup_batch(st, qb, ql, engine=eng)]
        st, rep, r = S.insert_batch(st, kb[new], kl[new],
                                    new.astype(np.int32), engine=eng)
        o.append((rep, r))
        st, rep = S.update_batch(st, qb, ql, np.arange(2048, dtype=np.int32),
                                 engine=eng)
        o.append(rep)
        st, rep = S.remove_batch(st, qb[::3], ql[::3], engine=eng)
        o.append(rep)
        for m in (1, 50, 700):
            o.append(S.range_scan(st, qb, ql, max_items=m, engine=eng))
        o.append(st.key_rows(o[-1][0]))
        st2, rb = S.rebalance(st)
        o.append((rb, S.lookup_batch(st2, qb, ql, engine=eng)))
        outs.append((o, st, st2))
    (oc, sc, sc2), (oh, sh, sh2) = outs
    same(tuple(oc), tuple(oh))
    trees(sc, sh)
    trees(sc2, sh2)
    assert int(oc[6][2].max()) == 700 and bool((oc[6][2] > 0).all())


@pytest.mark.cuda
def test_cuda_k2_parked_lanes_match_plain(cuda_device):
    """K2 on the batches the cross-shard scan gives each shard — lanes not
    active there parked on an all-0xFF start of length key_width, on clean
    and dirtied shards — equals its plain version bit for bit."""
    from repro_torch import shard as S
    from chip_smoke import _Recorder
    (card, _), kb, kl, n = _shard_pair("ycsb")
    eng = TraversalEngine("fused")
    rng = np.random.default_rng(2)
    for dirty in (False, True):
        if dirty:
            new = np.arange(n, n + 800)
            card, _, _ = S.insert_batch(card, kb[new], kl[new],
                                        new.astype(np.int32), engine=eng)
        q = rng.integers(0, n, 1024)
        qb, ql = kb[q].copy(), kl[q]
        qb[::3, -1] ^= 0xA5
        with _Recorder() as rec:
            S.range_scan(card, qb, ql, max_items=300, engine=eng)
        parked = 0
        for t, sqb, sql, mi in rec.calls:
            parked += int(((sql == 24) & (sqb == 0xFF).all(1)).sum())
            assert scan_kernel_vs_plain(t, sqb, sql, mi) == 0
        assert parked > 0 and len(rec.calls) > 1
    # a batch of parked lanes only
    park = torch.full((512, 24), 0xFF, dtype=torch.uint8, device="cuda")
    plen = torch.full((512,), 24, dtype=torch.int32, device="cuda")
    for t in card.shards:
        assert scan_kernel_vs_plain(t, park, plen, 50) == 0


# The flash-attention Function on the card: K5's forward against the plain
# version within chip_smoke.k5_tolerance, and the recompute backward's
# gradients against autograd through the plain version in float32, within
# chip_smoke.k5_grad_tolerance: causal, windowed, prefix and full masks,
# GQA ratios 1, 4 and 8, ragged S and T.
K5_GRAD_CASES = (
    dict(B=1, S=1100, T=1100, H=8, Hk=1, hd=128, mask=("causal", 0, 0)),
    dict(B=2, S=700, T=700, H=8, Hk=2, hd=64, mask=("causal", 128, 0)),
    dict(B=1, S=513, T=513, H=4, Hk=4, hd=128, mask=("causal", 0, 37)),
    dict(B=1, S=300, T=520, H=8, Hk=1, hd=64, mask=("full", 0, 0)),
)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("case", range(len(K5_GRAD_CASES)))
def test_cuda_k5_grads_match_plain(cuda_device, dtype, case):
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.attention import MaskSpec
    c = K5_GRAD_CASES[case]
    gen = torch.Generator(device=cuda_device).manual_seed(case)
    rnd = lambda *s: torch.randn(s, generator=gen, device=cuda_device) \
        .to(dtype)
    q = rnd(c["B"], c["S"], c["H"], c["hd"])
    k = rnd(c["B"], c["T"], c["Hk"], c["hd"])
    v = rnd(c["B"], c["T"], c["Hk"], c["hd"])
    g = rnd(c["B"], c["S"], c["H"] * c["hd"])
    n0 = ops.LAUNCHES
    r = k5_grad_check(q, k, v, g, MaskSpec(*c["mask"]), c["H"] // c["Hk"],
                      c["hd"] ** -0.5)
    assert ops.LAUNCHES - n0 == 1          # the forward: one K5 launch
    assert r["forward"]["max_err_over_tol"] <= 1.0, r
    assert r["backward"]["max_err_over_tol"] <= 1.0, r


@pytest.mark.cuda
def test_cuda_moe_train_step_matches_cpu(cuda_device):
    """One train step of deepseek-v3's SMOKE config (MoE with the sigmoid
    router, MLA, the MTP loss) at seq 2,304 from one state on the card and
    on the CPU: chip_smoke's check (d), within TRAIN_STEP_BOUND; K5 once a
    layer and once in the MTP block, a microbatch."""
    res, fails = train_parity(0, cuda_device, arch="deepseek-v3-671b")
    assert not fails, (fails, res)
    assert res["k5_launches"] == (3 + 1) * 2


@pytest.mark.cuda
@pytest.mark.parametrize("arch,over,launches", (
    ("paligemma-3b", {}, 2 * 2),
    ("whisper-medium", {"enc_seq": 2304}, (2 + 2 + 2) * 2)))
def test_cuda_vlm_and_encdec_train_steps_match_cpu(cuda_device, arch, over,
                                                   launches):
    """One train step of paligemma-3b's SMOKE config (8 patches before
    2,304 text tokens, the prefix-LM mask, the text-only loss) and of
    whisper-medium's (2,304 frames and tokens: K5 in the encoder, the
    decoder's self attention and its cross attention) from one state on
    the card and on the CPU: chip_smoke's check (d), within
    TRAIN_STEP_BOUND; K5 once an attention call, a microbatch."""
    res, fails = train_parity(0, cuda_device, arch=arch, **over)
    assert not fails, (fails, res)
    assert res["k5_launches"] == launches


@pytest.mark.cuda
@pytest.mark.parametrize("arch,launches", (("falcon-mamba-7b", 0),
                                           ("zamba2-7b", 2 * 2)))
def test_cuda_ssm_and_hybrid_train_steps_match_cpu(cuda_device, arch,
                                                   launches):
    """One train step of falcon-mamba-7b's SMOKE config (mamba1's chunked
    scan under autograd, no attention) and of zamba2-7b's (mamba2 and the
    shared block with its LoRA: K5 at S = 2,304 in each of its 2
    occurrences) from one state on the card and on the CPU: chip_smoke's
    check (d), within TRAIN_STEP_BOUND; K5 once an occurrence, a
    microbatch."""
    res, fails = train_parity(0, cuda_device, arch=arch)
    assert not fails, (fails, res)
    assert res["k5_launches"] == launches


@pytest.mark.cuda
def test_cuda_k5_attributes_of_each_build(cuda_device):
    """The four bf16 builds, as ``kernel_attributes`` reads them: (192,
    128) has one q buffer (214,112 bytes of shared memory), (256, 256) one
    q buffer and two stages of 64-key k and v tiles (197,728 bytes), the
    others two q buffers; one block a SM each."""
    from repro_torch.kernels.flash_attention import cuda as k5cuda
    want = {(64, 64): 1024 + 2 * 16384 + 2 * 2 * 16384 + 96,
            (128, 128): 1024 + 2 * 32768 + 2 * 2 * 32768 + 96,
            (192, 128): 1024 + 49152 + 2 * (49152 + 32768) + 96,
            (256, 256): 1024 + 65536 + 2 * (32768 + 32768) + 96}
    for (hd, hv), smem in want.items():
        a = k5cuda.kernel_attributes(hd, hv)
        assert a["dynamic_smem_bytes"] == smem and a["blocks_per_sm"] == 1, a
    assert k5cuda.kernel_attributes(136, 64) == k5cuda.kernel_attributes(
        192, 128)
    assert k5cuda.kernel_attributes(200, 136) == k5cuda.kernel_attributes(
        256, 256)


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu(cuda_device):
    """One train step of yi-9b's SMOKE config at seq 2,304 (K5 on the
    card, the tiled path on the CPU) from one state: chip_smoke's check
    (d), within TRAIN_STEP_BOUND."""
    res, fails = train_parity(0, cuda_device)
    assert not fails, (fails, res)
    assert res["k5_launches"] == 4


# ------------------------------------------------------------------ dedupe

@functools.lru_cache(maxsize=1)
def _dedupe_batches():
    """The batches of ``chip_smoke.dedupe_cases``; ``zipf`` at ycsb-a's
    4,194,304 lanes. Made once, and only where a card is present."""
    return dedupe_cases(seed=11)


def _dedupe_batch(name):
    return tuple(torch.from_numpy(a).cuda() for a in _dedupe_batches()[name])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ("zipf", "distinct", "one_key",
                                  "length_only", "width21", "width28",
                                  "width32", "single"))
def test_cuda_dedupe_matches_plain(cuda_device, name):
    """The dedupe kernel's winners and conflicts equal the plain version's
    (``batch_ops.dedupe_last_wins`` in lane order, on the CPU) bit for bit:
    ycsb-a's zipfian batch, all lanes distinct, one key in every lane, keys
    that differ only in length, each load width, one lane."""
    out = dedupe_vs_plain(*_dedupe_batch(name))
    torch.cuda.synchronize()
    if name == "one_key":
        assert out["conflicts"] == out["lanes"] - 1 and out["probes"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ("zipf", "distinct", "length_only"))
def test_cuda_dedupe_with_forced_collisions_matches_plain(cuda_device, name):
    """A table of B entries (the test-only capacity; the full table of
    ``distinct`` is the worst case of linear probing) forces long probe
    chains: the answers stay those of the plain version."""
    qb, ql = _dedupe_batch(name)
    B = qb.shape[0]
    out = dedupe_vs_plain(qb, ql, capacity=1 << (B - 1).bit_length())
    torch.cuda.synchronize()
    assert out["probes"] > 0


@pytest.mark.cuda
def test_cuda_dedupe_wrapper_counts_and_refuses(cuda_device):
    qb, ql = _dedupe_batch("width28")
    n0 = dd.LAUNCHES
    w, c, p = dd.dedupe_last_lanes(qb, ql)
    assert dd.LAUNCHES == n0 + 3 and p is None
    assert w.is_cuda and w.dtype == torch.bool and c.dtype == torch.int32
    w2, c2, p2 = dd.dedupe_last_lanes(qb, ql, count_probes=True)
    assert torch.equal(w, w2) and torch.equal(c, c2)
    assert p2.dtype == torch.int64 and int(p2) >= 0
    with pytest.raises(ValueError):
        dd.dedupe_last_lanes(qb, ql.cpu())
    with pytest.raises(ValueError):
        ddcuda.launch(qb, ql, capacity=qb.shape[0] // 2)
    empty = ddcuda.launch(qb[:0], ql[:0], count_probes=True)
    assert empty[0].numel() == 0 and int(empty[1]) == 0 and int(empty[2]) == 0
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_masked_update_and_absent_duplicate_inserts_match_cpu(
        cuda_device):
    """An update with repeated keys under a routed mask, an insert whose
    absent keys repeat in the batch (the new key takes its last lane's
    value and one key id) and a masked remove, on the card (the dedupe
    kernel, three launches an op) and on the CPU (the sort): bit-equal
    trees and reports."""
    kb, kl = ycsb_keys(7000, 21)
    rng = np.random.default_rng(21)
    rows = np.sort(rng.choice(7000, 4000, replace=False))
    fresh = np.setdiff1d(np.arange(7000), rows)
    cfg = TreeConfig.plan(max_keys=12000, key_width=24)
    card = bulk_build(cfg, KeySet(kb[rows], kl[rows]),
                      np.arange(4000, dtype=np.int32), target="cuda")
    upd = rows[zipf_indices(rng, 4000, 8192)]
    ins = rng.permutation(np.concatenate([
        fresh[zipf_indices(rng, fresh.size, 2048)],
        rows[rng.integers(0, 4000, 1024)]]))
    rm = rows[zipf_indices(rng, 4000, 2048)]
    upd_mask = rng.random(upd.size) < 0.7
    rm_mask = rng.random(rm.size) < 0.5
    out = []
    for t in (card, place_shard(card, "cpu")):
        eng = TraversalEngine("fused")
        n0 = dd.LAUNCHES
        t, ru = B.update_batch(t, kb[upd], kl[upd],
                               np.arange(upd.size, dtype=np.int32),
                               engine=eng, mask=upd_mask)
        t, ri, rounds = B.insert_batch(t, kb[ins], kl[ins],
                                       np.arange(ins.size, dtype=np.int32)
                                       + 10_000, engine=eng)
        t, rr = B.remove_batch(t, kb[rm], kl[rm], engine=eng, mask=rm_mask)
        out.append((t, (ru, ri, rr), rounds, dd.LAUNCHES - n0))
    (tc, rc, nc, lc), (th, rh, nh, lh) = out
    assert (lc, lh) == (9, 0)
    assert tree_diffs(tc, th) == [] and nc == nh
    for x, y in zip(rc, rh):
        for f in x._fields:
            assert torch.equal(getattr(x, f).cpu(), getattr(y, f)), f
    assert min(int(r.conflicts) for r in rc) > 0
    new = np.unique(fresh[np.isin(fresh, ins)])
    assert int(tc.arrays.key_count) == 4000 + new.size
