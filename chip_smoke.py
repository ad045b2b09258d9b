#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Drives the port's main paths on indexes of the size their users run: the
batched point lookup (``core.batch_ops.lookup_batch`` with
``TraversalEngine("fused")``, one launch of the fused-descent kernel K1 per
batch), YCSB workload E (``insert_batch`` then ``range_scan`` with the
``"fused"`` engine; the scan is one launch of the fused-scan kernel K2),
the device build and ``rebuild``, and the paper's factor analysis (Fig.
12(a)) through the per-level engine ``"cuda"`` (one launch of the
feature-comparison kernel K3 per level) and ``probe_cuda`` (the hashtag
leaf-filter kernel K4):

1. the card's name and power limit;
2. build of every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, sm_90a, all at once) into ``build/kernels/``;
3. ``ycsb``: YCSB-like keys (``user`` + 19 digits, width 24), 10,000,000 of
   them, planned as ``benchmarks/common.py::build_tree`` plans (``max_keys
   = 2.5 n``: ns=64, fs=4, 6 levels): every key is looked up once in
   batches of 65,536, 10% of each batch with its last byte flipped; every
   present key must be found with its value, and K1 must equal the plain
   torch version on the card bit for bit (leaf, path, found, slot, val and
   all six counters; stats on and off, sibling check on and off);
4. ``device-build`` of the same keys (``bulk_build(device=True)``): every
   tree array equal to the host build's;
5. ``ycsb-e`` on the ycsb tree: one scan batch on the clean tree, then 16
   rounds of ``insert_batch`` (3,449 fresh keys, 5% of the round's
   operations) and ``range_scan`` (65,536 starts drawn zipf(0.99) over the
   keys present, a third of them between keys; ``max_items`` 50, as
   ``benchmarks/ycsb.py`` runs workload E). Every inserted key and a sample
   of the original ones must be found; K2 must equal the plain version bit
   for bit on the clean and the dirtied tree (stats on and off, and the
   always-sort plain version), and 1,024 scans of each checked batch must
   equal a numpy oracle of the live keys read back from the tree;
6. ``rebuild``: 4,096 present keys removed from the dirtied tree, then
   ``rebuild`` on the card; the result must equal the host build of the
   live key set, report the expected ``n_live`` and ``reclaimed``, find
   every live key with its value (K1) and no removed one, and scan with no
   dirty leaf (K2);
7. ``factor`` on the rebuilt tree (fs=4) and a device-built fs=2 tree of
   the same keys: base, +prefix, +feature2, +feature4, +hashtag over
   65,536 zipf(0.99) present queries (``benchmarks/factor_analysis.py``);
   every key found with the same value in every step; engine ``"cuda"`` ==
   ``"torch"`` == ``"fused"`` on every output and counter (both layouts,
   stats on and off); K3 and K4 == their plain versions on every level's
   inputs; ``probe_cuda`` == ``leaf.probe``; launches == calls;
8. ``url``: URL keys (width 72, heavy shared prefixes), 1,000,000, the
   checks of 3, plus a tree whose parents are stale (blink sibling hops);
   then ``device-build`` at fs=4 and fs=2 and ``factor`` on those trees,
   with the ``"cuda"`` engine over a stale-parent copy equal to K1;
9. ``url-card-vs-cpu``: inserts (fit and split paths), an update and a
   remove on the url tree on the card and on a CPU copy; every tree array
   must be bit-equal afterwards (no scatter depends on which writer CUDA
   picks);
10. ``int-ns128``: ns=128 with 1,000,000 integer keys (width 8), the checks
    of 3, plus stale parents that need two sibling hops; then
    ``int-ns128-append``: 20,480 keys appended above the maximum in batches
    of 4,096 (leaf splits and inner inserts), found, and K2 held against
    the plain version inside the appended range;
11. timing with CUDA events: K1 on the main lookup batch; K2 on the last
    scan batch of the dirtied and of the clean tree; K3 at every level and
    K4 on the factor batch of the rebuilt tree; the plain versions;
    ``lookup_batch`` (engines ``"fused"`` and ``"cuda"``), ``range_scan``
    and ``insert_batch`` end to end (host clock); each kernel's bound.

Each phase prints one JSON line. The line before the last holds the
kernels table; the last line is ``{"ok": true, "device": ...}``. The script
exits non-zero, with no result, when there is no CUDA device, when the
port's sources are not beside it, or when any check fails. Run:
``python3 chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
INT_OPS_PER_S = 67e12         # H100 SXM non-tensor 32-bit rate, data sheet
SYLL = ["an", "ber", "co", "del", "er", "fo", "gra", "hu", "in", "jo",
        "ka", "lo", "mi", "nor", "ol", "pe", "qua", "ro", "sa", "tu"]
HOSTS = ["http://dbpedia.org/resource/", "http://example.com/a/b/",
         "https://api.service.io/v2/items/", "http://news.site.net/2024/"]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# ----------------------------------------------------------------- key sets
# Vectorised generators with the distributions of
# benchmarks/common.py::make_dataset ("ycsb", "url", "rand-int").

def ycsb_nums(n: int, seed: int) -> np.ndarray:
    """``n`` distinct sorted numbers below 10**18 (the YCSB key ids)."""
    rng = np.random.default_rng(seed)
    nums = np.zeros(0, np.int64)
    while nums.size < n:
        nums = np.unique(np.concatenate(
            [nums, rng.integers(0, 10**18, size=n - nums.size + 1024)]))
    return nums[:n]


def ycsb_encode(nums: np.ndarray):
    """``user`` + the zero-padded 19-digit number, width 24, length 23."""
    n = nums.shape[0]
    kb = np.zeros((n, 24), np.uint8)
    kb[:, :4] = np.frombuffer(b"user", np.uint8)
    for i in range(19):
        kb[:, 4 + i] = (nums // 10**(18 - i)) % 10 + ord("0")
    return kb, np.full(n, 23, np.int32)


def ycsb_keys(n: int, seed: int):
    """``user`` + a zero-padded 19-digit number below 10**18, width 24."""
    return ycsb_encode(ycsb_nums(n, seed))


def zipf_indices(rng, n_keys: int, n_ops: int, theta: float = 0.99):
    """Zipfian (skew ``theta``) request indices over ``n_keys``, the YCSB
    request distribution of ``benchmarks/common.py::zipf_indices``: inverse
    CDF over ranks, ranks decorrelated from key order by a permutation."""
    w = np.arange(1, n_keys + 1, dtype=np.float64) ** (-theta)
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    idx = np.searchsorted(cdf, rng.random(n_ops))
    return rng.permutation(n_keys)[np.clip(idx, 0, n_keys - 1)]


def url_keys(n: int, seed: int):
    """A host drawn by zipf(1.2), then ``word/word_number``, at most 72 B."""
    rng = np.random.default_rng(seed)
    have = np.zeros(0, "S72")
    while have.size < n:
        m = n - have.size + 1024
        host = rng.zipf(1.2, size=m) % len(HOSTS)
        wl = rng.integers(2, 5, size=(m, 2))
        syl = rng.integers(0, len(SYLL), size=(m, 2, 4))
        num = rng.integers(0, 10**9, size=m)
        word = lambda i, w: "".join(SYLL[s] for s in syl[i, w, :wl[i, w]])
        new = np.array([(HOSTS[host[i]] + word(i, 0) + "/" + word(i, 1) + "_"
                         + str(num[i])).encode()[:72] for i in range(m)],
                       dtype="S72")
        have = np.unique(np.concatenate([have, new]))
    have = have[:n]
    return (have.view(np.uint8).reshape(n, 72).copy(),
            np.char.str_len(have).astype(np.int32))


def int_keys(n: int, seed: int):
    """Distinct uniform 63-bit integers, big-endian, width 8."""
    from repro_torch.core.keys import encode_uint64
    rng = np.random.default_rng(seed)
    xs = np.zeros(0, np.int64)
    while xs.size < n:
        xs = np.unique(np.concatenate(
            [xs, rng.integers(0, 2**63, size=n - xs.size + 1024)]))
    xs = rng.permutation(xs[:n])
    return encode_uint64(xs.astype(np.uint64)), np.full(n, 8, np.int32)


# ------------------------------------------------------------ stale parents

def stale_parents(tree, leaves, double: bool = False):
    """A copy of ``tree`` in the state a leaf split leaves before the parent
    learns of it, so lookups need blink sibling hops.

    For each leaf ``i`` of ``leaves``: its last key ``x`` moves to the right
    sibling and ``i``'s high key becomes ``x`` (one hop for ``x``). With
    ``double``, ``x`` and every key of the right sibling ``j`` move to the
    sibling after it and both high keys become ``x`` (two hops for ``x``,
    one for ``j``'s keys). Needs a host-built tree (occupied slots first).
    Returns ``(tree, moved key ids)``.
    """
    a = tree.arrays
    tags, kid, val, occ, high = (t.clone() for t in (
        a.leaf_tags, a.leaf_keyid, a.leaf_val, a.leaf_occ, a.leaf_high))
    nxt = a.leaf_next.cpu().numpy()
    moved = []
    for i in leaves:
        j = int(nxt[i])
        src = [(i, int(occ[i].sum()) - 1)]
        if double:
            dst = int(nxt[j])
            src += [(j, s) for s in range(int(occ[j].sum()))]
            heads = (i, j)
        else:
            dst = j
            heads = (i,)
        x = int(kid[src[0]])
        f = int(occ[dst].sum())
        if f + len(src) > occ.shape[1]:
            raise ValueError(f"stale_parents: leaf {dst} has no room")
        for r, s in src:
            kid[dst, f], val[dst, f], tags[dst, f] = kid[r, s], val[r, s], tags[r, s]
            occ[dst, f] = True
            kid[r, s], val[r, s], tags[r, s], occ[r, s] = -1, 0, 0, False
            f += 1
        for h in heads:
            high[h] = x
        moved.append(x)
    return tree.replace(leaf_tags=tags, leaf_keyid=kid, leaf_val=val,
                        leaf_occ=occ, leaf_high=high), moved


# ------------------------------------------------------------------ checks

def _flat_outputs(outs):
    """(leaf, path, found, slot, val, bstats, lstats) -> {name: tensor}."""
    leaf, path, found, slot, val, bst, lst = outs
    d = {"leaf": leaf, "path": torch.stack(list(path), 1)}
    if found is not None:
        d.update(found=found.to(torch.int32), slot=slot, val=val)
    if bst is not None:
        d.update({f"b.{f}": getattr(bst, f) for f in bst._fields})
    if lst is not None:
        d.update({f"l.{f}": getattr(lst, f) for f in lst._fields})
    return d


def kernel_vs_plain(tree, qb, ql) -> int:
    """Hold the kernel against the plain torch version on the same inputs,
    for traverse and traverse+probe, stats on/off, sibling check on/off.
    Exact: returns the largest absolute difference, which must be 0."""
    from repro_torch.kernels.fused_descent import ops, ref
    worst = 0
    for probe in (True, False):
        for stats in (True, False):
            for sib in (True, False):
                kw = dict(sibling_check=sib, collect_stats=stats)
                if probe:
                    k = ops.fused_traverse_probe(tree, qb, ql, **kw)
                    p = ref.fused_traverse_probe_ref(tree, qb, ql, **kw)
                else:
                    k = ops.fused_traverse(tree, qb, ql, **kw)
                    k = (k[0], k[1], None, None, None, k[2], None)
                    p = ref.fused_traverse_ref(tree, qb, ql, **kw)
                    p = (p[0], p[1], None, None, None, p[2], None)
                dk, dp = _flat_outputs(k), _flat_outputs(p)
                if dk.keys() != dp.keys():
                    raise AssertionError(f"output sets differ: {dk.keys()} "
                                         f"vs {dp.keys()}")
                worst = max(worst, _exact(
                    f"K1 (probe={probe}, stats={stats}, sibling={sib})",
                    list(dk), list(dk.values()), [dp[n] for n in dk]))
    return worst


def _exact(what, names, got, want) -> int:
    """Largest |difference| between two sequences of tensors, which must be
    0 (and agree in dtype and shape)."""
    worst = 0
    for name, a, b in zip(names, got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{what} {name}: {a.dtype}{tuple(a.shape)} "
                                 f"vs {b.dtype}{tuple(b.shape)}")
        diff = int((a.long() - b.long()).abs().max()) if a.numel() else 0
        if diff:
            raise AssertionError(f"{what} differs on {name}: max |diff| "
                                 f"{diff}")
        worst = max(worst, diff)
    return worst


def tree_bytes(tree) -> int:
    a = tree.arrays
    ts = [getattr(a, f) for f in a._fields if f not in ("levels", "stacked")]
    ts += [t for lv in a.levels for t in lv] + list(a.stacked)
    return int(sum(t.numel() * t.element_size() for t in ts))


def run_phase(name, kb, kl, *, ns, batch, seed, device, stale=None):
    """Build, sweep every key through lookup_batch(engine="fused") in
    batches, check values, hold the kernel against the plain version, and
    optionally check a stale-parent copy of the tree."""
    from repro_torch.core import batch_ops, fbtree
    from repro_torch.core.keys import KeySet
    from repro_torch.core.traverse import TraversalEngine
    from repro_torch.kernels.fused_descent import ops

    n, L = kb.shape
    cfg = fbtree.TreeConfig.plan(max_keys=int(n * 2.5), key_width=L, ns=ns)
    t0 = time.perf_counter()
    tree = fbtree.bulk_build(cfg, KeySet(kb, kl), np.arange(n, dtype=np.int32),
                             target=device)
    if tree.device.type == "cuda":
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    rng = np.random.default_rng(seed + 1)
    perm = torch.from_numpy(rng.permutation(n)).to(device)
    flip_all = torch.from_numpy(rng.random(n) < 0.1).to(device)
    kb_d = torch.from_numpy(kb).to(device)
    kl_d = torch.from_numpy(kl).to(device)
    eng = TraversalEngine("fused")
    n_batches = -(-n // batch)
    sums = dict.fromkeys(("feat_rounds", "suffix_bs", "key_compares",
                          "lines_touched", "tag_candidates"), 0)
    present = present_found = flipped = flipped_absent = 0
    first = None

    ops.LAUNCHES = 0                      # counts from the main path only
    for bi in range(n_batches):
        idx = perm[bi * batch:(bi + 1) * batch]
        flip = flip_all[bi * batch:(bi + 1) * batch]
        qb = kb_d[idx].clone()
        qb[:, -1] ^= torch.where(flip, 0xA5, 0).to(torch.uint8)
        ql = kl_d[idx]
        vals, rep = batch_ops.lookup_batch(tree, qb, ql, engine=eng)
        ok = rep.found[~flip] & (vals[~flip] == idx[~flip].to(torch.int32))
        present += int((~flip).sum())
        present_found += int(ok.sum())
        # a flipped byte past the key's length can match no zero-padded key
        past = flip & (ql < L)
        flipped += int(flip.sum())
        flipped_absent += int((flip & ~rep.found).sum())
        if bool(rep.found[past].any()):
            raise AssertionError(f"{name}: a key with a byte flipped past "
                                 f"its length was found")
        for f in sums:
            sums[f] += int(getattr(rep, f).sum())
        if first is None:
            first = (qb, ql)
    launches = ops.LAUNCHES
    if tree.device.type == "cuda" and launches != n_batches:
        raise AssertionError(f"{name}: {launches} kernel launches for "
                             f"{n_batches} lookup_batch calls")
    if present_found != present:
        raise AssertionError(f"{name}: {present - present_found} of "
                             f"{present} present keys not found with their "
                             f"value")

    # the ragged last batch and the first one, against the plain version
    err = kernel_vs_plain(tree, *first)
    last = perm[(n_batches - 1) * batch:]
    err = max(err, kernel_vs_plain(tree, kb_d[last], kl_d[last]))
    out = {"phase": name, "keys": n, "width": L, "ns": ns, "fs": cfg.fs,
           "n_levels": cfg.n_levels, "tree_bytes": tree_bytes(tree),
           "host_build_s": build_s, "batch": batch, "batches": n_batches,
           "launches": launches, "present": present,
           "present_found": present_found, "flipped": flipped,
           "flipped_absent": flipped_absent,
           "per_op": {f: v / n for f, v in sums.items()},
           "kernel_vs_plain_max_abs_err": err}

    if stale is not None:
        nl = int(tree.arrays.leaf_count)
        leaves = list(range(3, nl - 3, max(1, (nl - 6) // 64)))[:64]
        st, moved = stale_parents(tree, leaves, double=(stale == "double"))
        qi = torch.tensor(moved, device=device, dtype=torch.long)
        # look the moved keys up by their bytes in the stale tree
        qb, ql = st.arrays.key_bytes[qi], st.arrays.key_lens[qi]
        vals, rep = batch_ops.lookup_batch(st, qb, ql, engine=eng)
        leaf, _, hstats = TraversalEngine("fused").traverse(st, qb, ql)
        if not bool(rep.found.all()):
            raise AssertionError(f"{name}: moved keys lost in the stale tree")
        want_hops = 2 if stale == "double" else 1
        if not bool((hstats.sibling_hops == want_hops).all()):
            raise AssertionError(f"{name}: expected {want_hops} sibling hops")
        err = max(err, kernel_vs_plain(st, qb, ql))
        out.update(stale_parents=len(moved), stale_hops=want_hops,
                   kernel_vs_plain_max_abs_err=err)
    emit(out)
    return tree, first, out


# ------------------------------------------------------------------- trees

def tree_to(tree, device):
    """A copy of ``tree`` with every array on ``device``."""
    from repro_torch.core.fbtree import FBTree, Level
    a = tree.arrays
    mv = lambda t: t.to(device, copy=True)
    flat = {f: mv(getattr(a, f)) for f in a._fields
            if f not in ("levels", "stacked")}
    return FBTree(tree.config, a._replace(
        levels=tuple(Level(*map(mv, lv)) for lv in a.levels),
        stacked=Level(*map(mv, a.stacked)), **flat))


def tree_fields(tree):
    """Every array of the tree by name, levels and stacked copy included."""
    a = tree.arrays
    for f in a._fields:
        v = getattr(a, f)
        if f == "levels":
            for i, lv in enumerate(v):
                for g in lv._fields:
                    yield f"levels[{i}].{g}", getattr(lv, g)
        elif f == "stacked":
            for g in v._fields:
                yield f"stacked.{g}", getattr(v, g)
        else:
            yield f, v


def tree_diffs(ta, tb):
    """Names of the arrays that differ in dtype, shape or any value."""
    out = []
    for (name, x), (_, y) in zip(tree_fields(ta), tree_fields(tb)):
        if x.device != y.device:
            x, y = x.cpu(), y.cpu()
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y):
            out.append(name)
    return out


# ------------------------------------------------------------------- scans

SCAN_OUT = ("out_kid", "out_val", "emitted", "rearranged")


def scan_kernel_vs_plain(tree, qb, ql, max_items: int) -> int:
    """Hold K2 against the plain torch version on the same inputs, stats on
    and off, and against the always-sort plain version. Exact: returns the
    largest absolute difference, which must be 0."""
    from repro_torch.kernels.fused_scan import ops, ref
    worst = 0
    for stats in (True, False):
        k = ops.fused_range_scan(tree, qb, ql, max_items=max_items,
                                 collect_stats=stats)
        for force in (False, True):
            p = ref.fused_range_scan_ref(tree, qb, ql, max_items=max_items,
                                         collect_stats=stats, force_sort=force)
            worst = max(worst, _exact(
                f"K2 (stats={stats}, force_sort={force})", SCAN_OUT, k, p))
    return worst


def scan_oracle_check(tree, qb, ql, out, max_items: int, n_check: int,
                      seed: int) -> int:
    """Hold ``n_check`` scans of a batch against a numpy oracle: the live
    keys read back from the tree's arrays, sorted by bytes then length; a
    scan must return the first ``max_items`` keys >= its start. Returns the
    number of scans checked."""
    from repro_torch.core.keys import pack_words
    a = tree.arrays
    kid_t = a.leaf_keyid[a.leaf_occ]
    kid = kid_t.cpu().numpy()
    val = a.leaf_val[a.leaf_occ].cpu().numpy()
    kb = a.key_bytes[kid_t.long()].cpu().numpy()
    kl = a.key_lens[kid_t.long()].cpu().numpy()
    pick = np.random.default_rng(seed).choice(qb.shape[0], n_check,
                                              replace=False)
    qbn, qln = qb.cpu().numpy()[pick], ql.cpu().numpy()[pick]
    n = kid.shape[0]
    # one lexsort of keys and starts together; a start sorts before a key
    # equal to it (flag 0 < 1), so the keys before it are the keys < start
    words = pack_words(np.concatenate([kb, qbn]))
    lens = np.concatenate([kl, qln])
    flag = np.concatenate([np.ones(n, np.int8), np.zeros(n_check, np.int8)])
    order = np.lexsort([flag, lens] + [words[:, i] for i in
                                       range(words.shape[1] - 1, -1, -1)])
    is_key = flag[order] == 1
    before = np.cumsum(is_key) - is_key
    pos = np.empty(n_check, np.int64)
    pos[order[~is_key] - n] = before[~is_key]
    s_kid, s_val = kid[order[is_key]], val[order[is_key]]
    at = pos[:, None] + np.arange(max_items)[None, :]
    ok = at < n
    want_kid = np.where(ok, s_kid[np.minimum(at, n - 1)], -1)
    want_val = np.where(ok, s_val[np.minimum(at, n - 1)], 0)
    got = [o.cpu().numpy()[pick] for o in out[:3]]
    for name, g, w in (("out_kid", got[0], want_kid),
                       ("out_val", got[1], want_val),
                       ("emitted", got[2], ok.sum(1))):
        bad = np.nonzero((g != w).reshape(n_check, -1).any(1))[0]
        if bad.size:
            raise AssertionError(f"scan != oracle on {name} for "
                                 f"{bad.size} of {n_check} starts")
    return n_check


# ------------------------------------------------------------------ ycsb-e

def run_ycsb_e(tree, kb, kl, *, seed, device, rounds=16, n_ins=3449,
               batch=65_536, max_items=50, n_check=1024):
    """YCSB workload E on the main tree: a scan batch on the clean tree,
    then ``rounds`` x (insert ``n_ins`` fresh keys, scan ``batch`` zipf
    starts), all through the ``"fused"`` engine; then the checks."""
    from repro_torch.core import batch_ops
    from repro_torch.core.traverse import TraversalEngine
    from repro_torch.kernels.fused_descent import ops as k1
    from repro_torch.kernels.fused_scan import ops as k2

    n = kb.shape[0]
    rng = np.random.default_rng(seed + 2)
    need = rounds * n_ins
    nums = np.zeros(n, np.int64)
    for i in range(19):
        nums = nums * 10 + (kb[:, 4 + i] - ord("0"))
    cand = np.unique(rng.integers(0, 10**18, size=2 * need))
    cand = cand[~np.isin(cand, nums)]
    fresh = rng.permutation(cand)[:need]
    ins_kb, ins_kl = ycsb_encode(fresh)
    ins_val = (n + np.arange(need)).astype(np.int32)
    kb_d = torch.from_numpy(np.concatenate([kb, ins_kb])).to(device)
    kl_d = torch.from_numpy(np.concatenate([kl, ins_kl])).to(device)
    val_d = torch.from_numpy(ins_val).to(device)
    eng = TraversalEngine("fused")
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))

    def scan(t, n_present):
        idx = torch.from_numpy(zipf_indices(rng, n_present, batch)).to(device)
        flip = torch.from_numpy(rng.random(batch) < 1 / 3).to(device)
        qb = kb_d[idx].clone()
        qb[:, -1] ^= torch.where(flip, 0xA5, 0).to(torch.uint8)
        ql = kl_d[idx]
        return qb, ql, batch_ops.range_scan(t, qb, ql, max_items=max_items,
                                            engine=eng)

    clean = tree
    k1.LAUNCHES = k2.LAUNCHES = 0          # counts from this path only
    first = scan(tree, n)
    ins_ms, ins_k1, splits, ins_rounds = [], [], 0, 0
    for r in range(rounds):
        sl = slice(r * n_ins, (r + 1) * n_ins)
        sync()
        t0, l0 = time.perf_counter(), k1.LAUNCHES
        tree, rep, nr = batch_ops.insert_batch(
            tree, kb_d[n:][sl], kl_d[n:][sl], val_d[sl], engine=eng)
        sync()
        ins_ms.append((time.perf_counter() - t0) * 1e3)
        ins_k1.append(k1.LAUNCHES - l0)
        if bool(rep.found.any()):
            raise AssertionError("ycsb-e: a fresh key was already present")
        splits += int(rep.splits)
        ins_rounds += nr
        last = scan(tree, n + (r + 1) * n_ins)
    scan_launches, k1_launches = k2.LAUNCHES, k1.LAUNCHES
    if torch.device(device).type == "cuda" and scan_launches != rounds + 1:
        raise AssertionError(f"ycsb-e: {scan_launches} K2 launches for "
                             f"{rounds + 1} range_scan calls")

    vals, rep = batch_ops.lookup_batch(tree, kb_d[n:], kl_d[n:], engine=eng)
    ins_found = int((rep.found & (vals == val_d)).sum())
    sample = torch.from_numpy(rng.choice(n, batch, replace=False)).to(device)
    vals, rep = batch_ops.lookup_batch(tree, kb_d[sample], kl_d[sample],
                                       engine=eng)
    orig_found = int((rep.found & (vals == sample.to(torch.int32))).sum())
    if ins_found != need or orig_found != batch:
        raise AssertionError(f"ycsb-e: found {ins_found} of {need} inserted "
                             f"and {orig_found} of {batch} original keys")
    err = max(scan_kernel_vs_plain(clean, *first[:2], max_items),
              scan_kernel_vs_plain(tree, *last[:2], max_items))
    checked = (scan_oracle_check(clean, *first, max_items, n_check, seed)
               + scan_oracle_check(tree, *last, max_items, n_check, seed))
    rearr_clean, rearr_last = int(first[2][3].sum()), int(last[2][3].sum())
    if rearr_clean != 0 or rearr_last <= 0:
        raise AssertionError(f"ycsb-e: rearranged {rearr_clean} on the clean "
                             f"batch, {rearr_last} after the inserts")
    a = tree.arrays
    nl = int(a.leaf_count)
    out = {"phase": "ycsb-e", "keys": n, "rounds": rounds,
           "inserts_per_round": n_ins, "scan_batch": batch,
           "max_items": max_items, "range_scan_calls": rounds + 1,
           "k2_launches": scan_launches, "k1_launches_in_inserts": k1_launches,
           "insert_rounds": ins_rounds, "splits": splits,
           "leaves": nl,
           "dirty_leaf_share": float((~a.leaf_ordered[:nl]).float().mean()),
           "inserted_found": ins_found, "original_sample_found": orig_found,
           "emitted_per_scan_last": float(last[2][2].float().mean()),
           "rearranged_clean": rearr_clean, "rearranged_last": rearr_last,
           "oracle_scans_checked": checked,
           "kernel_vs_plain_max_abs_err": err,
           "insert_batch_ms_median": statistics.median(ins_ms),
           "insert_batch_k1_launches": ins_k1,
           "tree_bytes": tree_bytes(tree)}
    emit(out)
    return clean, tree, first, last, (ins_kb, ins_kl, ins_val), out


def run_append(tree, kb, *, seed, device, n_app=20_480, batch=4096,
               max_items=50):
    """Append ``n_app`` keys above the tree's maximum in batches (monotone
    appends split the rightmost leaf every round and insert into its
    parents), find them, and hold K2 against the plain version on scans
    that start inside the appended range."""
    from repro_torch.core import batch_ops
    from repro_torch.core.keys import decode_uint64, encode_uint64
    from repro_torch.core.traverse import TraversalEngine

    rng = np.random.default_rng(seed + 3)
    top = decode_uint64(kb).max()
    new = top + np.uint64(1) + np.arange(n_app, dtype=np.uint64) * np.uint64(3)
    app_kb = torch.from_numpy(encode_uint64(new)).to(device)
    app_kl = torch.full((n_app,), 8, dtype=torch.int32, device=device)
    app_val = torch.arange(n_app, dtype=torch.int32, device=device) + 2**29
    eng = TraversalEngine("fused")
    counts0 = [int(lv.count) for lv in tree.arrays.levels]
    splits = rounds = 0
    for lo in range(0, n_app, batch):
        tree, rep, nr = batch_ops.insert_batch(
            tree, app_kb[lo:lo + batch], app_kl[lo:lo + batch],
            app_val[lo:lo + batch], engine=eng)
        splits += int(rep.splits)
        rounds += nr
    vals, rep = batch_ops.lookup_batch(tree, app_kb, app_kl, engine=eng)
    found = int((rep.found & (vals == app_val)).sum())
    if splits <= 0 or found != n_app:
        raise AssertionError(f"append: {splits} splits, {found} of {n_app} "
                             f"appended keys found")
    idx = torch.from_numpy(rng.choice(n_app, batch, replace=False)).to(device)
    qb, ql = app_kb[idx].clone(), app_kl[idx]
    qb[::3, -1] ^= 0xA5
    err = scan_kernel_vs_plain(tree, qb, ql, max_items)
    out = {"phase": "int-ns128-append", "appended": n_app, "batch": batch,
           "insert_rounds": rounds, "splits": splits, "appended_found": found,
           "level_counts_before": counts0,
           "level_counts_after": [int(lv.count) for lv in tree.arrays.levels],
           "scan_starts_checked": batch, "kernel_vs_plain_max_abs_err": err}
    emit(out)
    return out


def run_card_vs_cpu(tree, kb, kl, *, seed, device, n_batches=8, batch=4096):
    """The same inserts, update and remove on the tree on ``device`` and on
    a CPU copy; afterwards every tree array must be bit-equal. Half of each
    insert batch is fresh URL keys spread over the tree (fit path), half is
    existing keys with ``~`` appended, taken from one run of neighbouring
    keys, so they pile into a few leaves and split them."""
    from repro_torch.core import batch_ops
    from repro_torch.core.traverse import TraversalEngine

    rng = np.random.default_rng(seed + 4)
    n, L = kb.shape
    half = batch // 2
    existing = kb.view(f"S{L}").ravel()
    fresh_kb, _ = url_keys(2 * n_batches * half, seed + 5)
    fresh = fresh_kb.view(f"S{L}").ravel()
    fresh = rng.permutation(fresh[~np.isin(fresh, existing)])[
        :n_batches * half]
    short = np.nonzero(kl < L)[0]
    starts = rng.choice(short.size // half, n_batches, replace=False) * half
    derived = []
    for s in starts:
        rows = kb[short[s:s + half]].copy()
        rows[np.arange(half), kl[short[s:s + half]]] = ord("~")
        derived.append(rows.view(f"S{L}").ravel())
    ins = np.concatenate([np.stack([fresh[i * half:(i + 1) * half], d])
                          .ravel() for i, d in enumerate(derived)])
    ins = ins.view(np.uint8).reshape(-1, L)
    ins_kl = (ins != 0).sum(1).astype(np.int32)
    ins_val = (2**29 + np.arange(ins.shape[0])).astype(np.int32)
    upd_idx = rng.choice(n, batch, replace=False)
    upd_mask = rng.random(batch) < 0.8
    rm_kb = np.concatenate([kb[rng.choice(n, half, replace=False)],
                            ins[rng.choice(ins.shape[0], half, replace=False)]])
    rm_kl = (rm_kb != 0).sum(1).astype(np.int32)

    def drive(t, dev):
        eng = TraversalEngine("fused")
        reps, splits, rounds = [], 0, 0
        t0 = time.perf_counter()
        for i in range(n_batches):
            sl = slice(i * batch, (i + 1) * batch)
            t, rep, nr = batch_ops.insert_batch(t, ins[sl], ins_kl[sl],
                                                ins_val[sl], engine=eng)
            reps.append(rep)
            splits += int(rep.splits)
            rounds += nr
        t, rep = batch_ops.update_batch(
            t, kb[upd_idx], kl[upd_idx], np.arange(batch, dtype=np.int32),
            engine=eng, mask=upd_mask)
        reps.append(rep)
        t, rep = batch_ops.remove_batch(t, rm_kb, rm_kl, engine=eng)
        reps.append(rep)
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        return t, reps, splits, rounds, time.perf_counter() - t0

    card, card_reps, splits, rounds, card_s = drive(tree, device)
    host, host_reps, h_splits, h_rounds, host_s = drive(tree_to(tree, "cpu"),
                                                        "cpu")
    diffs = tree_diffs(card, host)
    rep_diffs = [f"op{i}.{f}" for i, (x, y) in enumerate(zip(card_reps,
                                                             host_reps))
                 for f in x._fields
                 if not torch.equal(getattr(x, f).cpu(), getattr(y, f))]
    n_fields = sum(1 for _ in tree_fields(card))
    if diffs or rep_diffs or (splits, rounds) != (h_splits, h_rounds):
        raise AssertionError(f"card != cpu: arrays {diffs}, reports "
                             f"{rep_diffs}, splits/rounds {(splits, rounds)} "
                             f"vs {(h_splits, h_rounds)}")
    if splits <= 0:
        raise AssertionError("url-card-vs-cpu: the inserts split no leaf")
    out = {"phase": "url-card-vs-cpu", "keys": n, "insert_batches": n_batches,
           "batch": batch, "inserted": int(ins.shape[0]),
           "insert_rounds": rounds, "splits": splits,
           "updated_lanes": int(upd_mask.sum()), "removed_lanes": batch,
           "fields_compared": n_fields, "fields_equal": n_fields - len(diffs),
           "card_s": card_s, "cpu_s": host_s}
    emit(out)
    return out


# ------------------------------------------------------- build and rebuild

def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_device_build(name, kb, kl, cfg, *, device, host=None, host_s=None):
    """``bulk_build(device=True)`` on ``device`` against the host build of
    the same keys (values ``arange(n)``; ``host``, built here when not
    given, and ``host_s`` its build time): every tree array bit-equal.
    Returns ``(device-built tree, phase line)``."""
    from repro_torch.core import fbtree
    from repro_torch.core.keys import KeySet
    n = kb.shape[0]
    vals = np.arange(n, dtype=np.int32)
    if host is None:
        t0 = time.perf_counter()
        host = fbtree.bulk_build(cfg, KeySet(kb, kl), vals, target=device)
        _sync(device)
        host_s = time.perf_counter() - t0
    _sync(device)
    t0 = time.perf_counter()
    built = fbtree.bulk_build(cfg, KeySet(kb, kl), vals, device=True,
                              target=device)
    _sync(device)
    dev_s = time.perf_counter() - t0
    diffs = tree_diffs(built, host)
    n_fields = sum(1 for _ in tree_fields(built))
    if diffs:
        raise AssertionError(f"device-build {name}: arrays differ from the "
                             f"host build: {diffs}")
    out = {"phase": "device-build", "tree": name, "keys": n, "fs": cfg.fs,
           "ns": cfg.ns, "n_levels": cfg.n_levels, "device_build_s": dev_s,
           "host_build_s": host_s, "fields_compared": n_fields,
           "fields_equal": n_fields - len(diffs)}
    emit(out)
    return built, out


def _lookup_in_batches(tree, kb_d, kl_d, batch, engine):
    """(found, vals) of every row of ``kb_d`` through ``lookup_batch``."""
    from repro_torch.core import batch_ops
    found, vals = [], []
    for lo in range(0, kb_d.shape[0], batch):
        v, rep = batch_ops.lookup_batch(tree, kb_d[lo:lo + batch],
                                        kl_d[lo:lo + batch], engine=engine)
        found.append(rep.found)
        vals.append(v)
    return torch.cat(found), torch.cat(vals)


def run_rebuild(dirty, kb, kl, inserts, *, seed, device, n_remove=4096,
                batch=65_536, max_items=50):
    """Remove ``n_remove`` present keys from the tree YCSB-E dirtied, then
    ``rebuild`` it on the card: the result must equal the host build of the
    live key set (the script's own oracle) in every array, report the
    expected ``n_live`` and ``reclaimed``, find every live key with its
    value through K1 and no removed one, and scan with no dirty leaf (K2's
    ``rearranged`` 0). Returns ``(rebuilt tree, (live kb, kl, vals))``."""
    from repro_torch.core import batch_ops, fbtree
    from repro_torch.core.keys import KeySet
    from repro_torch.core.traverse import TraversalEngine
    from repro_torch.kernels.fused_scan import ops as k2

    ins_kb, ins_kl, ins_val = inserts
    n = kb.shape[0]
    all_kb = np.concatenate([kb, ins_kb])
    all_kl = np.concatenate([kl, ins_kl])
    all_val = np.concatenate([np.arange(n, dtype=np.int32), ins_val])
    total = all_kb.shape[0]
    rng = np.random.default_rng(seed + 6)
    rm = rng.choice(total, n_remove, replace=False)
    eng = TraversalEngine("fused")
    tree, rep = batch_ops.remove_batch(dirty, all_kb[rm], all_kl[rm],
                                       engine=eng)
    if not bool(rep.found.all()):
        raise AssertionError("rebuild: a key chosen for removal was absent")
    live = np.ones(total, bool)
    live[rm] = False
    key_count = int(tree.arrays.key_count)

    _sync(device)
    base = torch.cuda.memory_allocated() if tree.device.type == "cuda" else 0
    if tree.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rebuilt, brep = batch_ops.rebuild(tree)
    _sync(device)
    rebuild_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() if tree.device.type == "cuda"
            else 0)
    del tree
    n_live, n_leaves, reclaimed, error = (int(x) for x in brep)
    if (error or n_live != int(live.sum()) or reclaimed != key_count - n_live
            or reclaimed != n_remove):
        raise AssertionError(f"rebuild: report {brep}, expected n_live "
                             f"{int(live.sum())}, reclaimed {n_remove}")

    lkb, lkl, lval = all_kb[live], all_kl[live], all_val[live]
    t0 = time.perf_counter()
    fresh = fbtree.bulk_build(rebuilt.config, KeySet(lkb, lkl), lval,
                              target=device)
    _sync(device)
    host_s = time.perf_counter() - t0
    diffs = tree_diffs(rebuilt, fresh)
    n_fields = sum(1 for _ in tree_fields(rebuilt))
    del fresh
    if diffs:
        raise AssertionError(f"rebuild != host build of the live set: "
                             f"{diffs}")

    # by value: key ids are not stable across a rebuild
    ins_live = live[n:]
    found, vals = _lookup_in_batches(
        rebuilt, torch.from_numpy(ins_kb[ins_live]).to(device),
        torch.from_numpy(ins_kl[ins_live]).to(device), batch, eng)
    ins_found = int((found & (vals == torch.from_numpy(
        ins_val[ins_live]).to(device))).sum())
    sample = rng.choice(n_live, batch, replace=False)
    found, vals = _lookup_in_batches(
        rebuilt, torch.from_numpy(lkb[sample]).to(device),
        torch.from_numpy(lkl[sample]).to(device), batch, eng)
    sample_found = int((found & (vals == torch.from_numpy(
        lval[sample]).to(device))).sum())
    found, _ = _lookup_in_batches(
        rebuilt, torch.from_numpy(all_kb[rm]).to(device),
        torch.from_numpy(all_kl[rm]).to(device), batch, eng)
    removed_found = int(found.sum())
    if (ins_found != int(ins_live.sum()) or sample_found != batch
            or removed_found):
        raise AssertionError(
            f"rebuild: found {ins_found} of {int(ins_live.sum())} live "
            f"inserted keys, {sample_found} of {batch} sampled live keys, "
            f"{removed_found} removed keys")

    idx = torch.from_numpy(zipf_indices(rng, n_live, batch)).to(device)
    qb = torch.from_numpy(lkb).to(device)[idx]
    ql = torch.from_numpy(lkl).to(device)[idx]
    qb[::3, -1] ^= 0xA5
    l0 = k2.LAUNCHES
    _, _, emitted, rearranged = batch_ops.range_scan(
        rebuilt, qb, ql, max_items=max_items, engine=eng)
    if rebuilt.device.type == "cuda" and k2.LAUNCHES != l0 + 1:
        raise AssertionError("rebuild: range_scan did not launch K2 once")
    rearr = int(rearranged.sum())
    if rearr != 0:
        raise AssertionError(f"rebuild: {rearr} dirty leaves scanned in the "
                             f"rebuilt tree")
    err = scan_kernel_vs_plain(rebuilt, qb, ql, max_items)
    out = {"phase": "rebuild", "keys_before": total, "removed": n_remove,
           "n_live": n_live, "n_leaves": n_leaves, "reclaimed": reclaimed,
           "error": bool(error), "rebuild_s": rebuild_s,
           "peak_bytes": peak, "bytes_before": base,
           "host_build_of_live_set_s": host_s,
           "fields_compared": n_fields, "fields_equal": n_fields - len(diffs),
           "inserted_live_found": ins_found, "live_sample_found": sample_found,
           "removed_found": removed_found,
           "emitted_per_scan": float(emitted.float().mean()),
           "rearranged": rearr, "scan_kernel_vs_plain_max_abs_err": err,
           "tree_bytes": tree_bytes(rebuilt)}
    emit(out)
    return rebuilt, (lkb, lkl, lval), out


# ---------------------------------------------------------- factor analysis

# (label, fs of the tree, variant) — benchmarks/factor_analysis.py's plan
FACTOR_STEPS = (("base", 4, "base"), ("+prefix", 4, "prefix"),
                ("+feature2", 2, "feature"), ("+feature4", 4, "feature"),
                ("+hashtag", 4, "feature+hash"))
K3_OUT = ("idx", "resolved", "run_lo", "run_hi", "rounds")
K4_OUT = ("cand", "first", "count")


def k3_vs_plain(feats, qfeat, knum, pcmp) -> int:
    """K3 against its plain version on the same inputs, stats on and off."""
    from repro_torch.kernels.feature_branch import ops, ref
    worst = 0
    for stats in (True, False):
        k = ops.feature_branch(feats, qfeat, knum, pcmp, collect_stats=stats)
        p = list(ref.feature_compare_rounds(feats, qfeat, knum, pcmp,
                                            collect_stats=stats))
        p[1] = p[1].to(torch.int32)
        worst = max(worst, _exact(f"K3 (stats={stats})", K3_OUT, k, p))
    return worst


def k4_vs_plain(tags, occ, qtag) -> int:
    """K4 against its plain version on the same inputs."""
    from repro_torch.kernels.leaf_probe import ops, ref
    return _exact("K4", K4_OUT, ops.leaf_probe(tags, occ, qtag),
                  ref.leaf_probe_ref(tags, occ, qtag))


def _variant_outputs(out):
    """(found, val, stats, leaf stats) -> {name: tensor}."""
    found, val, st, ls = out
    d = {"found": found.to(torch.int32), "val": val}
    d.update({f"b.{f}": getattr(st, f) for f in st._fields})
    d.update({f"l.{f}": getattr(ls, f) for f in ls._fields})
    return d


def engine_parity(tree, qb, ql) -> int:
    """Engine "cuda" (K3 per level) against "torch" and K1's "fused", both
    layouts, stats on and off: the descent (leaf ids, per-level paths,
    counters) and the feature variants of lookup_variant must be equal."""
    from repro_torch.core.baseline import lookup_variant
    from repro_torch.core.traverse import TraversalEngine
    worst = 0
    for stats in (True, False):
        engines = [TraversalEngine(b, l, collect_stats=stats)
                   for b in ("cuda", "torch") for l in ("tuple", "stacked")]
        engines.append(TraversalEngine("fused", collect_stats=stats))
        ref_d = ref_v = None
        for eng in engines:
            leaf, path, st = eng.traverse(tree, qb, ql)
            d = _flat_outputs((leaf, path, None, None, None, st, None))
            v = [_variant_outputs(lookup_variant(tree, qb, ql, var, eng))
                 for var in ("feature", "feature+hash")]
            if ref_d is None:
                ref_d, ref_v = d, v
                continue
            what = f"engine {eng.backend}/{eng.layout} (stats={stats})"
            worst = max(worst, _exact(what, list(d), list(d.values()),
                                      [ref_d[k] for k in d]))
            for x, y in zip(v, ref_v):
                worst = max(worst, _exact(what, list(x), list(x.values()),
                                          [y[k] for k in x]))
    return worst


def run_factor(name, trees, kb, kl, vals, *, seed, device, batch=65_536,
               stale=False):
    """The five steps of the paper's Fig. 12(a) over the trees of ``trees``
    (fs -> tree of the same keys): 65,536 zipf(0.99) present queries through
    ``lookup_variant`` with ``TraversalEngine("cuda", "stacked")`` (K3 on
    every level of the feature steps), then K4 through ``probe_cuda`` on the
    +hashtag leaves. All keys found with the same values in every step.
    Then, outside the counted path: engine "cuda" == "torch" == "fused", K3
    and K4 == their plain versions on every level's inputs, ``probe_cuda``
    == ``leaf.probe``, and (``stale``) the cuda engine over a stale-parent
    copy == K1."""
    from repro_torch.core import batch_ops
    from repro_torch.core.baseline import lookup_variant
    from repro_torch.core.branch import level_inputs
    from repro_torch.core.keys import fnv1a_tags
    from repro_torch.core.leaf import probe
    from repro_torch.core.traverse import TraversalEngine
    from repro_torch.kernels.feature_branch import ops as k3
    from repro_torch.kernels.leaf_probe import ops as k4

    rng = np.random.default_rng(seed + 7)
    n = kb.shape[0]
    idx = torch.from_numpy(zipf_indices(rng, n, batch)).to(device)
    qb = torch.from_numpy(kb).to(device)[idx]
    ql = torch.from_numpy(kl).to(device)[idx]
    want = torch.from_numpy(vals).to(device)[idx]
    eng = TraversalEngine("cuda", "stacked")
    n_levels = trees[4].config.n_levels
    on_card = torch.device(device).type == "cuda"

    k3.LAUNCHES = k4.LAUNCHES = 0          # counts from this path only
    rows, k3_calls = [], 0
    for label, fs, variant in FACTOR_STEPS:
        found, val, st, ls = lookup_variant(trees[fs], qb, ql, variant,
                                            engine=eng)
        k3_calls += n_levels if variant.startswith("feature") else 0
        if not bool((found & (val == want)).all()):
            raise AssertionError(f"factor {name} {label}: "
                                 f"{int((~found).sum())} keys not found")
        rows.append({"step": label, "fs": fs,
                     "key_cmp/op": float(st.key_compares.double().mean()),
                     "lines/op": float(st.lines_touched.double().mean()),
                     "feat_rounds/op": float(st.feat_rounds.double().mean()),
                     "suffix_bs/op": float(st.suffix_bs.double().mean())})
    tree = trees[4]
    leaf, path, _ = eng.traverse(tree, qb, ql)
    k3_calls += n_levels
    got = k4.probe_cuda(tree, leaf, qb, ql)
    k3_launches, k4_launches = k3.LAUNCHES, k4.LAUNCHES
    if on_card and (k3_launches, k4_launches) != (k3_calls, 1):
        raise AssertionError(f"factor {name}: {k3_launches} K3 launches for "
                             f"{k3_calls} level calls, {k4_launches} K4 "
                             f"launches for 1 probe_cuda call")

    worst = _exact("probe_cuda vs leaf.probe", ("found", "slot", "val"),
                   got[:3], probe(tree, leaf, qb, ql)[:3])
    plain_st = probe(tree, leaf, qb, ql)[3]
    worst = max(worst, _exact("probe_cuda stats", got[3]._fields, got[3],
                              plain_st))
    worst = max(worst, k4_vs_plain(tree.arrays.leaf_tags[leaf.long()],
                                   tree.arrays.leaf_occ[leaf.long()],
                                   fnv1a_tags(qb, ql)))
    k4_err = worst
    k3_err = 0
    for fs, t in sorted(trees.items()):
        worst = max(worst, engine_parity(t, qb, ql))
        _, tpath, _ = TraversalEngine("torch").traverse(t, qb, ql)
        for level, nid in zip(t.arrays.levels, tpath):
            k3_err = max(k3_err, k3_vs_plain(*level_inputs(level, nid.long(),
                                                           qb)))
    out = {"phase": "factor", "tree": name, "keys": n, "queries": batch,
           "steps": rows, "k3_launches": k3_launches, "k3_level_calls": k3_calls,
           "k4_launches": k4_launches, "all_found": True,
           "engine_parity_max_abs_err": worst,
           "k3_vs_plain_max_abs_err": k3_err,
           "k4_vs_plain_max_abs_err": k4_err}
    if stale:
        nl = int(tree.arrays.leaf_count)
        leaves = list(range(3, nl - 3, max(1, (nl - 6) // 64)))[:64]
        st_tree, moved = stale_parents(tree, leaves)
        qi = torch.tensor(moved, device=device, dtype=torch.long)
        sqb = torch.cat([st_tree.arrays.key_bytes[qi], qb[:4096]])
        sql = torch.cat([st_tree.arrays.key_lens[qi], ql[:4096]])
        v_c, r_c = batch_ops.lookup_batch(st_tree, sqb, sql, engine=eng)
        v_f, r_f = batch_ops.lookup_batch(st_tree, sqb, sql,
                                          engine=TraversalEngine("fused"))
        _exact("stale parents: cuda vs fused", ("val",) + r_c._fields,
               (v_c,) + tuple(r_c), (v_f,) + tuple(r_f))
        _, _, hs = eng.traverse(st_tree, sqb[:len(moved)], sql[:len(moved)])
        if not bool(r_c.found.all()) or not bool((hs.sibling_hops == 1).all()):
            raise AssertionError(f"factor {name}: stale-parent lookups lost "
                                 f"keys or took no sibling hop")
        out["stale_parent_keys"] = len(moved)
    emit(out)
    print(f"factor {name} ({n} keys, {batch} zipf queries):", flush=True)
    print("  step        fs  key_cmp/op  lines/op  feat_rounds/op  "
          "suffix_bs/op", flush=True)
    for r in rows:
        print(f"  {r['step']:<10} {r['fs']:>3}  {r['key_cmp/op']:>10.4f}  "
              f"{r['lines/op']:>8.3f}  {r['feat_rounds/op']:>14.4f}  "
              f"{r['suffix_bs/op']:>12.4f}", flush=True)
    return out, (qb, ql)


# ------------------------------------------------------------------ timing

def _event_ms(fn, runs: int):
    """Median device time of ``fn`` over ``runs`` runs, with CUDA events.
    A sleep kernel first keeps the card busy while the host enqueues, so the
    events bracket device work and not the host's launch overhead."""
    times = []
    for _ in range(runs):
        torch.cuda._sleep(2_000_000)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times), times


def bound(tree, qb, ql):
    """Least time the card could take for one fused traverse+probe of this
    batch: the larger of bytes / HBM rate and byte compares / integer rate.
    Bytes: the queries read once; per level, each distinct node row the
    batch visits (knum and the child id taken; for a non-trivial node also
    plen, the prefix row and the feature block); each distinct leaf's tag
    and occupancy rows and high/next ids; for every hit its key id, value,
    key row and length; and the outputs written once. Anchors read by the
    binary searches are left out, so this undercounts."""
    from repro_torch.kernels.fused_descent import ops
    a = tree.arrays
    s = a.stacked
    NL, C, fs, ns = s.features.shape
    B, L = qb.shape
    leaf, path, found, slot, val, bst, lst = ops.fused_traverse_probe(
        tree, qb, ql, collect_stats=True)
    nbytes = B * (L + 4)
    for l, ids in enumerate(path):
        u = torch.unique(ids.long())
        kn = s.knum[l, u]
        nbytes += int(u.numel()) * 8 + int((kn > 1).sum()) * (4 + L + fs * ns)
    ul = torch.unique(leaf.long())
    nbytes += int(ul.numel()) * (2 * ns + 8)
    hit = torch.unique(a.leaf_keyid[leaf.long(), slot.long()][found].long())
    nbytes += int(found.sum()) * 8 + int(hit.numel()) * (L + 4)
    nbytes += B * (4 + 4 * NL + 1 + 4 + 4)
    ops_n = (2 * ns * int(bst.feat_rounds.sum())
             + L * int(bst.key_compares.sum())
             + (2 * ns + L) * B)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_n / INT_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def timing(tree, qb, ql, runs: int):
    from repro_torch.core import batch_ops
    from repro_torch.core.traverse import TraversalEngine
    from repro_torch.kernels.fused_descent import ops, ref
    B = qb.shape[0]
    kern = lambda: ops.fused_traverse_probe(tree, qb, ql, collect_stats=False)
    plain = lambda: ref.fused_traverse_probe_ref(tree, qb, ql, collect_stats=False)
    eng = TraversalEngine("fused", collect_stats=False)
    for _ in range(3):
        kern(), plain()
    k_ms, k_all = _event_ms(kern, runs)
    p_ms, _ = _event_ms(plain, runs)
    e2e = []
    for _ in range(runs + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch_ops.lookup_batch(tree, qb, ql, engine=eng)
        torch.cuda.synchronize()
        e2e.append((time.perf_counter() - t0) * 1e3)
    e2e_ms = statistics.median(e2e[3:])
    b_ms, b_by, b_bytes = bound(tree, qb, ql)
    emit({"metric": "kernel_ms", "value": k_ms, "runs": runs, "batch": B,
          "min": min(k_all), "max": max(k_all)})
    emit({"metric": "kernel_mlookups_per_s", "value": B / k_ms / 1e3})
    emit({"metric": "plain_ms", "value": p_ms, "runs": runs})
    emit({"metric": "lookup_batch_ms", "value": e2e_ms, "runs": runs,
          "clock": "host, synchronized"})
    emit({"metric": "bound_ms", "value": b_ms, "bound_by": b_by,
          "bound_bytes": b_bytes})
    emit({"metric": "bound_share", "value": b_ms / k_ms})
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)


def scan_bound(tree, qb, ql, max_items: int):
    """Least time the card could take for one fused range scan of this
    batch: the larger of bytes / HBM rate and byte compares / integer rate.
    Bytes: the queries read once; the descent rows as in :func:`bound`; for
    each distinct leaf the scans visit (the walk replayed on this batch),
    its key-id, value and occupancy rows, next link and ordered flag, plus
    the high key of each start leaf; the key rows (and lengths) of hop 0's
    occupied slots and of the dirty leaves visited; and the outputs written
    once. Compares: the descent's, one L-byte compare per occupied slot of
    a start leaf, and k*ceil(log2 k) for each visit of a dirty leaf with k
    keys (a sort's least). Anchors read by the binary searches are left
    out, so this undercounts."""
    from repro_torch.core.keys import compare_padded
    from repro_torch.kernels.fused_descent import ops
    a = tree.arrays
    s = a.stacked
    NL, C, fs, ns = s.features.shape
    B, L = qb.shape
    leaf, path, bst = ops.fused_traverse(tree, qb, ql, collect_stats=True)
    nbytes = B * (L + 4)
    for l, ids in enumerate(path):
        u = torch.unique(ids.long())
        kn = s.knum[l, u]
        nbytes += int(u.numel()) * 8 + int((kn > 1).sum()) * (4 + L + fs * ns)
    cur = leaf.long()
    occ = a.leaf_occ[cur]
    kid = a.leaf_keyid[cur]
    kb = a.key_bytes[torch.clamp(kid, min=0).long()]
    kl = torch.where(occ, a.key_lens[torch.clamp(kid, min=0).long()], 0)
    emit = occ & (compare_padded(kb, kl, qb[:, None, :], ql[:, None]) >= 0)
    del kb, kl
    emitted = torch.clamp(emit.sum(-1), max=max_items)
    visited, key_rows = [cur], [kid[occ]]
    n_cmp = L * int(occ.sum())
    k = occ.sum(-1)
    dirty = ~a.leaf_ordered[cur]
    sort_cmp = lambda k: int((k * torch.ceil(torch.log2(torch.clamp(
        k.double(), min=1)))).sum())
    n_cmp += L * sort_cmp(k[dirty])
    nxt = a.leaf_next[cur]
    cur = torch.where((nxt >= 0) & (emitted < max_items), nxt, -1).long()
    while bool((cur >= 0).any()):
        act = cur >= 0
        c = cur[act]
        visited.append(c)
        occ = a.leaf_occ[c]
        dirty = ~a.leaf_ordered[c]
        key_rows.append(a.leaf_keyid[c][dirty][occ[dirty]])
        n_cmp += L * sort_cmp(occ[dirty].sum(-1))
        emitted[act] = torch.clamp(emitted[act] + occ.sum(-1), max=max_items)
        nxt = a.leaf_next[c]
        cur[act] = torch.where((nxt >= 0) & (emitted[act] < max_items), nxt,
                               -1).long()
    n_leaves = int(torch.unique(torch.cat(visited)).numel())
    n_keys = int(torch.unique(torch.cat(key_rows).long()).numel())
    nbytes += n_leaves * (9 * ns + 4 + 1) + int(torch.unique(leaf).numel()) * 4
    nbytes += n_keys * (L + 4)
    nbytes += B * max_items * 8 + B * 4
    ops_n = 2 * ns * int(bst.feat_rounds.sum()) + L * int(
        bst.key_compares.sum()) + n_cmp
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_n / INT_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def scan_timing(clean, tree, qb, ql, max_items: int, runs: int):
    """K2 on the dirtied and on the clean tree, the plain version, and
    range_scan end to end, on one scan batch, stats off."""
    from repro_torch.core import batch_ops
    from repro_torch.core.traverse import TraversalEngine
    from repro_torch.kernels.fused_scan import ops, ref
    kern = lambda t: ops.fused_range_scan(t, qb, ql, max_items=max_items,
                                          collect_stats=False)
    plain = lambda: ref.fused_range_scan_ref(tree, qb, ql, max_items=max_items,
                                             collect_stats=False)
    eng = TraversalEngine("fused", collect_stats=False)
    for _ in range(3):
        kern(tree), kern(clean), plain()
    k_ms, k_all = _event_ms(lambda: kern(tree), runs)
    kc_ms, _ = _event_ms(lambda: kern(clean), runs)
    p_ms, _ = _event_ms(plain, runs)
    e2e = []
    for _ in range(runs + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch_ops.range_scan(tree, qb, ql, max_items=max_items, engine=eng)
        torch.cuda.synchronize()
        e2e.append((time.perf_counter() - t0) * 1e3)
    b_ms, b_by, b_bytes = scan_bound(tree, qb, ql, max_items)
    bc_ms, _, _ = scan_bound(clean, qb, ql, max_items)
    B = qb.shape[0]
    emit({"metric": "scan_kernel_ms", "value": k_ms, "tree": "dirtied",
          "runs": runs, "batch": B, "max_items": max_items,
          "min": min(k_all), "max": max(k_all)})
    emit({"metric": "scan_kernel_ms", "value": kc_ms, "tree": "clean",
          "runs": runs, "batch": B})
    emit({"metric": "scan_plain_ms", "value": p_ms, "runs": runs})
    emit({"metric": "range_scan_ms", "value": statistics.median(e2e[3:]),
          "runs": runs, "clock": "host, synchronized"})
    emit({"metric": "scan_bound_ms", "value": b_ms, "bound_by": b_by,
          "bound_bytes": b_bytes, "clean_tree_bound_ms": bc_ms})
    emit({"metric": "scan_bound_share", "value": b_ms / k_ms})
    return dict(ms=k_ms, clean_ms=kc_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by)


def level_timing(tree, qb, ql, runs: int):
    """K3 per launch at every level and K4 per launch on one batch of the
    tree, stats off, beside their plain versions and their bounds; then
    ``lookup_batch`` with the "cuda" engine (K3 per level) beside K1's
    ``lookup_batch``, alternating, host clock.

    Bounds: the larger of bytes / HBM rate and compares / integer rate, for
    what this batch needs. K3 reads knum and pcmp (8 B a query), one
    feature row (ns B) and one query byte per round a query takes (a
    trivial node takes none), and writes 16 B a query; two compares a slot
    and round. K4 reads the tag and occupancy rows (2 ns B) and the query
    tag, and writes cand (ns B), first and count (8 B); two compares a
    slot."""
    from repro_torch.core import batch_ops
    from repro_torch.core.branch import level_inputs
    from repro_torch.core.keys import fnv1a_tags
    from repro_torch.core.traverse import TraversalEngine
    from repro_torch.kernels.feature_branch import ops as k3
    from repro_torch.kernels.feature_branch import ref as k3ref
    from repro_torch.kernels.leaf_probe import ops as k4
    from repro_torch.kernels.leaf_probe import ref as k4ref

    def bound(nbytes, ops_n):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops_n / INT_OPS_PER_S * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    B = qb.shape[0]
    leaf, path, _ = TraversalEngine("torch").traverse(tree, qb, ql)
    k3_rows = []
    for lvl, (level, nid) in enumerate(zip(tree.arrays.levels, path)):
        inp = level_inputs(level, nid.long(), qb)
        ns = inp[0].shape[-1]
        n_rounds = int(k3.feature_branch(*inp, collect_stats=True)[4].sum())
        for _ in range(3):
            k3.feature_branch(*inp, collect_stats=False)
            k3ref.feature_compare_rounds(*inp, collect_stats=False)
        k_ms, k_all = _event_ms(
            lambda: k3.feature_branch(*inp, collect_stats=False), runs)
        p_ms, _ = _event_ms(lambda: k3ref.feature_compare_rounds(
            *inp, collect_stats=False), runs)
        nbytes = B * 8 + n_rounds * (ns + 1) + B * 16
        b_ms, b_by = bound(nbytes, 2 * ns * n_rounds)
        row = {"metric": "k3_kernel_ms", "level": lvl, "value": k_ms,
               "min": min(k_all), "max": max(k_all), "plain_ms": p_ms,
               "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": nbytes,
               "rounds_per_query": n_rounds / B,
               "trivial_share": float((inp[2] <= 1).double().mean()),
               "runs": runs, "batch": B}
        emit(row)
        k3_rows.append(row)

    lid = leaf.long()
    a = tree.arrays
    tags, occ, qtag = a.leaf_tags[lid], a.leaf_occ[lid], fnv1a_tags(qb, ql)
    ns = tags.shape[-1]
    for _ in range(3):
        k4.leaf_probe(tags, occ, qtag), k4ref.leaf_probe_ref(tags, occ, qtag)
    k4_ms, k4_all = _event_ms(lambda: k4.leaf_probe(tags, occ, qtag), runs)
    k4p_ms, _ = _event_ms(lambda: k4ref.leaf_probe_ref(tags, occ, qtag),
                          runs)
    k4_bytes = B * (2 * ns + 1) + B * (ns + 8)
    k4b_ms, k4_by = bound(k4_bytes, 2 * ns * B)
    emit({"metric": "k4_kernel_ms", "value": k4_ms, "min": min(k4_all),
          "max": max(k4_all), "plain_ms": k4p_ms, "bound_ms": k4b_ms,
          "bound_by": k4_by, "bound_bytes": k4_bytes, "runs": runs,
          "batch": B})

    engines = {"cuda": TraversalEngine("cuda", "stacked", collect_stats=False),
               "fused": TraversalEngine("fused", collect_stats=False)}
    e2e = {k: [] for k in engines}
    for r in range(runs + 2):
        for name in (("cuda", "fused") if r % 2 else ("fused", "cuda")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch_ops.lookup_batch(tree, qb, ql, engine=engines[name])
            torch.cuda.synchronize()
            e2e[name].append((time.perf_counter() - t0) * 1e3)
    for name, ts in e2e.items():
        emit({"metric": "lookup_batch_ms", "engine": name, "tree": "rebuilt",
              "value": statistics.median(ts[2:]), "runs": runs,
              "clock": "host, synchronized"})
    k3_by = ("bytes" if all(r["bound_by"] == "bytes" for r in k3_rows)
             else "operations")
    return {"k3": dict(ms=sum(r["value"] for r in k3_rows),
                       plain_ms=sum(r["plain_ms"] for r in k3_rows),
                       bound_ms=sum(r["bound_ms"] for r in k3_rows),
                       bound_by=k3_by, levels=len(k3_rows)),
            "k4": dict(ms=k4_ms, plain_ms=k4p_ms, bound_ms=k4b_ms,
                       bound_by=k4_by)}


# -------------------------------------------------------------------- main

def _smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "n/a"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ycsb-keys", type=int, default=10_000_000)
    p.add_argument("--url-keys", type=int, default=1_000_000)
    p.add_argument("--int-keys", type=int, default=1_000_000)
    p.add_argument("--batch", type=int, default=65_536)
    p.add_argument("--runs", type=int, default=25)
    p.add_argument("--e-rounds", type=int, default=16)
    args = p.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.core import fbtree
        from repro_torch.core.keys import KeySet
        from repro_torch.kernels import nvcc
    except ImportError as e:
        print(f"chip_smoke: the port's sources are not beside the script "
              f"({e})", file=sys.stderr)
        return 2

    smi = _smi()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi}", flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "torch_name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    libs = nvcc.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [os.path.relpath(str(p), ROOT) for p in libs.values()]})
    for name, log in sorted(nvcc.BUILD_LOG.items()):
        print(f"nvcc {name}:\n{log.strip()}", flush=True)

    dev = "cuda"
    kb, kl = ycsb_keys(args.ycsb_keys, args.seed)
    tree, (qb, ql), main_out = run_phase("ycsb", kb, kl, ns=64,
                                         batch=args.batch, seed=args.seed,
                                         device=dev)
    run_device_build("ycsb", kb, kl, tree.config, device=dev, host=tree,
                     host_s=main_out["host_build_s"])
    clean, dirty, _, (sqb, sql, _), inserts, e_out = run_ycsb_e(
        tree, kb, kl, seed=args.seed, device=dev, rounds=args.e_rounds,
        batch=args.batch)
    rebuilt, (lkb, lkl, lval), _ = run_rebuild(
        dirty, kb, kl, inserts, seed=args.seed, device=dev, batch=args.batch)
    del kb, kl, inserts
    ycsb2 = fbtree.bulk_build(dataclasses.replace(rebuilt.config, fs=2),
                              KeySet(lkb, lkl), lval, device=True, target=dev)
    f_outs = [run_factor("ycsb-rebuilt", {2: ycsb2, 4: rebuilt}, lkb, lkl,
                         lval, seed=args.seed, device=dev, batch=args.batch)]
    fqb, fql = f_outs[0][1]
    del ycsb2, lkb, lkl, lval
    ukb, ukl = url_keys(args.url_keys, args.seed)
    url_tree, _, u_out = run_phase("url", ukb, ukl, ns=64, batch=args.batch,
                                   seed=args.seed, device=dev, stale="single")
    url4, _ = run_device_build("url", ukb, ukl, url_tree.config, device=dev,
                               host=url_tree, host_s=u_out["host_build_s"])
    url2, _ = run_device_build("url", ukb, ukl,
                               dataclasses.replace(url_tree.config, fs=2),
                               device=dev)
    f_outs.append(run_factor("url", {2: url2, 4: url4}, ukb, ukl,
                             np.arange(ukb.shape[0], dtype=np.int32),
                             seed=args.seed, device=dev, batch=args.batch,
                             stale=True))
    del url2, url4
    run_card_vs_cpu(url_tree, ukb, ukl, seed=args.seed, device=dev)
    del url_tree, ukb, ukl
    ikb, ikl = int_keys(args.int_keys, args.seed)
    int_tree, _, _ = run_phase("int-ns128", ikb, ikl, ns=128,
                               batch=args.batch, seed=args.seed, device=dev,
                               stale="double")
    a_out = run_append(int_tree, ikb, seed=args.seed, device=dev)
    del int_tree

    t = timing(tree, qb, ql, args.runs)
    st = scan_timing(clean, dirty, sqb, sql, 50, args.runs)
    lt = level_timing(rebuilt, fqb, fql, args.runs)
    factor = [f for f, _ in f_outs]
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "fused_descent", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_descent.cu",
        "replaces": "src/repro/kernels/fused_descent/kernel.py:299",
        "launches": main_out["launches"],
        "max_abs_err": main_out["kernel_vs_plain_max_abs_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None}, {
        "name": "fused_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_scan.cu",
        "replaces": "src/repro/kernels/fused_scan/kernel.py:237",
        "launches": e_out["k2_launches"],
        "max_abs_err": max(e_out["kernel_vs_plain_max_abs_err"],
                           a_out["kernel_vs_plain_max_abs_err"]),
        "ms": st["ms"], "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
        "bound_by": st["bound_by"], "library_ms": None}, {
        "name": "feature_branch", "route": "cuda",
        "source": "src/repro_torch/csrc/feature_branch.cu",
        "replaces": "src/repro/kernels/feature_branch/kernel.py:121",
        "launches": sum(f["k3_launches"] for f in factor),
        "max_abs_err": max(f["k3_vs_plain_max_abs_err"] for f in factor),
        "ms": lt["k3"]["ms"], "plain_ms": lt["k3"]["plain_ms"],
        "bound_ms": lt["k3"]["bound_ms"], "bound_by": lt["k3"]["bound_by"],
        "library_ms": None,
        "per": f"one descent: {lt['k3']['levels']} launches, one a level"}, {
        "name": "leaf_probe", "route": "cuda",
        "source": "src/repro_torch/csrc/leaf_probe.cu",
        "replaces": "src/repro/kernels/leaf_probe/kernel.py:39",
        "launches": sum(f["k4_launches"] for f in factor),
        "max_abs_err": max(f["k4_vs_plain_max_abs_err"] for f in factor),
        "ms": lt["k4"]["ms"], "plain_ms": lt["k4"]["plain_ms"],
        "bound_ms": lt["k4"]["bound_ms"], "bound_by": lt["k4"]["bound_by"],
        "library_ms": None}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
