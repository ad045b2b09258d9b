#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Drives the port's main paths at the size their users run them: the
batched point lookup (``core.batch_ops.lookup_batch`` with
``TraversalEngine("fused")``, one launch of the fused-descent kernel K1 per
batch), YCSB workload E (``insert_batch`` then ``range_scan`` with the
``"fused"`` engine; the scan is one launch of the fused-scan kernel K2),
the device build and ``rebuild``, and the paper's factor analysis (Fig.
12(a)) through the per-level engine ``"cuda"`` (one launch of the
feature-comparison kernel K3 per level) and ``probe_cuda`` (the hashtag
leaf-filter kernel K4), and LLM serving through the FB+-tree prefix cache
(``serving.Engine`` on yi-9b at full size; every long prefill layer is one
launch of the flash-attention kernel K5):

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
11. ``shard``: the ycsb keys in 4 range shards on the card (DESIGN.md
    §7 at ``benchmarks/shard.py``'s largest shard count; every shard
    planned like the ycsb tree, ``sharded_build(device=True)``), held
    against the unsharded tree op for op: each shard == the device build of
    its ``sharded_partition`` run; lookups over every key (K1 launches ==
    the shards owning lanes); 4 YCSB-E rounds of inserts and 66,560-start
    scans (1,024 starts just below the split keys, so lanes spill), then
    update and remove, equal in values, found, emitted and resolved key
    bytes; K2 on each shard's batch of the last scan (parked all-0xFF
    lanes) == its plain version; a sticky ``drop_shard`` on shard 2
    (degraded lookups from the snapshot, exactly its insert lanes failed,
    scans that need it failed with a correct prefix), then
    ``TreeVersionManager.rebalance()`` published, healthy, balanced, every
    live key found, each shard == the device build of its partition of the
    live set. Times: sharded and unsharded ``lookup_batch`` and
    ``range_scan`` (host clock), ``rebalance_s``, peak memory;
12. timing with CUDA events: K1 on the main lookup batch; K2 on the last
    scan batch of the dirtied and of the clean tree; K3 at every level and
    K4 on the factor batch of the rebuilt tree, warm and with the L2
    flushed, and their design lines; the plain versions;
    ``lookup_batch`` (engines ``"fused"`` and ``"cuda"``), ``range_scan``
    and ``insert_batch`` end to end (host clock); each kernel's bound;
13. ``serve``: the port's ``Engine`` on ``get_config("yi-9b")`` (48 layers,
    d_model 4096, GQA 32/4, vocab 64,000; bf16 weights from
    ``lm.init_params`` under a generator seeded with ``--seed``) serving
    16 requests of 3,072 tokens (``launch/serve.py::make_requests``: a
    2,048-token system prompt from 4 families drawn zipf(1.5), then a
    private tail), ``max_batch`` 4, 16-token blocks, 1,024 pages, 32 new
    tokens each, ``tree_backend="fused"``. Every request must finish; K5
    must launch 48 times per prefill, K1 once per match, insert probe,
    insert round and eviction remove (counted by the obs counters), K2
    once per eviction scan; evictions and hits must happen; the final tree
    must pass ``fsck``; the cache's calls replayed on a CPU cache with the
    ``"torch"`` engine must give the same answers, arrays, pool and stats;
    KV loaded from cached pages must equal the request's own prefill
    within the bf16 bound; two fresh engines must give ``reqs[0]`` the
    same continuation; K5 must equal its plain version within
    :func:`k5_tolerance` (per element, scaled to the output) on the real
    q, k, v of layers 0 and 47 and on ``K5_CASES``. It prints prefill ms
    per request, decode step ms, new tokens/s, request latency p50/p99,
    peak device memory, and K5's time, bound, plain time and
    ``scaled_dot_product_attention``'s time;
14. ``shard-cache``: the serve phase's recorded cache calls replayed on a
    ``PrefixCache(n_shards=4)`` with the ``"fused"`` engine on the card and
    on the CPU: every answer equal to the other's and to the unsharded
    cache's, pools, stats and every shard's arrays equal;
15. ``train``: ``launch/train.py::train_loop`` on yi-9b at full width, its
    depth cut to 8 layers (:data:`TRAIN_RUN`), AdamW, 12 steps of 2 x 4,096
    tokens in 2 microbatches. K5 must launch once per layer, microbatch and
    step; the loss must stay finite and fall; on layer 0's real q, k, v,
    K5's forward must equal its plain version within :func:`k5_tolerance`
    and the recompute backward's dq, dk, dv autograd through the plain
    version within :func:`k5_grad_tolerance`; a card step must equal a CPU
    step from one state within :data:`TRAIN_STEP_BOUND`; a restart after
    an injected failure must give the uninterrupted run's losses and a
    checkpoint that restores equal. It prints the step's ms, tokens/s,
    ``train_mfu``, peak device memory, and K5's forward and the recompute
    backward's ms at the training shape.

Each phase prints one JSON line. The line before the last holds the
kernels table; the last line is ``{"ok": true, "device": ...}``. The script
exits non-zero, with no result, when there is no CUDA device, when the
port's sources are not beside it, or when any check fails. Run:
``python3 chip_smoke.py``; ``rehearse_serve()`` runs the serve phase's
checks on the CPU at SMOKE size, ``rehearse_shard()`` the shard phases'
at 6,000 keys, ``rehearse_train()`` the train phase's at SMOKE size.
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


URL_WIDTH = 72


def url_keys(n: int, seed: int):
    """A host drawn by zipf(1.2), then ``word/word_number``, at most
    ``URL_WIDTH`` bytes."""
    rng = np.random.default_rng(seed)
    have = np.zeros(0, f"S{URL_WIDTH}")
    while have.size < n:
        m = n - have.size + 1024
        host = rng.zipf(1.2, size=m) % len(HOSTS)
        wl = rng.integers(2, 5, size=(m, 2))
        syl = rng.integers(0, len(SYLL), size=(m, 2, 4))
        num = rng.integers(0, 10**9, size=m)
        word = lambda i, w: "".join(SYLL[s] for s in syl[i, w, :wl[i, w]])
        new = np.array([(HOSTS[host[i]] + word(i, 0) + "/" + word(i, 1) + "_"
                         + str(num[i])).encode()[:URL_WIDTH] for i in range(m)],
                       dtype=f"S{URL_WIDTH}")
        have = np.unique(np.concatenate([have, new]))
    have = have[:n]
    return (have.view(np.uint8).reshape(n, URL_WIDTH).copy(),
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
    from repro_torch.shard import place_shard

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
    host, host_reps, h_splits, h_rounds, host_s = drive(
        place_shard(tree, "cpu"), "cpu")
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


# ------------------------------------------------------------------- shards

class _Launches:
    """K1/K2 launches of the sharded ops alone: :meth:`run` calls one op
    and adds the launches it made; checks and the unsharded twin calls
    stay outside."""

    def __init__(self):
        self.k1 = self.k2 = 0

    def run(self, fn, *a, **kw):
        from repro_torch.kernels.fused_descent import ops as k1
        from repro_torch.kernels.fused_scan import ops as k2
        l1, l2 = k1.LAUNCHES, k2.LAUNCHES
        out = fn(*a, **kw)
        self.k1 += k1.LAUNCHES - l1
        self.k2 += k2.LAUNCHES - l2
        return out


class _Recorder:
    """Record the per-shard ``batch_ops.range_scan`` calls of the sharded
    scans made inside the ``with`` block: ``(shard tree, starts, lengths,
    max_items)`` each, the batches K2 is given, parked lanes included."""

    def __enter__(self):
        from repro_torch.core import batch_ops
        self.calls, self._orig = [], batch_ops.range_scan

        def rec(tree, qb, ql, max_items=64, engine=None):
            self.calls.append((tree, qb, ql, max_items))
            return self._orig(tree, qb, ql, max_items=max_items,
                              engine=engine)
        batch_ops.range_scan = rec
        return self

    def __exit__(self, *exc):
        from repro_torch.core import batch_ops
        batch_ops.range_scan = self._orig


def _host_ms(fn, runs: int, device) -> float:
    """Median host-clock ms of ``fn`` over ``runs`` runs after 3 warm-ups,
    each run ending in a synchronize."""
    times = []
    for _ in range(runs + 3):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[3:])


def _resolved(tree, kid):
    """Key bytes and lengths of an unsharded scan's key ids (zero rows past
    ``emitted``), the form ``ShardedTree.key_rows`` gives."""
    live = kid >= 0
    k = torch.clamp(kid, min=0).long()
    return (torch.where(live[..., None], tree.arrays.key_bytes[k], 0),
            torch.where(live, tree.arrays.key_lens[k], 0))


def _scan_diffs(st, tree, out, want, rows=None):
    """Names of the outputs where a sharded scan differs from the unsharded
    one (on ``rows`` only, when given): emitted counts, values, key bytes
    and lengths of the emitted items."""
    gk, v, em = out[:3]
    kid, wv, wem = want[:3]
    got = (em, v) + st.key_rows(gk)
    exp = (wem, wv) + _resolved(tree, kid)
    names = ("emitted", "values", "key_bytes", "key_lens")
    if rows is not None:
        got = tuple(x[rows] for x in got)
        exp = tuple(x[rows] for x in exp)
    return [n for n, a, b in zip(names, got, exp) if not torch.equal(a, b)]


def run_shard(tree, kb, kl, *, seed, device, n_shards=4, batch=65_536,
              rounds=4, n_ins=3449, max_items=50, n_spill=1024, n_remove=4096,
              runs=25):
    """The ``shard`` phase: DESIGN.md §7's range-sharded tree over the
    ycsb keys (``kb``/``kl``, sorted, as ``ycsb_keys`` makes them) in
    ``n_shards`` shards on ``device``, each planned like the unsharded
    ``tree`` (its config), held against ``tree`` op for op:

    1. build: every shard equals ``bulk_build(device=True)`` of its
       ``sharded_partition`` run, array for array; the router's split keys
       are the runs' minima;
    2. lookups over every key in the ycsb phase's batches (10% flipped):
       values and found equal the unsharded tree's; K1 launches equal the
       shards owning lanes, summed over the batches;
    3. YCSB-E: ``rounds`` x (``insert_batch`` of ``n_ins`` fresh keys,
       ``range_scan`` of ``batch`` zipf(0.99) starts plus ``n_spill``
       starts just below the split keys), then ``update_batch`` and
       ``remove_batch``, on both trees: reports, emitted counts, values
       and resolved key bytes equal, no lane failed, lanes spilled; K2
       launches equal the shard scans dispatched, and K2 on every shard
       batch of the last scan (parked all-0xFF lanes included) equals its
       plain version;
    4. degradation under a sticky ``drop_shard`` on shard 2: lookups serve
       its lanes ``degraded`` from the build-time snapshot, an insert fails
       exactly its lanes, scans that need it fail (with the fault-free
       prefix); then ``TreeVersionManager.rebalance()`` publishes (its fsck
       gate passes), health is all ok, shard sizes differ by at most one,
       every live key is found with its value, and every shard equals the
       device build of its partition of the live set;
    5. times: sharded and unsharded ``lookup_batch`` and ``range_scan``
       (host clock, synchronized, median of ``runs``; none with
       ``runs=0``), ``rebalance_s``, the phase's peak device memory.

    Returns the phase's JSON object (``k1_launches``/``k2_launches`` count
    the sharded ops' launches)."""
    from repro_torch import shard as S
    from repro_torch.core import batch_ops, fbtree
    from repro_torch.core.faults import FaultPlan, FaultSpec, RetryPolicy
    from repro_torch.core.keys import KeySet
    from repro_torch.core.lifecycle import TreeVersionManager
    from repro_torch.core.traverse import TraversalEngine

    on_card = torch.device(device).type == "cuda"
    n, L = kb.shape
    cfg = tree.config
    eng = TraversalEngine("fused")
    vals = np.arange(n, dtype=np.int32)
    M = max_items
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    cnt = _Launches()
    t_phase = time.perf_counter()

    # ---- 1. build, against the device build of each partition run
    _sync(device)
    t0 = time.perf_counter()
    st = S.sharded_build(KeySet(kb, kl), vals, n_shards, device=True,
                         cfg=cfg, target=device)
    _sync(device)
    build_s = time.perf_counter() - t0
    parts, split_keys = fbtree.sharded_partition(KeySet(kb, kl), vals,
                                                 n_shards, presorted=True)
    n_fields = 0
    for s, (pks, pv) in enumerate(parts):
        want = fbtree.bulk_build(cfg, pks, pv, device=True, target=device)
        diffs = tree_diffs(st.shards[s], want)
        n_fields += sum(1 for _ in tree_fields(want))
        del want
        if diffs:
            raise AssertionError(f"shard: shard {s} != the device build of "
                                 f"its partition run: {diffs}")
    if not (np.array_equal(st.router.split_bytes.cpu().numpy(),
                           np.stack([b for b, _ in split_keys]))
            and st.router.split_lens.tolist() == [l for _, l in split_keys]):
        raise AssertionError("shard: the router's split keys are not the "
                             "partition runs' minima")
    starts = np.cumsum([0] + [p.n for p, _ in parts])[:-1]
    del parts

    # ---- 2. lookups over every key, the ycsb phase's batches
    rng = np.random.default_rng(seed + 1)
    perm = torch.from_numpy(rng.permutation(n)).to(device)
    flip_all = torch.from_numpy(rng.random(n) < 0.1).to(device)
    kb_d = torch.from_numpy(kb).to(device)
    kl_d = torch.from_numpy(kl).to(device)
    n_batches = -(-n // batch)
    k1_want = k1_0 = cnt.k1
    lookups_equal = 0
    first = None
    for bi in range(n_batches):
        idx = perm[bi * batch:(bi + 1) * batch]
        qb = kb_d[idx].clone()
        qb[:, -1] ^= torch.where(flip_all[bi * batch:(bi + 1) * batch],
                                 0xA5, 0).to(torch.uint8)
        ql = kl_d[idx]
        v_s, rep_s = cnt.run(S.lookup_batch, st, qb, ql, engine=eng)
        v_u, rep_u = batch_ops.lookup_batch(tree, qb, ql, engine=eng)
        k1_want += rep_s.shards_hit
        if rep_s.shards_hit + rep_s.shards_skipped != n_shards:
            raise AssertionError("shard: a healthy lookup dropped a shard")
        lookups_equal += int(torch.equal(v_s, v_u)
                             and torch.equal(rep_s.found, rep_u.found))
        if first is None:
            first = (qb, ql)
    k1_lookups = cnt.k1 - k1_0
    if lookups_equal != n_batches:
        raise AssertionError(f"shard: {n_batches - lookups_equal} of "
                             f"{n_batches} lookup batches differ from the "
                             f"unsharded tree")
    if on_card and k1_lookups != k1_want - k1_0:
        raise AssertionError(f"shard: {k1_lookups} K1 launches for "
                             f"{k1_want - k1_0} shard lookups")

    # ---- 3. YCSB-E rounds, then update and remove, on both trees
    rng = np.random.default_rng(seed + 7)
    need = (rounds + 1) * n_ins
    nums = np.zeros(n, np.int64)
    for i in range(19):
        nums = nums * 10 + (kb[:, 4 + i] - ord("0"))
    cand = np.unique(rng.integers(0, 10**18, size=2 * need))
    fresh = rng.permutation(cand[~np.isin(cand, nums)])[:need]
    del nums, cand
    f_kb, f_kl = ycsb_encode(fresh)
    f_kb, f_kl = torch.from_numpy(f_kb).to(device), torch.from_numpy(
        f_kl).to(device)
    f_val = torch.arange(need, dtype=torch.int32, device=device) + n
    bounds = starts[1:]
    per = [n_spill // len(bounds) + (i < n_spill % len(bounds))
           for i in range(len(bounds))]
    spill_at = np.concatenate([b - 1 - rng.integers(0, 2 * M, size=k)
                               for b, k in zip(bounds, per)])
    spill_at = torch.from_numpy(np.clip(spill_at, 0, n - 1)).to(device)
    ut = tree
    k2_want = k2_0 = cnt.k2
    scans_equal = spilled = parked = 0
    for r in range(rounds):
        sl = slice(r * n_ins, (r + 1) * n_ins)
        ut, rep_u, _ = batch_ops.insert_batch(ut, f_kb[sl], f_kl[sl],
                                              f_val[sl], engine=eng)
        st, rep_s, _ = cnt.run(S.insert_batch, st, f_kb[sl], f_kl[sl],
                               f_val[sl], engine=eng)
        if (bool(rep_u.found.any()) or not torch.equal(rep_u.found,
                                                        rep_s.found)
                or bool(rep_s.failed.any())):
            raise AssertionError("shard: a round's insert differs")
        idx = torch.from_numpy(zipf_indices(rng, n, batch)).to(device)
        idx = torch.cat([idx, spill_at])
        qb = kb_d[idx].clone()
        flip = torch.from_numpy(rng.random(idx.shape[0]) < 1 / 3).to(device)
        qb[:, -1] ^= torch.where(flip, 0xA5, 0).to(torch.uint8)
        ql = kl_d[idx]
        with _Recorder() as rec:
            out = cnt.run(S.range_scan, st, qb, ql, max_items=M, engine=eng)
        want = batch_ops.range_scan(ut, qb, ql, max_items=M, engine=eng)
        k2_want += len(rec.calls)
        diffs = _scan_diffs(st, ut, out, want)
        if diffs or bool(out[4].any()):
            raise AssertionError(f"shard: round {r} scan differs from the "
                                 f"unsharded scan on {diffs} (failed "
                                 f"{int(out[4].sum())})")
        scans_equal += 1
        owner = S.route(st.router, qb, ql)
        last_shard = torch.where(out[0] >= 0, out[0] // st.kid_stride,
                                 -1).max(1).values
        spilled += int((last_shard > owner).sum())
    scan_q, scan_out, scan_want = (qb, ql), out, want
    k2_scans = cnt.k2 - k2_0
    if on_card and k2_scans != k2_want - k2_0:
        raise AssertionError(f"shard: {k2_scans} K2 launches for "
                             f"{k2_want - k2_0} shard scans")
    if spilled == 0:
        raise AssertionError("shard: no scan lane spilled into a later "
                             "shard")
    # K2 on each shard batch of the last scan, parked lanes included
    k2_err = 0
    for t, sqb, sql, mi in rec.calls:
        parked += int(((sql == L) & (sqb == 0xFF).all(1)).sum())
        k2_err = max(k2_err, scan_kernel_vs_plain(t, sqb, sql, mi))
    if parked == 0:
        raise AssertionError("shard: no shard batch held a parked lane")
    shard_scans = [(t, sqb, sql) for t, sqb, sql, _ in rec.calls]
    del rec

    upd = torch.from_numpy(rng.choice(n, batch, replace=False)).to(device)
    uqb = kb_d[upd].clone()
    uqb[::10, -1] ^= 0xA5
    uval = torch.arange(batch, dtype=torch.int32, device=device) + 2**29
    ut, rep_u = batch_ops.update_batch(ut, uqb, kl_d[upd], uval, engine=eng)
    st, rep_s = cnt.run(S.update_batch, st, uqb, kl_d[upd], uval,
                        engine=eng)
    rm = upd[:n_remove]
    ut, rep_u2 = batch_ops.remove_batch(ut, kb_d[rm], kl_d[rm], engine=eng)
    st, rep_s2 = cnt.run(S.remove_batch, st, kb_d[rm], kl_d[rm], engine=eng)
    v_s, l_s = cnt.run(S.lookup_batch, st, uqb, kl_d[upd], engine=eng)
    v_u, l_u = batch_ops.lookup_batch(ut, uqb, kl_d[upd], engine=eng)
    if not (torch.equal(rep_u.found, rep_s.found)
            and int(rep_u.conflicts) == int(rep_s.conflicts)
            and torch.equal(rep_u2.found, rep_s2.found)
            and bool(rep_s2.found.all())
            and torch.equal(v_s, v_u) and torch.equal(l_s.found, l_u.found)
            and st.n_keys_live == ut.n_keys_live):
        raise AssertionError("shard: update/remove differ from the "
                             "unsharded tree")

    # ---- 5 (part). times of the healthy tree
    times = {}
    if runs:
        qb, ql = first
        times = dict(
            lookup_batch_ms=_host_ms(
                lambda: S.lookup_batch(st, qb, ql, engine=eng), runs, device),
            unsharded_lookup_batch_ms=_host_ms(
                lambda: batch_ops.lookup_batch(tree, qb, ql, engine=eng),
                runs, device),
            range_scan_ms=_host_ms(
                lambda: S.range_scan(st, *scan_q, max_items=M, engine=eng),
                runs, device),
            unsharded_range_scan_ms=_host_ms(
                lambda: batch_ops.range_scan(ut, *scan_q, max_items=M,
                                             engine=eng), runs, device),
            # where a routed batch's time goes: the routing with its one
            # host copy, then each shard's op over the whole batch
            route_ms=_host_ms(
                lambda: torch.bincount(S.route(st.router, qb, ql),
                                       minlength=n_shards).tolist(),
                runs, device),
            per_shard_lookup_batch_ms=[_host_ms(
                lambda t=t: batch_ops.lookup_batch(t, qb, ql, engine=eng),
                runs, device) for t in st.shards],
            per_shard_range_scan_ms=[_host_ms(
                lambda c=c: batch_ops.range_scan(*c, max_items=M,
                                                 engine=eng), runs, device)
                for c in shard_scans])
    del shard_scans

    # ---- 4. degradation: shard 2 drops at every dispatch
    down_s = min(2, n_shards - 1)
    plan = FaultPlan((FaultSpec("shard.dispatch.*", "drop_shard",
                                shard=down_s),), sleep=lambda s: None)
    retry = RetryPolicy(sleep=lambda s: None)
    look = torch.from_numpy(rng.choice(n, batch, replace=False)).to(device)
    qb, ql = kb_d[look], kl_d[look]
    v, rep = cnt.run(S.lookup_batch, st, qb, ql, engine=eng, faults=plan,
                     retry=retry)
    down = rep.owner == down_s
    v_snap, r_snap = batch_ops.lookup_batch(tree, qb, ql, engine=eng)
    v_now, r_now = batch_ops.lookup_batch(ut, qb, ql, engine=eng)
    want_v = torch.where(down, v_snap, v_now)
    want_f = torch.where(down, r_snap.found, r_now.found)
    if not (bool(down.any()) and torch.equal(rep.degraded, down)
            and torch.equal(v, want_v) and torch.equal(rep.found, want_f)
            and rep.shards_dropped == (down_s,)
            and not st.health.is_ok(down_s)):
        raise AssertionError("shard: degraded lookups do not serve the "
                             "down shard's lanes from its snapshot")
    sl = slice(rounds * n_ins, need)
    st, rep, _ = cnt.run(S.insert_batch, st, f_kb[sl], f_kl[sl], f_val[sl],
                         engine=eng, faults=plan, retry=retry)
    if not (bool(rep.failed.any())
            and torch.equal(rep.failed, rep.owner == down_s)):
        raise AssertionError("shard: the insert did not fail exactly the "
                             "down shard's lanes")
    ut, _, _ = batch_ops.insert_batch(ut, f_kb[sl], f_kl[sl], f_val[sl],
                                      engine=eng, mask=~rep.failed)
    ins_failed = int(rep.failed.sum())
    qb, ql = scan_q
    out = cnt.run(S.range_scan, st, qb, ql, max_items=M, engine=eng,
                  faults=plan, retry=retry)
    want = batch_ops.range_scan(ut, qb, ql, max_items=M, engine=eng)
    owner = S.route(st.router, qb, ql)
    wb, wl = _resolved(ut, want[0])
    item_owner = S.route(st.router, wb.reshape(-1, L),
                         wl.reshape(-1)).reshape(wl.shape)
    needs = (owner == down_s) | ((owner < down_s) & (
        (item_owner >= down_s) & (want[0] >= 0)).any(1))
    ok = ~needs
    prefix = torch.arange(M, device=qb.device)[None, :] < out[2][:, None]
    gb, gl = st.key_rows(out[0])
    if not (torch.equal(out[4], needs) and bool(needs.any())
            and not _scan_diffs(st, ut, out, want, rows=ok)
            and torch.equal(torch.where(prefix[..., None], wb, 0), gb)
            and torch.equal(torch.where(prefix, want[1], 0), out[1])):
        raise AssertionError("shard: scans needing the down shard are not "
                             "exactly the failed lanes with a correct "
                             "prefix")
    scan_failed = int(needs.sum())

    mgr = TreeVersionManager(st, faults=plan)
    _sync(device)
    t0 = time.perf_counter()
    pub = mgr.rebalance()
    _sync(device)
    publish_s = time.perf_counter() - t0
    if not (pub.ok and mgr.verify):
        raise AssertionError(f"shard: the rebalance did not publish: "
                             f"{pub.reason}")
    st2, rb = mgr.current, pub.aux
    _sync(device)
    t0 = time.perf_counter()
    again, _ = S.rebalance(st, faults=plan)
    _sync(device)
    rebalance_s = time.perf_counter() - t0
    del again, st
    kb_l, kl_l, _, vv_l, n_live = batch_ops.gather_live_sorted(ut)
    n_live = int(n_live)
    kb_l, kl_l, vv_l = kb_l[:n_live], kl_l[:n_live], vv_l[:n_live]
    live_found = 0
    for lo in range(0, n_live, batch):
        got, rep = cnt.run(S.lookup_batch, st2, kb_l[lo:lo + batch],
                           kl_l[lo:lo + batch], engine=eng)
        live_found += int((rep.found & (got == vv_l[lo:lo + batch])).sum())
    after = list(rb.counts_after)
    if not (st2.health.n_unhealthy == 0 and max(after) - min(after) <= 1
            and rb.n_live == n_live and live_found == n_live):
        raise AssertionError(f"shard: after the rebalance: health "
                             f"{st2.health}, counts {after}, n_live "
                             f"{rb.n_live} vs {n_live}, {live_found} live "
                             f"keys found with their value")
    parts, _ = fbtree.sharded_partition(
        KeySet(kb_l.cpu().numpy(), kl_l.cpu().numpy()), vv_l.cpu().numpy(),
        n_shards, presorted=True)
    for s, (pks, pv) in enumerate(parts):
        want = fbtree.bulk_build(cfg, pks, pv, device=True, target=device)
        diffs = tree_diffs(st2.shards[s], want)
        del want
        if diffs:
            raise AssertionError(f"shard: rebalanced shard {s} != the "
                                 f"device build of its partition of the "
                                 f"live set: {diffs}")
    del parts, st2, mgr
    peak = torch.cuda.max_memory_allocated() if on_card else None
    out = {"phase": "shard", "keys": n, "shards": n_shards,
           "device": str(device), "config": {"ns": cfg.ns, "fs": cfg.fs,
                                             "n_levels": cfg.n_levels,
                                             "key_cap": cfg.key_cap},
           "build_s": build_s, "fields_compared": n_fields,
           "lookup_batches": n_batches, "lookup_batches_equal": lookups_equal,
           "k1_launches_lookups": k1_lookups,
           "scan_rounds": rounds, "scan_batch": int(scan_q[0].shape[0]),
           "scans_equal": scans_equal, "spilled_lanes": spilled,
           "k2_launches_scans": k2_scans, "parked_lanes_checked": parked,
           "k2_parked_vs_plain_max_abs_err": k2_err,
           "updated": batch, "removed": n_remove,
           "degraded_lanes": int(down.sum()),
           "insert_failed_lanes": ins_failed,
           "scan_failed_lanes": scan_failed,
           "rebalance_s": rebalance_s, "rebalance_publish_s": publish_s,
           "counts_before": list(rb.counts_before), "counts_after": after,
           "n_live": n_live, "live_found": live_found,
           "k1_launches": cnt.k1, "k2_launches": cnt.k2,
           "peak_bytes": peak, "phase_s": time.perf_counter() - t_phase,
           **times}
    emit(out)
    card = _smi() if on_card else "cpu (no device times)"
    for name, v in times.items():
        emit({"metric": f"shard_{name}", "value": v, "runs": runs,
              "clock": "host, synchronized", "card": card})
    emit({"metric": "shard_rebalance_s", "value": rebalance_s,
          "card": card})
    emit({"metric": "shard_peak_device_bytes", "value": peak, "card": card})
    return out


def run_shard_cache(log, *, n_pages, block_tokens, device, n_shards=4):
    """Replay the ``serve`` phase's recorded cache calls (``log``, from
    :func:`_serve_engine`) on a ``PrefixCache(n_shards=n_shards)`` with the
    ``"fused"`` engine on ``device`` and on the same cache on the CPU:
    every answer must equal the other cache's and the one recorded from
    the unsharded cache, and the pools, stats and every shard's arrays must
    be equal at the end. Returns the phase's JSON object."""
    from repro_torch.core.traverse import TraversalEngine
    from repro_torch.serving import PrefixCache
    eng = TraversalEngine("fused", collect_stats=False)
    caches = [PrefixCache(n_pages, block_tokens, engine=eng,
                          n_shards=n_shards, target=d)
              for d in (device, "cpu")]
    cnt = _Launches()
    calls = same = 0
    for e in log:
        if e[0] == "match":
            got = [cnt.run(caches[0].match, e[1]), caches[1].match(e[1])]
            ok = got[0] == got[1] == e[2]
        else:
            got = [cnt.run(caches[0].publish, e[1], e[2]),
                   caches[1].publish(e[1], e[2])]
            ok = all((g is None) == (e[3] is None)
                     and (g is None or np.array_equal(g, e[3]))
                     for g in got)
        calls += 1
        same += int(ok)
    card, cpu = caches
    diffs = [f"shard{s}.{d}" for s, (a, b) in enumerate(
        zip(card.tree.shards, cpu.tree.shards)) for d in tree_diffs(a, b)]
    diffs += _pool_diffs(card.pool, cpu.pool)
    out = {"phase": "shard-cache", "shards": n_shards, "calls": calls,
           "answers_equal": same, "stats": card.stats,
           "stats_equal": card.stats == cpu.stats, "diffs": diffs,
           "evicts": card.stats["evicts"], "k1_launches": cnt.k1,
           "k2_launches": cnt.k2}
    emit(out)
    if same != calls or diffs or card.stats != cpu.stats:
        raise AssertionError(f"shard-cache: {calls - same} of {calls} "
                             f"answers differ, arrays {diffs[:5]}, stats "
                             f"{card.stats} vs {cpu.stats}")
    return out


def rehearse_shard(seed=0):
    """The ``shard`` phase and the sharded cache replay on the CPU at a
    small size: 6,000 ycsb keys in 4 shards, batches of 512, two scan
    rounds, and the cache calls of :func:`rehearse_serve`'s mix. Every
    check of both but the kernels' (the plain versions run). Returns
    ``(shard line, shard-cache line)``."""
    from repro_torch.core import fbtree
    from repro_torch.core.keys import KeySet
    n = 6_000
    kb, kl = ycsb_keys(n, seed)
    cfg = fbtree.TreeConfig.plan(max_keys=int(n * 2.5), key_width=24)
    tree = fbtree.bulk_build(cfg, KeySet(kb, kl), np.arange(n, dtype=np.int32),
                             target="cpu")
    out = run_shard(tree, kb, kl, seed=seed, device="cpu", batch=512,
                    rounds=2, n_ins=100, n_spill=48, n_remove=128, runs=0)
    _, _, log = _serve(seed, torch.device("cpu"), 0, **REHEARSAL_MIX)
    cache = run_shard_cache(log, n_pages=REHEARSAL_MIX["n_pages"],
                            block_tokens=16, device="cpu")
    return out, cache


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


def factor_batch(kb, kl, vals, *, seed, device, batch=65_536):
    """The factor phase's queries: ``batch`` keys drawn zipf(0.99) over
    ``kb`` (all present), with their lengths and values, on ``device``."""
    rng = np.random.default_rng(seed + 7)
    idx = torch.from_numpy(zipf_indices(rng, kb.shape[0], batch)).to(device)
    return (torch.from_numpy(kb).to(device)[idx],
            torch.from_numpy(kl).to(device)[idx],
            torch.from_numpy(vals).to(device)[idx])


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

    n = kb.shape[0]
    qb, ql, want = factor_batch(kb, kl, vals, seed=seed, device=device,
                                batch=batch)
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

L2_FLUSH_BYTES = 64 << 20     # more than the H100's 50 MB L2


def _event_ms(fn, runs: int, flush: bool = False):
    """Median device time of ``fn`` over ``runs`` runs, with CUDA events.
    A sleep kernel first keeps the card busy while the host enqueues, so the
    events bracket device work and not the host's launch overhead. With
    ``flush``, a write of ``L2_FLUSH_BYTES`` before each run evicts the L2,
    so ``fn`` reads its inputs from device memory."""
    times = []
    buf = (torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
           if flush else None)
    for _ in range(runs):
        if flush:
            buf.zero_()
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
    for L in (tree.config.key_width, URL_WIDTH):
        emit({"metric": "k1_design", **k1_design(tree.config.ns, L)})
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)


def k1_design(ns: int, L: int) -> dict:
    """What the K1 instantiation a lookup at ``ns`` and key width ``L``
    takes (stats off, sibling check and probe on) asks of the card:
    registers and local memory (spills) a thread, shared memory and threads
    a block, blocks a SM (``cudaFuncGetAttributes``,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``). The kernels have a
    build for each number of 32-byte stripes a key takes (``stripes_for``
    in ``csrc/cmp.cuh``): the timed ycsb width takes one, ``URL_WIDTH``
    three."""
    from repro_torch.kernels.fused_descent import cuda
    return dict(ns=ns, key_width=L, stats=False, sibling=True, probe=True,
                **cuda.kernel_attributes(ns, L, stats=False, sibling=True,
                                         probe=True))


def k3_design(ns: int, fs: int) -> dict:
    """The same for the K3 instantiation a level at ``ns`` and ``fs`` takes
    (stats off), with the lanes and queries a warp of its lane groups."""
    from repro_torch.kernels.feature_branch import cuda
    lanes = cuda.lanes_per_query(ns)
    return dict(ns=ns, fs=fs, stats=False, lanes_per_query=lanes,
                queries_per_warp=32 // lanes,
                **cuda.kernel_attributes(ns, fs, stats=False))


def k4_design(ns: int) -> dict:
    """The same for the K4 instantiation at ``ns``."""
    from repro_torch.kernels.leaf_probe import cuda
    lanes = cuda.lanes_per_query(ns)
    return dict(ns=ns, lanes_per_query=lanes, queries_per_warp=32 // lanes,
                **cuda.kernel_attributes(ns))


def k2_design(ns: int, L: int) -> dict:
    """The same for the K2 instantiation a scan at ``ns`` and key width
    ``L`` takes (stats off)."""
    from repro_torch.kernels.fused_scan import cuda
    return dict(ns=ns, key_width=L, stats=False,
                **cuda.kernel_attributes(ns, L, stats=False))


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
    for L in (tree.config.key_width, URL_WIDTH):
        emit({"metric": "k2_design", **k2_design(tree.config.ns, L)})
    return dict(ms=k_ms, clean_ms=kc_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by)


def level_timing(tree, qb, ql, runs: int):
    """K3 per launch at every level and K4 per launch on one batch of the
    tree, stats off, warm and with the L2 flushed before each run
    (``l2_flushed_ms``), beside their plain versions and their bounds, and
    the design lines of both (``k3_design``, ``k4_design``); then
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
        kf_ms, _ = _event_ms(
            lambda: k3.feature_branch(*inp, collect_stats=False), runs,
            flush=True)
        p_ms, _ = _event_ms(lambda: k3ref.feature_compare_rounds(
            *inp, collect_stats=False), runs)
        nbytes = B * 8 + n_rounds * (ns + 1) + B * 16
        b_ms, b_by = bound(nbytes, 2 * ns * n_rounds)
        row = {"metric": "k3_kernel_ms", "level": lvl, "value": k_ms,
               "min": min(k_all), "max": max(k_all), "l2_flushed_ms": kf_ms,
               "plain_ms": p_ms,
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
    k4f_ms, _ = _event_ms(lambda: k4.leaf_probe(tags, occ, qtag), runs,
                          flush=True)
    k4p_ms, _ = _event_ms(lambda: k4ref.leaf_probe_ref(tags, occ, qtag),
                          runs)
    k4_bytes = B * (2 * ns + 1) + B * (ns + 8)
    k4b_ms, k4_by = bound(k4_bytes, 2 * ns * B)
    emit({"metric": "k4_kernel_ms", "value": k4_ms, "min": min(k4_all),
          "max": max(k4_all), "l2_flushed_ms": k4f_ms, "plain_ms": k4p_ms,
          "bound_ms": k4b_ms, "bound_by": k4_by, "bound_bytes": k4_bytes,
          "runs": runs, "batch": B})
    emit({"metric": "k3_design", **k3_design(ns, tree.config.fs)})
    emit({"metric": "k4_design", **k4_design(ns)})

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


# ------------------------------------------------------------------ serving

BF16_OPS_PER_S = 989e12       # H100 SXM dense bf16 tensor-core rate, data sheet
SERVE_ARCH = "yi-9b"
# The served mix: 16 requests of a 2,048-token system prompt (4 families,
# zipf 1.5) and a 1,024-token private tail, 32 new tokens each, over 1,024
# pages of 16 tokens, fewer than the ~1,400-1,540 distinct blocks the mix
# needs, so the cache evicts. The rehearsal keeps that overflow at SMOKE
# size: at most 4 x 4 + 16 x 2 = 48 blocks over 32 pages.
SERVE_MIX = dict(smoke=False, n_req=16, plen=3072, shared=2048,
                 new_tokens=32, n_pages=1024)
REHEARSAL_MIX = dict(smoke=True, n_req=16, plen=96, shared=64, new_tokens=8,
                     n_pages=32)
# The flash-attention sweep held against the plain version on the card (and
# by tests/test_torch_cuda.py): ragged S and T (S = T = 1,100 is no multiple
# of the 128-row tiles: the ring's last lap is ragged and its tail masked),
# every mask kind, GQA n_rep in {1, 4, 8}, kv_len < T and rows with no valid
# key. "sdpa" cases go through ops.flash_sdpa ([B,S,H,hd], kv not repeated),
# "flat" cases straight to cuda.launch ([BH,S,hd] with kv_len < T, which
# flash_sdpa never asks for).
K5_CASES = (
    dict(api="sdpa", B=2, S=200, T=200, H=8, Hk=2, hd=32, mask=("causal", 0, 0)),
    dict(api="sdpa", B=1, S=130, T=70, H=4, Hk=4, hd=16, mask=("full", 0, 0)),
    dict(api="sdpa", B=1, S=96, T=160, H=8, Hk=1, hd=16, mask=("causal", 24, 0)),
    dict(api="sdpa", B=1, S=257, T=257, H=32, Hk=4, hd=128,
         mask=("causal", 0, 13)),
    dict(api="sdpa", B=2, S=1000, T=1000, H=8, Hk=2, hd=64,
         mask=("causal", 100, 0)),
    dict(api="sdpa", B=1, S=3072, T=3072, H=32, Hk=4, hd=128,
         mask=("causal", 0, 0)),
    dict(api="sdpa", B=1, S=1100, T=1100, H=32, Hk=4, hd=128,
         mask=("causal", 300, 0)),
    dict(api="flat", BH=2, S=256, T=256, hd=32, kv_len=96, mask=("causal", 40, 0)),
    dict(api="flat", BH=4, S=300, T=333, hd=128, kv_len=200,
         mask=("causal", 0, 0)),
    dict(api="flat", BH=3, S=65, T=129, hd=24, kv_len=129, mask=("full", 0, 0)),
)


def attention_pairs(S: int, T: int, kv_len: int, causal: bool, window: int,
                    prefix_len: int) -> int:
    """The (query, key) pairs the mask keeps, for one head."""
    kv_len = min(kv_len, T)
    if not causal:
        return S * kv_len
    q = np.arange(S, dtype=np.int64)
    hi = np.minimum(q + 1, kv_len)              # window keys are [lo, hi)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros_like(q)
    p = min(prefix_len, kv_len)                 # prefix keys are [0, p)
    inter = np.where(hi > lo, np.maximum(np.minimum(hi, p) - lo, 0), 0)
    return int((np.maximum(hi - lo, 0) + p - inter).sum())


K5_BOUND = ("float32: 1e-4 max(1, max|v|); bf16: 2^-6 |want| + 2^-5 R + "
            "kv_len 2^-24 A per element, A = sum w|v|, R = sqrt(sum w^2 v^2)")


def k5_tolerance(q, k, v, want, *, scale, kv_len, causal, window=0,
                 prefix_len=0):
    """The bound K5 is held to against its plain version, per output
    element: q [BH,S,hd], k/v [BH,T,hv], ``want`` [BH,S,hv] the plain
    version's output. A row with no valid key gets 0: it must be 0.

    float32: 1e-4 times max(1, max|v|), a few float32 ulps of the output
    (both sum in float32, in other orders).

    bf16: 2^-6·|want| + 2^-5·R + kv_len·2^-24·A, with w the row's exact
    float32 softmax weights, A = Σ_j w_j·|v_j| and R = sqrt(Σ_j w_j²·v_j²):
    - 2^-6·|want|: both round their output to bf16, each within one ulp,
      and an ulp is at most 2^-7 of the value;
    - 2^-5·R: the kernel rounds each unnormalized weight to bf16, the plain
      version each normalized one, each within 2^-8 of the weight. The two
      roundings of a key's weight differ, key by key, with no common sign,
      so the output moves by Σ_j w_j·v_j·(δ_j - ε_j), whose standard
      deviation is at most 2^-8·sqrt(2/3)·R: the bound is ten of them;
    - kv_len·2^-24·A: float32 sums of up to kv_len terms in other orders.
    On long causal rows R is about |out|, far below max|v|: a dropped kv
    tile or a wrong correction factor moves the output by many R."""
    from repro_torch.kernels.flash_attention.ref import NEG, key_mask
    vk = v[:, :kv_len].float()
    if q.dtype == torch.float32:
        vmax = float(vk.abs().max()) if vk.numel() else 0.0
        return torch.full(want.shape, 1e-4 * max(1.0, vmax),
                          device=want.device)
    m = key_mask(q.shape[1], kv_len, causal, window, prefix_len, q.device)
    live = m.any(-1)[:, None]
    tol = torch.empty(want.shape, device=want.device)
    for i in range(0, q.shape[0], 8):      # 8 heads' [S, kv_len] at a time
        s = torch.einsum("bsh,bth->bst", q[i:i + 8].float(),
                         k[i:i + 8, :kv_len].float()) * scale
        w = torch.softmax(torch.where(m, s, NEG), dim=-1) * live
        vi = vk[i:i + 8]
        tol[i:i + 8] = (2.0 ** -6 * want[i:i + 8].float().abs()
                        + 2.0 ** -5 * torch.sqrt((w * w) @ (vi * vi))
                        + kv_len * 2.0 ** -24 * (w @ vi.abs()))
    return tol


def _err_over_tol(got, want, tol) -> dict:
    err = (got.float() - want.float()).abs()
    ratio = torch.where(err == 0, 0.0, err / tol)   # a zero bound broken: inf
    return dict(max_abs_err=float(err.max()) if err.numel() else 0.0,
                max_err_over_tol=float(ratio.max()) if err.numel() else 0.0,
                max_abs_want=float(want.float().abs().max())
                if err.numel() else 0.0)


def k5_check(got, q, k, v, mask, n_rep: int, scale: float) -> dict:
    """``got`` [B,S,H*hv] against the plain version of K5 on q [B,S,H,hd],
    k/v [B,T,Hk,hv], within :func:`k5_tolerance`. Returns the max |error|
    and the max error / bound (at most 1 to pass)."""
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_ref, from_flat, to_flat)
    flat = to_flat(q, k, v, n_rep)
    kw = dict(scale=scale, kv_len=k.shape[1], causal=mask.kind == "causal",
              window=mask.window, prefix_len=mask.prefix_len)
    want = flash_attention_ref(*flat, **kw)
    tol = k5_tolerance(*flat, want, **kw)
    B, Hk = q.shape[0], k.shape[2]
    return _err_over_tol(got, from_flat(want, B, Hk, n_rep),
                         from_flat(tol, B, Hk, n_rep))


def k5_vs_plain(q, k, v, mask, n_rep: int, scale: float) -> dict:
    """K5 (``ops.flash_sdpa`` on the card) against its plain version on
    the same device and inputs: :func:`k5_check`."""
    from repro_torch.kernels.flash_attention import ops
    return k5_check(ops.flash_sdpa(q, k, v, mask, n_rep, scale), q, k, v,
                    mask, n_rep, scale)


def k5_sweep(device, dtype, seed: int):
    """Every case of ``K5_CASES`` in ``dtype``: K5 against its plain
    version within :func:`k5_tolerance` (so rows with no valid key exactly
    0). Returns the worst error, the worst error / bound, and the
    failures."""
    from repro_torch.kernels.flash_attention import cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models.attention import MaskSpec
    gen = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=gen, device=device).to(dtype)
    worst = ratio = 0.0
    bad = []
    for c in K5_CASES:
        kind, window, pre = c["mask"]
        if c["api"] == "sdpa":
            q = rnd(c["B"], c["S"], c["H"], c["hd"])
            k = rnd(c["B"], c["T"], c["Hk"], c["hd"])
            v = rnd(c["B"], c["T"], c["Hk"], c["hd"])
            r = k5_vs_plain(q, k, v, MaskSpec(*c["mask"]),
                            c["H"] // c["Hk"], c["hd"] ** -0.5)
        else:
            q = rnd(c["BH"], c["S"], c["hd"])
            k = rnd(c["BH"], c["T"], c["hd"])
            v = rnd(c["BH"], c["T"], c["hd"])
            kw = dict(scale=c["hd"] ** -0.5, kv_len=c["kv_len"],
                      causal=kind == "causal", window=window, prefix_len=pre)
            got, _ = cuda.launch(q[:, None], k[:, None], v[:, None], n_rep=1,
                                 **kw)
            want = flash_attention_ref(q, k, v, **kw)
            r = _err_over_tol(got[:, :, 0], want,
                              k5_tolerance(q, k, v, want, **kw))
            if window:   # rows whose window lies wholly past kv_len
                empty = torch.arange(c["S"], device=device) - window + 1 \
                    >= c["kv_len"]
                if not bool(empty.any()):
                    bad.append(f"{c}: no row without a valid key")
        worst = max(worst, r["max_abs_err"])
        ratio = max(ratio, r["max_err_over_tol"])
        if not r["max_err_over_tol"] <= 1.0:
            bad.append(f"{c}: {r}")
    return dict(max_abs_err=worst, max_err_over_tol=ratio,
                cases=len(K5_CASES), failures=bad)


def k5_bound(B, S, T, H, Hk, hd, hv, mask, elem_bytes=2):
    """Least time for one K5 call: the larger of its operations (2·hd for
    q·k and 2·hv for p·v per kept pair, per head) over the bf16 tensor-core
    rate and its bytes (q, k, v read once, out written once) over HBM."""
    kind, window, pre = mask
    pairs = attention_pairs(S, T, T, kind == "causal", window, pre)
    flops = 2 * (hd + hv) * pairs * B * H
    nbytes = elem_bytes * (B * S * H * (hd + hv) + B * T * Hk * (hd + hv))
    t_ops = flops / BF16_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), flops, nbytes


def k5_timing(q, k, v, n_rep: int, runs: int):
    """K5 at the served shape (causal): CUDA-event median of the kernel,
    of its plain version and of one ``scaled_dot_product_attention`` call
    on the same inputs (kv repeated, ``is_causal=True``; timed here as a
    yardstick, never called by the port), and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_sdpa_ref
    from repro_torch.models.attention import CAUSAL
    B, S, H, hd = q.shape
    T, Hk, hv = k.shape[1], k.shape[2], v.shape[-1]
    scale = hd ** -0.5
    kern = lambda: ops.flash_sdpa(q, k, v, CAUSAL, n_rep, scale)
    plain = lambda: flash_sdpa_ref(q, k, v, CAUSAL, n_rep, scale)
    qh = q.transpose(1, 2)
    kh = k.repeat_interleave(n_rep, dim=2).transpose(1, 2)
    vh = v.repeat_interleave(n_rep, dim=2).transpose(1, 2)
    lib = lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                                 scale=scale)
    for _ in range(2):
        kern(), plain(), lib()
    n0 = ops.LAUNCHES
    k_ms, k_all = _event_ms(kern, runs)
    timed_launches = ops.LAUNCHES - n0
    p_ms, _ = _event_ms(plain, max(3, runs // 5))
    l_ms, _ = _event_ms(lib, runs)
    lib_err = float((lib().transpose(1, 2).reshape(B, S, H * hv).float()
                     - kern().float()).abs().max())
    b_ms, b_by, flops, nbytes = k5_bound(B, S, T, H, Hk, hd, hv,
                                         ("causal", 0, 0), q.element_size())
    out = dict(ms=k_ms, min_ms=min(k_all), max_ms=max(k_all), runs=runs,
               timed_launches=timed_launches, plain_ms=p_ms, library_ms=l_ms,
               library_vs_kernel_max_abs_err=lib_err, bound_ms=b_ms,
               bound_by=b_by, flops=flops, bytes=nbytes,
               tflops_per_s=flops / k_ms / 1e9, bound_share=b_ms / k_ms,
               shape=dict(B=B, S=S, T=T, H=H, Hk=Hk, hd=hd, dtype=str(q.dtype)))
    emit({"metric": "k5_ms", **out})
    emit({"metric": "k5_design", **k5_design(hd)})
    return out


def k5_design(head_dim: int) -> dict:
    """Evidence that the card runs K5's wgmma/TMA body: the kernel's
    registers a thread, its static and dynamic shared memory and its blocks
    a SM (``cudaFuncGetAttributes``, ``cudaOccupancyMaxActiveBlocksPer
    Multiprocessor``), and whether the built library's SASS holds warpgroup
    MMAs (``HGMMA``) and TMA tile loads (``UTMALDG``), read with
    ``cuobjdump -sass`` where the tool is on the path (else null; a
    library without them fails)."""
    import shutil
    from torch.utils.cpp_extension import CUDA_HOME
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.flash_attention import cuda
    out = dict(head_dim=head_dim, **cuda.kernel_attributes(head_dim))
    lib = nvcc.library_path(cuda.SOURCE)
    tool = shutil.which("cuobjdump") or (
        os.path.join(CUDA_HOME, "bin", "cuobjdump") if CUDA_HOME else None)
    sass = None
    if tool and os.path.exists(tool):
        r = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                           text=True, timeout=300)
        sass = r.stdout if r.returncode == 0 else None
    out.update(library=os.path.relpath(str(lib), ROOT), cuobjdump=tool,
               sass_has_hgmma=None if sass is None else "HGMMA" in sass,
               sass_has_utmaldg=None if sass is None else "UTMALDG" in sass)
    if sass is not None and not (out["sass_has_hgmma"]
                                 and out["sass_has_utmaldg"]):
        raise AssertionError(f"K5's library lacks HGMMA or UTMALDG: {out}")
    return out


def capture_qkv(params, cfg, toks, layers):
    """q, k, v of ``layers`` in one prefill of ``toks`` [1, S] (the inputs
    K5 gets there), by running the blocks one at a time."""
    from repro_torch.models import attention as A
    from repro_torch.models import blocks as BLK
    from repro_torch.models import lm
    from repro_torch.models.layers import apply_norm
    x = params["embed"][toks.long()]
    B, S = toks.shape
    pos = torch.arange(S, dtype=torch.int32, device=toks.device).expand(B, S)
    mask = A.MaskSpec("causal", cfg.window, 0)
    out = {}
    for i, (kind, n) in enumerate(BLK.block_kinds(cfg)):
        for j in range(n):
            pl = lm.layer_params(params[f"seg{i}"], j)
            if j in layers:
                h = apply_norm(x, pl["ln1"], cfg.norm, cfg.norm_eps)
                out[j] = A._qkv(pl["attn"], cfg, h, pos)
            x, _ = BLK.block_forward(pl, cfg, kind, x, pos, mask)
    return out


def _pool_diffs(pa, pb):
    out = [f for f in ("used", "refs", "last_access", "hits")
           if not np.array_equal(getattr(pa, f), getattr(pb, f))]
    return out + (["clock"] if pa.clock != pb.clock else [])


def _serve_engine(cfg, params, scfg, reqs, dev):
    """Serve ``reqs`` with a fresh ``Engine``, recording every call the
    engine makes to its prefix cache, checking each load of cached KV
    against the request's own prefill, timing each prefill and decode
    step, and counting the kernel launches of the run. Returns
    ``(results, fails, log)``, ``log`` the recorded cache calls; the engine
    is freed on return."""
    from repro_torch import obs
    from repro_torch.core import fsck
    from repro_torch.core.traverse import TraversalEngine
    from repro_torch.kernels.flash_attention import ops as k5
    from repro_torch.kernels.fused_descent import ops as k1
    from repro_torch.kernels.fused_scan import ops as k2
    from repro_torch.models.attention import FLASH_THRESH
    from repro_torch.serving import Engine, PrefixCache
    on_card = dev.type == "cuda"
    bt = scfg.block_tokens
    eng = Engine(cfg, params, scfg)
    pc = eng.prefix
    log, kv_errs, prefill_ms, step_ms = [], [], [], []
    match, publish = pc.match, pc.publish
    load, prefill, step = eng._load_blocks, eng._prefill, eng.step

    def rec_match(prompts):
        out = match(prompts)
        log.append(("match", [np.array(p) for p in prompts], out))
        return out

    def rec_publish(toks, n_known):
        out = publish(toks, n_known)
        log.append(("publish", np.array(toks), n_known,
                    None if out is None else out.copy()))
        return out

    def checked_load(slot, pages):
        # the slot holds the request's own prefill KV; the pages, written
        # by an earlier request with the same token prefix, must give the
        # same KV for those positions
        n = len(pages) * bt
        own = (eng.cache.k[:, slot, :n].clone(),
               eng.cache.v[:, slot, :n].clone())
        load(slot, pages)
        for o, got in zip(own, (eng.cache.k, eng.cache.v)):
            err = float((got[:, slot, :n].float() - o.float()).abs().max())
            kv_errs.append((err, 2.0 ** -6 * float(o.float().abs().max())))

    def timed(fn, times):
        def run(*a):
            _sync(dev)
            t = time.perf_counter()
            out = fn(*a)
            _sync(dev)
            times.append((time.perf_counter() - t) * 1e3)
            return out
        return run

    pc.match, pc.publish = rec_match, rec_publish
    eng._load_blocks = checked_load
    eng._prefill = timed(prefill, prefill_ms)
    eng.step = timed(step, step_ms)

    obs.enable()
    obs.reset()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    k1.LAUNCHES = k2.LAUNCHES = k5.LAUNCHES = 0     # counts from this path only
    t0 = time.perf_counter()
    done = eng.run(reqs)
    _sync(dev)
    run_s = time.perf_counter() - t0
    launches = dict(k1=k1.LAUNCHES, k2=k2.LAUNCHES, k5=k5.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    value = lambda name, **kw: getattr(obs.get_metric(name, **kw), "value", 0)
    ops = {op: value("op.calls", op=op)
           for op in ("lookup", "insert", "remove", "scan")}
    ins_rounds = value("op.rounds", op="insert")
    lat = obs.get_metric("serve.request_latency_s")
    obs.disable()

    fails = []
    new_tokens = scfg.max_new_tokens
    if not all(r.done and len(r.out) == new_tokens for r in done):
        fails.append("a request is not done with max_new_tokens tokens")
    n_match = sum(1 for e in log if e[0] == "match")
    plen = max(len(r) for r in reqs)
    want = dict(
        # one K1 descent per match, per insert's probe and insert round,
        # per eviction's remove; one K2 scan per eviction; one K5 launch per
        # layer of every prefill above FLASH_THRESH
        k1=n_match + ops["insert"] + ins_rounds + ops["remove"],
        k2=ops["scan"],
        k5=cfg.n_layers * len(prefill_ms) if plen * plen > FLASH_THRESH
        else 0)
    if ops["lookup"] != n_match:
        fails.append(f"{ops['lookup']} lookups for {n_match} matches")
    if on_card and launches != want:
        fails.append(f"launches {launches}, expected {want}")
    stats = dict(pc.stats)
    if not (stats["evicts"] > 0 and stats["hits"] > 0):
        fails.append(f"no eviction or no hit: {stats}")
    rep = fsck.check(pc.tree)
    if not rep.ok:
        fails.append(f"fsck: {rep.violations[:3]}")
    # the same calls on a CPU cache with the plain "torch" tree engine
    t0 = time.perf_counter()
    cpu = PrefixCache(scfg.n_pages, bt,
                      engine=TraversalEngine("torch", collect_stats=False),
                      target="cpu")
    for e in log:
        if e[0] == "match":
            same = cpu.match(e[1]) == e[2]
        else:
            got = cpu.publish(e[1], e[2])
            same = (got is None) == (e[3] is None) and (
                got is None or np.array_equal(got, e[3]))
        if not same:
            fails.append(f"replay: a {e[0]} answers otherwise on the CPU")
            break
    replay_s = time.perf_counter() - t0
    diffs = tree_diffs(pc.tree, cpu.tree) + _pool_diffs(pc.pool, cpu.pool)
    if diffs or cpu.stats != stats:
        fails.append(f"card cache != CPU replay: {diffs[:5]}, "
                     f"{stats} vs {cpu.stats}")
    kv_err = max((e for e, _ in kv_errs), default=0.0)
    if not kv_errs or any(not e <= tol for e, tol in kv_errs):
        fails.append(f"cached KV off the request's own prefill "
                     f"({len(kv_errs) // 2} loads, max err {kv_err})")
    res = dict(run_s=run_s, new_tokens=sum(len(r.out) for r in done),
               prefill_ms=prefill_ms, step_ms=step_ms, launches=launches,
               expected_launches=want, op_calls=ops, insert_rounds=ins_rounds,
               cache_stats=stats, hit_rate=pc.hit_rate(),
               hit_blocks=[r.cached_blocks for r in done], fsck_ok=rep.ok,
               replay_equal=not diffs and cpu.stats == stats,
               replay_s=replay_s, kv_loads_checked=len(kv_errs) // 2,
               kv_load_max_abs_err=kv_err, peak_bytes=peak,
               latency_p50_s=lat.p50 if lat is not None else None,
               latency_p99_s=lat.p99 if lat is not None else None)
    return res, fails, log


def run_serve(*, seed, runs=25):
    """The ``serve`` phase on the card: :data:`SERVE_MIX` on
    ``get_config("yi-9b")`` (full width and depth, bf16 weights from
    ``lm.init_params`` under a generator seeded with ``seed``) through the
    FB+-tree prefix cache with the ``"fused"`` tree engine; the checks of
    :func:`_serve_engine`, two fresh engines serving ``reqs[0]`` alike, K5
    against its plain version on the real q, k, v of the first and last
    layer and on ``K5_CASES``, and K5's timing at the served shape.
    Returns ``(phase line, K5 timing, recorded cache calls)``."""
    return _serve(seed, torch.device("cuda"), runs, **SERVE_MIX)


def rehearse_serve(seed=0):
    """The ``serve`` phase on the CPU, on yi-9b's SMOKE config with
    :data:`REHEARSAL_MIX`: every check of the phase but the kernel's (no
    kernel runs on the CPU: K5 stays below ``FLASH_THRESH`` and K1/K2 run
    their plain versions). Returns the phase's JSON object."""
    return _serve(seed, torch.device("cpu"), 0, **REHEARSAL_MIX)[0]


def _serve(seed, dev, runs, *, smoke, n_req, plen, shared, new_tokens,
           n_pages):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import lm
    from repro_torch.models.attention import CAUSAL
    from repro_torch.serving import Engine, ServeConfig
    on_card = dev.type == "cuda"
    cfg = get_config(SERVE_ARCH, smoke=smoke)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    _sync(dev)
    init_s = time.perf_counter() - t0
    reqs = make_requests(n_req, cfg.vocab, shared, plen, seed=seed)
    scfg = ServeConfig(max_batch=4, s_max=plen + new_tokens + 8,
                       block_tokens=16, n_pages=n_pages,
                       max_new_tokens=new_tokens, tree_backend="fused")
    res, fails, log = _serve_engine(cfg, params, scfg, reqs, dev)
    if on_card:
        torch.cuda.empty_cache()
    # determinism: two fresh engines serving reqs[0] alone
    solo = [Engine(cfg, params, scfg).run([reqs[0]])[0].out for _ in range(2)]
    if solo[0] != solo[1]:
        fails.append(f"fresh engines disagree on reqs[0]: {solo}")
    # K5 on the real q, k, v of the first and the last layer of one prefill
    n_rep = cfg.n_heads // cfg.n_kv_heads
    real, sweep, timing = {}, {}, None
    with torch.inference_mode():
        qkv = capture_qkv(params, cfg, torch.as_tensor(reqs[0], device=dev)
                          [None], (0, cfg.n_layers - 1))
        for layer, (q, k, v) in qkv.items():
            real[layer] = k5_vs_plain(q, k, v, CAUSAL, n_rep, cfg.hd ** -0.5)
            if not real[layer]["max_err_over_tol"] <= 1.0:
                fails.append(f"K5 layer {layer}: {real[layer]}")
        if on_card:    # no kernel runs on the CPU: nothing to sweep
            for dt in (torch.float32, torch.bfloat16):
                s = k5_sweep(dev, dt, seed)
                fails += [f"K5 sweep {dt}: {b}" for b in s.pop("failures")]
                sweep[str(dt)] = s
            timing = k5_timing(*qkv[0], n_rep, runs)
    del qkv
    n_params = sum(t.numel() for t in _leaves(params))
    pm, sm = res.pop("prefill_ms"), res.pop("step_ms")
    out = {"phase": "serve", "arch": cfg.name, "params": n_params,
           "init_s": init_s, "requests": n_req, "prompt_len": plen,
           "shared_prefix": shared, "serve_config": {
               k: v for k, v in dataclasses.asdict(scfg).items()
               if k != "faults"},
           "prefills": len(pm), "decode_steps": len(sm), **res,
           "solo_equal": solo[0] == solo[1], "k5_real": real,
           "k5_sweep": sweep, "fails": fails}
    emit(out)
    emit({"metric": "serve_prefill_ms_per_request",
          "value": statistics.median(pm), "all": pm,
          "clock": "host, synchronized"})
    emit({"metric": "serve_decode_step_ms", "value": statistics.median(sm),
          "min": min(sm), "max": max(sm), "steps": len(sm),
          "clock": "host, synchronized"})
    emit({"metric": "serve_new_tokens_per_s",
          "value": res["new_tokens"] / res["run_s"],
          "new_tokens": res["new_tokens"], "run_s": res["run_s"]})
    emit({"metric": "serve_request_latency_s", "p50": res["latency_p50_s"],
          "p99": res["latency_p99_s"],
          "source": "obs histogram serve.request_latency_s (log2 buckets)"})
    emit({"metric": "serve_peak_device_bytes", "value": res["peak_bytes"]})
    if fails:
        raise AssertionError("serve: " + "; ".join(fails))
    return out, timing, log


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# ------------------------------------------------------------------ training

TRAIN_ARCH = "yi-9b"
H100_BF16_PEAK = 989.4e12     # H100 SXM dense bf16 tensor-core FLOP/s, data sheet
# The trained configuration: yi-9b at full width (d_model 4096, GQA 32/4,
# head dim 128, d_ff 11,008, vocab 64,000, bf16 params, AdamW with float32
# m, v and master: 16 bytes a parameter), depth cut from 48 layers to 8
# (8.83B parameters would need 141 GB of state, 8 layers' 1.91B 30.5 GB);
# train_4k's 4,096 tokens a sequence, its global batch of 256 cut to 2 in
# 2 microbatches; 12 steps.
TRAIN_RUN = dict(n_layers=8, seq=4096, batch=2, n_micro=2, steps=12)
# (d) the card against the CPU: yi-9b's SMOKE widths and 2 layers, one
# step of 2 sequences of 2,304 tokens (S*T above FLASH_THRESH: K5 runs on
# the card, _sdpa_flash on the CPU) in 2 microbatches.
TRAIN_PARITY = dict(seq=2304, batch=2, n_micro=2)
# (e) the restart path: SMOKE size, 12 steps of 2 x 64 tokens, a
# checkpoint every 4 steps, a worker lost at step 6.
TRAIN_RESTART = dict(seq=64, batch=2, steps=12, save_every=4, fail_at=6)

K5_GRAD_BOUND = (
    "per element, with the exact float32 softmax weights P, dP = g v^T, "
    "D = rowsum(P dP), dS = P (dP - D) and u = 2^-8 (bf16; 2^-24 and "
    "+1e-4 max|want| for float32): 2^-6 |want| + 8 x the rounding std of "
    "the bf16 products (u sqrt(sum t^2) over each sum's terms t), of D and "
    "of the tile-max path, + u x the tile partials' magnitudes")
TRAIN_STEP_BOUND = (
    "card vs CPU, one bf16 AdamW step: loss and ce within 2e-3 relative, "
    "grad_norm within 3e-2 relative, lr within 1e-6; every parameter element "
    "within 2 lr + 2^-7 |cpu| and each tensor's mean |diff| within lr / 4")
TRAIN_RESTART_BOUND = "each step's loss within 1e-3 relative of the uninterrupted run's"


def k5_grad_tolerance(q, k, v, g, want, *, scale, causal, window=0,
                      prefix_len=0, q_chunk=1024, kv_chunk=1024):
    """The bound the flash-attention Function's gradients (the recompute
    backward through ``_sdpa_flash``) are held to against
    autograd through the plain version in float32, per element: flat
    q [BH,S,hd], k/v [BH,T,hv] (kv repeated), the output cotangent g
    [BH,S,hv] and ``want`` = {"dq", "dk", "dv"} (flat, float32).

    The backward recomputes in float32 from exact bf16 products but rounds
    to bf16 (unit u = 2^-8 of each value): the weights p before p.v, each
    tile's p.v sum, the cotangent of p.v's output, dP = g.v^T, and each q
    chunk's dk and dv sums. With P, dP, D = Σ_j P·dP and dS = P·(dP - D)
    exact:
    - 2^-6·|want|: the final rounding of both sides' gradients;
    - 8·u·sqrt(Σ t²) over each sum's terms t (dv: P·g; dq: P·|dP|·k; dk:
      P·|dP|·q): independent roundings with no common sign, whose sum has
      a standard deviation below u·sqrt(Σ t²)/sqrt(3) — the bound is ~14;
    - the error of D (a row's dO·O, O from rounded weights and partials),
      common to the row: 8·sD·|P·k| in dq, 8·sqrt(Σ_i (P·sD·q)²) in dk;
    - the tile-max path: autograd through the running max carries a row's
      rounding noise e = u·sqrt(Σ_j (P·dP)²) + sD to each tile's argmax
      key (exactly zero in exact arithmetic): 8·e·|k| there in dq, and
      8·Σ e·|q| over the rows whose max a key is, in dk;
    - u·Σ_chunks |partial|: dk's and dv's q-chunk sums, rounded each.
    Heads are bounded one at a time; the caller sums dk's and dv's bounds
    over a kv head's query heads."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ref import NEG, key_mask
    BH, S, _ = q.shape
    T = k.shape[1]
    bf16 = q.dtype == torch.bfloat16
    u = 2.0 ** -8 if bf16 else 2.0 ** -24
    m = key_mask(S, T, causal, window, prefix_len, q.device)
    live = m.any(-1)[:, None]
    nk = -(-T // kv_chunk)
    Tp = nk * kv_chunk
    tol = {n: torch.empty(w.shape, device=q.device) for n, w in want.items()}

    def chunks(w, x):        # Σ over q chunks of |w_chunk @ x_chunk|
        return sum((w[:, :, c:c + q_chunk] @ x[:, c:c + q_chunk]).abs()
                   for c in range(0, S, q_chunk))

    for i in range(0, BH, 8):                 # 8 heads' [S, T] at a time
        sl = slice(i, i + 8)
        qf, kf, vf, gf = (t[sl].float() for t in (q, k, v, g))
        b = qf.shape[0]
        s = torch.where(m, torch.einsum("bsh,bth->bst", qf, kf) * scale, NEG)
        P = torch.softmax(s, dim=-1) * live
        dP = gf @ vf.transpose(1, 2)
        D = (gf * (P @ vf)).sum(-1, keepdim=True)
        dS = P * (dP - D)
        Pd = P * dP.abs()
        del dP
        # each kv tile's p.v partial, as the forward rounds it
        parts = torch.einsum(
            "bsnk,bnkh->bsnh", F.pad(P, (0, Tp - T)).reshape(b, S, nk, -1),
            F.pad(vf, (0, 0, 0, Tp - T)).reshape(b, nk, kv_chunk, -1))
        sD = u * torch.sqrt((gf * gf * ((P * P) @ (vf * vf)
                                        + parts.square().sum(2)))
                            .sum(-1, keepdim=True))
        e = u * torch.sqrt((Pd * Pd).sum(-1, keepdim=True)) + sD
        # how often each key is a row's max in its tile
        sp = F.pad(s, (0, Tp - T), value=NEG).reshape(b, S, nk, kv_chunk)
        arg = sp.argmax(-1) + torch.arange(nk, device=q.device) * kv_chunk
        hit = torch.zeros_like(s)
        hit.scatter_add_(2, arg.clamp(max=T - 1),
                         (sp.amax(-1) > NEG / 2).float())
        del s, sp
        Pt = P.transpose(1, 2)
        tol["dv"][sl] = (8 * u * torch.sqrt((Pt * Pt) @ (gf * gf))
                         + u * chunks(Pt, gf))
        tol["dq"][sl] = 8 * scale * (
            u * torch.sqrt((Pd * Pd) @ (kf * kf)) + sD * (P @ kf).abs()
            + e * (hit @ kf.abs()))
        tol["dk"][sl] = scale * (8 * (
            u * torch.sqrt((Pd * Pd).transpose(1, 2) @ (qf * qf))
            + torch.sqrt((P * sD).square().transpose(1, 2) @ (qf * qf))
            + (hit * e).transpose(1, 2) @ qf.abs())
            + u * chunks(dS.transpose(1, 2), qf))
    for n, w in want.items():
        tol[n] += 2.0 ** -6 * w.abs()
        if not bf16:
            tol[n] += 1e-4 * float(w.abs().max())
    return tol


def k5_grad_check(q, k, v, g, mask, n_rep: int, scale: float) -> dict:
    """``ops.flash_sdpa`` under autograd on q [B,S,H,hd], k/v [B,T,Hk,hv]
    for the output cotangent g [B,S,H*hv]. ``forward``: its output (on the
    card, one K5 launch) against the plain version, :func:`k5_check`.
    ``backward``: dq, dk, dv of the recompute backward, which recomputes
    through the plain tiled path and never reads K5's output, against
    autograd through ``flash_attention_ref`` in float32, within
    :func:`k5_grad_tolerance`: each one's max |error|, max error / bound
    and mean bound / mean |want|, and their worst max error / bound. Each
    max error / bound is at most 1 to pass."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (flash_attention_ref,
                                                         to_flat)
    B, S, H, hd = q.shape
    T, Hk, hv = k.shape[1], k.shape[2], v.shape[-1]
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    out = ops.flash_sdpa(*ins, mask, n_rep, scale)
    fwd = k5_check(out.detach(), q, k, v, mask, n_rep, scale)
    got = torch.autograd.grad(out, ins, g)
    del out
    kw = dict(scale=scale, causal=mask.kind == "causal", window=mask.window,
              prefix_len=mask.prefix_len)
    flat = to_flat(q, k, v, n_rep)
    gf = g.reshape(B, S, Hk, n_rep, hv).permute(0, 2, 3, 1, 4) \
          .reshape(B * H, S, hv)
    want = {n: torch.empty(t.shape, device=q.device)
            for n, t in zip(("dq", "dk", "dv"), flat)}
    for i in range(0, B * H, 8):              # 8 heads' [S, T] at a time
        ins_f = [t[i:i + 8].float().requires_grad_() for t in flat]
        o = flash_attention_ref(*ins_f, kv_len=T, **kw)
        for n, d in zip(("dq", "dk", "dv"),
                        torch.autograd.grad(o, ins_f, gf[i:i + 8].float())):
            want[n][i:i + 8] = d
    tol = k5_grad_tolerance(*flat, gf, want, **kw)
    unq = lambda t: t.reshape(B, Hk, n_rep, S, -1).permute(0, 3, 1, 2, 4) \
                     .reshape(B, S, H, -1)
    unkv = lambda t: t.reshape(B, Hk, n_rep, T, -1).sum(2).permute(0, 2, 1, 3)
    bwd = {}
    for n, d, fold in zip(("dq", "dk", "dv"), got, (unq, unkv, unkv)):
        w, t = fold(want[n]), fold(tol[n])
        bwd[n] = dict(_err_over_tol(d, w, t),
                      mean_tol_over_mean_want=float(t.mean()
                                                    / w.abs().mean()))
    bwd["max_err_over_tol"] = max(r["max_err_over_tol"] for r in bwd.values())
    return {"forward": fwd, "backward": bwd}


def capture_train_qkv(cfg, seed: int, dev):
    """q, k, v of layer 0 in the first step of :func:`run_train`'s loop:
    the parameters ``init_state`` draws from ``seed`` (``lm.init_params``
    draws first) on the first sequence of ``TokenStream``'s batch 0."""
    from repro_torch.models import lm
    from repro_torch.train.data import DataConfig, TokenStream
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    data = TokenStream(DataConfig(vocab=cfg.vocab,
                                  global_batch=TRAIN_RUN["batch"],
                                  seq_len=TRAIN_RUN["seq"], seed=seed), cfg)
    toks = torch.from_numpy(data.batch_at(0)["tokens"][:1]).to(dev)
    with torch.no_grad():
        first = dataclasses.replace(cfg, n_layers=1)
        return capture_qkv(params, first, toks, (0,))[0]


def step_compare(got, want, mg, mw, lr: float) -> list:
    """The failures of one bf16 AdamW step on two devices against
    :data:`TRAIN_STEP_BOUND`: ``got``/``want`` the params after it,
    ``mg``/``mw`` its metrics."""
    from repro_torch.train.tree import tree_paths
    fails = []
    for key, rel in (("loss", 2e-3), ("ce", 2e-3), ("grad_norm", 3e-2)):
        a, b = float(mg[key]), float(mw[key])
        if not abs(a - b) <= rel * abs(b):
            fails.append(f"{key} {a} vs {b}")
    if not abs(float(mg["lr"]) - float(mw["lr"])) <= 1e-6 * float(mw["lr"]):
        fails.append(f"lr {float(mg['lr'])} vs {float(mw['lr'])}")
    wants = dict(tree_paths(want))
    for key, a in tree_paths(got):
        a, b = a.float().cpu(), wants[key].float().cpu()
        d = (a - b).abs()
        if not bool((d <= 2 * lr + 2.0 ** -7 * b.abs()).all()):
            fails.append(f"{key}: max |diff| {float(d.max())}")
        if not float(d.mean()) <= lr / 4:
            fails.append(f"{key}: mean |diff| {float(d.mean())}")
    return fails


def train_parity(seed: int, dev) -> tuple:
    """Check (d): one ``make_train_step`` step of yi-9b's SMOKE config at
    :data:`TRAIN_PARITY` from one state on ``dev`` and on the CPU (the CPU
    runs ``_sdpa_flash``), within :data:`TRAIN_STEP_BOUND`. On the CPU
    alone it runs the CPU side. Returns (result, failures)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as k5
    from repro_torch.train import optim as O
    from repro_torch.train.data import DataConfig, TokenStream
    from repro_torch.train.train_step import init_state, make_train_step
    from repro_torch.train.tree import tree_map
    cfg = get_config(TRAIN_ARCH, smoke=True)
    ocfg = O.OptConfig(lr=1e-3, warmup=1, total_steps=10)
    state = init_state(cfg, ocfg, torch.Generator().manual_seed(seed))
    batch = TokenStream(DataConfig(vocab=cfg.vocab,
                                   global_batch=TRAIN_PARITY["batch"],
                                   seq_len=TRAIN_PARITY["seq"], seed=seed),
                        cfg).batch_at(0)
    runs, fails = {}, []
    for d in dict.fromkeys([str(dev), "cpu"]):
        st = tree_map(lambda t: t.to(d, copy=True), state)
        b = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
        n0 = k5.LAUNCHES
        st, m = make_train_step(cfg, ocfg, n_micro=TRAIN_PARITY["n_micro"])(
            st, b)
        runs[d] = (st["params"], m, k5.LAUNCHES - n0)
    cpu_m = runs["cpu"][1]
    res = {"cpu_loss": float(cpu_m["loss"]),
           "cpu_grad_norm": float(cpu_m["grad_norm"])}
    if not all(torch.isfinite(v).all() for v in cpu_m.values()):
        fails.append(f"non-finite CPU metrics {cpu_m}")
    if str(dev) != "cpu":
        p, m, launched = runs[str(dev)]
        want = cfg.n_layers * TRAIN_PARITY["n_micro"]
        if launched != want:
            fails.append(f"card step: {launched} K5 launches, expected {want}")
        fails += step_compare(p, runs["cpu"][0], m, cpu_m, ocfg.lr)
        res.update(card_loss=float(m["loss"]),
                   card_grad_norm=float(m["grad_norm"]), k5_launches=launched)
    return res, fails


def train_restart(seed: int, dev) -> tuple:
    """Check (e): ``train_loop`` at SMOKE size on ``dev`` with checkpoints
    in a temporary directory and a failure injected: exactly one restart,
    every step's loss equal to an uninterrupted run's within
    :data:`TRAIN_RESTART_BOUND`, and a saved state restored (onto a meta
    template) to equal tensors. Returns (result, failures)."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import train_loop
    from repro_torch.train import checkpoint as CK
    from repro_torch.train import optim as O
    from repro_torch.train.train_step import state_template
    from repro_torch.train.tree import tree_paths
    cfg = get_config(TRAIN_ARCH, smoke=True)
    r = TRAIN_RESTART
    mesh = make_local_mesh(device=str(dev))
    kw = dict(save_every=r["save_every"], mesh=mesh, seed=seed,
              log_every=10 ** 9)
    fails = []
    with tempfile.TemporaryDirectory() as tmp:
        hurt = train_loop(cfg, r["steps"], r["batch"], r["seq"],
                          ckpt_dir=os.path.join(tmp, "a"),
                          inject_failure=r["fail_at"], **kw)
        whole = train_loop(cfg, r["steps"], r["batch"], r["seq"], **kw)
        ocfg = O.OptConfig(lr=1e-3, warmup=min(20, r["steps"] // 5 or 1),
                           total_steps=r["steps"])
        back, step = CK.restore(os.path.join(tmp, "a"),
                                state_template(cfg, ocfg), device=dev)
    if len(hurt["restarts"]) != 1:
        fails.append(f"{len(hurt['restarts'])} restarts, expected 1")
    worst = 0.0
    for s in range(r["steps"]):
        a, b = hurt["losses"].get(s), whole["losses"][s]
        worst = max(worst, abs(a - b) / abs(b) if a is not None else np.inf)
    if not worst <= 1e-3:
        fails.append(f"losses after the restart off by {worst} (relative)")
    saved = dict(tree_paths(hurt["state"]))
    diff = [k for k, t in tree_paths(back) if not torch.equal(t, saved[k])]
    if step != r["steps"] or diff:
        fails.append(f"restored step {step}, unequal tensors {diff[:5]}")
    return dict(restarts=hurt["restarts"], max_loss_rel_diff=worst,
                losses=[hurt["losses"][s] for s in range(r["steps"])],
                restored_step=step, restored_equal=not diff), fails


def k5_train_timing(q, k, v, g, n_rep: int, runs: int) -> dict:
    """K5's forward at the training shape and the recompute backward
    (``ops.flash_sdpa_backward``) on the same inputs, CUDA-event medians;
    the forward's bound as :func:`k5_bound` counts it."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.attention import CAUSAL
    B, S, H, hd = q.shape
    T, Hk, hv = k.shape[1], k.shape[2], v.shape[-1]
    scale = hd ** -0.5
    with torch.no_grad():
        fwd = lambda: ops.flash_sdpa(q, k, v, CAUSAL, n_rep, scale)
        bwd = lambda: ops.flash_sdpa_backward(q, k, v, g, CAUSAL, n_rep,
                                              scale)
        fwd(), bwd()
        f_ms, f_all = _event_ms(fwd, runs)
        b_ms, b_all = _event_ms(bwd, max(3, runs // 5))
    b_bound, b_by, flops, nbytes = k5_bound(B, S, T, H, Hk, hd, hv,
                                            ("causal", 0, 0), q.element_size())
    return dict(forward_ms=f_ms, forward_min_ms=min(f_all),
                forward_bound_ms=b_bound, forward_bound_by=b_by,
                forward_flops=flops, backward_ms=b_ms,
                backward_min_ms=min(b_all), runs=runs,
                shape=dict(B=B, S=S, T=T, H=H, Hk=Hk, hd=hd,
                           dtype=str(q.dtype), mask="causal"))


def run_train(*, seed, runs=25, device="cuda"):
    """The ``train`` phase: (c) on the real q, k, v of layer 0, K5's
    forward at the training shape against its plain version and the
    recompute backward's gradients against autograd through it; the main
    path, ``train_loop`` on yi-9b at full width (:data:`TRAIN_RUN`: (a) K5 launches = layers x
    microbatches x steps, (b) every loss finite and the last 3 below the
    first 3); (d) :func:`train_parity`; (e) :func:`train_restart`; the
    step's time, tokens/s, ``train_mfu``, peak memory, and K5's forward
    and backward times at the training shape. Returns the phase line."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as k5
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import train_loop
    from repro_torch.models.attention import CAUSAL, FLASH_THRESH
    t_phase = time.perf_counter()
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    r = TRAIN_RUN
    cfg = get_config(TRAIN_ARCH, n_layers=r["n_layers"])
    n_rep = cfg.n_heads // cfg.n_kv_heads
    fails = []
    # (c) K5's forward and the recompute backward on layer 0's q, k, v of
    # the first step
    q, k, v = capture_train_qkv(cfg, seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    g = (torch.randn(q.shape[:2] + (q.shape[2] * v.shape[-1],),
                     generator=gen, device=dev) * 1e-3).to(q.dtype)
    k5c = k5_grad_check(q, k, v, g, CAUSAL, n_rep, cfg.hd ** -0.5)
    if not k5c["forward"]["max_err_over_tol"] <= 1.0:
        fails.append(f"K5's forward at the training shape: {k5c['forward']}")
    if not k5c["backward"]["max_err_over_tol"] <= 1.0:
        fails.append(f"the recompute backward's gradients: {k5c['backward']}")
    timing = k5_train_timing(q, k, v, g, n_rep, runs) if on_card else None
    del q, k, v, g
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    # the main path
    k5.LAUNCHES = 0                      # counts from this path only
    out = train_loop(cfg, r["steps"], r["batch"], r["seq"], seed=seed,
                     n_micro=r["n_micro"], mesh=make_local_mesh(
                         device=str(dev)), log_every=10 ** 9)
    launches = k5.LAUNCHES
    peak = torch.cuda.max_memory_allocated() if on_card else None
    n_params = sum(t.numel() for t in _leaves(out["state"]["params"]))
    del out["state"]
    losses = [out["losses"][s] for s in range(r["steps"])]
    want = cfg.n_layers * r["n_micro"] * r["steps"] \
        if r["seq"] ** 2 > FLASH_THRESH else 0
    if on_card and launches != want:
        fails.append(f"K5 launches {launches}, expected {want}")
    if not all(np.isfinite(losses)):
        fails.append(f"non-finite loss: {losses}")
    if not np.mean(losses[-3:]) < np.mean(losses[:3]):
        fails.append(f"the loss did not fall: {losses}")
    first_ms, *step_ms = (d * 1e3 for d in out["durations"])
    if on_card:
        torch.cuda.empty_cache()
    parity, f = train_parity(seed, dev)
    fails += [f"card vs CPU step: {x}" for x in f]
    restart, f = train_restart(seed, dev)
    fails += [f"restart: {x}" for x in f]
    tokens = r["batch"] * r["seq"]
    med = statistics.median(step_ms)
    res = {"phase": "train", "arch": cfg.name, "layers": cfg.n_layers,
           "params": n_params, "train_run": r, "losses": losses,
           "k5_launches": launches, "expected_k5_launches": want,
           "first_step_ms": first_ms, "step_ms": step_ms,
           "peak_bytes": peak, "k5_forward": k5c["forward"],
           "k5_forward_tolerance": K5_BOUND,
           "recompute_backward_grads": k5c["backward"],
           "recompute_backward_tolerance": K5_GRAD_BOUND, "card_vs_cpu": parity,
           "card_vs_cpu_tolerance": TRAIN_STEP_BOUND, "restart": restart,
           "restart_tolerance": TRAIN_RESTART_BOUND, "k5_train": timing,
           "phase_s": time.perf_counter() - t_phase, "fails": fails}
    emit(res)
    emit({"metric": "train_step_ms", "value": med, "min": min(step_ms),
          "max": max(step_ms), "steps": len(step_ms),
          "clock": "host, each step ending in float(loss), which waits for "
                   "the card (train_loop's durations); median of the steps "
                   "after the first"})
    emit({"metric": "train_tokens_per_s", "value": tokens / med * 1e3})
    emit({"metric": "train_mfu", "value": 6 * n_params * tokens
          / (med / 1e3) / H100_BF16_PEAK,
          "flops_per_step": 6 * n_params * tokens, "peak_flops_per_s":
          H100_BF16_PEAK, "peak_source": "H100 SXM data sheet, dense bf16",
          "counts": "6 x parameters x tokens (no attention term)"})
    emit({"metric": "train_peak_device_bytes", "value": peak})
    if timing is not None:
        emit({"metric": "k5_train_ms", **timing})
    if fails:
        raise AssertionError("train: " + "; ".join(fails))
    return res


def rehearse_train(seed=0):
    """The ``train`` phase's checks on the CPU: (b) on yi-9b's SMOKE
    config through ``train_loop`` (12 steps of 2 x 64 tokens in 2
    microbatches), (d) without the card side, (e) at SMOKE size. Returns
    ``{"losses", "card_vs_cpu", "restart"}``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import train_loop
    dev = torch.device("cpu")
    cfg = get_config(TRAIN_ARCH, smoke=True)
    out = train_loop(cfg, TRAIN_RUN["steps"], TRAIN_RUN["batch"], 64,
                     seed=seed, n_micro=TRAIN_RUN["n_micro"],
                     mesh=make_local_mesh(device="cpu"), log_every=10 ** 9)
    losses = [out["losses"][s] for s in range(TRAIN_RUN["steps"])]
    fails = []
    if not (all(np.isfinite(losses))
            and np.mean(losses[-3:]) < np.mean(losses[:3])):
        fails.append(f"losses {losses}")
    parity, f = train_parity(seed, dev)
    fails += f
    restart, f = train_restart(seed, dev)
    fails += f
    if fails:
        raise AssertionError("train rehearsal: " + "; ".join(fails))
    return {"losses": losses, "card_vs_cpu": parity, "restart": restart}


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
    del inserts
    ycsb2 = fbtree.bulk_build(dataclasses.replace(rebuilt.config, fs=2),
                              KeySet(lkb, lkl), lval, device=True, target=dev)
    f_outs = [run_factor("ycsb-rebuilt", {2: ycsb2, 4: rebuilt}, lkb, lkl,
                         lval, seed=args.seed, device=dev, batch=args.batch)]
    fqb, fql = f_outs[0][1]
    del ycsb2, lkb, lkl, lval
    torch.cuda.empty_cache()
    sh_out = run_shard(tree, kb, kl, seed=args.seed, device=dev,
                       batch=args.batch, runs=args.runs)
    del kb, kl
    torch.cuda.empty_cache()
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
    del tree, clean, dirty, rebuilt, qb, ql, sqb, sql, fqb, fql
    torch.cuda.empty_cache()
    s_out, k5t, s_log = run_serve(seed=args.seed, runs=args.runs)
    k5_checks = [*s_out["k5_real"].values(), *s_out["k5_sweep"].values()]
    shc_out = run_shard_cache(s_log, n_pages=s_out["serve_config"]["n_pages"],
                              block_tokens=s_out["serve_config"][
                                  "block_tokens"], device=dev)
    del s_log
    torch.cuda.empty_cache()
    t_out = run_train(seed=args.seed, runs=args.runs)
    k5_checks.append(t_out["k5_forward"])
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "fused_descent", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_descent.cu",
        "replaces": "src/repro/kernels/fused_descent/kernel.py:299",
        "launches": main_out["launches"] + sh_out["k1_launches"]
        + shc_out["k1_launches"],
        "launches_by_path": {"ycsb": main_out["launches"],
                             "shard": sh_out["k1_launches"],
                             "shard-cache": shc_out["k1_launches"]},
        "max_abs_err": main_out["kernel_vs_plain_max_abs_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None}, {
        "name": "fused_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_scan.cu",
        "replaces": "src/repro/kernels/fused_scan/kernel.py:237",
        "launches": e_out["k2_launches"] + sh_out["k2_launches"]
        + shc_out["k2_launches"],
        "launches_by_path": {"ycsb-e": e_out["k2_launches"],
                             "shard": sh_out["k2_launches"],
                             "shard-cache": shc_out["k2_launches"]},
        "max_abs_err": max(e_out["kernel_vs_plain_max_abs_err"],
                           a_out["kernel_vs_plain_max_abs_err"],
                           sh_out["k2_parked_vs_plain_max_abs_err"]),
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
        "library_ms": None}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:86",
        "launches": s_out["launches"]["k5"] + t_out["k5_launches"],
        "launches_by_path": {"serve": s_out["launches"]["k5"],
                             "train": t_out["k5_launches"]},
        "max_abs_err": max(r["max_abs_err"] for r in k5_checks),
        "max_err_over_tol": max(r["max_err_over_tol"] for r in k5_checks),
        "tolerance": K5_BOUND,
        "recompute_backward_max_abs_err": {
            n: t_out["recompute_backward_grads"][n]["max_abs_err"]
            for n in ("dq", "dk", "dv")},
        "recompute_backward_tolerance": K5_GRAD_BOUND,
        "train_forward_ms": t_out["k5_train"]["forward_ms"],
        "train_backward_ms": t_out["k5_train"]["backward_ms"],
        "ms": k5t["ms"], "plain_ms": k5t["plain_ms"],
        "bound_ms": k5t["bound_ms"], "bound_by": k5t["bound_by"],
        "library_ms": k5t["library_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention "
                   "(kv repeated, is_causal=True)",
        "per": "one prefill layer: " + ", ".join(
            f"{k}={v}" for k, v in k5t["shape"].items())}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
