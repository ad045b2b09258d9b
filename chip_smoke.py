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
launch of the flash-attention kernel K5), training, and the MoE family
(llama4-scout through ``Engine``, deepseek-v3's MLA with K5 at q/k head
dim 192), the vlm family (paligemma-3b, K5 at head dim 256 under the
prefix-LM mask), the enc-dec family (whisper-medium, K5 without a mask
over 32,768 frames), the ssm family (falcon-mamba-7b, no attention) and
the hybrid family (zamba2-7b, K5 at head dim 112 in its shared attention):

1. the card's name and power limit;
2. build of every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, sm_90a, all at once) into ``build/kernels/``; then
   ``dedupe``: the write path's dedupe kernel against its plain version
   bit for bit on every batch of :func:`dedupe_cases` (a zipfian batch of
   4,194,304 lanes among them) and with a table of B entries, and its time
   beside the plain sort chain's (:func:`run_dedupe`); every write op of
   the phases below dedupes through it (the kernels line counts its
   launches, by phase);
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
11. ``tpcc``: TPC-C's customer-name index (``bench/keysets/tpcc_customer.py``:
    10,020,000 keys of 32-40 bytes behind 8-24 shared ones, long equal
    feature runs) built on the card as the benchmark's ``tpcc-name-10M``
    builds it; every key looked up once through ``lookup_batch`` (engine
    ``"fused"``, stats off) in batches of 1,048,576, the benchmark's, one
    lane in ten with its last byte made one no key holds: present keys
    found with their record id, the others absent; K1's S = 2 build (as
    the library picks it) launched once a batch, counted by ``LAUNCHES``
    and by build in ``obs``; K1 == the plain version bit for bit on the
    first full batch and the ragged last; K1's time on a full batch;
12. ``shard``: the ycsb keys in 4 range shards on the card (DESIGN.md
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
13. timing with CUDA events: K1 on the main lookup batch; K2 on the last
    scan batch of the dirtied and of the clean tree; K3 at every level and
    K4 on the factor batch of the rebuilt tree, warm and with the L2
    flushed, and their design lines; the plain versions;
    ``lookup_batch`` (engines ``"fused"`` and ``"cuda"``), ``range_scan``
    and ``insert_batch`` end to end (host clock); each kernel's bound;
14. ``serve``: the port's ``Engine`` on ``get_config("yi-9b")`` (48 layers,
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
15. ``shard-cache``: the serve phase's recorded cache calls replayed on a
    ``PrefixCache(n_shards=4)`` with the ``"fused"`` engine on the card and
    on the CPU: every answer equal to the other's and to the unsharded
    cache's, pools, stats and every shard's arrays equal;
16. ``train``: ``launch/train.py::train_loop`` on yi-9b at full width, its
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
    backward's ms at the training shape;
17. ``serve-moe``: the MoE family at full width (:data:`SERVE_MOE`). (a)
    llama4-scout cut to 8 layers through the port's ``Engine`` (8 requests
    of the serve mix, gshard at capacity factor 1.25): the checks of
    ``serve`` (every request done, K5 8 times a prefill, hits and
    evictions, fsck, the CPU replay, cached KV), K5 against its plain
    version on layer 0's real q, k, v, ``moe_scatter`` and ``moe_mixed``
    against ``moe_gshard`` on layer 0's FFN input within :data:`MOE_BOUND`,
    and prefill then 4 decode steps against the teacher-forced forward on
    one 2,100-token sequence at capacity factor 8 (:data:`DECODE_BOUND`).
    (b) deepseek-v3 cut to 4 layers (3 dense, 1 MoE; no MTP) through
    ``lm.prefill`` (4 x 3,072 tokens; one warm-up and three timed, the
    median reported) and 16 ``lm.decode_step`` calls: K5 once a layer a
    prefill, K5 on layer 0's real MLA q, k, v (q/k 192, v 128) within
    :func:`k5_tolerance` and timed there beside
    ``scaled_dot_product_attention``, the dispatches on the MoE layer, and
    decode against forward. (c) both at SMOKE widths on the card against
    the CPU (:data:`MOE_PARITY_BOUND`), and a deepseek SMOKE train step
    (MoE, MLA, MTP) within :data:`TRAIN_STEP_BOUND`. It prints prefill ms
    a request, decode step ms, new tokens/s, peak memory and each
    dispatch's ms;
18. ``serve-vlm``: paligemma-3b as published (:data:`SERVE_VLM`; 18
    layers, heads of 256, 256 image patches before the text under the
    prefix-LM mask) through ``lm.prefill`` (4 x (256 + 2,048) tokens) and
    32 ``lm.decode_step`` calls: K5's (256, 256) build once a layer a
    prefill, K5 on layer 0's real q, k, v within :func:`k5_tolerance` and
    timed there and on one 8,192-token sequence beside
    ``scaled_dot_product_attention`` with the same mask, decode against
    forward, the SMOKE model on the card against the CPU
    (:data:`FAMILY_PARITY_BOUND`) and a SMOKE train step
    (:data:`TRAIN_STEP_BOUND`);
19. ``serve-whisper``: whisper-medium as configured
    (:data:`SERVE_WHISPER`; 24 + 24 layers) through ``lm.prefill`` (2
    requests of 32,768 frames and 256 tokens: K5 without a mask at
    32,768^2 in every encoder layer and at S != T in every cross
    attention) and 32 decode steps, with the checks of ``serve-vlm`` (K5's
    encoder check on the first and last 1,024 rows of layer 0);
20. ``serve-mamba``: falcon-mamba-7b as configured (:data:`SERVE_MAMBA`;
    64 mamba1 layers, no attention: K5 launches 0) through ``lm.prefill``
    (4 x 2,048 tokens; the chunked selective scan in torch ops) and 32
    decode steps, with decode against forward (on the float32 draws of the
    same seed, the bf16 model's drift printed beside it), the SMOKE model
    on the card against the CPU and a SMOKE train step; layer 0's mixer
    timed with CUDA events, split into its input projections, the scan and
    its output;
21. ``serve-zamba``: zamba2-7b as configured (:data:`SERVE_ZAMBA`; 13
    groups of 5 mamba2 layers, each followed by the shared attention+MLP
    block with its LoRA, then 3) through ``lm.prefill`` (4 x 3,072 tokens:
    K5 at head dim 112, the (128, 128) build, once an occurrence, 13
    launches a prefill) and 32 decode steps, with the checks of
    ``serve-mamba`` and K5 on the first occurrence's real q, k, v;
22. ``parallel``: (a) ``param_shardings`` of all ten configurations from
    ``lm.param_shapes`` on both production meshes (16 x 16 and 2 x 16 x
    16, abstract), fsdp off and on: every sharded dim divides; parameter
    GB, GB a device and ZeRO-1 AdamW state GB a device
    (``opt_state_shardings``); (b) a one-rank NCCL group and the
    ``DeviceMesh`` of a (1, 1) mesh: the train phase's yi-9b state placed
    by ``param_shardings`` (every local shard equal to its source) and one
    ``make_train_step`` step under ``ShardCtx`` whose loss equals the
    train phase's first-step loss bit for bit; (c) ``pipeline_apply`` on
    the reference's pipeline configuration (:data:`PIPE_DENSE`: 4 stages x
    8 layers, d 4,096, ff 16,384, bf16, 8 microbatches of 4 x 1,024
    tokens) bit for bit against the sequential stages and within
    :data:`PIPE_DENSE_BOUND` of the whole batch, timed; (d) yi-9b's 8
    layers as 4 stages of 2 decoder blocks (:data:`PIPE_YI`), forward and
    backward through the pipeline against the unpipelined stack
    (:data:`PIPE_YI_BOUND`), K5 once a layer a microbatch;
23. ``examples``: the four ``examples/*_torch.py`` twins on the card in
    this process (K1 and K2 launches counted), quickstart's, ycsb_demo's
    and serve_lm's output equal to their CPU runs', train_lm's loss falling
    with one restart;
24. ``dryrun``: the dry run (``launch/dryrun.py``, fake tensors on "cuda"
    over fake process groups of 256 and 512 ranks) of yi-9b's three
    shapes and deepseek-v3's train_4k on both meshes and the pipeline dry
    run, each a process of its own (:data:`DRYRUN_CELLS`), every record
    ``ok``; meanwhile the train phase's yi-9b as a 1 x 1 cell whose
    counted FLOPs must equal the same counter's over the real step
    (its predicted peak printed beside ``max_memory_allocated``), and K5
    through a one-rank NCCL DTensor equal to the plain call bit for bit,
    one launch.

Each phase prints one JSON line. The line before the last holds the
kernels table; the last line is ``{"ok": true, "device": ...}``. The script
exits non-zero, with no result, when there is no CUDA device, when the
port's sources are not beside it, or when any check fails. Run:
``python3 chip_smoke.py``; ``rehearse_serve()`` runs the serve phase's
checks on the CPU at SMOKE size, ``rehearse_shard()`` the shard phases'
at 6,000 keys, ``rehearse_train()`` the train phase's at SMOKE size,
``rehearse_serve_moe()`` the serve-moe phase's at SMOKE size,
``rehearse_serve_vlm()``, ``rehearse_serve_whisper()``,
``rehearse_serve_mamba()`` and ``rehearse_serve_zamba()`` the serve-vlm,
serve-whisper, serve-mamba and serve-zamba phases' at SMOKE size,
``rehearse_parallel()``, ``rehearse_examples()`` and
``rehearse_dryrun()`` the parallel, examples and dryrun phases' on the
CPU.
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


DEDUPE_LANES = 4_194_304     # ycsb-a's update batch


def dedupe_cases(seed: int, lanes: int = DEDUPE_LANES) -> dict:
    """Write batches for the dedupe kernel, ``name -> (qb u8 [B, L], ql
    int32 [B])`` as numpy: ``zipf``, ``lanes`` YCSB keys drawn zipfian
    (0.99) from ``lanes // 4`` keys, as skewed as ycsb-a's update batch
    (the hottest key takes ~6% of the lanes); ``distinct``, every lane its own key;
    ``one_key``, one key in every lane; ``length_only``, keys whose rows are
    equal and whose lengths differ (the bytes past a length are 0), each
    three times; ``width21``, ``width28`` and ``width32``, zipfian rows cut
    or zero-padded to widths read in bytes (21, 28) and in 8-byte words
    (32, as 24); ``single``, one lane."""
    rng = np.random.default_rng(seed)
    n_keys = max(lanes // 4, 64)
    kb, kl = ycsb_keys(n_keys, seed)
    zi = zipf_indices(rng, n_keys, lanes)
    small = min(lanes, 65_536)
    m = small // 9
    rows = kb[rng.choice(n_keys, m, replace=False)]
    cut = rng.integers(1, 21, m)
    rows[np.arange(kb.shape[1])[None, :] >= cut[:, None]] = 0
    lo = np.repeat(np.arange(m), 9)
    lo_len = (cut[lo] + np.tile(np.repeat(np.arange(3), 3), m)).astype(np.int32)
    lo_perm = rng.permutation(lo.size)
    zs = zi[:small]
    wide = np.zeros((small, 32), np.uint8)
    wide[:, :24] = kb[zs]
    return {
        "zipf": (kb[zi], kl[zi]),
        "distinct": (kb[rng.permutation(n_keys)[:small]],
                     np.full(min(small, n_keys), 23, np.int32)),
        "one_key": (np.repeat(kb[:1], small, 0), np.full(small, 23, np.int32)),
        "length_only": (rows[lo[lo_perm]], lo_len[lo_perm]),
        "width21": (np.ascontiguousarray(kb[zs, :21]),
                    np.full(small, 21, np.int32)),
        "width28": (np.pad(kb[zs], ((0, 0), (0, 4))), kl[zs]),
        "width32": (wide, kl[zs]),
        "single": (kb[:1], kl[:1]),
    }


def dedupe_vs_plain(qb, ql, capacity=None) -> dict:
    """The dedupe kernel on the card against the plain version
    (``batch_ops.dedupe_last_wins`` in lane order) on the CPU, bit for bit:
    winners and conflicts (raises on a difference). The kernel runs through
    the wrapper the write ops call (``ops.dedupe_last_lanes``), or, with
    ``capacity``, through the binding with a table of that size, to force
    probe chains. Returns the lanes, conflicts, probe steps, capacity and
    the largest difference found (0)."""
    from repro_torch.kernels.dedupe import cuda, ops, ref
    if capacity is None:
        w, c, p = ops.dedupe_last_lanes(qb, ql, count_probes=True)
    else:
        w, c, p = cuda.launch(qb, ql, capacity=capacity, count_probes=True)
    pw, pc = ref.dedupe_ref(qb.cpu(), ql.cpu())
    err = _exact("dedupe", ["winners", "conflicts"], [w.cpu(), c.cpu()],
                 [pw, pc])
    B = qb.shape[0]
    return {"lanes": B, "conflicts": int(c), "probes": int(p),
            "capacity": capacity or cuda.table_capacity(B),
            "max_abs_err": err}


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


TPCC_BATCH = 1 << 20    # lookups a call of the benchmark's workload-c


def build_label(labels: dict) -> str:
    """A K1 build as ``kernel.launches`` labels it: ``S<stripes>-G<lanes>``."""
    return f"S{labels['stripes']}-G{labels['lanes']}"


def run_tpcc(n: int, *, seed: int, device, runs: int = 25,
             batch: int = TPCC_BATCH) -> dict:
    """TPC-C's customer-name index at the benchmark's shapes: the keys of
    ``bench/keysets/tpcc_customer.py``, built with ``bulk_build(device=True)``
    and the tree settings of ``bench/configs/tpcc-name-10M.json`` as the
    harness builds them, every key looked up once through
    ``lookup_batch(engine="fused", collect_stats=False)`` in batches of
    ``batch``. One lane in ten has its last byte XORed with 0xA5, which
    no key holds there (C_FIRST is alphanumeric), so it must come back
    absent; every other lane found with its record id. On the card K1 runs
    the build the library picks for 40-byte keys (``cuda.stripes``: S = 2;
    ``cuda.lanes``: G lanes a query), one launch a batch, counted by
    ``LAUNCHES`` and by build (S and G) in ``obs``;
    the first full batch and the ragged last are held against the plain
    version exactly, and K1 is timed on the first."""
    from bench.keysets import tpcc_customer as tpcc
    from repro_torch import obs
    from repro_torch.core import batch_ops, fbtree
    from repro_torch.core.keys import KeySet
    from repro_torch.core.traverse import TraversalEngine
    from repro_torch.kernels.fused_descent import cuda as kcuda
    from repro_torch.kernels.fused_descent import ops

    with open(os.path.join(ROOT, "bench", "configs",
                           "tpcc-name-10M.json")) as f:
        conf = json.load(f)
    t0 = time.perf_counter()
    kb, kl = tpcc.generate(n, seed, device)
    L = kb.shape[1]
    cfg = fbtree.TreeConfig.plan(
        max_keys=int(n * conf["capacity_factor"]), key_width=L,
        ns=conf["ns"], fs=conf["fs"], leaf_fill=conf["leaf_fill"],
        inner_fill=conf["inner_fill"])
    tree = fbtree.bulk_build(cfg, KeySet(kb.cpu().numpy(), kl.cpu().numpy()),
                             np.arange(n, dtype=np.int32), device=True,
                             target=torch.device(device).type)
    _sync(device)
    build_s = time.perf_counter() - t0
    on_card = tree.device.type == "cuda"

    g = torch.Generator().manual_seed(seed + 29)
    perm = torch.randperm(n, generator=g).to(device)
    flip_all = (torch.rand(n, generator=g) < 0.1).to(device)
    eng = TraversalEngine("fused", collect_stats=False)
    n_batches = -(-n // batch)
    present = present_found = flipped = flipped_absent = 0
    batches = []
    ops.LAUNCHES = 0
    obs.disable(), obs.reset()
    obs.enable()
    try:
        for bi in range(n_batches):
            idx = perm[bi * batch:(bi + 1) * batch]
            flip = flip_all[bi * batch:(bi + 1) * batch]
            qb, ql = kb[idx].clone(), kl[idx]
            lanes = torch.arange(qb.shape[0], device=qb.device)
            last = ql.long() - 1
            qb[lanes, last] ^= torch.where(flip, 0xA5, 0).to(torch.uint8)
            vals, rep = batch_ops.lookup_batch(tree, qb, ql, engine=eng)
            ok = rep.found[~flip] & (vals[~flip] == idx[~flip].to(torch.int32))
            present += int((~flip).sum())
            present_found += int(ok.sum())
            flipped += int(flip.sum())
            flipped_absent += int((flip & ~rep.found).sum())
            if bi in (0, n_batches - 1):
                batches.append((qb, ql))
        launches = ops.LAUNCHES
        by_build = {build_label(dict(m.labels)): int(m.value)
                    for m in obs.all_metrics() if m.name == "kernel.launches"}
    finally:
        obs.disable(), obs.reset()
    if present_found != present or flipped_absent != flipped:
        raise AssertionError(
            f"tpcc: {present - present_found} of {present} present keys not "
            f"found with their value, {flipped - flipped_absent} of "
            f"{flipped} changed keys found")
    stripes = kcuda.stripes(L) if on_card else None
    lanes = kcuda.lanes(cfg.ns, L) if on_card else None
    build = build_label({"stripes": stripes, "lanes": lanes})
    if on_card and (launches != n_batches
                    or by_build != {build: n_batches}):
        raise AssertionError(f"tpcc: {launches} K1 launches ({by_build} by "
                             f"build) for {n_batches} lookup_batch calls")
    err = max(kernel_vs_plain(tree, qb, ql) for qb, ql in batches)
    out = {"phase": "tpcc", "keys": n, "width": L,
           "key_lens": [int(kl.min()), int(kl.max())], "ns": cfg.ns,
           "fs": cfg.fs, "n_levels": cfg.n_levels,
           "tree_bytes": tree_bytes(tree), "device_build_s": build_s,
           "batch": batch, "batches": n_batches, "launches": launches,
           "launches_by_build": by_build, "stripes": stripes,
           "lanes_per_query": lanes,
           "present": present, "present_found": present_found,
           "flipped": flipped, "flipped_absent": flipped_absent,
           "kernel_vs_plain_lanes": [qb.shape[0] for qb, _ in batches],
           "kernel_vs_plain_max_abs_err": err}
    if on_card:
        qb, ql = batches[0]
        kern = lambda: ops.fused_traverse_probe(tree, qb, ql,
                                                collect_stats=False)
        for _ in range(3):
            kern()
        k_ms, k_all = _event_ms(kern, runs)
        out.update(k1_ms=k_ms, k1_min_ms=min(k_all), k1_max_ms=max(k_all),
                   k1_runs=runs, k1_design=k1_design(cfg.ns, L))
    emit(out)
    return out


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
    from bench.keysets import tpcc_customer
    for L in (tree.config.key_width, tpcc_customer.WIDTH, URL_WIDTH):
        emit({"metric": "k1_design", **k1_design(tree.config.ns, L)})
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)


def run_dedupe(*, seed: int, runs: int, lanes: int = DEDUPE_LANES) -> dict:
    """The write path's dedupe kernel (``csrc/dedupe.cu``) against its plain
    version on every batch of :func:`dedupe_cases`, and with a table of
    ``B`` entries (probe chains) on ``zipf`` and ``distinct``; then, on
    ``zipf``, its device time (CUDA events; warm, and with the L2 flushed)
    beside the plain sort chain's on the card and the byte bound: the key
    batch read once and the winners written once, at 3.35 TB/s."""
    from repro_torch.kernels.dedupe import cuda, ref
    checks = {}
    for name, (qb, ql) in dedupe_cases(seed, lanes).items():
        q, l = torch.from_numpy(qb).cuda(), torch.from_numpy(ql).cuda()
        checks[name] = dedupe_vs_plain(q, l)
        if name in ("zipf", "distinct"):
            full = 1 << (q.shape[0] - 1).bit_length()
            checks[name + "_small_table"] = dedupe_vs_plain(q, l, capacity=full)
        if name == "zipf":
            zipf = (q, l)
    torch.cuda.synchronize()
    q, l = zipf
    B, L = q.shape
    kern = lambda: cuda.launch(q, l)
    plain = lambda: ref.dedupe_ref(q, l)
    for _ in range(3):
        kern(), plain()
    k_ms, k_all = _event_ms(kern, runs)
    f_ms, _ = _event_ms(kern, runs, flush=True)
    p_ms, _ = _event_ms(plain, runs)
    b_bytes = B * (L + 5)
    b_ms = b_bytes / 3.35e12 * 1e3
    out = {"phase": "dedupe", "checks": checks,
           "kernel_vs_plain_max_abs_err": max(
               c["max_abs_err"] for c in checks.values()),
           "lanes": B, "width": L,
           "ms": k_ms, "min_ms": min(k_all), "max_ms": max(k_all),
           "l2_flushed_ms": f_ms, "plain_ms": p_ms, "bound_ms": b_ms,
           "bound_by": "bytes", "bound_bytes": b_bytes,
           "bound_share": b_ms / k_ms, "runs": runs,
           "dedupe_design": {w: cuda.kernel_attributes(w)
                             for w in cuda.WORDS}}
    emit(out)
    return out


def k1_design(ns: int, L: int) -> dict:
    """What the K1 instantiation a lookup at ``ns`` and key width ``L``
    takes (stats off, sibling check and probe on) asks of the card:
    registers and local memory (spills) a thread, shared memory and threads
    a block, blocks a SM (``cudaFuncGetAttributes``,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``). The kernels have a
    build for each number of 32-byte stripes a key takes (``stripes_for``
    in ``csrc/cmp.cuh``): the timed ycsb width takes one, tpcc's 40 bytes
    two, ``URL_WIDTH`` three; each with the lanes a query of its lane
    groups (``lanes_for`` in ``csrc/fused_descent.cu``) and the queries a
    warp."""
    from repro_torch.kernels.fused_descent import cuda
    lanes = cuda.lanes(ns, L)
    return dict(ns=ns, key_width=L, stats=False, sibling=True, probe=True,
                stripes=cuda.stripes(L), lanes_per_query=lanes,
                queries_per_warp=32 // lanes,
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
# flash_sdpa never asks for). A case with "hv" has a v head dim of its own:
# the six after the first ten take the (192, 128) build, MLA's widths (S =
# T = 3,072 causal, a window, a prefix, kv_len < T, odd S and T, n_rep 1
# and 4; q/k 136 padded to 192 in shared memory); the next six the (256,
# 256) build, PaliGemma's (one sequence of its served prefill, 256 patches
# + 2,048 text tokens under the prefix-LM mask; a prefix of 200, no
# multiple of the 64-key tile; a window; kv_len < T; S != T without a
# mask; q/k 200 and v 136 padded to 256); the next is the (64, 64) build
# without a mask at S != T past one q tile and over several key tiles
# (whisper's cross attention); the last three take head dim 112 (zamba2's
# shared attention) through the (128, 128) build, zero-padded by TMA: MHA
# 32/32 causal at S = T = 3,072 (the served prefill's), a window, and a
# flat case with kv_len < T whose window leaves its last rows no key.
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
    dict(api="sdpa", B=1, S=3072, T=3072, H=16, Hk=16, hd=192, hv=128,
         mask=("causal", 0, 0)),
    dict(api="sdpa", B=1, S=1100, T=1100, H=8, Hk=2, hd=192, hv=128,
         mask=("causal", 300, 0)),
    dict(api="sdpa", B=2, S=257, T=257, H=4, Hk=4, hd=192, hv=128,
         mask=("causal", 0, 13)),
    dict(api="sdpa", B=1, S=131, T=71, H=4, Hk=1, hd=192, hv=128,
         mask=("full", 0, 0)),
    dict(api="flat", BH=3, S=301, T=333, hd=192, hv=128, kv_len=200,
         mask=("causal", 0, 0)),
    dict(api="flat", BH=2, S=200, T=256, hd=136, hv=64, kv_len=96,
         mask=("causal", 40, 0)),
    dict(api="sdpa", B=1, S=2304, T=2304, H=8, Hk=1, hd=256, hv=256,
         mask=("causal", 0, 256)),
    dict(api="sdpa", B=2, S=457, T=457, H=4, Hk=1, hd=256, hv=256,
         mask=("causal", 0, 200)),
    dict(api="sdpa", B=1, S=1100, T=1100, H=8, Hk=2, hd=256, hv=256,
         mask=("causal", 300, 0)),
    dict(api="flat", BH=3, S=301, T=333, hd=256, hv=256, kv_len=200,
         mask=("causal", 0, 0)),
    dict(api="sdpa", B=1, S=131, T=71, H=4, Hk=1, hd=256, hv=256,
         mask=("full", 0, 0)),
    dict(api="flat", BH=2, S=200, T=256, hd=200, hv=136, kv_len=96,
         mask=("causal", 40, 0)),
    dict(api="sdpa", B=2, S=300, T=1000, H=16, Hk=16, hd=64,
         mask=("full", 0, 0)),
    dict(api="sdpa", B=1, S=3072, T=3072, H=32, Hk=32, hd=112,
         mask=("causal", 0, 0)),
    dict(api="sdpa", B=2, S=1100, T=1100, H=4, Hk=4, hd=112,
         mask=("causal", 300, 0)),
    dict(api="flat", BH=3, S=256, T=300, hd=112, kv_len=96,
         mask=("causal", 40, 0)),
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
    # a NaN error is an infinite one, so the maxima below cannot drop it
    err = (got.float() - want.float()).abs().nan_to_num(nan=float("inf"))
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
    0). Returns the worst error, the worst error / bound, the failures and
    the indices of the failed cases."""
    from repro_torch.kernels.flash_attention import cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models.attention import MaskSpec
    gen = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=gen, device=device).to(dtype)
    worst = ratio = 0.0
    bad, failed = [], []
    for i, c in enumerate(K5_CASES):
        kind, window, pre = c["mask"]
        hv = c.get("hv", c["hd"])
        if c["api"] == "sdpa":
            q = rnd(c["B"], c["S"], c["H"], c["hd"])
            k = rnd(c["B"], c["T"], c["Hk"], c["hd"])
            v = rnd(c["B"], c["T"], c["Hk"], hv)
            r = k5_vs_plain(q, k, v, MaskSpec(*c["mask"]),
                            c["H"] // c["Hk"], c["hd"] ** -0.5)
        else:
            q = rnd(c["BH"], c["S"], c["hd"])
            k = rnd(c["BH"], c["T"], c["hd"])
            v = rnd(c["BH"], c["T"], hv)
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
            failed.append(i)
    return dict(max_abs_err=worst, max_err_over_tol=ratio,
                cases=len(K5_CASES), failures=bad, failed_cases=failed)


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


PLAIN_CHUNK_BYTES = 4 << 30   # float32 logits the plain version holds at once


def plain_sdpa(q, k, v, mask, n_rep: int, scale: float):
    """K5's plain version (``flash_sdpa_ref``) on q [B,S,H,hd], k/v
    [B,T,Hk,hv], one (sequence, kv head) group at a time when the whole
    call's float32 logits would pass ``PLAIN_CHUNK_BYTES`` (whisper's
    encoder: 32 heads of 32,768^2, ~137 GB); each group is the same
    function on its own heads, so the result is the same."""
    from repro_torch.kernels.flash_attention.ref import flash_sdpa_ref
    B, S, H, _ = q.shape
    T, Hk, hv = k.shape[1], k.shape[2], v.shape[-1]
    if 4 * B * H * S * T <= PLAIN_CHUNK_BYTES:
        return flash_sdpa_ref(q, k, v, mask, n_rep, scale)
    out = torch.empty((B, S, H, hv), dtype=q.dtype, device=q.device)
    for b in range(B):
        for g in range(Hk):
            hs = slice(g * n_rep, (g + 1) * n_rep)
            out[b:b + 1, :, hs] = flash_sdpa_ref(
                q[b:b + 1, :, hs], k[b:b + 1, :, g:g + 1],
                v[b:b + 1, :, g:g + 1], mask, n_rep, scale).view(
                    1, S, n_rep, hv)
    return out.reshape(B, S, H * hv)


def k5_check_rows(got, q, k, v, mask, n_rep: int, scale: float,
                  rows: int = 1024) -> dict:
    """:func:`k5_check` of K5's output ``got`` [B,S,H*hv] on the first and
    the last ``rows`` query rows only, where the whole [S, T] logits of the
    plain version and its bound do not fit the card (whisper's encoder at
    S = T = 32,768). Without a causal mask a row's output depends on that
    row's query alone, so the rows compared are those of the whole call."""
    if mask.kind == "causal":
        raise ValueError("k5_check_rows: rows depend on their index under "
                         "a causal mask")
    S = q.shape[1]
    head = min(rows, S)
    idx = torch.cat([torch.arange(head),
                     torch.arange(max(head, S - rows), S)]).to(q.device)
    r = k5_check(got[:, idx], q[:, idx], k, v, mask, n_rep, scale)
    return dict(r, rows_checked=int(idx.numel()), rows=S)


def sdpa_library(q, k, v, mask, n_rep: int, scale: float):
    """One ``scaled_dot_product_attention`` call computing what K5 computes
    on q [B,S,H,hd], k/v [B,T,Hk,hv] under ``mask`` (kv repeated to H
    heads; ``is_causal=True`` for a plain causal mask, none for ``FULL``, a
    boolean ``attn_mask`` for a window or a prefix), the backend PyTorch
    picks for it (``torch._fused_sdp_choice``; null where this PyTorch
    cannot say) and the call as a thunk. Timed as a yardstick, never
    called by the port."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ref import key_mask
    S, T = q.shape[1], k.shape[1]
    qh = q.transpose(1, 2)
    kh = k.repeat_interleave(n_rep, dim=2).transpose(1, 2)
    vh = v.repeat_interleave(n_rep, dim=2).transpose(1, 2)
    causal = mask.kind == "causal"
    am, is_causal = None, False
    if causal and (mask.window or mask.prefix_len):
        am = key_mask(S, T, True, mask.window, mask.prefix_len, q.device)
    else:
        is_causal = causal
    backend = None
    try:
        from torch.nn.attention import SDPBackend
        backend = SDPBackend(torch._fused_sdp_choice(
            qh, kh, vh, am, 0.0, is_causal, scale=scale)).name
    except (AttributeError, RuntimeError, ValueError):  # not exposed here
        pass

    def call():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=am,
                                              is_causal=is_causal, scale=scale)
    what = ("is_causal=True" if is_causal else "a boolean attn_mask"
            if am is not None else "no mask")
    return call, backend, f"kv repeated, {what}"


def k5_timing(q, k, v, n_rep: int, runs: int, scale=None, metric="k5_ms",
              mask=None, plain_runs=None):
    """K5 at a served shape under ``mask`` (causal when None): CUDA-event
    median of the kernel, of its plain version (:func:`plain_sdpa`, over
    ``plain_runs`` runs, default a fifth of ``runs`` and at least 3) and of
    one ``scaled_dot_product_attention`` call on the same inputs with the
    same mask (:func:`sdpa_library`), and the bound. ``scale`` is hd^-0.5
    when None. Prints the times as ``metric`` and a ``k5_design`` line for
    the build of these head dims."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.attention import CAUSAL
    mask = mask or CAUSAL
    B, S, H, hd = q.shape
    T, Hk, hv = k.shape[1], k.shape[2], v.shape[-1]
    scale = scale or hd ** -0.5
    kern = lambda: ops.flash_sdpa(q, k, v, mask, n_rep, scale)
    plain = lambda: plain_sdpa(q, k, v, mask, n_rep, scale)
    lib, backend, lib_what = sdpa_library(q, k, v, mask, n_rep, scale)
    plain_runs = plain_runs or max(3, runs // 5)
    for _ in range(2):
        kern(), lib()
    plain()
    n0 = ops.LAUNCHES
    k_ms, k_all = _event_ms(kern, runs)
    timed_launches = ops.LAUNCHES - n0
    p_ms, _ = _event_ms(plain, plain_runs)
    l_ms, _ = _event_ms(lib, runs)
    lib_err = float((lib().transpose(1, 2).reshape(B, S, H * hv).float()
                     - kern().float()).abs().max())
    b_ms, b_by, flops, nbytes = k5_bound(B, S, T, H, Hk, hd, hv,
                                         tuple(mask), q.element_size())
    out = dict(ms=k_ms, min_ms=min(k_all), max_ms=max(k_all), runs=runs,
               timed_launches=timed_launches, plain_ms=p_ms,
               plain_runs=plain_runs, library_ms=l_ms,
               library_backend=backend, library=lib_what,
               library_vs_kernel_max_abs_err=lib_err, bound_ms=b_ms,
               bound_by=b_by, flops=flops, bytes=nbytes,
               tflops_per_s=flops / k_ms / 1e9, bound_share=b_ms / k_ms,
               shape=dict(B=B, S=S, T=T, H=H, Hk=Hk, hd=hd, hv=hv,
                          mask=list(mask), dtype=str(q.dtype)))
    emit({"metric": metric, **out})
    emit({"metric": "k5_design", **k5_design(hd, hv)})
    return out


def k5_design(head_dim: int, v_head_dim: int) -> dict:
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
    out = dict(head_dim=head_dim, v_head_dim=v_head_dim,
               **cuda.kernel_attributes(head_dim, v_head_dim))
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


def capture_layers(params, cfg, toks, layers, patches=None) -> dict:
    """For each layer in ``layers``, what it sees in one forward of ``toks``
    [B, S] (after the vlm's projected ``patches``, under its prefix-LM
    mask, when given), by running the blocks one at a time up to the last
    of them: q, k, v and the scale K5 gets there (MLA's 192-wide q/k for
    deepseek), ``n_rep``, the mask, the layer's kind and parameters, and
    its FFN input (the normed hidden after its attention)."""
    from repro_torch.models import attention as A
    from repro_torch.models import blocks as BLK
    from repro_torch.models import lm
    from repro_torch.models import mla as MLA
    from repro_torch.models.layers import apply_norm
    x = params["embed"][toks.long()]
    pre = 0
    if patches is not None:
        x = torch.cat([patches.to(x.dtype) @ params["proj"], x], dim=1)
        pre = cfg.n_patches
    B, S = x.shape[:2]
    pos = torch.arange(S, dtype=torch.int32, device=toks.device).expand(B, S)
    mask = A.MaskSpec("causal", cfg.window, pre)
    out, i = {}, 0
    for si, (kind, n) in enumerate(BLK.block_kinds(cfg)):
        for j in range(n):
            if i > max(layers):
                return out
            pl = lm.layer_params(params[f"seg{si}"], j)
            if i in layers:
                h = apply_norm(x, pl["ln1"], cfg.norm, cfg.norm_eps)
                if kind.startswith("mla"):
                    q, k, v, scale = MLA.mla_qkv(pl["attn"], cfg, h, pos)
                else:
                    (q, k, v), scale = A._qkv(pl["attn"], cfg, h, pos), \
                        cfg.hd ** -0.5
                x = x + BLK._mixer(pl, cfg, kind, h, pos, mask)
                f_in = apply_norm(x, pl["ln2"], cfg.norm, cfg.norm_eps)
                out[i] = dict(q=q, k=k, v=v, scale=scale,
                              n_rep=q.shape[2] // k.shape[2], mask=mask,
                              kind=kind, params=pl, ffn_in=f_in)
                x = x + BLK._ffn(pl, cfg, f_in)[0]
            else:
                x, _ = BLK.block_forward(pl, cfg, kind, x, pos, mask)
            i += 1
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
        caps = capture_layers(params, cfg, torch.as_tensor(
            reqs[0], device=dev)[None], (0, cfg.n_layers - 1))
        for layer, c in caps.items():
            real[layer] = k5_vs_plain(c["q"], c["k"], c["v"], CAUSAL, n_rep,
                                      c["scale"])
            if not real[layer]["max_err_over_tol"] <= 1.0:
                fails.append(f"K5 layer {layer}: {real[layer]}")
        if on_card:    # no kernel runs on the CPU: nothing to sweep
            for dt in (torch.float32, torch.bfloat16):
                s = k5_sweep(dev, dt, seed)
                fails += [f"K5 sweep {dt}: {b}" for b in s.pop("failures")]
                sweep[str(dt)] = s
            timing = k5_timing(caps[0]["q"], caps[0]["k"], caps[0]["v"],
                               n_rep, runs)
    del caps
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
    "within 2 lr (1 + 2^-8) + 2^-7 |cpu| and each tensor's mean |diff| "
    "within lr / 4")
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
        c = capture_layers(params, cfg, toks, (0,))[0]
    return c["q"], c["k"], c["v"]


def param_step_bound(want, lr: float):
    """The per-element bound of :data:`TRAIN_STEP_BOUND` on the params
    after one bf16 AdamW step on two devices, ``want`` the CPU's. Adam's
    first update is lr times g / (|g| + eps) (weight decay alike on both),
    so where g's sign differs the float32 masters lie up to 2 lr apart;
    each side then rounds to bf16 at its own magnitude, within 2^-8 of it:
    2^-8 |cpu| + 2^-8 (|cpu| + 2 lr)."""
    return 2 * lr * (1 + 2.0 ** -8) + 2.0 ** -7 * want.abs()


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
        if not bool((d <= param_step_bound(b, lr)).all()):
            fails.append(f"{key}: max |diff| {float(d.max())}")
        if not float(d.mean()) <= lr / 4:
            fails.append(f"{key}: mean |diff| {float(d.mean())}")
    return fails


def k5_calls(cfg) -> int:
    """The attention calls of one forward pass (each a K5 launch on the
    card when its S·T passes ``FLASH_THRESH``): one a layer, one in the MTP
    block, and for enc-dec the encoder's layers and the decoder's cross
    attention too; none for ssm, one a shared-block occurrence for
    hybrid."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.hybrid_pattern().count("a")
    n = cfg.n_layers + cfg.mtp
    if cfg.family == "encdec":
        n += cfg.n_enc_layers + cfg.n_layers
    return n


def train_parity(seed: int, dev, arch: str = TRAIN_ARCH,
                 seq: int = TRAIN_PARITY["seq"], **over) -> tuple:
    """Check (d): one ``make_train_step`` step of ``arch``'s SMOKE config
    (yi-9b's; deepseek-v3's in ``serve-moe``: MoE, MLA and the MTP loss;
    paligemma-3b's and whisper-medium's in ``serve-vlm`` and
    ``serve-whisper``, their patches or frames from ``TokenStream``; ``over``
    overrides the config) at :data:`TRAIN_PARITY` (sequences of ``seq``
    tokens) from one state on ``dev`` and on the CPU (the CPU runs
    ``_sdpa_flash``), within :data:`TRAIN_STEP_BOUND`. On the CPU alone it
    runs the CPU side. Returns (result, failures)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as k5
    from repro_torch.train import optim as O
    from repro_torch.train.data import DataConfig, TokenStream
    from repro_torch.train.train_step import init_state, make_train_step
    from repro_torch.train.tree import tree_map
    cfg = get_config(arch, smoke=True, **over)
    ocfg = O.OptConfig(lr=1e-3, warmup=1, total_steps=10)
    state = init_state(cfg, ocfg, torch.Generator().manual_seed(seed))
    batch = TokenStream(DataConfig(vocab=cfg.vocab,
                                   global_batch=TRAIN_PARITY["batch"],
                                   seq_len=seq, seed=seed),
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
        # one launch an attention call a microbatch
        want = k5_calls(cfg) * TRAIN_PARITY["n_micro"]
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


# ------------------------------------------------------------------ serve-moe

# The MoE family at full width. llama4-scout (GQA 40/8, head dim 128, 16
# experts of d_ff 8,192, a top-1 softmax router, a shared expert, vocab
# 202,048; gshard at capacity factor 1.25), cut from 48 layers to 8 (~19.7B
# parameters, ~39.4 GB bf16), served through Engine: 8 requests of the serve
# phase's mix (3,072 tokens, a 2,048-token prompt of 4 families drawn zipf
# 1.5), 16 new tokens each, 4 at a time, over the serve phase's 1,024 pages
# of 16 tokens, fewer than the 1,280 blocks the requests publish, so the
# cache evicts (128 blocks). At 512 pages the second wave's publishes evict
# a page matched earlier in the same wave before it is loaded: a fault of
# the reference's engine, which the port keeps (ROADMAP queue 3), and which
# the cached-KV check would flag. The rehearsal's 24 pages evict too, and
# keep every matched page. deepseek-v3 (MLA, 128
# heads: q_lora 1,536, kv_lora 512, nope 128, rope 64, v 128; 256 experts of
# d_ff 2,048, a top-8 sigmoid router with a bias, 1 shared expert, dense d_ff
# 18,432, vocab 129,280), cut from 61 layers to 4 (the 3 dense layers and 1
# MoE layer) and without its MTP block, which serving never reads: ~15.1B
# parameters, ~30.2 GB; prefills of 4 sequences of 3,072 tokens (one untimed
# warm-up, then the median of three), then 16 decode steps, through lm.prefill and lm.decode_step (the Engine's page
# store holds GQA pages only, as the reference's does). "parity" is the
# decode-vs-forward check: one sequence of 2,100 tokens (S*S above
# FLASH_THRESH), 4 decode steps.
SERVE_MOE = dict(
    llama4=dict(arch="llama4-scout-17b-a16e", smoke=False, n_layers=8,
                n_req=8, plen=3072, shared=2048, new_tokens=16, n_pages=1024),
    deepseek=dict(arch="deepseek-v3-671b", smoke=False, n_layers=4, batch=4,
                  plen=3072, steps=16, prefills=4),
    parity=dict(S=2100, steps=4),
    card_vs_cpu=dict(B=2, S=2100, steps=4, capacity_factor=8.0,
                     train_seq=2304))
REHEARSAL_MOE = dict(
    llama4=dict(arch="llama4-scout-17b-a16e", smoke=True, n_layers=None,
                n_req=8, plen=96, shared=64, new_tokens=8, n_pages=24),
    deepseek=dict(arch="deepseek-v3-671b", smoke=True, n_layers=None,
                  batch=2, plen=96, steps=4, prefills=2),
    parity=dict(S=40, steps=4),
    card_vs_cpu=dict(B=2, S=40, steps=4, capacity_factor=8.0, train_seq=64))
# "card_vs_cpu" is (c), the card against the CPU at SMOKE widths: one
# prefill of 2 sequences of 2,100 tokens (K5 on the card, _sdpa_flash on
# the CPU) and 4 decode steps, in float32 and bf16, at capacity factor 8: no
# slot is dropped, so a token that bf16 noise routes to other experts at a
# near-tie changes only its own output, not which later tokens an expert
# drops; then a deepseek train step of 2 x 2,304 tokens (TRAIN_PARITY's).
# The rehearsal runs (c)'s CPU side on short sequences.
ROUTE_TIE_GAP = 2.0 ** -5
MOE_BOUND = ("per element (k + 2) 2^-8 A, A = the sum over the token's kept "
             "slots of |router weight x expert output| in float32: each "
             "dispatch rounds each weighted output, and its sum, to bf16")
ROUTE_TIE = ("a token some MoE layer routes to other experts in one run "
             "than in the other is excused when, in the run held as the "
             "reference (the CPU's, or the forward's), that layer's k-th and "
             "(k+1)-th selection scores for it lie within 2^-5 (the TIE of "
             "tests/test_torch_moe.py: noise reorders a near-tie), and so are "
             "its later layers; any other reordering fails")
DECODE_BOUND = ("max |logits - forward's| < 0.15 (tests/test_models.py); "
                "at most one position routed otherwise, excused as "
                + ROUTE_TIE)
MOE_PARITY_BOUND = ("tests/test_torch_models.py's: float32 logits 1e-4 "
                    "(decode 1e-3) of the largest, cache entries 2^-7 of "
                    "their own magnitude + 1e-4 of the largest; bf16 5e-2 of "
                    "the largest; tokens routed otherwise excused as "
                    + ROUTE_TIE)


def _moe_cfg(spec, **over):
    """The configuration of a ``serve-moe`` part: the arch at full width
    (or SMOKE), its depth cut to ``n_layers``, deepseek without MTP."""
    from repro_torch.configs import get_config
    if spec["n_layers"]:
        over["n_layers"] = spec["n_layers"]
    if spec["arch"] == "deepseek-v3-671b":
        over["mtp"] = False
    return get_config(spec["arch"], smoke=spec["smoke"], **over)


class _Routes:
    """Within a ``with`` block, every routing of ``models.moe._route`` in
    call order: (expert ids [B,S,k], selection scores [B,S,E]: the sigmoid
    scores plus the bias, or the softmax probabilities, which top-k
    ranks)."""

    def __enter__(self):
        from repro_torch.models import moe as MOE
        self.calls, self._mod, self._orig = [], MOE, MOE._route

        def route(p, cfg, x):
            out = self._orig(p, cfg, x)
            logits = x.float() @ p["router"]
            sel = (torch.sigmoid(logits) + p["router_bias"]
                   if cfg.router == "sigmoid" else torch.softmax(logits, -1))
            self.calls.append((out[0], sel))
            return out
        MOE._route = route
        return self

    def __exit__(self, *exc):
        self._mod._route = self._orig

    def at(self, s: int):
        """The calls cut to sequence position ``s``."""
        return [(i[:, s:s + 1], sc[:, s:s + 1]) for i, sc in self.calls]


def route_diff(want, got):
    """The tokens (b, s) that some MoE layer routes to other experts in
    ``got`` than in ``want`` (``_Routes`` calls of the same layers on the
    same tokens, in layer order), the faults among them: a reordering of
    scores that are not a near-tie in ``want`` (:data:`ROUTE_TIE`), and
    the readings of each such token where it first differs: (layer, its
    gap in ``want``, how far its scores moved between the runs). A token
    already routed otherwise in an earlier layer carries another FFN
    output from there on, so its later layers are not judged."""
    if len(want) != len(got):
        return set(), [f"{len(want)} routings against {len(got)}"], []
    flipped, faults, ties = set(), [], []
    for layer, ((wi, ws), (gi, gs)) in enumerate(zip(want, got)):
        wi, ws, gi, gs = wi.cpu(), ws.float().cpu(), gi.cpu(), gs.float().cpu()
        k = wi.shape[-1]
        diff = (torch.sort(wi, -1).values != torch.sort(gi, -1).values).any(-1)
        top = torch.sort(ws, -1, descending=True).values
        for b, s in diff.nonzero().tolist():
            if (b, s) in flipped:
                continue
            flipped.add((b, s))
            gap = float(top[b, s, k - 1] - top[b, s, k])
            move = float((ws[b, s] - gs[b, s]).abs().max())
            ties.append((layer, gap, move))
            if not gap <= ROUTE_TIE_GAP:
                faults.append(f"token ({b}, {s}) layer {layer}: experts "
                              f"{wi[b, s].tolist()} vs {gi[b, s].tolist()}, "
                              f"score gap {gap}, scores moved {move}")
    return flipped, faults, ties


def tie_readings(ties) -> dict:
    """What :func:`route_diff`'s readings say of the tokens routed
    otherwise: how many, the largest gap and move, and the largest gap of
    those first routed otherwise in the first MoE layer (before any other
    token's change could reach them)."""
    first = [g for layer, g, _ in ties if layer == 0]
    return {"tokens": len(ties),
            "max_gap": max((g for _, g, _ in ties), default=None),
            "max_move": max((m for _, _, m in ties), default=None),
            "max_gap_first_moe_layer": max(first, default=None)}


def decode_vs_forward(params, cfg, toks, steps: int):
    """The reference's own check (``tests/test_models.py::test_prefill_
    decode_matches_forward``) on one sequence ``toks`` [1, S] at a capacity
    factor where no slot can drop (8, as there, or the experts over top-k
    when that is larger: capacity >= S, since a decode step of one token
    never drops and a forward that dropped late tokens would differ):
    ``lm.prefill`` of the first S - steps tokens, then ``steps`` decode
    steps, each step's logits against the teacher-forced ``lm.forward``'s
    within :data:`DECODE_BOUND`. Returns (result, failures)."""
    from repro_torch.models import lm
    from repro_torch.models import moe as MOE
    cfg8 = dataclasses.replace(cfg, capacity_factor=max(
        8.0, cfg.n_experts / max(cfg.top_k, 1)))
    S = toks.shape[1]
    n = S - steps
    with torch.inference_mode():
        with _Routes() as fwd:
            logits, _, _ = lm.forward(params, cfg8, {"tokens": toks})
        want = logits[0, n - 1:].float()
        del logits
        with _Routes() as pre:
            pl, cache = lm.prefill(params, cfg8, {"tokens": toks[:, :n]},
                                   S_max=S + 8)
        got, routes = [pl[0].float()], [(fwd.at(n - 1), pre.at(n - 1))]
        for i in range(steps):
            pos = torch.full((1,), n + i, dtype=torch.int32,
                             device=toks.device)
            with _Routes() as dec:
                dl, cache = lm.decode_step(params, cfg8, toks[:, n + i], pos,
                                           cache)
            got.append(dl[0].float())
            routes.append((fwd.at(n + i), dec.calls))
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    fails, excused, ties = [], [], []
    cap = MOE.capacity(cfg8, S)
    load = max((int(torch.bincount(i.flatten().long(),
                                   minlength=cfg.n_experts).max())
                for i, _ in fwd.calls), default=0)
    if load > cap:
        fails.append(f"decode vs forward: an expert took {load} tokens "
                     f"over a capacity of {cap}")
    for i, (w, g) in enumerate(routes):
        flipped, faults, t = route_diff(w, g)
        fails += [f"position {n - 1 + i}: {f}" for f in faults]
        ties += t
        if flipped:
            excused.append(n - 1 + i)
    kept = [e for i, e in enumerate(errs) if n - 1 + i not in excused]
    if len(excused) > 1:
        fails.append(f"decode vs forward: {len(excused)} of {len(errs)} "
                     f"positions excused")
    if not max(kept, default=0.0) < 0.15:
        fails.append(f"decode vs forward: errors {errs}")
    return dict(S=S, steps=steps, capacity_factor=cfg8.capacity_factor,
                capacity=cap, max_expert_load=load,
                max_abs_err=max(kept, default=None), errs=errs,
                excused_positions=excused, route_ties=tie_readings(ties),
                bound=DECODE_BOUND), fails


def moe_term_sum(p, cfg, x):
    """[B,S,d] float32: for each token, the sum over its kept slots of
    |router weight x expert output|, the scale of the roundings a
    dispatch's combine makes."""
    from repro_torch.models import moe as MOE
    B, S, d = x.shape
    idx, w, _ = MOE._route(p, cfg, x)
    st, sk = MOE._slot_assignment(idx, cfg.n_experts, MOE.capacity(cfg, S))
    ws = MOE._slot_weights(idx, w, st, sk)
    h = MOE._expert_ffn(p, cfg, MOE.gather_dispatch(MOE._pad_token(x), st))
    terms = h.float().abs() * ws.float().abs()[..., None]
    del h
    bi = torch.arange(B, device=x.device)[:, None, None].expand_as(st)
    A = torch.zeros((B, S + 1, d), device=x.device)
    return A.index_put_((bi, st.long()), terms, accumulate=True)[:, :S]


def moe_agreement(p, cfg, h, runs: int) -> dict:
    """``moe_scatter`` and ``moe_mixed`` against ``moe_gshard`` on the FFN
    input ``h`` at the configuration's capacity, within :data:`MOE_BOUND`,
    and each one's time (CUDA events, on the card)."""
    from repro_torch.models import moe as MOE
    with torch.inference_mode():
        ys = {f"moe_{n}": fn(p, cfg, h)[0] for n, fn in MOE.MOE_IMPLS.items()}
        tol = (cfg.top_k + 2) * 2.0 ** -8 * moe_term_sum(p, cfg, h)
        out = {"capacity": MOE.capacity(cfg, h.shape[1]),
               "tokens": h.shape[0] * h.shape[1], "bound": MOE_BOUND,
               "fails": []}
        for n in ("moe_scatter", "moe_mixed"):
            r = _err_over_tol(ys[n], ys["moe_gshard"], tol)
            out[n + "_vs_gshard"] = r
            if not r["max_err_over_tol"] <= 1.0:
                out["fails"].append(f"{n} vs moe_gshard: {r}")
        del ys, tol
        if h.is_cuda:
            for n, fn in MOE.MOE_IMPLS.items():
                out[f"moe_{n}_ms"] = _event_ms(lambda: fn(p, cfg, h),
                                               runs)[0]
    return out


def serve_moe_llama4(spec, parity, seed: int, dev, runs: int) -> dict:
    """(a): :func:`_serve_engine`'s checks on llama4 through ``Engine``;
    K5 against its plain version on layer 0's real q, k, v; the three
    dispatches on layer 0's FFN input; decode against forward."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import lm
    from repro_torch.models.attention import CAUSAL
    from repro_torch.serving import ServeConfig
    on_card = dev.type == "cuda"
    cfg = _moe_cfg(spec)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    _sync(dev)
    init_s = time.perf_counter() - t0
    reqs = make_requests(spec["n_req"], cfg.vocab, spec["shared"],
                         spec["plen"], seed=seed)
    scfg = ServeConfig(max_batch=4, s_max=spec["plen"] + spec["new_tokens"] + 8,
                       block_tokens=16, n_pages=spec["n_pages"],
                       max_new_tokens=spec["new_tokens"], tree_backend="fused")
    res, fails, _ = _serve_engine(cfg, params, scfg, reqs, dev)
    if on_card:
        torch.cuda.empty_cache()
    toks = torch.as_tensor(reqs[0], device=dev)[None]
    with torch.inference_mode():
        cap = capture_layers(params, cfg, toks, (0,))[0]
        real = k5_vs_plain(cap["q"], cap["k"], cap["v"], CAUSAL, cap["n_rep"],
                           cap["scale"])
        if not real["max_err_over_tol"] <= 1.0:
            fails.append(f"K5 layer 0: {real}")
        moe = moe_agreement(cap["params"]["moe"], cfg, cap["ffn_in"], runs)
        fails += moe.pop("fails")
        del cap
    dvf, f = decode_vs_forward(params, cfg, toks[:, :parity["S"]],
                               parity["steps"])
    fails += f
    pm, sm = res.pop("prefill_ms"), res.pop("step_ms")
    out = {"arch": cfg.name, "layers": cfg.n_layers, "moe_impl": cfg.moe_impl,
           "params": sum(t.numel() for t in _leaves(params)),
           "init_s": init_s, "requests": len(reqs),
           "prompt_len": spec["plen"], "serve_config": {
               k: v for k, v in dataclasses.asdict(scfg).items()
               if k != "faults"},
           "prefills": len(pm), "decode_steps": len(sm),
           "prefill_ms": statistics.median(pm), "prefill_ms_all": pm,
           "decode_step_ms": statistics.median(sm),
           "decode_step_ms_range": [min(sm), max(sm)],
           "new_tokens_per_s": res["new_tokens"] / res["run_s"], **res,
           "k5_layer0": real, "k5_tolerance": K5_BOUND, "moe_dispatch": moe,
           "decode_vs_forward": dvf, "fails": fails}
    return out


def serve_moe_deepseek(spec, parity, seed: int, dev, runs: int) -> dict:
    """(b): deepseek through ``lm.prefill`` and ``lm.decode_step`` (greedy
    tokens): K5 once a layer a prefill, finite logits; K5 against its plain
    version on layer 0's real q, k, v (q/k 192, v 128) and its time there;
    the three dispatches on the MoE layer's FFN input; decode against
    forward."""
    from repro_torch.kernels.flash_attention import ops as k5
    from repro_torch.models import lm
    from repro_torch.models.attention import CAUSAL, FLASH_THRESH
    on_card = dev.type == "cuda"
    cfg = _moe_cfg(spec)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    _sync(dev)
    init_s = time.perf_counter() - t0
    B, S, steps = spec["batch"], spec["plen"], spec["steps"]
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)).to(dev)
    fails = []
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    k5.LAUNCHES = 0                     # counts from this path only
    with torch.inference_mode():
        prefill_ms = []                 # the first one warms up, untimed
        for _ in range(spec["prefills"]):
            cache = logits = None
            _sync(dev)
            t = time.perf_counter()
            logits, cache = lm.prefill(params, cfg, {"tokens": toks},
                                       S_max=S + steps + 8)
            _sync(dev)
            prefill_ms.append((time.perf_counter() - t) * 1e3)
        pre_launches = k5.LAUNCHES
        step_ms, finite = [], bool(torch.isfinite(logits).all())
        for i in range(steps):
            nxt = torch.argmax(logits.float(), -1).to(torch.int32)
            pos = torch.full((B,), S + i, dtype=torch.int32, device=dev)
            _sync(dev)
            t = time.perf_counter()
            logits, cache = lm.decode_step(params, cfg, nxt, pos, cache)
            _sync(dev)
            step_ms.append((time.perf_counter() - t) * 1e3)
            finite &= bool(torch.isfinite(logits).all())
    launches = k5.LAUNCHES
    peak = torch.cuda.max_memory_allocated() if on_card else None
    want = spec["prefills"] * cfg.n_layers if S * S > FLASH_THRESH else 0
    if on_card and (pre_launches, launches) != (want, want):
        fails.append(f"K5 launches {pre_launches} in the prefills, {launches}"
                     f" in all; expected {want} (one a layer a prefill)")
    if not finite or logits.shape != (B, cfg.vocab):
        fails.append(f"logits {tuple(logits.shape)}, finite {finite}")
    del cache, logits
    if on_card:
        torch.cuda.empty_cache()
    timing = None
    with torch.inference_mode():
        caps = capture_layers(params, cfg, toks[:1], (0, cfg.n_dense_layers))
        cap = caps[0]
        real = k5_vs_plain(cap["q"], cap["k"], cap["v"], CAUSAL, cap["n_rep"],
                           cap["scale"])
        if not real["max_err_over_tol"] <= 1.0:
            fails.append(f"K5 layer 0 (q/k {cap['q'].shape[-1]}, v "
                         f"{cap['v'].shape[-1]}): {real}")
        if on_card:
            timing = k5_timing(cap["q"], cap["k"], cap["v"], cap["n_rep"],
                               runs, scale=cap["scale"], metric="k5_mla_ms")
        cap = caps[cfg.n_dense_layers]
        moe = moe_agreement(cap["params"]["moe"], cfg, cap["ffn_in"], runs)
        fails += moe.pop("fails")
        del cap, caps
    dvf, f = decode_vs_forward(params, cfg, toks[:1, :parity["S"]],
                               parity["steps"])
    fails += f
    return {"arch": cfg.name, "layers": cfg.n_layers, "mtp": cfg.mtp,
            "moe_impl": cfg.moe_impl,
            "params": sum(t.numel() for t in _leaves(params)),
            "init_s": init_s, "batch": B, "prompt_len": S,
            "prefill_ms": statistics.median(prefill_ms[1:]),
            "prefill_ms_all": prefill_ms,
            "prefill_ms_per_request": statistics.median(prefill_ms[1:]) / B,
            "decode_step_ms": statistics.median(step_ms),
            "decode_step_ms_all": step_ms,
            "new_tokens_per_s": B * steps / (sum(step_ms) / 1e3),
            "k5_launches": launches, "expected_k5_launches": want,
            "peak_bytes": peak, "k5_layer0": real, "k5_tolerance": K5_BOUND,
            "k5_mla_timing": timing, "moe_dispatch": moe,
            "moe_layer": cfg.n_dense_layers, "decode_vs_forward": dvf,
            "fails": fails}


def _cache_fails(got, want, dtype, what, skip):
    """``tests/test_torch_models.py``'s cache bound on every row of two
    stacked caches (``KVCache`` or ``MLACache``) but the tokens ``skip``."""
    fails = []
    for f, g, w in zip(want._fields, got, want):
        g, w = g.float().cpu().clone(), w.float().cpu().clone()
        for b, s in skip:
            g[:, b, s] = w[:, b, s] = 0
        d = (g - w).abs()
        ok = (d <= 2.0 ** -7 * w.abs() + 1e-4 * w.abs().max()).all() \
            if dtype == torch.float32 else d.max() <= 5e-2 * w.abs().max()
        if not bool(ok):
            fails.append(f"{what} cache {f}: max |diff| {float(d.max())}")
    return fails


def moe_card_vs_cpu(spec, seed: int, dev) -> tuple:
    """(c): each MoE configuration's SMOKE model from one CPU init (deepseek
    without MTP), ``spec``'s prefill and decode steps on ``dev`` and on the
    CPU, in float32 and bf16, logits and caches within
    :data:`MOE_PARITY_BOUND`; then one deepseek SMOKE train step (MoE, MLA,
    MTP) on ``dev`` against the CPU, :func:`train_parity`. On the CPU alone
    it runs the CPU side. Returns (result, failures)."""
    from repro_torch.models import lm
    from repro_torch.train.tree import tree_map
    B, S, steps = spec["B"], spec["S"], spec["steps"]
    res, fails = {}, []
    for arch in ("llama4-scout-17b-a16e", "deepseek-v3-671b"):
        for dtype in (torch.float32, torch.bfloat16):
            smoke = dict(arch=arch, smoke=True, n_layers=None)
            cfg = _moe_cfg(smoke, param_dtype=str(dtype).split(".")[-1],
                           capacity_factor=spec["capacity_factor"])
            params = lm.init_params(cfg, torch.Generator().manual_seed(seed))
            toks = torch.from_numpy(np.random.default_rng(seed).integers(
                0, cfg.vocab, (B, S + steps)).astype(np.int32))
            runs = {}
            for d in dict.fromkeys([str(dev), "cpu"]):
                p = tree_map(lambda t: t.to(d, copy=True), params)
                tk = toks.to(d)
                with torch.inference_mode(), _Routes() as rt:
                    pl, cache = lm.prefill(p, cfg, {"tokens": tk[:, :S]},
                                           S_max=S + steps)
                    pre = list(rt.calls)
                    out = [pl.float().cpu()]
                    for i in range(steps):
                        n0 = len(rt.calls)
                        dl, cache = lm.decode_step(
                            p, cfg, tk[:, S + i], torch.full(
                                (B,), S + i, dtype=torch.int32, device=d),
                            cache)
                        out.append((dl.float().cpu(), rt.calls[n0:]))
                runs[d] = (out, pre, cache)
            what = f"{arch} {dtype}"
            (cpu_out, cpu_pre, cpu_cache) = runs["cpu"]
            r = {"cpu_logit_max": float(cpu_out[0].abs().max())}
            if str(dev) != "cpu":
                got, pre, cache = runs[str(dev)]
                flipped, f, ties = route_diff(cpu_pre, pre)
                fails += [f"{what} prefill: {x}" for x in f]
                rel = 1e-4 if dtype == torch.float32 else 5e-2
                keep = [b for b in range(B) if (b, S - 1) not in flipped]
                err = float((got[0][keep] - cpu_out[0][keep]).abs().max())
                if not err <= rel * float(cpu_out[0].abs().max()):
                    fails.append(f"{what} prefill logits: {err}")
                errs = [err]
                for i in range(steps):
                    (g, gr), (w, wr) = got[i + 1], cpu_out[i + 1]
                    step_flips, f, t = route_diff(wr, gr)
                    fails += [f"{what} decode {i}: {x}" for x in f]
                    ties += t
                    flipped |= {(b, S + i) for b, _ in step_flips}
                    keep = [b for b in range(B) if (b, 0) not in step_flips]
                    rel = 1e-3 if dtype == torch.float32 else 5e-2
                    err = float((g[keep] - w[keep]).abs().max())
                    errs.append(err)
                    if not err <= rel * float(w.abs().max()):
                        fails.append(f"{what} decode {i} logits: {err}")
                fails += _cache_fails(cache, cpu_cache, dtype, what, flipped)
                if dtype == torch.float32 and flipped:
                    fails.append(f"{what}: float32 tokens routed otherwise: "
                                 f"{sorted(flipped)}")
                r.update(max_abs_err=errs, excused_tokens=sorted(flipped),
                         route_ties=tie_readings(ties))
            res[what] = r
    step, f = train_parity(seed, dev, arch="deepseek-v3-671b",
                           seq=spec["train_seq"])
    fails += [f"deepseek train step: {x}" for x in f]
    res["deepseek train step"] = step
    return res, fails


def run_serve_moe(*, seed, runs=25):
    """The ``serve-moe`` phase on the card (:data:`SERVE_MOE`): (a)
    :func:`serve_moe_llama4`, (b) :func:`serve_moe_deepseek`, (c)
    :func:`moe_card_vs_cpu`. Returns the phase line."""
    return _serve_moe(seed, torch.device("cuda"), runs, SERVE_MOE)


def rehearse_serve_moe(seed=0):
    """The ``serve-moe`` phase's checks on the CPU at SMOKE size
    (:data:`REHEARSAL_MOE`; no kernel runs, and (c) runs its CPU side).
    Returns the phase's JSON object."""
    return _serve_moe(seed, torch.device("cpu"), 0, REHEARSAL_MOE)


def _free(dev) -> None:
    """Collect what the last part left (the engine and the hooks that
    record its cache calls refer to each other, so its weights wait for
    the cycle collector) and return the card's cached blocks."""
    import gc
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _serve_moe(seed, dev, runs, spec):
    t_phase = time.perf_counter()
    llama = serve_moe_llama4(spec["llama4"], spec["parity"], seed, dev, runs)
    emit({"part": "serve-moe llama4", **llama})
    _free(dev)
    deep = serve_moe_deepseek(spec["deepseek"], spec["parity"], seed, dev,
                              runs)
    emit({"part": "serve-moe deepseek", **deep})
    _free(dev)
    parity, f = moe_card_vs_cpu(spec["card_vs_cpu"], seed, dev)
    fails = ([f"llama4: {x}" for x in llama["fails"]]
             + [f"deepseek: {x}" for x in deep["fails"]]
             + [f"card vs CPU: {x}" for x in f])
    out = {"phase": "serve-moe", "llama4": llama, "deepseek": deep,
           "card_vs_cpu": parity, "card_vs_cpu_tolerance": MOE_PARITY_BOUND,
           "train_step_tolerance": TRAIN_STEP_BOUND,
           "phase_s": time.perf_counter() - t_phase, "fails": fails}
    emit(out)
    for name, part in (("llama4", llama), ("deepseek", deep)):
        emit({"metric": "serve_moe_prefill_ms_per_request", "arch": name,
              "value": part.get("prefill_ms_per_request",
                                part["prefill_ms"]),
              "clock": "host, synchronized"})
        emit({"metric": "serve_moe_decode_step_ms", "arch": name,
              "value": part["decode_step_ms"], "clock": "host, synchronized"})
        emit({"metric": "serve_moe_new_tokens_per_s", "arch": name,
              "value": part["new_tokens_per_s"]})
        emit({"metric": "serve_moe_peak_device_bytes", "arch": name,
              "value": part["peak_bytes"]})
        emit({"metric": "moe_dispatch_ms", "arch": name,
              **{k: v for k, v in part["moe_dispatch"].items()
                 if k.endswith("_ms") or k in ("capacity", "tokens")}})
    if fails:
        raise AssertionError("serve-moe: " + "; ".join(fails))
    return out


# ------------------------------------------------------- vlm and enc-dec

# paligemma-3b as published (arXiv:2407.07726: 18 layers, d_model 2,048, 8
# query heads and 1 kv head of 256, geglu d_ff 16,384, vocab 257,216, tied
# embedding; a SigLIP stub: 256 patch embeddings of width 1,152 drawn from
# the seed), uncut: ~2.51B parameters, ~5.0 GB bf16. "serve": prefills of 4
# sequences of 256 patches + 2,048 text tokens (S = 2,304, so K5 runs once
# a layer with the prefix-LM mask; one untimed warm-up, then the median of
# three) and 32 decode steps through lm.prefill and lm.decode_step (the
# engine refuses vlm, as the reference's does). "long" is K5 timed on one
# 8,192-token sequence (256 patches + 7,936 text). "parity" is decode vs
# forward on one sequence of 256 patches + 1,844 text tokens (2,100 in
# all), 4 decode steps; "card_vs_cpu" the SMOKE model on the card and the
# CPU (8 patches + 2,092 text tokens, so K5 runs on the card), then a
# SMOKE train step of 2 x 2,304 text tokens.
SERVE_VLM = dict(
    arch="paligemma-3b", smoke=False, batch=4, text=2048, steps=32,
    prefills=4, long_text=7936, parity=dict(text=1844, steps=4),
    card_vs_cpu=dict(B=2, text=2092, frames=0, steps=4, over={},
                     train_seq=2304))
REHEARSAL_VLM = dict(
    arch="paligemma-3b", smoke=True, batch=2, text=40, steps=4,
    prefills=2, long_text=0, parity=dict(text=24, steps=4),
    card_vs_cpu=dict(B=2, text=24, frames=0, steps=4, over={}, train_seq=32))
# whisper-medium as configured (24 + 24 layers, d_model 1,024, MHA 16 heads
# of 64, d_ff 4,096, vocab 51,865, learned positions sized to the repo's
# 32k shapes; stub frames of width 128 drawn from the seed), uncut: ~0.83B
# parameters. "serve": prefills of 2 requests of 32,768 frames and a
# 256-token decoder prompt (the encoder runs K5 without a mask at
# 32,768^2 once a layer; the cross attention, S·T = 8.4M, runs K5 at S !=
# T once a layer; the decoder's 256^2 self attention stays on the exact
# path; one untimed warm-up, then the median of three) and 32 decode
# steps. "parity": decode vs forward on one request (32,768 frames, 260
# tokens, 4 decode steps); "card_vs_cpu" the SMOKE model with its position
# tables sized to 2,112 rows on 2,100 frames and 2,050 tokens (K5 in all
# three attentions on the card), then a SMOKE train step of 2 x 2,304.
SERVE_WHISPER = dict(
    arch="whisper-medium", smoke=False, batch=2, frames=32768,
    text=256, steps=32, prefills=4, parity=dict(text=260, steps=4),
    card_vs_cpu=dict(B=2, text=2050, frames=2100, steps=4,
                     over=dict(enc_seq=2112), train_seq=2304))
REHEARSAL_WHISPER = dict(
    arch="whisper-medium", smoke=True, batch=2, frames=48, text=24,
    steps=4, prefills=2, parity=dict(text=24, steps=4),
    card_vs_cpu=dict(B=2, text=24, frames=40, steps=4, over={},
                     train_seq=32))
# falcon-mamba-7b as configured (64 mamba1 layers, d_model 4,096, d_inner
# 8,192, ssm_state 16, dt_rank 256, vocab 65,024 tied), uncut: 7.01B
# parameters. "serve": prefills of 4 x 2,048 tokens (one untimed warm-up,
# then the median of three; no attention, so no K5) and 32 decode steps;
# "parity" decode vs forward on one request of 2,100 tokens (9 scan chunks,
# the last ragged), 4 decode steps, on the same draws in float32: in bf16
# the card's products round otherwise at M = 1 than at M = 2,100 (layer
# 0's dt already differs by an ulp in places on the first decode step,
# tools/decode_drift.py), and 64 layers carry that to 0.13-0.21 of the
# logits, past the bound; that drift is measured beside it
# (bf16_decode_drift). "card_vs_cpu" the SMOKE model
# on the card and the CPU, then a SMOKE train step of 2 x 2,304.
SERVE_MAMBA = dict(
    arch="falcon-mamba-7b", smoke=False, batch=4, text=2048, steps=32,
    prefills=4, parity=dict(text=2100, steps=4, float32=True),
    card_vs_cpu=dict(B=2, text=2092, frames=0, steps=4, over={},
                     train_seq=2304))
REHEARSAL_MAMBA = dict(
    arch="falcon-mamba-7b", smoke=True, batch=2, text=300, steps=4,
    prefills=2, parity=dict(text=300, steps=4, float32=True),
    card_vs_cpu=dict(B=2, text=40, frames=0, steps=4, over={}, train_seq=32))
# zamba2-7b as configured (81 layers: 13 groups of 5 mamba2 layers, each
# followed by the shared attention+MLP block with its occurrence's LoRA,
# then 3; d_model 3,584, MHA 32 heads of 112, d_ff 14,336, ssm_state 64,
# LoRA rank 128, vocab 32,000 tied), uncut: 5.63B parameters (68 mamba2
# layers). "serve":
# prefills of 4 x 3,072 tokens (S·T passes FLASH_THRESH: K5 at head dim
# 112 in each of the 13 occurrences) and 32 decode steps; "parity" one
# request of 2,100 tokens (K5 in forward and prefill), 4 decode steps, in
# float32 as falcon-mamba's (bf16 drift 0.13-0.20 measured beside it);
# "card_vs_cpu" the SMOKE model on 2,092 tokens (K5 on the card), then a
# SMOKE train step of 2 x 2,304.
SERVE_ZAMBA = dict(
    arch="zamba2-7b", smoke=False, batch=4, text=3072, steps=32,
    prefills=4, parity=dict(text=2100, steps=4, float32=True),
    card_vs_cpu=dict(B=2, text=2092, frames=0, steps=4, over={},
                     train_seq=2304))
REHEARSAL_ZAMBA = dict(
    arch="zamba2-7b", smoke=True, batch=2, text=300, steps=4,
    prefills=2, parity=dict(text=300, steps=4, float32=True),
    card_vs_cpu=dict(B=2, text=40, frames=0, steps=4, over={}, train_seq=32))
FAMILY_PARITY_BOUND = ("tests/test_torch_models.py's: float32 logits 1e-4 "
                       "(decode 1e-3) of the largest, cache entries 2^-7 of "
                       "their own magnitude + 1e-4 of the largest; bf16 5e-2 "
                       "of the largest")


def _inputs(cfg, B: int, text: int, frames: int, seed: int, dev) -> dict:
    """A batch drawn from ``seed`` with numpy: tokens [B, text], and the
    vlm's patches [B, n_patches, frontend_dim] or the enc-dec's frames
    [B, frames, frontend_dim] (float32; the model casts them)."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, text)).astype(np.int32)}
    if cfg.family == "vlm":
        b["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.frontend_dim), dtype=np.float32)
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal(
            (B, frames, cfg.frontend_dim), dtype=np.float32)
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def _text(batch, n: int) -> dict:
    """``batch`` with its tokens cut to the first ``n``."""
    return dict(batch, tokens=batch["tokens"][:, :n])


def _offset(cfg) -> int:
    return cfg.n_patches if cfg.family == "vlm" else 0


def family_decode_vs_forward(params, cfg, batch, steps: int):
    """The reference's own check (``tests/test_models.py::test_prefill_
    decode_matches_forward``) for the vlm and enc-dec families on one
    request ``batch`` (tokens [1, S] with its patches or frames):
    ``lm.prefill`` of the first S - steps tokens, then ``steps`` decode
    steps (vlm positions after the patches), each step's logits against
    the teacher-forced ``lm.forward``'s, max |diff| < 0.15. Returns
    (result, failures)."""
    from repro_torch.models import lm
    toks = batch["tokens"]
    S, off = toks.shape[1], _offset(cfg)
    n = S - steps
    with torch.inference_mode():
        logits, _, _ = lm.forward(params, cfg, batch)
        want = logits[0, off + n - 1:].float()
        del logits
        pl, cache = lm.prefill(params, cfg, _text(batch, n),
                               S_max=off + S + 8)
        got = [pl[0].float()]
        for i in range(steps):
            pos = torch.full((1,), off + n + i, dtype=torch.int32,
                             device=toks.device)
            dl, cache = lm.decode_step(params, cfg, toks[:, n + i], pos,
                                       cache)
            got.append(dl[0].float())
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    fails = [] if max(errs) < 0.15 else [f"decode vs forward: errors {errs}"]
    return dict(S=S, steps=steps, max_abs_err=max(errs), errs=errs,
                logit_max=float(want.abs().max()),
                bound="max |logits - forward's| < 0.15 "
                      "(tests/test_models.py)"), fails


def bf16_decode_drift(params, cfg, batch, steps: int) -> dict:
    """How far the bf16 model's decode steps drift from its teacher-forced
    forward (max |logits diff| a step, after the prefill's), measured and
    held to no bound: a bf16 product rounds otherwise at M = 1 than at M =
    S on the card, and a deep stack carries those ulps on (``PERF.md``,
    PR 22)."""
    r, _ = family_decode_vs_forward(params, cfg, batch, steps)
    return {"errs": r["errs"], "max_abs_err": r["max_abs_err"],
            "logit_max": r["logit_max"], "param_dtype": cfg.param_dtype}


def _cache_parts(cache):
    """The caches of one family as named tuples, for :func:`_cache_fails`:
    the cache itself (a ``KVCache`` or, for ssm, a ``MambaState``), the
    enc-dec's self cache and its cross rows, or the hybrid's ``grp``,
    ``attn`` and ``tail``."""
    from repro_torch.models.attention import KVCache
    if not isinstance(cache, dict):
        return [("", cache)]
    if "cross_k" in cache:
        return [("self", cache["self"]),
                ("cross", KVCache(cache["cross_k"], cache["cross_v"]))]
    return sorted(cache.items())


def family_card_vs_cpu(spec, seed: int, dev) -> tuple:
    """The SMOKE model of ``spec["arch"]`` (``spec["over"]`` applied) from
    one CPU init, ``spec``'s prefill and decode steps on ``dev`` and on the
    CPU, in float32 and bf16, logits and caches within
    :data:`FAMILY_PARITY_BOUND`; then one SMOKE train step on ``dev``
    against the CPU, :func:`train_parity`. On the CPU alone it runs the CPU
    side. Returns (result, failures)."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.train.tree import tree_map
    B, n, steps = spec["B"], spec["text"], spec["steps"]
    res, fails = {}, []
    arch = spec["arch"]
    for dtype in (torch.float32, torch.bfloat16):
        cfg = get_config(arch, smoke=True, param_dtype=str(dtype).split(".")[-1],
                         **spec["over"])
        off = _offset(cfg)
        params = lm.init_params(cfg, torch.Generator().manual_seed(seed))
        cpu_batch = _inputs(cfg, B, n + steps, spec["frames"], seed, "cpu")
        runs = {}
        for d in dict.fromkeys([str(dev), "cpu"]):
            p = tree_map(lambda t: t.to(d, copy=True), params)
            b = {k: v.to(d) for k, v in cpu_batch.items()}
            with torch.inference_mode():
                pl, cache = lm.prefill(p, cfg, _text(b, n),
                                       S_max=off + n + steps)
                out = [pl.float().cpu()]
                for i in range(steps):
                    pos = torch.full((B,), off + n + i, dtype=torch.int32,
                                     device=d)
                    dl, cache = lm.decode_step(p, cfg, b["tokens"][:, n + i],
                                               pos, cache)
                    out.append(dl.float().cpu())
            runs[d] = (out, cache)
        what = f"{arch} {dtype}"
        cpu_out, cpu_cache = runs["cpu"]
        r = {"cpu_logit_max": float(cpu_out[0].abs().max())}
        if str(dev) != "cpu":
            got, cache = runs[str(dev)]
            errs = []
            for i, (g, w) in enumerate(zip(got, cpu_out)):
                rel = (5e-2 if dtype == torch.bfloat16 else
                       1e-4 if i == 0 else 1e-3)
                errs.append(float((g - w).abs().max()))
                if not errs[-1] <= rel * float(w.abs().max()):
                    fails.append(f"{what} {'decode %d' % (i - 1) if i else 'prefill'}"
                                 f" logits: {errs[-1]}")
            for (name, gc), (_, wc) in zip(_cache_parts(cache),
                                           _cache_parts(cpu_cache)):
                fails += _cache_fails(gc, wc, dtype, f"{what} {name}", ())
            r.update(max_abs_err=errs)
        res[what] = r
    step, f = train_parity(seed, dev, arch=arch, seq=spec["train_seq"],
                           **({"enc_seq": spec["train_seq"]}
                              if arch == "whisper-medium" else {}))
    fails += [f"{arch} train step: {x}" for x in f]
    res[f"{arch} train step"] = step
    return res, fails


def capture_whisper(params, cfg, batch) -> dict:
    """What K5 gets in layer 0 of one whisper prefill of ``batch``: the
    encoder's self attention q, k, v (over every frame, no mask) and the
    decoder's cross attention q (after the causal self attention) and k, v
    (from the whole encoder's output)."""
    from repro_torch.models import attention as A
    from repro_torch.models import lm
    from repro_torch.models.layers import apply_norm
    e = params["enc"]
    frames, toks = batch["frames"], batch["tokens"]
    x = frames.to(cfg.dtype) @ e["proj"] + e["pos"][:frames.shape[1]]
    pe = lm.layer_params(e["blocks"], 0)
    enc = A._qkv(pe["attn"], cfg, apply_norm(x, pe["ln1"], cfg.norm,
                                             cfg.norm_eps), None)
    del x
    enc_out = lm.encode(params, cfg, frames)
    pd = lm.layer_params(params["dec_blocks"], 0)
    h = params["embed"][toks.long()] + params["dec_pos"][:toks.shape[1]]
    g = apply_norm(h, pd["ln1"], cfg.norm, cfg.norm_eps)
    h = h + A.attn_forward(pd["attn"], cfg, g, None, A.CAUSAL)
    q = A._heads(apply_norm(h, pd["lnx"], cfg.norm, cfg.norm_eps),
                 pd["cross"]["wq"])
    k, v = A.cross_kv(pd["cross"], enc_out)
    return dict(enc=enc, cross=(q, k, v), n_rep=cfg.n_heads // cfg.n_kv_heads)


def capture_zamba(params, cfg, toks) -> dict:
    """What K5 gets in the first shared-attention occurrence of one zamba2
    prefill of ``toks`` [B, S]: the first group's mamba2 layers, then the
    shared block's normed input through its q, k, v projections and
    rotary (the LoRA joins after the attention)."""
    from repro_torch.models import attention as A
    from repro_torch.models import blocks as BLK
    from repro_torch.models import lm
    from repro_torch.models.layers import apply_norm
    x = params["embed"][toks.long()]
    B, S = toks.shape
    pos = torch.arange(S, dtype=torch.int32, device=toks.device).expand(B, S)
    mg = lm.layer_params(params["mamba_grp"], 0)
    for j in range(cfg.shared_attn_period - 1):
        x, _ = BLK.block_forward(lm.layer_params(mg, j), cfg, "mamba2", x,
                                 pos, A.CAUSAL)
    sh = params["shared"]
    h = apply_norm(x, sh["ln1"], cfg.norm, cfg.norm_eps)
    q, k, v = A._qkv(sh["attn"], cfg, h, pos)
    return dict(q=q, k=k, v=v, n_rep=cfg.n_heads // cfg.n_kv_heads,
                scale=cfg.hd ** -0.5, mask=A.CAUSAL)


def mamba_mixer_timing(params, cfg, toks, runs: int) -> dict:
    """Layer 0's mamba mixer on its real normed input from ``toks`` [B, S],
    CUDA events (median of ``runs``): the whole ``mamba1_forward`` and its
    three parts, ``mamba1_inputs`` (in_proj, the conv, x_proj, dt_w),
    ``mamba1_scan`` (the chunked selective scan) and ``mamba1_output`` (D,
    the gate, out_proj), with the products' FLOP; for mamba2 the whole
    ``mamba2_forward``."""
    from repro_torch.models import lm
    from repro_torch.models import mamba as M
    from repro_torch.models.layers import apply_norm
    seg = (params["seg0"] if cfg.family == "ssm"
           else lm.layer_params(params["mamba_grp"], 0))
    pl = lm.layer_params(seg, 0)
    mx = pl["mixer"]
    B, S = toks.shape
    d, di = cfg.d_model, cfg.d_inner
    h = apply_norm(params["embed"][toks.long()], pl["ln1"], cfg.norm,
                   cfg.norm_eps)
    if cfg.ssm_version == 2:
        ms, _ = _event_ms(lambda: M.mamba2_forward(mx, cfg, h), runs)
        return dict(mixer="mamba2", tokens=B * S, mixer_ms=ms)
    ins = M.mamba1_inputs(mx, cfg, h)
    y, hT = M.mamba1_scan(cfg, mx["A_log"], *ins[:4])
    out = dict(mixer="mamba1", tokens=B * S, chunk=256,
               mixer_ms=_event_ms(lambda: M.mamba1_forward(mx, cfg, h),
                                  runs)[0],
               inputs_ms=_event_ms(lambda: M.mamba1_inputs(mx, cfg, h),
                                   runs)[0],
               scan_ms=_event_ms(lambda: M.mamba1_scan(
                   cfg, mx["A_log"], *ins[:4]), runs)[0],
               output_ms=_event_ms(lambda: M.mamba1_output(
                   mx, cfg, h, y, ins, hT), runs)[0])
    flops = 2 * B * S * (d * 2 * di + di * (cfg.dtr + 2 * cfg.ssm_state)
                         + cfg.dtr * di + di * d)
    out.update(projection_flops=flops,
               scan_share=out["scan_ms"] / out["mixer_ms"],
               scan_state_bytes_a_chunk=4 * B * 256 * di * cfg.ssm_state)
    emit({"metric": "mamba1_layer0_ms", **out})
    return out


def k5_prefill_calls(cfg, S: int, T: int) -> int:
    """K5 launches of one prefill of S tokens (T encoder frames): each
    attention call whose S·T passes ``FLASH_THRESH``."""
    from repro_torch.models.attention import FLASH_THRESH
    if cfg.family == "encdec":
        return (cfg.n_enc_layers * (T * T > FLASH_THRESH)
                + cfg.n_layers * (S * S > FLASH_THRESH)
                + cfg.n_layers * (S * T > FLASH_THRESH))
    return k5_calls(cfg) * (S * S > FLASH_THRESH)


def serve_family(spec, seed: int, dev, runs: int) -> dict:
    """A vlm, enc-dec, ssm or hybrid model at ``spec``'s width through
    ``lm.prefill`` (``spec["prefills"]`` of ``spec["batch"]`` requests: one
    untimed warm-up, then the median of the rest) and ``spec["steps"]``
    greedy ``lm.decode_step`` calls: K5 launches
    (:func:`k5_prefill_calls` a prefill; none for ssm), finite logits of
    the right shape; K5 against its plain version on the real q, k, v of
    layer 0 (for whisper the encoder's on its first and last 1,024 rows,
    and the cross attention's; for zamba2 the first shared-attention
    occurrence's) and, on the card, timed there beside
    ``scaled_dot_product_attention`` with the same mask; for ssm and
    hybrid, layer 0's mamba mixer timed (:func:`mamba_mixer_timing`);
    decode against forward."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as k5
    from repro_torch.models import lm
    from repro_torch.models.attention import FULL
    on_card = dev.type == "cuda"
    cfg = get_config(spec["arch"], smoke=spec["smoke"])
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    _sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    B, n, steps, off = spec["batch"], spec["text"], spec["steps"], _offset(cfg)
    batch = _inputs(cfg, B, n, spec.get("frames", 0), seed, dev)
    fails = []
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    k5.LAUNCHES = 0                     # counts from this path only
    with torch.inference_mode():
        prefill_ms = []                 # the first one warms up, untimed
        for _ in range(spec["prefills"]):
            cache = logits = None
            _sync(dev)
            t = time.perf_counter()
            logits, cache = lm.prefill(params, cfg, batch,
                                       S_max=off + n + steps + 8)
            _sync(dev)
            prefill_ms.append((time.perf_counter() - t) * 1e3)
        pre_launches = k5.LAUNCHES
        step_ms, finite = [], bool(torch.isfinite(logits).all())
        for i in range(steps):
            nxt = torch.argmax(logits.float(), -1).to(torch.int32)
            pos = torch.full((B,), off + n + i, dtype=torch.int32, device=dev)
            _sync(dev)
            t = time.perf_counter()
            logits, cache = lm.decode_step(params, cfg, nxt, pos, cache)
            _sync(dev)
            step_ms.append((time.perf_counter() - t) * 1e3)
            finite &= bool(torch.isfinite(logits).all())
    launches = k5.LAUNCHES
    peak = torch.cuda.max_memory_allocated() if on_card else None
    S = off + n
    per = k5_prefill_calls(cfg, S, spec.get("frames", S))
    want = spec["prefills"] * per
    if on_card and (pre_launches, launches) != (want, want):
        fails.append(f"K5 launches {pre_launches} in the prefills, {launches}"
                     f" in all; expected {want} ({per} a prefill)")
    if not finite or logits.shape != (B, cfg.vocab):
        fails.append(f"logits {tuple(logits.shape)}, finite {finite}")
    del cache, logits
    _free(dev)
    real, timing = {}, {}
    with torch.inference_mode():
        if cfg.family == "vlm":
            cap = capture_layers(params, cfg, batch["tokens"], (0,),
                                 patches=batch["patches"])[0]
            qkv = (cap["q"], cap["k"], cap["v"])
            real["layer0"] = k5_vs_plain(*qkv, cap["mask"], cap["n_rep"],
                                         cap["scale"])
            if on_card:
                timing["served"] = k5_timing(*qkv, cap["n_rep"], runs,
                                             mask=cap["mask"],
                                             metric="k5_vlm_ms")
            del cap, qkv
            if on_card and spec["long_text"]:
                lb = _inputs(cfg, 1, spec["long_text"], 0, seed + 1, dev)
                cap = capture_layers(params, cfg, lb["tokens"], (0,),
                                     patches=lb["patches"])[0]
                timing["long"] = k5_timing(cap["q"], cap["k"], cap["v"],
                                           cap["n_rep"], runs,
                                           mask=cap["mask"],
                                           metric="k5_vlm_long_ms")
                del cap, lb
        elif cfg.family == "hybrid":
            cap = capture_zamba(params, cfg, batch["tokens"])
            qkv = (cap["q"], cap["k"], cap["v"])
            real["occurrence0"] = k5_vs_plain(*qkv, cap["mask"], cap["n_rep"],
                                              cap["scale"])
            if on_card:
                timing["served"] = k5_timing(*qkv, cap["n_rep"], runs,
                                             mask=cap["mask"],
                                             metric="k5_zamba_ms")
            del cap, qkv
        elif cfg.family == "encdec":
            cap = capture_whisper(params, cfg, batch)
            q, k, v = cap["enc"]
            got = k5.flash_sdpa(q, k, v, FULL, cap["n_rep"], cfg.hd ** -0.5)
            real["encoder_layer0"] = k5_check_rows(
                got, q, k, v, FULL, cap["n_rep"], cfg.hd ** -0.5)
            del got
            real["cross_layer0"] = k5_vs_plain(*cap["cross"], FULL,
                                               cap["n_rep"], cfg.hd ** -0.5)
            if on_card:
                timing["encoder"] = k5_timing(q, k, v, cap["n_rep"], runs,
                                              mask=FULL, plain_runs=3,
                                              metric="k5_whisper_encoder_ms")
                timing["cross"] = k5_timing(*cap["cross"], cap["n_rep"], runs,
                                            mask=FULL,
                                            metric="k5_whisper_cross_ms")
            del cap, q, k, v
        if on_card and cfg.family in ("ssm", "hybrid"):
            timing["mixer"] = mamba_mixer_timing(params, cfg,
                                                 batch["tokens"], runs)
    k5.LAUNCHES = launches              # the checks' launches do not count
    for name, r in real.items():
        if not r["max_err_over_tol"] <= 1.0:
            fails.append(f"K5 {name}: {r}")
    _free(dev)
    pb = _inputs(cfg, 1, spec["parity"]["text"], spec.get("frames", 0),
                 seed + 2, dev)
    p_steps = spec["parity"]["steps"]
    drift = None
    if spec["parity"].get("float32"):
        # the bf16 model's drift is measured, not held to the bound; the
        # check runs on the same draws in float32 (see SERVE_MAMBA)
        drift = bf16_decode_drift(params, cfg, pb, p_steps)
        del params
        _free(dev)
        cfg = dataclasses.replace(cfg, param_dtype="float32")
        params = lm.init_params(cfg, torch.Generator(device=dev)
                                .manual_seed(seed))
    dvf, f = family_decode_vs_forward(params, cfg, pb, p_steps)
    dvf["param_dtype"] = cfg.param_dtype
    fails += f
    return {"arch": cfg.name, "layers": cfg.n_layers,
            "enc_layers": cfg.n_enc_layers, "params": n_params,
            "init_s": init_s, "batch": B, "prompt_len": S,
            "frames": spec.get("frames"),
            "prefill_ms": statistics.median(prefill_ms[1:]),
            "prefill_ms_all": prefill_ms,
            "prefill_ms_per_request": statistics.median(prefill_ms[1:]) / B,
            "decode_step_ms": statistics.median(step_ms),
            "decode_step_ms_all": step_ms,
            "new_tokens_per_s": B * steps / (sum(step_ms) / 1e3),
            "k5_launches": launches, "expected_k5_launches": want,
            "peak_bytes": peak, "k5_real": real, "k5_tolerance": K5_BOUND,
            "k5_timing": timing, "decode_vs_forward": dvf,
            "bf16_decode_drift": drift, "fails": fails,
            **({"k5": "no attention on this path: K5 launches 0"}
               if cfg.family == "ssm" else {})}


def _serve_family(phase, seed, dev, runs, spec):
    t_phase = time.perf_counter()
    part = serve_family(spec, seed, dev, runs)
    _free(dev)
    parity, f = family_card_vs_cpu(dict(spec["card_vs_cpu"],
                                        arch=spec["arch"]), seed, dev)
    fails = part["fails"] + [f"card vs CPU: {x}" for x in f]
    out = {"phase": phase, **part, "card_vs_cpu": parity,
           "card_vs_cpu_tolerance": FAMILY_PARITY_BOUND,
           "train_step_tolerance": TRAIN_STEP_BOUND,
           "phase_s": time.perf_counter() - t_phase, "fails": fails}
    emit(out)
    emit({"metric": f"{phase}_prefill_ms_per_request",
          "value": part["prefill_ms_per_request"],
          "clock": "host, synchronized"})
    emit({"metric": f"{phase}_decode_step_ms", "value": part["decode_step_ms"],
          "clock": "host, synchronized"})
    emit({"metric": f"{phase}_new_tokens_per_s",
          "value": part["new_tokens_per_s"]})
    emit({"metric": f"{phase}_peak_device_bytes", "value": part["peak_bytes"]})
    print(f"{phase}: {out['phase_s']:.1f} s", flush=True)
    if fails:
        raise AssertionError(f"{phase}: " + "; ".join(fails))
    return out


def run_serve_vlm(*, seed, runs=25):
    """The ``serve-vlm`` phase on the card (:data:`SERVE_VLM`): paligemma-3b
    served at full width (:func:`serve_family`), then the SMOKE model on
    the card against the CPU and a SMOKE train step
    (:func:`family_card_vs_cpu`). Returns the phase line."""
    return _serve_family("serve-vlm", seed, torch.device("cuda"), runs,
                         SERVE_VLM)


def rehearse_serve_vlm(seed=0):
    """The ``serve-vlm`` phase's checks on the CPU at SMOKE size
    (:data:`REHEARSAL_VLM`; no kernel runs). Returns the phase line."""
    return _serve_family("serve-vlm", seed, torch.device("cpu"), 0,
                         REHEARSAL_VLM)


def run_serve_whisper(*, seed, runs=25):
    """The ``serve-whisper`` phase on the card (:data:`SERVE_WHISPER`):
    whisper-medium served at full width (:func:`serve_family`), then the
    SMOKE model on the card against the CPU and a SMOKE train step. Returns
    the phase line."""
    return _serve_family("serve-whisper", seed, torch.device("cuda"), runs,
                         SERVE_WHISPER)


def rehearse_serve_whisper(seed=0):
    """The ``serve-whisper`` phase's checks on the CPU at SMOKE size
    (:data:`REHEARSAL_WHISPER`; no kernel runs). Returns the phase line."""
    return _serve_family("serve-whisper", seed, torch.device("cpu"), 0,
                         REHEARSAL_WHISPER)


def run_serve_mamba(*, seed, runs=25):
    """The ``serve-mamba`` phase on the card (:data:`SERVE_MAMBA`):
    falcon-mamba-7b served at full width (:func:`serve_family`; no K5 on
    this path), then the SMOKE model on the card against the CPU and a
    SMOKE train step. Returns the phase line."""
    return _serve_family("serve-mamba", seed, torch.device("cuda"), runs,
                         SERVE_MAMBA)


def rehearse_serve_mamba(seed=0):
    """The ``serve-mamba`` phase's checks on the CPU at SMOKE size
    (:data:`REHEARSAL_MAMBA`). Returns the phase line."""
    return _serve_family("serve-mamba", seed, torch.device("cpu"), 0,
                         REHEARSAL_MAMBA)


def run_serve_zamba(*, seed, runs=25):
    """The ``serve-zamba`` phase on the card (:data:`SERVE_ZAMBA`):
    zamba2-7b served at full width (:func:`serve_family`; K5 at head dim
    112 once an occurrence a prefill), then the SMOKE model on the card
    against the CPU and a SMOKE train step. Returns the phase line."""
    return _serve_family("serve-zamba", seed, torch.device("cuda"), runs,
                         SERVE_ZAMBA)


def rehearse_serve_zamba(seed=0):
    """The ``serve-zamba`` phase's checks on the CPU at SMOKE size
    (:data:`REHEARSAL_ZAMBA`; no kernel runs). Returns the phase line."""
    return _serve_family("serve-zamba", seed, torch.device("cpu"), 0,
                         REHEARSAL_ZAMBA)


# -------------------------------------------------------------------- main

# ------------------------------------------------------------------ parallel

# (c) the reference's own pipeline configuration
# (src/repro/launch/dryrun_pipeline.py:23-33): 4 stages x 8 layers of
# h + tanh(h @ wi) @ wo, d 4,096, ff 16,384, bf16, 8 microbatches of
# 4 x 1,024 tokens, forward. wi and wo are drawn with the std of their
# fan-in.
PIPE_DENSE = dict(n_stages=4, layers_per_stage=8, d=4096, ff=16384,
                  n_micro=8, mb=4, seq=1024)
REHEARSAL_PIPE_DENSE = dict(n_stages=4, layers_per_stage=2, d=64, ff=256,
                            n_micro=8, mb=2, seq=16)
PIPE_DENSE_BOUND = (
    "the pipeline equal bit for bit to the stages applied in sequence "
    "microbatch by microbatch; against a float32 evaluation of the same "
    "bf16 weights and input, its relative rms error at most 2 x the "
    "whole-batch bf16 evaluation's + 2^-9")
# (d) yi-9b's 8 full-width layers (the train phase's configuration) as 4
# stages of 2 decoder blocks, a batch of 4 x 4,096 tokens in 4
# microbatches: forward and backward of sum(y * G) for a fixed G.
PIPE_YI = dict(n_stages=4, n_layers=8, batch=4, seq=4096, n_micro=4)
REHEARSAL_PIPE_YI = dict(n_stages=4, n_layers=8, batch=4, seq=64, n_micro=4,
                         smoke=True)
PIPE_YI_BOUND = (
    "against the unpipelined block stack on the whole batch, with the "
    "train phase's tolerances (TRAIN_STEP_BOUND): the functional within "
    "2e-3 relative (the loss's), the output's rms difference within 2e-3 of "
    "its rms, and for the grad of x and each stage's wq grad the norm of "
    "the difference within 3e-2 of the norm (the grad norm's)")


def _ways(entry, sizes) -> int:
    """How many ways a spec entry splits its dim."""
    from repro_torch.parallel.sharding import spec_names
    k = 1
    for a in spec_names(entry):
        k *= sizes[a]
    return k


def parallel_specs() -> tuple:
    """(a) ``param_shardings`` of every configuration, from
    ``lm.param_shapes`` (inside ``state_template``) only, on both
    production meshes with fsdp off and on: every sharded dim must divide
    (``tests/test_sharding.py::test_all_arch_param_shardings_build``'s
    check, here for the ZeRO-1 AdamW state's specs too); the parameter GB,
    GB a device and the ZeRO-1 AdamW state's GB a device
    (``opt_state_shardings``). Returns (rows, fails)."""
    import torch.utils._pytree as pytree
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.train import optim as O
    from repro_torch.parallel import sharding as SH
    from repro_torch.train.train_step import state_template
    rows, fails = [], []
    meshes = [make_production_mesh(multi_pod=m) for m in (False, True)]
    for arch in ARCH_IDS:
        tpl = state_template(get_config(arch), O.OptConfig())
        params, opt = tpl["params"], tpl["opt"]
        for mesh in meshes:
            sizes = mesh.shape
            for fsdp in (False, True):
                ps = SH.param_shardings(params, mesh, fsdp=fsdp)
                os_ = O.opt_state_shardings(opt, ps, mesh)
                pairs = {"params": (params, ps), "adamw": (opt, os_)}
                gb = {}
                for what, (tree, shs) in pairs.items():
                    leaves = pytree.tree_flatten_with_path(tree)[0]
                    shl = pytree.tree_leaves(shs)
                    per_device = 0
                    for (path, leaf), sh in zip(leaves, shl):
                        k = 1
                        for e, n in zip(sh.spec, leaf.shape):
                            k *= _ways(e, sizes)
                            if n % _ways(e, sizes):
                                fails.append(f"{arch} {what} "
                                             f"{SH._path_str(path)} "
                                             f"{tuple(leaf.shape)} {sh.spec}")
                        per_device += leaf.numel() * leaf.element_size() // k
                    gb[what] = sum(t.numel() * t.element_size()
                                   for _, t in leaves) / 1e9
                    gb[what + "_per_device"] = per_device / 1e9
                rows.append({"mesh": dict(sizes), "arch": arch,
                             "fsdp": fsdp, "param_gb": gb["params"],
                             "param_gb_per_device": gb["params_per_device"],
                             "zero1_adamw_gb_per_device":
                                 gb["adamw_per_device"]})
    return rows, fails


def parallel_placement(seed: int, dev, want_loss: float, run: dict,
                       smoke: bool = False) -> tuple:
    """(b) a one-rank process group (NCCL on the card, gloo on the CPU) and
    the ``DeviceMesh`` of a (1, 1) ("data", "model") mesh; the train
    phase's state (``run``'s configuration, its seed) placed by
    ``param_shardings``: every local shard equal to its source bit for
    bit; then one ``make_train_step`` step under ``ShardCtx`` of that mesh
    on the train phase's first batch, whose loss must equal ``want_loss``
    (the train phase's first step) bit for bit. Returns (line, fails)."""
    import torch.distributed as dist
    import torch.utils._pytree as pytree
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import device_mesh, make_mesh
    from repro_torch.train import optim as O
    from repro_torch.train.data import DataConfig, TokenStream
    from repro_torch.parallel import sharding as SH
    from repro_torch.train.train_step import init_state, make_train_step
    fails = []
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        dm = device_mesh(make_mesh((1, 1), ("data", "model")))
        over = {} if smoke else {"n_layers": run["n_layers"]}
        cfg = get_config(TRAIN_ARCH, smoke=smoke, **over)
        ocfg = O.OptConfig(lr=1e-3, warmup=min(20, run["steps"] // 5 or 1),
                           total_steps=run["steps"])     # train_loop's
        state = init_state(cfg, ocfg,
                           torch.Generator(device=dev).manual_seed(seed))
        leaves, treedef = pytree.tree_flatten(state["params"])
        shs = pytree.tree_leaves(SH.param_shardings(state["params"], dm))
        placed, differ = [], 0
        for i, (p, sh) in enumerate(zip(leaves, shs)):
            local = distribute_tensor(p, dm, sh.placements).to_local()
            differ += not torch.equal(local, p)
            placed.append(local)
            leaves[i] = None
        del leaves
        state["params"] = pytree.tree_unflatten(placed, treedef)
        del placed
        if differ:
            fails.append(f"{differ} local shards differ from their source")
        data = TokenStream(DataConfig(vocab=cfg.vocab,
                                      global_batch=run["batch"],
                                      seq_len=run["seq"], seed=seed), cfg)
        b = {k: torch.from_numpy(v).to(dev)
             for k, v in data.batch_at(0).items()}
        step = make_train_step(cfg, ocfg, shard=SH.shard,
                               n_micro=run["n_micro"])
        with SH.ShardCtx(dm):
            state, metrics = step(state, b)
        loss = float(metrics["loss"])
        if loss != want_loss:
            fails.append(f"loss {loss!r} != the train phase's first-step "
                         f"loss {want_loss!r}")
        del state, metrics
    finally:
        dist.destroy_process_group()
    return {"backend": backend, "mesh": {"data": 1, "model": 1},
            "leaves": len(shs), "loss": loss, "train_first_loss": want_loss,
            "placements": sorted({str(sh.placements) for sh in shs})}, fails


def _rel_rms(a, b) -> float:
    d = (a.float() - b.float()).pow(2).mean().sqrt()
    return float(d / b.float().pow(2).mean().sqrt())


def _dense_stage(pl, h):
    """One stage of the reference's dry-run pipeline: its layers of
    h + tanh(h @ wi) @ wo."""
    wi, wo = pl
    for i in range(wi.shape[0]):
        h = h + torch.tanh(h @ wi[i]) @ wo[i]
    return h


def pipeline_dense(spec: dict, seed: int, dev, runs: int) -> tuple:
    """(c) ``pipeline_apply`` on the reference's pipeline configuration
    (:data:`PIPE_DENSE`): against the stages in sequence microbatch by
    microbatch and the whole batch at once (:data:`PIPE_DENSE_BOUND`);
    its median time (CUDA events), TFLOP/s and the schedule's bubble.
    Returns (line, fails)."""
    from repro_torch.launch.mesh import make_pipeline_mesh
    from repro_torch.parallel.pipeline import bubble_fraction, pipeline_apply
    P_, L, d, ff = (spec[k] for k in ("n_stages", "layers_per_stage", "d",
                                      "ff"))
    M, mb, S = spec["n_micro"], spec["mb"], spec["seq"]
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    bf = torch.bfloat16
    wi = torch.randn((P_, L, d, ff), generator=g, device=dev,
                     dtype=bf).mul_(d ** -0.5)
    wo = torch.randn((P_, L, ff, d), generator=g, device=dev,
                     dtype=bf).mul_(ff ** -0.5)
    x = torch.randn((M * mb, S, d), generator=g, device=dev, dtype=bf)
    mesh = make_pipeline_mesh(P_, device=str(dev))
    fails = []
    with torch.no_grad():
        pipe = lambda: pipeline_apply(mesh, _dense_stage, (wi, wo), x, M)
        y = pipe()

        def sequential():
            out = []
            for m in range(M):
                h = x[m * mb:(m + 1) * mb]
                for s in range(P_):
                    h = _dense_stage((wi[s], wo[s]), h)
                out.append(h)
            return torch.cat(out)

        def whole():
            h = x
            for s in range(P_):
                h = _dense_stage((wi[s], wo[s]), h)
            return h

        exact = torch.equal(y, sequential())
        w = whole()
        ref = x.float()
        for s in range(P_):
            ref = _dense_stage((wi[s].float(), wo[s].float()), ref)
        err_pipe, err_whole = _rel_rms(y, ref), _rel_rms(w, ref)
        y_vs_whole = {"rel_rms": _rel_rms(y, w), "max_abs_err":
                      float((y.float() - w.float()).abs().max())}
        del ref, w
        if not exact:
            fails.append("the pipeline differs from the sequential stages")
        if not err_pipe <= 2 * err_whole + 2.0 ** -9:
            fails.append(f"relative rms error against float32 {err_pipe} "
                         f"> 2 x the whole batch's {err_whole} + 2^-9")
        timing = None
        if dev.type == "cuda":
            n = max(3, min(runs, 5))
            ms, _ = _event_ms(pipe, n)
            seq_ms, _ = _event_ms(sequential, 3)
            whole_ms, _ = _event_ms(whole, 3)
            flops = 4 * M * mb * S * d * ff * P_ * L
            nbytes = 2 * (wi.numel() + wo.numel() + 2 * x.numel())
            timing = {"ms": ms, "sequential_ms": seq_ms,
                      "whole_batch_ms": whole_ms, "runs": n,
                      "tflops_per_s": flops / (ms / 1e3) / 1e12,
                      "peak_tflops_per_s": H100_BF16_PEAK / 1e12,
                      "share_of_peak": flops / (ms / 1e3) / H100_BF16_PEAK,
                      "flops": flops,
                      "bound_ms": max(flops / H100_BF16_PEAK,
                                      nbytes / HBM_BYTES_PER_S) * 1e3,
                      "bound_by": "operations"
                      if flops / H100_BF16_PEAK > nbytes / HBM_BYTES_PER_S
                      else "bytes",
                      "clock": "CUDA events, median"}
    return {"config": spec, "weights_gb": 2 * (wi.numel() + wo.numel()) / 1e9,
            "equal_to_sequential": exact,
            "rel_rms_err_vs_float32": err_pipe,
            "whole_batch_rel_rms_err_vs_float32": err_whole,
            "vs_whole_batch": y_vs_whole, "tolerance": PIPE_DENSE_BOUND,
            "bubble": bubble_fraction(P_, M),
            "bubble_note": "(P - 1) / (M + P - 1) of the ticks: a property "
                           "of the schedule; on one card the stages run one "
                           "after another, so it costs no time here",
            "timing": timing}, fails


def _grad_rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def pipeline_yi(spec: dict, seed: int, dev, runs: int) -> tuple:
    """(d) yi-9b's layers (:data:`PIPE_YI`) as ``n_stages`` stages of
    decoder blocks through ``pipeline_apply``, forward and backward of a
    fixed linear functional of the output, against the unpipelined block
    stack on the whole batch (:data:`PIPE_YI_BOUND`); K5's launches in the
    pipeline's run (one a layer a microbatch); the pipeline's forward and
    backward time. Returns (line, fails)."""
    import torch.utils._pytree as pytree
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as k5
    from repro_torch.launch.mesh import make_pipeline_mesh
    from repro_torch.models import attention as A
    from repro_torch.models import blocks as BLK
    from repro_torch.models import lm
    from repro_torch.models.attention import FLASH_THRESH
    from repro_torch.parallel.pipeline import pipeline_apply
    smoke = spec.get("smoke", False)
    cfg = get_config(TRAIN_ARCH, smoke=smoke, n_layers=spec["n_layers"])
    P_, M, B, S = (spec[k] for k in ("n_stages", "n_micro", "batch", "seq"))
    per = cfg.n_layers // P_
    (kind, _), = BLK.block_kinds(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    seg = lm.init_params(cfg, gen)["seg0"]
    stacked = pytree.tree_map(lambda t: t.view((P_, per) + t.shape[1:]), seg)
    x = torch.randn((B, S, cfg.d_model), generator=gen,
                    device=dev).to(cfg.dtype)
    G = torch.randn((B, S, cfg.d_model), generator=gen, device=dev)
    mask = A.MaskSpec("causal", cfg.window, 0)

    def stage(pl, h):
        pos = lm._positions(h.shape[0], h.shape[1], h.device)
        for j in range(per):
            h, _ = BLK.block_forward(lm.layer_params(pl, j), cfg, kind, h,
                                     pos, mask)
        return h

    def unpipelined(ps, h):
        for s in range(P_):
            h = stage(pytree.tree_map(lambda t: t[s], ps), h)
        return h

    mesh = make_pipeline_mesh(P_, device=str(dev))
    pipelined = lambda ps, h: pipeline_apply(mesh, stage, ps, h, M)

    def fwd_bwd(run):
        ps = pytree.tree_map(lambda t: t.detach().requires_grad_(), stacked)
        xx = x.detach().requires_grad_()
        with torch.enable_grad():
            y = run(ps, xx)
            f = (y.float() * G).sum()
            leaves = pytree.tree_leaves(ps)
            grads = torch.autograd.grad(f, [xx] + leaves)
        by_id = {id(t): g for t, g in zip(leaves, grads[1:])}
        return {"y": y.detach(), "f": float(f.detach()), "gx": grads[0],
                "gwq": by_id[id(ps["attn"]["wq"])]}

    k5.LAUNCHES = 0                      # counts from the pipeline only
    got = fwd_bwd(pipelined)
    launches = k5.LAUNCHES
    want_launches = cfg.n_layers * M if (S * S > FLASH_THRESH) else 0
    want = fwd_bwd(unpipelined)
    fails = []
    if dev.type == "cuda" and launches != want_launches:
        fails.append(f"K5 launches {launches}, expected {want_launches}")
    cmp = {"f_rel": abs(got["f"] - want["f"]) / abs(want["f"]),
           "y_rel_rms": _rel_rms(got["y"], want["y"]),
           "y_max_abs_err": float((got["y"].float()
                                   - want["y"].float()).abs().max()),
           "y_equal": bool(torch.equal(got["y"], want["y"])),
           "gx_rel": _grad_rel(got["gx"], want["gx"]),
           "gwq_rel_by_stage": [_grad_rel(got["gwq"][s], want["gwq"][s])
                                for s in range(P_)]}
    if not cmp["f_rel"] <= 2e-3:
        fails.append(f"functional {got['f']} vs {want['f']}")
    if not cmp["y_rel_rms"] <= 2e-3:
        fails.append(f"output relative rms {cmp['y_rel_rms']}")
    for name, r in [("grad x", cmp["gx_rel"])] + [
            (f"stage {s} wq grad", r)
            for s, r in enumerate(cmp["gwq_rel_by_stage"])]:
        if not r <= 3e-2:
            fails.append(f"{name}: relative difference {r}")
    del got, want
    timing = None
    if dev.type == "cuda":
        ms, _ = _event_ms(lambda: fwd_bwd(pipelined), max(2, min(runs, 3)))
        whole_ms, _ = _event_ms(lambda: fwd_bwd(unpipelined), 2)
        timing = {"forward_backward_ms": ms, "unpipelined_ms": whole_ms,
                  "clock": "CUDA events, median"}
    return {"arch": cfg.name, "layers": cfg.n_layers, "stages": P_,
            "layers_per_stage": per, "batch": B, "seq": S, "n_micro": M,
            "k5_launches": launches, "expected_k5_launches": want_launches,
            "vs_unpipelined": cmp, "tolerance": PIPE_YI_BOUND,
            "timing": timing}, fails


def _parallel(seed, dev, runs, want_loss, train_run, dense, yi, smoke):
    t_phase = time.perf_counter()
    t = time.perf_counter()
    rows, fails = parallel_specs()
    specs_s = time.perf_counter() - t
    for r in rows:
        emit({"part": "parallel specs", **r})
    t = time.perf_counter()
    placement, f = parallel_placement(seed, dev, want_loss, train_run,
                                      smoke=smoke)
    fails += [f"placement: {x}" for x in f]
    placement["seconds"] = time.perf_counter() - t
    _free(dev)
    t = time.perf_counter()
    dense_out, f = pipeline_dense(dense, seed, dev, runs)
    fails += [f"pipeline (reference config): {x}" for x in f]
    dense_out["seconds"] = time.perf_counter() - t
    _free(dev)
    t = time.perf_counter()
    yi_out, f = pipeline_yi(yi, seed, dev, runs)
    fails += [f"pipeline (yi-9b): {x}" for x in f]
    yi_out["seconds"] = time.perf_counter() - t
    _free(dev)
    out = {"phase": "parallel", "specs_s": specs_s, "placement": placement,
           "pipeline_dense": dense_out, "pipeline_yi": yi_out,
           "phase_s": time.perf_counter() - t_phase, "fails": fails}
    emit(out)
    print(f"parallel: {out['phase_s']:.1f} s", flush=True)
    if fails:
        raise AssertionError("parallel: " + "; ".join(fails))
    return out


def run_parallel(*, seed, train_first_loss, runs=25):
    """The ``parallel`` phase on the card: (a) :func:`parallel_specs`, (b)
    :func:`parallel_placement` against the train phase's first-step loss
    ``train_first_loss``, (c) :func:`pipeline_dense`, (d)
    :func:`pipeline_yi`. Returns the phase line."""
    return _parallel(seed, torch.device("cuda"), runs, train_first_loss,
                     TRAIN_RUN, PIPE_DENSE, PIPE_YI, smoke=False)


def rehearse_parallel(seed=0):
    """The ``parallel`` phase's checks on the CPU: (b) at yi-9b's SMOKE
    size against :func:`rehearse_train`'s first loss (the same run as the
    train rehearsal's ``train_loop``), (c) and (d) at
    :data:`REHEARSAL_PIPE_DENSE` and :data:`REHEARSAL_PIPE_YI`. Returns the
    phase line."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import train_loop
    run = dict(TRAIN_RUN, seq=64, steps=1)
    out = train_loop(get_config(TRAIN_ARCH, smoke=True), run["steps"],
                     run["batch"], run["seq"], seed=seed,
                     n_micro=run["n_micro"],
                     mesh=make_local_mesh(device="cpu"), log_every=10 ** 9)
    return _parallel(seed, torch.device("cpu"), 0, out["losses"][0], run,
                     REHEARSAL_PIPE_DENSE, REHEARSAL_PIPE_YI, smoke=True)


# ------------------------------------------------------------------ examples

# examples/*_torch.py with their documented arguments (the train twin's
# checkpoints go under build/); quickstart, ycsb_demo and serve_lm must
# print on the card what they print on the CPU.
EXAMPLES = ("quickstart_torch", "ycsb_demo_torch", "serve_lm_torch",
            "train_lm_torch")


def _example(name: str, argv) -> list:
    """Run ``examples/<name>.py``'s ``main(argv)`` in this process; its
    stdout lines."""
    import contextlib
    import importlib.util
    import io
    path = os.path.join(ROOT, "examples", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main(list(argv))
    return buf.getvalue().splitlines()


def _serve_json(lines) -> dict:
    out = json.loads(lines[-1])
    return {k: v for k, v in out.items()
            if k not in ("device", "tok_per_s")}


def _examples(dev, compare_cpu: bool):
    import shutil
    from repro_torch.kernels.fused_descent import ops as k1
    from repro_torch.kernels.fused_scan import ops as k2
    t_phase = time.perf_counter()
    ck = os.path.join(ROOT, "build", "examples_train_ck")
    shutil.rmtree(ck, ignore_errors=True)
    dev_args = [] if dev.type == "cuda" else ["--device", "cpu"]
    extra = {"train_lm_torch": ["--ckpt", ck]}
    k1.LAUNCHES = k2.LAUNCHES = 0        # counts from the twins only
    lines, secs = {}, {}
    for name in EXAMPLES:
        t = time.perf_counter()
        lines[name] = _example(name, dev_args + extra.get(name, []))
        secs[name] = time.perf_counter() - t
        for line in lines[name]:
            print(f"{name}: {line}", flush=True)
    launches = {"fused_descent": k1.LAUNCHES, "fused_scan": k2.LAUNCHES}
    shutil.rmtree(ck, ignore_errors=True)
    fails = []
    for name in ("quickstart_torch", "ycsb_demo_torch"):
        printed = json.loads(lines[name][-1][len("launches: "):])
        if dev.type == "cuda" and printed["fused_descent"] == 0:
            fails.append(f"{name} launched no fused-descent kernel")
    if dev.type == "cuda" and not (launches["fused_descent"]
                                   and launches["fused_scan"]):
        fails.append(f"kernel launches {launches}")
    if compare_cpu:
        for name in ("quickstart_torch", "ycsb_demo_torch"):
            cpu = _example(name, ["--device", "cpu"])
            if lines[name][:-1] != cpu[:-1]:
                fails.append(f"{name}: the card's lines differ from the "
                             f"CPU's")
        cpu = _example("serve_lm_torch", ["--device", "cpu"])
        if _serve_json(lines["serve_lm_torch"]) != _serve_json(cpu):
            fails.append("serve_lm_torch: the card's JSON differs from the "
                         "CPU's")
    tl = lines["train_lm_torch"]
    train = json.loads("\n".join(tl[max(i for i, x in enumerate(tl)
                                        if x == "{"):]))
    if not (train["last5"] < train["first5"]
            and len(train["restarts"]) == 1):
        fails.append(f"train_lm_torch: {train}")
    out = {"phase": "examples", "launches": launches, "seconds": secs,
           "serve": _serve_json(lines["serve_lm_torch"]),
           "train": {k: train[k] for k in ("first5", "last5")},
           "train_restarts": len(train["restarts"]),
           "phase_s": time.perf_counter() - t_phase, "fails": fails}
    emit(out)
    print(f"examples: {out['phase_s']:.1f} s", flush=True)
    if fails:
        raise AssertionError("examples: " + "; ".join(fails))
    return out


def run_examples():
    """The ``examples`` phase on the card: the four twins with their
    documented arguments, in this process; K1 and K2 launches counted over
    them; quickstart's, ycsb_demo's and serve_lm's output equal to their
    CPU runs'; train_lm's loss falls with one restart. Returns the phase
    line."""
    return _examples(torch.device("cuda"), compare_cpu=True)


def rehearse_examples():
    """The ``examples`` phase on the CPU (no comparison run)."""
    return _examples(torch.device("cpu"), compare_cpu=False)


# ------------------------------------------------------------------- dryrun

# The dry run's cells on the card's host (``launch/dryrun.py``, fake
# tensors on "cuda", ``--profile optimized``), each its own process, all
# at once: yi-9b in the three shapes and deepseek-v3's training on the
# single mesh, deepseek-v3's training on the multi mesh; then the
# pipeline dry run (``launch/dryrun_pipeline.py``).
DRYRUN_CELLS = (("yi-9b", "train_4k", "single"),
                ("yi-9b", "prefill_32k", "single"),
                ("yi-9b", "decode_32k", "single"),
                ("deepseek-v3-671b", "train_4k", "single"),
                ("deepseek-v3-671b", "train_4k", "multi"))
DRYRUN_TIMEOUT = 600
# the dry run held against the card: the train phase's yi-9b (8 layers,
# 2 x 4,096 tokens in 2 microbatches; remat "full", the dry run's) as a
# 1 x 1 cell, and the real step
DRYRUN_CARD = dict(n_layers=8, seq=4096, batch=2, n_micro=2)


def _dryrun_procs(device: str, out_dir: str, cells=DRYRUN_CELLS,
                  pipeline=None):
    """Start one process a dry-run cell (and one for the pipeline dry run,
    ``pipeline`` its config or None for the reference's), all at once;
    their JSON goes under ``out_dir``. Returns [(what, path, Popen)]."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = []
    for arch, shape, mesh in cells:
        path = os.path.join(out_dir, f"{arch}.{shape}.{mesh}.json")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mesh, "--profile",
               "optimized", "--device", device, "--out", path]
        procs.append(((arch, shape, mesh), path, subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)))
    path = os.path.join(out_dir, "pipeline.json")
    code = ("import json, sys; from repro_torch.launch import "
            "dryrun_pipeline as P; json.dump(P.run(sys.argv[1], "
            "json.loads(sys.argv[2])), open(sys.argv[3], 'w'))")
    procs.append((("pipeline",), path, subprocess.Popen(
        [sys.executable, "-c", code, device, json.dumps(pipeline or {}),
         path], cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)))
    return procs


def _dryrun_wait(procs, timeout: float) -> tuple:
    """Wait for every process (killing all at ``timeout``); returns (the
    records by cell, fails)."""
    t_end = time.perf_counter() + timeout
    recs, fails = {}, []
    try:
        for what, path, p in procs:
            try:
                _, err = p.communicate(
                    timeout=max(1.0, t_end - time.perf_counter()))
            except subprocess.TimeoutExpired:
                fails.append(f"{what}: no record in {timeout:.0f} s")
                continue
            if p.returncode != 0:
                fails.append(f"{what}: exit {p.returncode}: {err[-600:]}")
                continue
            with open(path) as f:
                rec = json.load(f)
            recs[what] = rec[0] if isinstance(rec, list) else rec
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return recs, fails


def _cell_line(r: dict) -> dict:
    """A cell's record without its long lists, GB a device beside it."""
    line = {k: v for k, v in r.items()
            if k not in ("top_traffic", "collectives")}
    m = r.get("memory_analysis")
    if m:
        line["device_GB"] = (m["argument_size_in_bytes"]
                             + m["temp_size_in_bytes"]) / 1e9
        line["fits_80GB"] = line["device_GB"] <= 80.0
    return line


def dryrun_vs_card(seed: int, dev, spec: dict, smoke: bool = False) -> tuple:
    """yi-9b (``spec``: layers, tokens, batch, microbatches) as a 1 x 1
    dry-run cell on a fake group, and the same step for real on ``dev``:
    the dry run's counted FLOPs must equal what the same counter
    (``cost_analysis.flops_of``) reads over the real step; the predicted
    per-device peak (arguments + temporaries) is printed beside the real
    step's ``max_memory_allocated``, and their ratio. Returns (line,
    fails)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import cost_analysis as CA
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.train_step import init_state, make_train_step
    fails = []
    over = {} if smoke else {"n_layers": spec["n_layers"]}
    cfg = dataclasses.replace(get_config(TRAIN_ARCH, smoke=smoke, **over),
                              remat="full")
    t = time.perf_counter()
    rec = D.run_cell(TRAIN_ARCH, "train_4k", "single",
                     n_micro=spec["n_micro"], device=dev.type, cfg=cfg,
                     amesh=make_mesh((1, 1), ("data", "model")),
                     shape_override=dict(seq_len=spec["seq"],
                                         global_batch=spec["batch"]))
    cell_s = time.perf_counter() - t
    if rec["status"] != "ok":
        return {"status": rec["status"], "error": rec.get("error")}, [
            f"the 1 x 1 cell: {rec.get('error')}"]
    mem = rec["memory_analysis"]
    predicted = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    ocfg = D.opt_for(cfg)
    state = init_state(cfg, ocfg,
                       torch.Generator(device=dev).manual_seed(seed))
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (spec["batch"],
                                                    spec["seq"]),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)}
    step = make_train_step(cfg, ocfg, n_micro=spec["n_micro"])
    flops, (state, m) = CA.flops_of(step, state, batch)
    loss = float(m["loss"])
    if flops != rec["flops_per_device"]:
        fails.append(f"the dry run counted {rec['flops_per_device']!r} "
                     f"FLOPs, the real step {flops!r}")
    measured = None
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, m = step(state, batch)
        float(m["loss"])
        measured = torch.cuda.max_memory_allocated()
    del state, m, batch
    return {"cell_s": cell_s, "flops_dry_run": rec["flops_per_device"],
            "flops_card": flops, "flops_equal": flops == rec[
                "flops_per_device"], "loss": loss,
            "predicted_peak_bytes": predicted, "memory_analysis": mem,
            "measured_peak_bytes": measured,
            "measured_over_predicted": (measured / predicted
                                        if measured else None),
            "reshards": rec["reshards"],
            "config": dict(spec, layers=cfg.n_layers, remat=cfg.remat,
                           opt=ocfg.kind)}, fails


def k5_through_dtensor(seed: int, dev, shape=(1, 4096, 32, 4, 128)) -> tuple:
    """K5 on a one-rank mesh's DTensors (NCCL on the card, gloo on the
    CPU): q, k, v of ``shape`` (B, S, H, Hk, hd; bf16) placed [Shard(0),
    Shard(2)] over a (1, 1) ("data", "model") ``DeviceMesh``: the output's
    local shard equal to the plain-tensor call bit for bit, ``LAUNCHES``
    up by one a call on the card. Returns (line, fails)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.kernels.flash_attention import ops as k5
    from repro_torch.launch.mesh import device_mesh, make_mesh
    from repro_torch.models.attention import CAUSAL
    B, S, H, Hk, hd = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((B, S, h, hd), generator=g, device=dev)
               .to(torch.bfloat16) for h in (H, Hk, Hk))
    fails = []
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        dm = device_mesh(make_mesh((1, 1), ("data", "model")))
        pl = [Shard(0), Shard(2)]
        qd, kd, vd = (DTensor.from_local(t, dm, pl) for t in (q, k, v))
        before = k5.LAUNCHES
        out = k5.flash_sdpa(qd, kd, vd, CAUSAL, H // Hk, hd ** -0.5)
        launches = k5.LAUNCHES - before
        want = k5.flash_sdpa(q, k, v, CAUSAL, H // Hk, hd ** -0.5)
        equal = bool(torch.equal(out.to_local(), want))
        placements = [str(p) for p in out.placements]
    finally:
        dist.destroy_process_group()
    if not equal:
        fails.append("K5 through the DTensor differs from the plain call")
    if dev.type == "cuda" and launches != 1:
        fails.append(f"K5 through the DTensor: {launches} launches, not 1")
    return {"backend": backend, "shape": dict(zip("B S H Hk hd".split(),
                                                  shape)),
            "equal": equal, "launches": launches,
            "placements": placements}, fails


def _dryrun(seed, dev, spec, cells, pipeline, smoke, out_dir):
    t_phase = time.perf_counter()
    os.makedirs(out_dir, exist_ok=True)
    procs = _dryrun_procs("cuda" if dev.type == "cuda" else "cpu", out_dir,
                          cells, pipeline)
    fails = []
    try:
        card, f = dryrun_vs_card(seed, dev, spec, smoke=smoke)
        fails += [f"1 x 1 cell: {x}" for x in f]
        _free(dev)
        k5d, f = k5_through_dtensor(seed, dev)
        fails += [f"K5 DTensor: {x}" for x in f]
        _free(dev)
    finally:
        recs, f = _dryrun_wait(procs, DRYRUN_TIMEOUT)
    fails += f
    for what, r in recs.items():
        if what == ("pipeline",):
            continue
        emit({"part": "dryrun cell", **_cell_line(r)})
        if r.get("status") != "ok":
            fails.append(f"{what}: {r.get('status')} {r.get('error')}")
    pipe = recs.get(("pipeline",))
    if pipe is not None:
        emit({"part": "dryrun pipeline", **{
            k: v for k, v in pipe.items() if k != "per_stage"}})
    out = {"phase": "dryrun", "vs_card": card, "k5_dtensor": k5d,
           "cells": {"|".join(w): {"status": r.get("status"),
                                   "device_GB": _cell_line(r).get(
                                       "device_GB"),
                                   "compile_s": r.get("compile_s"),
                                   "reshards": r.get("reshards")}
                     for w, r in recs.items() if w != ("pipeline",)},
           "phase_s": time.perf_counter() - t_phase, "fails": fails}
    emit(out)
    print(f"dryrun: {out['phase_s']:.1f} s", flush=True)
    if fails:
        raise AssertionError("dryrun: " + "; ".join(fails))
    return out


def run_dryrun(*, seed):
    """The ``dryrun`` phase on the card: the dry-run cells
    (:data:`DRYRUN_CELLS`) and the pipeline dry run in processes of their
    own, meanwhile :func:`dryrun_vs_card` (:data:`DRYRUN_CARD`) and
    :func:`k5_through_dtensor`. Returns the phase line."""
    return _dryrun(seed, torch.device("cuda"), DRYRUN_CARD, DRYRUN_CELLS,
                   None, smoke=False,
                   out_dir=os.path.join(ROOT, "build", "dryrun"))


def rehearse_dryrun(seed=0, out_dir=None):
    """The ``dryrun`` phase's checks on the CPU: yi-9b's SMOKE widths as
    the 1 x 1 cell (2 x 1,024 tokens, below ``FLASH_THRESH``: above it the
    fake tensors take K5's op, the CPU's real ones the tiled path), K5
    through a one-rank gloo mesh (the plain version), yi-9b's decode cell
    at full width and the pipeline dry run at a small size. Returns the
    phase line."""
    out_dir = out_dir or os.path.join(ROOT, "build", "dryrun-rehearsal")
    return _dryrun(seed, torch.device("cpu"),
                   dict(DRYRUN_CARD, seq=1024), DRYRUN_CELLS[2:3],
                   dict(n_stages=2, repl=2, d=64, ff=128, layers_per_stage=2,
                        n_micro=4, mb=2, seq=8),
                   smoke=True, out_dir=out_dir)


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
    p.add_argument("--tpcc-keys", type=int, default=10_020_000,
                   help="customers of the tpcc phase: a multiple of 3,000")
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
    from repro_torch.kernels.dedupe import ops as dedupe_ops
    dd_paths = {}                     # dedupe launches through the wrapper

    def dd_mark(path):
        dd_paths[path] = dedupe_ops.LAUNCHES - sum(dd_paths.values())

    dedupe_ops.LAUNCHES = 0
    dd_out = run_dedupe(seed=args.seed, runs=args.runs)
    dd_mark("dedupe")
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
    dd_mark("ycsb")
    torch.cuda.empty_cache()
    sh_out = run_shard(tree, kb, kl, seed=args.seed, device=dev,
                       batch=args.batch, runs=args.runs)
    dd_mark("shard")
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
    dd_mark("url, int")
    torch.cuda.empty_cache()
    tp_out = run_tpcc(args.tpcc_keys, seed=args.seed, device=dev,
                      runs=args.runs)
    torch.cuda.empty_cache()

    t = timing(tree, qb, ql, args.runs)
    st = scan_timing(clean, dirty, sqb, sql, 50, args.runs)
    lt = level_timing(rebuilt, fqb, fql, args.runs)
    factor = [f for f, _ in f_outs]
    del tree, clean, dirty, rebuilt, qb, ql, sqb, sql, fqb, fql
    torch.cuda.empty_cache()
    s_out, k5t, s_log = run_serve(seed=args.seed, runs=args.runs)
    dd_mark("serve")
    k5_checks = [*s_out["k5_real"].values(), *s_out["k5_sweep"].values()]
    shc_out = run_shard_cache(s_log, n_pages=s_out["serve_config"]["n_pages"],
                              block_tokens=s_out["serve_config"][
                                  "block_tokens"], device=dev)
    dd_mark("shard-cache")
    del s_log
    torch.cuda.empty_cache()
    t_out = run_train(seed=args.seed, runs=args.runs)
    k5_checks.append(t_out["k5_forward"])
    torch.cuda.empty_cache()
    m_out = run_serve_moe(seed=args.seed, runs=args.runs)
    k5_checks += [m_out["llama4"]["k5_layer0"], m_out["deepseek"]["k5_layer0"]]
    mla = m_out["deepseek"]["k5_mla_timing"]
    torch.cuda.empty_cache()
    v_out = run_serve_vlm(seed=args.seed, runs=args.runs)
    w_out = run_serve_whisper(seed=args.seed, runs=args.runs)
    torch.cuda.empty_cache()
    mb_out = run_serve_mamba(seed=args.seed, runs=args.runs)
    torch.cuda.empty_cache()
    z_out = run_serve_zamba(seed=args.seed, runs=args.runs)
    k5_checks += [*v_out["k5_real"].values(), *w_out["k5_real"].values(),
                  *z_out["k5_real"].values()]
    torch.cuda.empty_cache()
    p_out = run_parallel(seed=args.seed, train_first_loss=t_out["losses"][0],
                         runs=args.runs)
    dd_mark("models")
    x_out = run_examples()
    dd_mark("examples")
    torch.cuda.empty_cache()
    d_out = run_dryrun(seed=args.seed)
    dd_mark("dryrun")
    k5_rows = {"vlm_256_256": v_out["k5_timing"]["served"],
               "vlm_256_256_8k": v_out["k5_timing"]["long"],
               "whisper_encoder_64_64": w_out["k5_timing"]["encoder"],
               "whisper_cross_64_64": w_out["k5_timing"]["cross"],
               "zamba_112": z_out["k5_timing"]["served"]}
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "fused_descent", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_descent.cu",
        "replaces": "src/repro/kernels/fused_descent/kernel.py:299",
        "launches": main_out["launches"] + tp_out["launches"]
        + sh_out["k1_launches"] + shc_out["k1_launches"]
        + x_out["launches"]["fused_descent"],
        "launches_by_path": {"ycsb": main_out["launches"],
                             "tpcc": tp_out["launches"],
                             "shard": sh_out["k1_launches"],
                             "shard-cache": shc_out["k1_launches"],
                             "examples": x_out["launches"]["fused_descent"]},
        "max_abs_err": max(main_out["kernel_vs_plain_max_abs_err"],
                           tp_out["kernel_vs_plain_max_abs_err"]),
        "tpcc_ms": tp_out["k1_ms"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None}, {
        "name": "fused_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_scan.cu",
        "replaces": "src/repro/kernels/fused_scan/kernel.py:237",
        "launches": e_out["k2_launches"] + sh_out["k2_launches"]
        + shc_out["k2_launches"] + x_out["launches"]["fused_scan"],
        "launches_by_path": {"ycsb-e": e_out["k2_launches"],
                             "shard": sh_out["k2_launches"],
                             "shard-cache": shc_out["k2_launches"],
                             "examples": x_out["launches"]["fused_scan"]},
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
        "name": "dedupe", "route": "cuda",
        "source": "src/repro_torch/csrc/dedupe.cu",
        "replaces": None,
        "launches": dedupe_ops.LAUNCHES,
        "launches_by_path": dd_paths,
        "per": "one write op (update, remove, insert): three launches "
               "(fill, insert, resolve); timed on a zipfian batch of "
               f"{dd_out['lanes']} lanes",
        "max_abs_err": dd_out["kernel_vs_plain_max_abs_err"],
        "ms": dd_out["ms"], "plain_ms": dd_out["plain_ms"],
        "bound_ms": dd_out["bound_ms"], "bound_by": dd_out["bound_by"],
        "library_ms": None}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:86",
        "launches": s_out["launches"]["k5"] + t_out["k5_launches"]
        + m_out["llama4"]["launches"]["k5"] + m_out["deepseek"]["k5_launches"]
        + v_out["k5_launches"] + w_out["k5_launches"]
        + mb_out["k5_launches"] + z_out["k5_launches"]
        + p_out["pipeline_yi"]["k5_launches"]
        + d_out["k5_dtensor"]["launches"],
        "launches_by_path": {
            "serve": s_out["launches"]["k5"], "train": t_out["k5_launches"],
            "serve-moe llama4": m_out["llama4"]["launches"]["k5"],
            "serve-moe deepseek": m_out["deepseek"]["k5_launches"],
            "serve-vlm": v_out["k5_launches"],
            "serve-whisper": w_out["k5_launches"],
            "serve-mamba": mb_out["k5_launches"],
            "serve-zamba": z_out["k5_launches"],
            "pipeline": p_out["pipeline_yi"]["k5_launches"],
            "dryrun": d_out["k5_dtensor"]["launches"]},
        "builds": "bf16 (q/k, v) head dims padded to (64, 64), (128, 128) "
                  "(zamba2's 112 zero-padded by TMA), (192, 128) or "
                  "(256, 256); float32 q/k and v up to 256",
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
        "library": "torch.nn.functional.scaled_dot_product_attention ("
                   + k5t["library"] + ")",
        "per": "one prefill layer: " + ", ".join(
            f"{k}={v}" for k, v in k5t["shape"].items()),
        **{name: {k: row[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_backend", "bound_share", "shape")}
           for name, row in {"mla_192_128": mla, **k5_rows}.items()}}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
