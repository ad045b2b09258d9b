#!/usr/bin/env python3
"""Check and time versions of the tree kernels K1 (fused descent), K2
(fused scan), K3 (feature branch) and K4 (leaf probe) on the card, in
turns.

Each version is a directory holding the kernels' CUDA sources
(``fused_descent.cu``, ``fused_scan.cu``, ``feature_branch.cu``,
``leaf_probe.cu`` and the headers they include), given as ``name=dir``
(default: the checkout's
``src/repro_torch/csrc``); keep scratch versions under ``build/``. The
workload is ``chip_smoke.py``'s, at its sizes (seed 0):

- ycsb: 10,000,000 YCSB-like keys of 24 bytes (ns 64, fs 4, 6 levels),
  one lookup batch of 65,536 queries (10% absent), and YCSB-E's scan
  batch (65,536 zipf(0.99) starts, ``max_items`` 50) on the clean tree and
  on the tree after 16 rounds of 3,449 inserts (``run_phase`` and
  ``run_ycsb_e`` build them with the checkout's kernels and check them);
- url: 1,000,000 URL keys of up to 72 bytes (ns 64), the kernels' build for
  keys of three 32-byte stripes (``stripes_for`` in ``csrc/cmp.cuh``;
  ycsb's takes one): one lookup
  batch of 65,536 queries, and a scan batch (65,536 zipf(0.99) starts, a
  third with their last byte flipped, ``max_items`` 50) on the clean tree
  and on the tree after 16 rounds of 3,449 fresh URL keys inserted;
- rebuilt: the ycsb tree after YCSB-E with 4,096 keys removed, then
  ``rebuild`` (``run_rebuild``), and the factor phase's batch over it
  (65,536 zipf(0.99) present keys, ``factor_batch``): the batch
  ``chip_smoke.py::level_timing`` times K3 and K4 on.

One JSON line each:

- per version: what each kernel's instantiation asks of the card
  (registers, local memory, shared memory, blocks a SM; K1 at every build
  the trees of ``k1_trees`` launch, with its lanes a query, K2 at both
  widths, K3 at ns 64 and fs 4, K4 at ns 64, with the queries a warp of
  K3's and K4's lane groups; null where the version's source has no
  ``fbt_*_attrs`` entry), and its checks: K1 and K2 against their plain
  versions on the batches above (stats on and off), K3 on every level's
  inputs of the ycsb lookup batch and of the rebuilt tree's factor batch,
  K4 on both batches' leaves, as the largest absolute difference, which
  must be 0;
- per turn, in the order a, b, ..., b, a: K1 on the lookup batch, K2 on
  the dirtied and on the clean tree (ycsb, then ``url_``), K3 at each
  level and summed over the levels of the ycsb lookup batch and of the
  rebuilt tree's factor batch (``factor_``), K4 on the leaves of both
  (CUDA events, median of 25, stats off; K3 and K4 also with the L2
  flushed before each run, ``_flushed``), an empty kernel between the
  same events (``empty_kernel_ms``: the floor under every kernel time),
  and ycsb's ``lookup_batch`` and ``range_scan`` end to end (engine
  ``"fused"``, host clock, synchronized, median of 25).

K1 is also timed on the benchmark's trees (``k1_trees``): ycsb-10M and
tpcc-name-10M as ``bench/configs`` give them and ``bench/harness.py``
builds them, each with one scrambled-zipfian batch of 1,048,576 loaded keys
(the benchmark's lookup batch) and its first 65,536; and, at 65,536, url
(the url tree above, S = 3), 1,000,000 integer keys and 1,000,000 URL
keys at ns 128, and 1,000,000 YCSB-like keys zero-padded to 128 and 256
bytes at ns 64 and to 64, 128 and 256 bytes at ns 128 (the S = 2, 4 and
8 builds). Each version is checked on every one of these batches too,
and its K1 builds' attributes and lanes a query are printed.

``--k1`` times K1 alone, on these trees only (no scan trees, no K3 or K4).
``--lanes 2,4,...`` adds a version per G (2 to 16; 2 at ns 64 only): the
checkout's sources with ``lanes_for`` in ``fused_descent.cu`` giving G for
every (ns, S), copied under ``build/k1_lanes/`` (the body of one warp a
query is an older commit's sources, given as ``name=dir``).

Run on a machine with a card, from the checkout's root:
``python3 tools/tree_bench.py [--k1] [--lanes 4,8,16] [name=dir ...]``.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

FILES = {"k1": "fused_descent.cu", "k2": "fused_scan.cu",
         "k3": "feature_branch.cu", "k4": "leaf_probe.cu"}
SEED, YCSB_KEYS, URL_KEYS, BATCH, E_ROUNDS, RUNS = (0, 10_000_000, 1_000_000,
                                                    65_536, 16, 25)
N_INS, MAX_ITEMS = 3449, 50


K1_BATCH = 1_048_576        # the benchmark's lookup batch
K1_WIDE = (("ycsb-10M", 64), ("tpcc-name-10M", 64))
# (key width, ns) of zero-padded YCSB-like keys: the S = 2, 4 and 8 builds
K1_PAD = ((128, 64), (256, 64), (64, 128), (128, 128), (256, 128))
LANES_FN = re.compile(
    r"(constexpr int lanes_for\(int NS, int S\) \{\n  return )[^;]*;")


def lanes_version(g: int) -> Path:
    """The checkout's kernel sources with every K1 build at ``g`` lanes a
    query, under ``build/k1_lanes/g<g>``."""
    from repro_torch.kernels import nvcc
    d = ROOT / "build" / "k1_lanes" / f"g{g}"
    d.mkdir(parents=True, exist_ok=True)
    for f in nvcc.CSRC.iterdir():
        text = f.read_text()
        if f.name == FILES["k1"]:
            text, n = LANES_FN.subn(rf"\g<1>{g};", text)
            assert n == 1, "lanes_for not found"
        (d / f.name).write_text(text)
    return d


def k1_trees(cs, url_tree=None):
    """{name: (tree, [(batch name, qb, ql), ...])}: the trees K1 is timed
    on beside the ycsb batch (see the module's docstring)."""
    from bench import dists, keysets
    from repro_torch.core import fbtree
    from repro_torch.core.keys import KeySet
    out = {}
    zipf = dists.load("scrambled_zipfian")
    for name, ns in K1_WIDE:
        cfg = json.loads((ROOT / "bench" / "configs" / f"{name}.json"
                          ).read_text())
        n = int(cfg["recordcount"])
        kb, kl = keysets.load(cfg["key_set"]).generate(n, SEED, "cuda")
        plan = fbtree.TreeConfig.plan(
            max_keys=int(n * cfg["capacity_factor"]), key_width=kb.shape[1],
            ns=cfg["ns"], fs=cfg["fs"], leaf_fill=cfg["leaf_fill"],
            inner_fill=cfg["inner_fill"])
        tree = fbtree.bulk_build(plan, KeySet(kb.cpu().numpy(),
                                              kl.cpu().numpy()),
                                 np.arange(n, dtype=np.int32), device=True,
                                 target="cuda")
        idx = zipf.draw(np.random.default_rng(SEED + 7), n, (K1_BATCH,),
                        {"theta": 0.99}, "cuda")
        qb, ql = kb[idx].contiguous(), kl[idx].contiguous()
        out[name] = (tree, [("1m", qb, ql), ("64k", qb[:BATCH], ql[:BATCH])])
        del kb, kl
    rng = np.random.default_rng(SEED + 8)

    def small(name, kb, kl, ns):
        n = kb.shape[0]
        plan = fbtree.TreeConfig.plan(max_keys=int(2.5 * n),
                                      key_width=kb.shape[1], ns=ns)
        tree = fbtree.bulk_build(plan, KeySet(kb, kl),
                                 np.arange(n, dtype=np.int32), device=True,
                                 target="cuda")
        idx = torch.from_numpy(cs.zipf_indices(rng, n, BATCH)).cuda()
        a = tree.arrays
        out[name] = (tree, [("64k", a.key_bytes[idx].clone(),
                             a.key_lens[idx].clone())])

    if url_tree is not None:
        tree, (qb, ql) = url_tree
        out["url-1M"] = (tree, [("64k", qb, ql)])
    else:
        small("url-1M", *cs.url_keys(URL_KEYS, SEED), 64)
    small("int-1M-ns128", *cs.int_keys(URL_KEYS, SEED), 128)
    small("url-1M-ns128", *cs.url_keys(URL_KEYS, SEED), 128)
    kb, kl = cs.ycsb_keys(URL_KEYS, SEED)
    for w, ns in K1_PAD:
        pad = np.zeros((kb.shape[0], w), np.uint8)
        pad[:, :kb.shape[1]] = kb
        small(f"ycsb-1M-w{w}" + ("-ns128" if ns == 128 else ""), pad, kl, ns)
    return out


def k1_attrs(k1cuda, trees) -> dict:
    """The K1 build each tree's lookups launch: its attributes and lanes a
    query (32, one warp a query, where the version has no such entry)."""
    from repro_torch.kernels import nvcc
    lib = nvcc.load(k1cuda.SOURCE)
    out = {}
    for name, (tree, _) in trees.items():
        ns, L = tree.config.ns, tree.config.key_width
        row = nvcc.attributes(lib.fbt_fused_descent_attrs, "k1", ns, L, 0, 1, 1)
        row["stripes"] = int(lib.fbt_fused_descent_stripes(L))
        row["lanes_per_query"] = (int(lib.fbt_fused_descent_lanes(ns, L))
                                  if hasattr(lib, "fbt_fused_descent_lanes")
                                  else 32)
        out[name] = row
    return out


def _host_ms(fn, runs: int) -> float:
    ts = []
    for _ in range(runs + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts[3:])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("versions", nargs="*", metavar="name=dir")
    p.add_argument("--unchecked", nargs="*", default=[], metavar="name",
                   help="versions timed but not checked (diagnostic "
                        "versions that are wrong by design)")
    p.add_argument("--k1", action="store_true",
                   help="time K1 alone, on the benchmark's trees")
    p.add_argument("--lanes", default="", metavar="G,G,...",
                   help="add a version of K1 at each G lanes a query")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("tree_bench: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import batch_ops
    from repro_torch.core.branch import level_inputs
    from repro_torch.core.keys import fnv1a_tags
    from repro_torch.core.traverse import TraversalEngine
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.feature_branch import cuda as k3cuda
    from repro_torch.kernels.feature_branch import ops as k3
    from repro_torch.kernels.fused_descent import cuda as k1cuda
    from repro_torch.kernels.fused_descent import ops as k1
    from repro_torch.kernels.fused_scan import cuda as k2cuda
    from repro_torch.kernels.fused_scan import ops as k2
    from repro_torch.kernels.leaf_probe import cuda as k4cuda
    from repro_torch.kernels.leaf_probe import ops as k4

    mods = {"k1": k1cuda, "k2": k2cuda, "k3": k3cuda, "k4": k4cuda}
    versions = dict(v.split("=", 1) for v in args.versions)
    for g in filter(None, args.lanes.split(",")):
        versions[f"g{int(g)}"] = str(lanes_version(int(g)))
    versions = versions or {"checkout": str(nvcc.CSRC)}
    versions = {k: Path(v).resolve() for k, v in versions.items()}
    srcs = [d / f for d in versions.values() for f in FILES.values()]
    t0 = time.perf_counter()
    nvcc.build(srcs)
    print(json.dumps({"card": cs._smi(), "torch": torch.__version__,
                      "build_s": time.perf_counter() - t0}), flush=True)

    def use(d):
        for k, m in mods.items():
            m.SOURCE, m._FN = d / FILES[k], None

    def attrs(kernel, *a):
        lib = nvcc.load(mods[kernel].SOURCE)
        name = f"fbt_{FILES[kernel][:-3]}_attrs"
        if not hasattr(lib, name):
            return None
        out = nvcc.attributes(getattr(lib, name), kernel, *a)
        if kernel in ("k3", "k4"):
            out["queries_per_warp"] = 32 // mods[kernel].lanes_per_query(a[0])
        return out

    use(nvcc.CSRC)
    if args.k1:
        return k1_turns(cs, k1, k1cuda, versions, use, args.unchecked)
    kb, kl = cs.ycsb_keys(YCSB_KEYS, SEED)
    tree, (qb, ql), _ = cs.run_phase("ycsb", kb, kl, ns=64, batch=BATCH,
                                     seed=SEED, device="cuda")
    clean, dirty, _, (sqb, sql, _), inserts, _ = cs.run_ycsb_e(
        tree, kb, kl, seed=SEED, device="cuda", rounds=E_ROUNDS, batch=BATCH,
        max_items=MAX_ITEMS)
    rebuilt, (lkb, lkl, lval), _ = cs.run_rebuild(
        dirty, kb, kl, inserts, seed=SEED, device="cuda", batch=BATCH)
    del kb, kl, inserts
    fqb, fql, _ = cs.factor_batch(lkb, lkl, lval, seed=SEED, device="cuda",
                                  batch=BATCH)
    del lkb, lkl, lval
    L = qb.shape[1]

    def level_work(t, q, n):
        """Every level's K3 inputs and the leaves' K4 inputs of a batch."""
        leaf, path, _ = TraversalEngine("torch").traverse(t, q, n)
        lid = leaf.long()
        return ([level_inputs(lv, nid.long(), q)
                 for lv, nid in zip(t.arrays.levels, path)],
                (t.arrays.leaf_tags[lid], t.arrays.leaf_occ[lid],
                 fnv1a_tags(q, n)))

    k3_inputs, k4_inputs = level_work(tree, qb, ql)
    fk3_inputs, fk4_inputs = level_work(rebuilt, fqb, fql)
    fs = tree.config.fs
    url, (uqb, uql), (uclean, udirty, usqb, usql) = url_trees(cs)
    trees = k1_trees(cs, url_tree=(url, (uqb, uql)))

    for name, d in versions.items():
        use(d)
        if name in args.unchecked:
            print(json.dumps({"version": name, "dir": str(d),
                              "checked": False}), flush=True)
            continue
        err = max(cs.kernel_vs_plain(tree, qb, ql),
                  cs.kernel_vs_plain(dirty, sqb, sql),
                  cs.kernel_vs_plain(url, uqb, uql),
                  cs.kernel_vs_plain(udirty, usqb, usql))
        serr = max(cs.scan_kernel_vs_plain(t, q, n, MAX_ITEMS)
                   for t, q, n in ((clean, sqb, sql), (dirty, sqb, sql),
                                   (uclean, usqb, usql), (udirty, usqb, usql)))
        k3err = max(cs.k3_vs_plain(*inp) for inp in k3_inputs + fk3_inputs)
        k4err = max(cs.k4_vs_plain(*k4_inputs), cs.k4_vs_plain(*fk4_inputs))
        err = max(err, k1_check(cs, trees))
        print(json.dumps({
            "version": name, "dir": str(d),
            "k1_builds": k1_attrs(k1cuda, trees),
            "k2_attrs": attrs("k2", 64, L, 0),
            "url_k2_attrs": attrs("k2", 64, cs.URL_WIDTH, 0),
            "k3_attrs": attrs("k3", 64, fs, 0),
            "k4_attrs": attrs("k4", 64),
            "k1_vs_plain_max_abs_err": err, "k2_vs_plain_max_abs_err": serr,
            "k3_vs_plain_max_abs_err": k3err,
            "k4_vs_plain_max_abs_err": k4err}), flush=True)

    eng = TraversalEngine("fused", collect_stats=False)
    order = list(versions) + list(versions)[::-1]
    for turn, name in enumerate(order):
        use(versions[name])
        kern1 = lambda t, q, n: k1.fused_traverse_probe(t, q, n,
                                                        collect_stats=False)
        scan = lambda t, q, n: k2.fused_range_scan(
            t, q, n, max_items=MAX_ITEMS, collect_stats=False)
        kern3 = lambda inp: k3.feature_branch(*inp, collect_stats=False)
        kern4 = lambda inp: k4.leaf_probe(*inp)
        timed = {"k1_ms": (kern1, tree, qb, ql),
                 "k2_dirty_ms": (scan, dirty, sqb, sql),
                 "k2_clean_ms": (scan, clean, sqb, sql),
                 "url_k1_ms": (kern1, url, uqb, uql),
                 "url_k2_dirty_ms": (scan, udirty, usqb, usql),
                 "url_k2_clean_ms": (scan, uclean, usqb, usql)}
        level = {}
        for pre, k3s, k4s in (("", k3_inputs, k4_inputs),
                              ("factor_", fk3_inputs, fk4_inputs)):
            for lvl, inp in enumerate(k3s):
                level[f"{pre}k3_l{lvl}_ms"] = (kern3, inp)
            level[f"{pre}k4_ms"] = (kern4, k4s)
        for _ in range(3):
            for fn, *a in timed.values():
                fn(*a)
            for fn, inp in level.values():
                fn(inp)
        row = {"turn": turn, "version": name, **k1_times(cs, k1, trees)}
        for key, (fn, *a) in timed.items():
            row[key] = cs._event_ms(lambda: fn(*a), RUNS)[0]
        for key, (fn, inp) in level.items():
            row[key] = cs._event_ms(lambda: fn(inp), RUNS)[0]
            row[key[:-3] + "_flushed_ms"] = cs._event_ms(
                lambda: fn(inp), RUNS, flush=True)[0]
        for pre, k3s in (("", k3_inputs), ("factor_", fk3_inputs)):
            for sfx in ("_ms", "_flushed_ms"):
                row[f"{pre}k3_descent{sfx}"] = sum(
                    row[f"{pre}k3_l{lvl}{sfx}"] for lvl in range(len(k3s)))
        row.update({
            "empty_kernel_ms": cs._event_ms(lambda: torch.cuda._sleep(1),
                                            RUNS)[0],
            "lookup_batch_ms": _host_ms(lambda: batch_ops.lookup_batch(
                tree, qb, ql, engine=eng), RUNS),
            "range_scan_ms": _host_ms(lambda: batch_ops.range_scan(
                dirty, sqb, sql, max_items=MAX_ITEMS, engine=eng), RUNS)})
        print(json.dumps(row), flush=True)
    return 0


def k1_check(cs, trees) -> int:
    """K1 against its plain version on every batch of ``trees``."""
    return max(cs.kernel_vs_plain(tree, qb, ql)
               for tree, batches in trees.values() for _, qb, ql in batches)


def k1_times(cs, k1, trees) -> dict:
    """K1's device time (stats off; CUDA events, median of ``RUNS``) on
    every batch of ``trees``, as ``k1_<tree>_<batch>_ms``."""
    row = {}
    for name, (tree, batches) in trees.items():
        for b, qb, ql in batches:
            fn = lambda: k1.fused_traverse_probe(tree, qb, ql,
                                                 collect_stats=False)
            for _ in range(3):
                fn()
            row[f"k1_{name}_{b}_ms"] = cs._event_ms(fn, RUNS)[0]
    return row


def k1_turns(cs, k1, k1cuda, versions, use, unchecked) -> int:
    """``--k1``: each version's K1 builds and checks on the trees of
    :func:`k1_trees`, then K1's times in turns (a, b, ..., b, a)."""
    trees = k1_trees(cs)
    for name, d in versions.items():
        use(d)
        line = {"version": name, "dir": str(d),
                "k1_builds": k1_attrs(k1cuda, trees)}
        if name not in unchecked:
            line["k1_vs_plain_max_abs_err"] = k1_check(cs, trees)
        print(json.dumps(line), flush=True)
    order = list(versions) + list(versions)[::-1]
    for turn, name in enumerate(order):
        use(versions[name])
        print(json.dumps({"turn": turn, "version": name,
                          **k1_times(cs, k1, trees)}), flush=True)
    return 0


def url_trees(cs):
    """The url tree (built and swept by ``chip_smoke.run_phase``), its
    lookup batch, and the scan trees and batch: the clean tree, the tree
    after ``E_ROUNDS`` rounds of ``N_INS`` fresh URL keys inserted through
    the ``"fused"`` engine, and ``BATCH`` zipf(0.99) starts over every key,
    a third with their last byte flipped (starts between keys)."""
    from repro_torch.core import batch_ops
    from repro_torch.core.traverse import TraversalEngine
    kb, kl = cs.url_keys(URL_KEYS, SEED)
    tree, lookups, _ = cs.run_phase("url", kb, kl, ns=64, batch=BATCH,
                                    seed=SEED, device="cuda")
    need = E_ROUNDS * N_INS
    fresh, fl = cs.url_keys(2 * need, SEED + 5)
    new = ~np.isin(fresh.view(f"S{cs.URL_WIDTH}").ravel(),
                   kb.view(f"S{cs.URL_WIDTH}").ravel())
    fresh, fl = fresh[new][:need], fl[new][:need]
    eng = TraversalEngine("fused")
    dirty = tree
    for r in range(E_ROUNDS):
        sl = slice(r * N_INS, (r + 1) * N_INS)
        dirty, _, _ = batch_ops.insert_batch(
            dirty, fresh[sl], fl[sl],
            np.arange(URL_KEYS + r * N_INS, URL_KEYS + (r + 1) * N_INS,
                      dtype=np.int32), engine=eng)
    a = dirty.arrays
    nl = int(a.leaf_count)
    print(json.dumps({"phase": "url-scan-trees", "inserted": need,
                      "leaves": nl, "dirty_leaf_share": float(
                          (~a.leaf_ordered[:nl]).float().mean())}), flush=True)
    all_kb = np.concatenate([kb, fresh])
    all_kl = np.concatenate([kl, fl])
    rng = np.random.default_rng(SEED + 2)
    idx = cs.zipf_indices(rng, all_kb.shape[0], BATCH)
    qb, ql = all_kb[idx].copy(), all_kl[idx]
    flip = np.nonzero(rng.random(BATCH) < 1 / 3)[0]
    qb[flip, ql[flip] - 1] ^= 0x01
    scans = (tree, dirty, torch.from_numpy(qb).cuda(),
             torch.from_numpy(ql).cuda())
    return tree, lookups, scans

if __name__ == "__main__":
    sys.exit(main())
