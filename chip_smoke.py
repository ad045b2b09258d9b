#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Drives the port's batched point lookup — ``core.batch_ops.lookup_batch``
with ``TraversalEngine("fused")``, which launches the fused whole-descent
CUDA kernel once per batch — on an index of the size its users run:

1. the card's name and power limit;
2. build of every CUDA kernel from ``src/repro_torch/csrc`` (``nvcc``,
   sm_90a) into ``build/kernels/``;
3. YCSB-like keys (``user`` + 19 digits, width 24), 10,000,000 of them,
   planned as ``benchmarks/common.py::build_tree`` plans (``max_keys =
   2.5 n``: ns=64, fs=4, 6 levels): every key is looked up once in batches
   of 65,536, 10% of each batch with its last byte flipped; every present
   key must be found with its value, and the kernel must equal the plain
   torch version on the card bit for bit (leaf, path, found, slot, val and
   all six counters; stats on and off, sibling check on and off);
4. URL keys (width 72, heavy shared prefixes), 1,000,000, the same checks,
   plus a tree whose parents are stale (blink sibling hops);
5. ns=128 with 1,000,000 integer keys (width 8), the same checks, plus
   stale parents that need two sibling hops;
6. timing of the main phase's batch with CUDA events: the kernel, the plain
   torch version, end-to-end ``lookup_batch``, and the kernel's bound.

Each phase prints one JSON line. The line before the last holds the
kernels table; the last line is ``{"ok": true, "device": ...}``. The script
exits non-zero, with no result, when there is no CUDA device or when the
port's sources are not beside it. Run: ``python3 chip_smoke.py``.
"""
from __future__ import annotations

import argparse
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

def ycsb_keys(n: int, seed: int):
    """``user`` + a zero-padded 19-digit number below 10**18, width 24."""
    rng = np.random.default_rng(seed)
    nums = np.zeros(0, np.int64)
    while nums.size < n:
        nums = np.unique(np.concatenate(
            [nums, rng.integers(0, 10**18, size=n - nums.size + 1024)]))
    nums = nums[:n]
    kb = np.zeros((n, 24), np.uint8)
    kb[:, :4] = np.frombuffer(b"user", np.uint8)
    for i in range(19):
        kb[:, 4 + i] = (nums // 10**(18 - i)) % 10 + ord("0")
    return kb, np.full(n, 23, np.int32)


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
                for name in dk:
                    a, b = dk[name], dp[name]
                    if a.shape != b.shape or a.dtype != b.dtype:
                        raise AssertionError(
                            f"{name}: kernel {a.dtype}{tuple(a.shape)} vs "
                            f"plain {b.dtype}{tuple(b.shape)}")
                    diff = int((a.long() - b.long()).abs().max()) if a.numel() else 0
                    worst = max(worst, diff)
                    if diff:
                        raise AssertionError(
                            f"kernel != plain on {name} (probe={probe}, "
                            f"stats={stats}, sibling={sib}): max |diff| {diff}")
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
    args = p.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels.fused_descent import cuda, ops

    smi = _smi()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi}", flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "torch_name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    lib = cuda.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(str(lib), ROOT)})
    if cuda.BUILD_LOG:
        print(cuda.BUILD_LOG.strip(), flush=True)

    dev = "cuda"
    kb, kl = ycsb_keys(args.ycsb_keys, args.seed)
    tree, (qb, ql), main_out = run_phase("ycsb", kb, kl, ns=64,
                                         batch=args.batch, seed=args.seed,
                                         device=dev)
    launches = main_out["launches"]
    del kb, kl
    kb, kl = url_keys(args.url_keys, args.seed)
    run_phase("url", kb, kl, ns=64, batch=args.batch, seed=args.seed,
              device=dev, stale="single")
    kb, kl = int_keys(args.int_keys, args.seed)
    run_phase("int-ns128", kb, kl, ns=128, batch=args.batch, seed=args.seed,
              device=dev, stale="double")

    t = timing(tree, qb, ql, args.runs)
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "fused_descent", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_descent.cu",
        "replaces": "src/repro/kernels/fused_descent/kernel.py:299",
        "launches": launches, "max_abs_err": main_out["kernel_vs_plain_max_abs_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
