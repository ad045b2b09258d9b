"""Mini YCSB session against the FB+-tree through the PyTorch/CUDA port
(``repro_torch``), step for step as ``examples/ycsb_demo.py``, plus the
serving-side view: the prefix cache under a skewed "system prompt"
workload.

  PYTHONPATH=src python examples/ycsb_demo_torch.py [--device cpu]

The url dataset, the tree plan and the zipf draw are copies of
``benchmarks/common.py``'s ``make_dataset``, ``build_tree`` and
``zipf_indices`` (that module imports JAX), so the same seeds give the
same keys and queries. On the card the lookups and the cache's tree ops
run the fused-descent and fused-scan kernels (engine ``"fused"``); the
last line prints their launch counts.
"""
import argparse
import json

import numpy as np
import torch

from repro_torch.core import batch_ops as B
from repro_torch.core import keys as K
from repro_torch.core.baseline import lookup_variant
from repro_torch.core.fbtree import TreeConfig, bulk_build, resolve_target
from repro_torch.core.traverse import TraversalEngine
from repro_torch.kernels.fused_descent import ops as k1
from repro_torch.kernels.fused_scan import ops as k2
from repro_torch.serving import PrefixCache

ENGINE = TraversalEngine("fused")

SYLL = ["an", "ber", "co", "del", "er", "fo", "gra", "hu", "in", "jo",
        "ka", "lo", "mi", "nor", "ol", "pe", "qua", "ro", "sa", "tu"]
HOSTS = ["http://dbpedia.org/resource/", "http://example.com/a/b/",
         "https://api.service.io/v2/items/", "http://news.site.net/2024/"]


def _word(rng, lo=2, hi=4):
    return "".join(rng.choice(SYLL) for _ in range(rng.integers(lo, hi + 1)))


def make_dataset(name: str, n: int, seed: int = 7):
    """-> (keys, key_width): ``benchmarks/common.py``'s ``"url"`` set
    (~70 B keys with heavy shared prefixes), draw for draw."""
    if name != "url":
        raise KeyError(name)
    rng = np.random.default_rng(seed)
    out = set()
    while len(out) < n:
        h = HOSTS[int(rng.zipf(1.2)) % len(HOSTS)]
        tail = f"{_word(rng)}/{_word(rng)}_{rng.integers(0, 10**9)}"
        out.add((h + tail).encode()[:72])
    return sorted(out)[:n], 72


def build_tree(keys, width, target, fs: int = 4, ns: int = 64):
    ks = K.make_keyset(keys, width)
    cfg = TreeConfig.plan(max_keys=int(len(keys) * 2.5), key_width=width,
                          fs=fs, ns=ns)
    vals = np.arange(len(keys), dtype=np.int32)
    return bulk_build(cfg, ks, vals, target=target), ks


def zipf_indices(rng, n_keys: int, n_ops: int, theta: float) -> np.ndarray:
    """Zipfian (skew=theta) request indices over n_keys (YCSB default
    .99)."""
    if theta <= 0.01:
        return rng.integers(0, n_keys, size=n_ops)
    ranks = np.arange(1, n_keys + 1, dtype=np.float64)
    w = ranks ** (-theta)
    cdf = np.cumsum(w) / w.sum()
    u = rng.random(n_ops)
    idx = np.searchsorted(cdf, u)
    perm = rng.permutation(n_keys)    # decorrelate rank from key order
    return perm[np.clip(idx, 0, n_keys - 1)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = str(resolve_target(args.device))
    rng = np.random.default_rng(1)

    print("== YCSB-C / A on the url dataset (heavy prefix skew) ==")
    keys, width = make_dataset("url", 10_000)
    tree, ks = build_tree(keys, width, dev)
    idx = zipf_indices(rng, len(keys), 8192, 0.99)
    qb = torch.from_numpy(ks.bytes[idx]).to(dev)
    ql = torch.from_numpy(ks.lens[idx]).to(dev)
    for var in ("base", "feature", "feature+hash"):
        f, v, st, ls = lookup_variant(tree, qb, ql, variant=var,
                                      engine=ENGINE)
        print(f"  {var:13s} found={bool(f.all())} "
              f"keycmp/op={float(st.key_compares.float().mean()):5.2f} "
              f"lines/op={float(st.lines_touched.float().mean()):5.1f} "
              f"suffix_bs/op={float(st.suffix_bs.float().mean()):.3f}")
    tree, rep = B.update_batch(tree, qb[:4096], ql[:4096],
                               torch.arange(4096, dtype=torch.int32),
                               engine=ENGINE)
    print(f"  YCSB-A updates: batch=4096, in-batch dup ops superseded="
          f"{int(rep.conflicts)} (latch-free last-writer-wins)")

    print("\n== prefix cache: shared system prompts ==")
    pc = PrefixCache(n_pages=512, block_tokens=16,
                     engine=TraversalEngine("fused", collect_stats=False),
                     target=dev)
    system_prompts = [rng.integers(0, 30_000, size=64).astype(np.int32)
                      for _ in range(3)]
    for wave in range(4):
        reqs = []
        for _ in range(8):
            sp = system_prompts[int(rng.zipf(1.5)) % 3]
            reqs.append(np.concatenate(
                [sp, rng.integers(0, 30_000, 48)]).astype(np.int32))
        hits, pages = pc.match(reqs)
        for r, h in zip(reqs, hits):
            pc.publish(r, h)
        print(f"  wave {wave}: hit blocks per request = {hits} "
              f"(prefix hit rate so far {pc.hit_rate():.2f})")
    print("  tree stats:", pc.stats)
    print("launches:", json.dumps({"fused_descent": k1.LAUNCHES,
                                   "fused_scan": k2.LAUNCHES}))


if __name__ == "__main__":
    main()
