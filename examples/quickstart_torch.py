"""Quickstart: the FB+-tree core API through the PyTorch/CUDA port
(``repro_torch``), step for step as ``examples/quickstart.py``.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

On the card the lookups, the factor variants and the range scan run the
fused-descent and fused-scan kernels (engine ``"fused"``); the last line
prints their launch counts. On the CPU the same engine runs their plain
versions, with the same answers and counters.
"""
import argparse
import json

import numpy as np
import torch

from repro_torch import shard as S
from repro_torch.core import batch_ops as B
from repro_torch.core import keys as K
from repro_torch.core.baseline import lookup_variant
from repro_torch.core.fbtree import TreeConfig, bulk_build, resolve_target
from repro_torch.core.traverse import TraversalEngine
from repro_torch.kernels.fused_descent import ops as k1
from repro_torch.kernels.fused_scan import ops as k2

ENGINE = TraversalEngine("fused")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = str(resolve_target(args.device))
    rng = np.random.default_rng(0)

    # ---- build a tree over mixed string keys ----------------------------
    keys = [f"user:{i:06d}".encode() for i in range(0, 40_000, 4)]
    ks = K.make_keyset(keys, max_key_len=16)
    cfg = TreeConfig.plan(max_keys=40_000, key_width=16)  # ns=64, fs=4
    tree = bulk_build(cfg, ks, np.arange(len(keys), dtype=np.int32),
                      target=dev)
    print(f"built: {len(keys)} keys, height={cfg.n_levels}, "
          f"leaves={int(tree.arrays.leaf_count)}")

    # ---- batched point lookups ------------------------------------------
    q = K.make_keyset([b"user:000400", b"user:000401", b"user:039996"], 16)
    vals, rep = B.lookup_batch(tree, q.bytes, q.lens, engine=ENGINE)
    print("lookup:", list(zip([bool(f) for f in rep.found],
                              [int(v) for v in vals])))

    # ---- latch-free-style batched update (versions untouched) ------------
    tree, _ = B.update_batch(tree, q.bytes[:1], q.lens[:1],
                             torch.tensor([777], dtype=torch.int32),
                             engine=ENGINE)
    print("after update:", int(B.lookup_batch(
        tree, q.bytes[:1], q.lens[:1], engine=ENGINE)[0][0]))

    # ---- bulk insert with node splits ------------------------------------
    new = K.make_keyset([f"user:{i:06d}".encode()
                         for i in range(1, 4000, 4)], 16)
    tree, repi, rounds = B.insert_batch(tree, new.bytes, new.lens,
                                        np.arange(new.n, dtype=np.int32),
                                        engine=ENGINE)
    print(f"inserted {new.n} keys in {rounds} bulk-split rounds "
          f"({int(repi.splits)} leaf splits)")

    # ---- device build + online rebuild (DESIGN.md §5) ---------------------
    tree_dev = bulk_build(cfg, ks, np.arange(len(keys), dtype=np.int32),
                          device=True, target=dev)  # bit-identical arrays
    rm = K.make_keyset([f"user:{i:06d}".encode()
                        for i in range(0, 20_000, 8)], 16)
    tree_dev, _ = B.remove_batch(tree_dev, rm.bytes, rm.lens, engine=ENGINE)
    tree_dev, rep = B.rebuild(tree_dev)  # compact tombstones device-side
    print(f"rebuild: {int(rep.n_live)} live keys in {int(rep.n_leaves)} "
          f"leaves ({int(rep.reclaimed)} pool rows reclaimed)")

    # ---- ordered range scan -----------------------------------------------
    start = K.make_keyset([b"user:000399"], 16)
    kid, vals, emitted, _ = B.range_scan(tree, start.bytes, start.lens,
                                         max_items=5, engine=ENGINE)
    kb = tree.arrays.key_bytes.cpu().numpy()
    print("scan from user:000399 ->",
          [bytes(kb[i]).rstrip(b"\0").decode()
           for i in kid[0][:5].cpu().numpy()])

    # ---- the paper's counters: feature comparison vs binary search --------
    idx = rng.integers(0, len(keys), size=4096)
    qb, ql = ks.bytes[idx], ks.lens[idx]
    for var in ("base", "feature+hash"):
        _, _, st, _ = lookup_variant(tree, qb, ql, variant=var,
                                     engine=ENGINE)
        print(f"{var:13s} "
              f"key_compares/op={float(st.key_compares.float().mean()):5.2f} "
              f"modeled_lines/op={float(st.lines_touched.float().mean()):5.1f}")

    # ---- shard it (DESIGN.md §7): routed ops, bit-identical results -------
    st = S.sharded_build(ks, np.arange(len(keys), dtype=np.int32),
                         n_shards=4, target=dev)
    svals, srep = S.lookup_batch(st, q.bytes, q.lens, engine=ENGINE)
    print("sharded lookup (owner per query:", srep.owner.tolist(), ") ->",
          list(zip(srep.found.tolist(), svals.tolist())))
    st, rrep = S.rebalance(st)   # skew-recovery barrier: even re-partition
    print("rebalance:", rrep.counts_before, "->", rrep.counts_after)
    print("launches:", json.dumps({"fused_descent": k1.LAUNCHES,
                                   "fused_scan": k2.LAUNCHES}))


if __name__ == "__main__":
    main()
