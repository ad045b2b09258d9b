"""``k1_roofline``: K1 (``repro_torch/csrc/fused_descent.cu``, the
fused descent and leaf probe) as a share of its roofline over the traced
window: the least bytes its launches must move, at the H100 SXM's 3.35 TB/s
(NVIDIA's data sheet), over K1's device time in the trace.

The count (:func:`least_bytes`) is worked out from the call's queries, the
reference's ranks of them and the bulk load's shape (``bench/geometry.py``);
it reads nothing K1 wrote. For one launch of ``B`` queries of width ``L``:

* the queries read once (``L`` bytes and a 4-byte length each) and the
  answers written once (lookup: a 4-byte value and a found flag; update's
  probe: a 4-byte leaf id, a 4-byte slot and a found flag);
* each distinct inner node on the queries' paths: its key count and the
  child id taken (8 bytes), and, where it has more than one child, its
  prefix length (4), prefix row (``L``) and feature block (``fs * ns``);
* each distinct leaf reached: its tag and occupancy rows (``2 * ns``) and
  its high key and next link (8);
* each distinct key matched: its key id and value (8) and its key row and
  length (``L + 4``).

Anchors read by the searches inside a node are left out, so the count is a
lower bound and the share is one too. Compares are left out: at about 20
dependent loads a query the kernel waits on memory, and bytes bound it.
"""
import torch

HBM_BYTES_PER_S = 3.35e12
KERNEL = "fused_descent"
OUT_BYTES = {"lookup": 4 + 1, "update": 4 + 4 + 1}


def least_bytes(rank, found, shape, L: int, ns: int, fs: int, op: str) -> int:
    """Least bytes of one K1 launch over queries of reference ``rank``
    (first key not below the query) and ``found`` flags."""
    B = rank.shape[0]
    total = B * (L + 4) + B * OUT_BYTES[op]
    leaf = shape.leaf_of(torch.clamp(rank, max=shape.n - 1))
    total += torch.unique(leaf).numel() * (2 * ns + 8)
    for lvl, node in enumerate(shape.path_of(leaf)):
        u = torch.unique(node)
        wide = int((shape.children(lvl, u) > 1).sum())
        total += u.numel() * 8 + wide * (4 + L + fs * ns)
    total += shape.chain * 8
    total += torch.unique(rank[found]).numel() * (8 + L + 4)
    return int(total)


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    calls, ops = ctx["calls"], ctx["ops"]
    t, n = tr.kernel_s(KERNEL), tr.count(KERNEL)
    # K1 is one launch a call. The trace may lose a few launches' records
    # (2 of 4,765 in one 10 s run on an H100); the count is then scaled to
    # the launches it holds. Any other number means the path changed.
    if (t <= 0 or not 0.99 * len(calls) <= n <= len(calls)
            or any(o.op not in OUT_BYTES for o in ops)):
        return None
    # Lookups and updates leave the keys where they were loaded, so the
    # reference after the window ranks every call's queries as it stood.
    cfg, ref = ctx["config"], ctx["reference"]
    memo, total = {}, 0
    for j, r, *_ in calls:
        key = (j, r % ops[j].P)
        if key not in memo:
            rank, found = ref.search(ops[j].qb[key[1]], ops[j].ql[key[1]])
            memo[key] = least_bytes(rank, found, ctx["shape"], ctx["key_width"],
                                    cfg["ns"], cfg["fs"], ops[j].op)
        total += memo[key]
    return 100.0 * total * n / len(calls) / HBM_BYTES_PER_S / t
