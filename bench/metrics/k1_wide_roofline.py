"""``k1_wide_roofline``: K1's builds for keys over 32 bytes (S > 1 key
stripes, ``repro_torch/csrc/fused_descent.cu`` with ``cmp.cuh``'s
``stripes_for``) as a share of their roofline over the traced window: the
least bytes their launches must move, counted by
:func:`k1_roofline.least_bytes` at the configuration's key width, at the
H100 SXM's 3.35 TB/s, over the device time of those launches.

The trace names a launch by its template arguments
(``fbt::fused_descent<64, 2, false, true, true>``: ns, then S), so the
build each launch ran is read from its name. The reading is None where the
trace holds no launch of a wide build, or where the wide launches are not
one a call.
"""
import re

from . import k1_roofline as k1

BUILD = re.compile(k1.KERNEL + r"[^0-9A-Za-z]+(\d+)[^0-9A-Za-z]+(\d+)[^0-9A-Za-z]")


def stripes(name: str):
    """S of the K1 build a device op's name gives, or None for another op."""
    m = BUILD.search(name)
    return int(m.group(2)) if m else None


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    calls, ops = ctx["calls"], ctx["ops"]
    wide = [(e - s) for n, s, e in tr.device_ops if (stripes(n) or 1) > 1]
    t, n = sum(wide) * 1e-9, len(wide)
    # One launch a call, a few of whose records the trace may lose, as
    # k1_roofline reads them; any other count means the path changed.
    if (t <= 0 or not 0.99 * len(calls) <= n <= len(calls)
            or any(o.op not in k1.OUT_BYTES for o in ops)):
        return None
    cfg, ref = ctx["config"], ctx["reference"]
    memo, total = {}, 0
    for j, r, *_ in calls:
        key = (j, r % ops[j].P)
        if key not in memo:
            rank, found = ref.search(ops[j].qb[key[1]], ops[j].ql[key[1]])
            memo[key] = k1.least_bytes(rank, found, ctx["shape"],
                                       cfg["key_width"], cfg["ns"], cfg["fs"],
                                       ops[j].op)
        total += memo[key]
    return 100.0 * total * n / len(calls) / k1.HBM_BYTES_PER_S / t
