"""``k1_wide_roofline`` on a synthetic trace: it reads the wide builds of K1
alone, counts the bytes ``k1_roofline.least_bytes`` counts, and reads
nothing where the trace holds no wide launch or not one a call."""
import pytest
import torch

from bench.geometry import BulkLoad
from bench.keysets import tpcc_customer as tpcc
from bench.metrics import k1_roofline as k1
from bench.metrics import k1_wide_roofline as wide
from bench.reference.index import SortedKeys
from bench.trace import Trace

NARROW = "void fbt::fused_descent<64, 1, false, true, true>(fbt::DescentArgs)"
WIDE = "void fbt::fused_descent<64, 2, false, true, true>(fbt::DescentArgs)"
OTHER = "void at::native::vectorized_elementwise_kernel<4>(int)"
CONFIG = {"key_width": tpcc.WIDTH, "ns": 64, "fs": 4}


class Lookups:
    op, P = "lookup", 2

    def __init__(self, kb, kl):
        g = torch.Generator().manual_seed(3)
        idx = torch.randint(0, kb.shape[0], (self.P, 512), generator=g)
        self.qb, self.ql = kb[idx], kl[idx].clone()
        self.ql[:, ::5] -= 1                  # some absent keys


@pytest.fixture(scope="module")
def ctx():
    kb, kl = tpcc.generate(6000, 0, "cpu")
    ref = SortedKeys(kb, kl, torch.arange(6000))
    calls = [(0, r, 0, 0, 0) for r in range(6)]
    return dict(calls=calls, ops=[Lookups(kb, kl)], reference=ref,
                config=CONFIG, key_width=tpcc.WIDTH,
                shape=BulkLoad(6000, 48, 48, 6))


def trace(names, ns=1000):
    ops = [(n, i * 2 * ns, i * 2 * ns + ns) for i, n in enumerate(names)]
    return Trace(ops, [], (0, 2 * ns * len(names)))


def test_it_reads_the_wide_build_alone(ctx):
    names = [WIDE, OTHER, NARROW] * 6
    got = wide.read({**ctx, "trace": trace(names, ns=1000)})
    o = ctx["ops"][0]
    per_entry = []
    for e in range(o.P):
        rank, found = ctx["reference"].search(o.qb[e], o.ql[e])
        per_entry.append(k1.least_bytes(rank, found, ctx["shape"], tpcc.WIDTH,
                                        64, 4, "lookup"))
    total = sum(per_entry[r % o.P] for _, r, *_ in ctx["calls"])
    want = 100.0 * total / k1.HBM_BYTES_PER_S / (6 * 1000e-9)
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("names", [[NARROW] * 6, [OTHER] * 6, [WIDE] * 3,
                                   [WIDE] * 7, []],
                         ids=["narrow", "none", "too_few", "too_many",
                              "empty"])
def test_it_reads_nothing_without_one_wide_launch_a_call(ctx, names):
    assert wide.read({**ctx, "trace": trace(names)}) is None


def test_no_trace_reads_nothing(ctx):
    assert wide.read(ctx) is None


@pytest.mark.parametrize("name,S", [
    (WIDE, 2), (NARROW, 1), (OTHER, None),
    ("void fbt::fused_descent<128, 8, true, false, true>(fbt::DescentArgs)", 8),
    ("void_fbt::fused_descent_64__3__false__true__true__fbt::DescentAr", 3)])
def test_the_build_is_read_from_the_kernel_name(name, S):
    assert wide.stripes(name) == S
