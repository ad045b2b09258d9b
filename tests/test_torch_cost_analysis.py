"""The dry run's counter (``repro_torch.launch.cost_analysis``) against
hand counts and against the reference's ``hlo_analysis`` (its roofline
with the reference's constants; its per-op rules' twins), and K5's custom
op: its fake and its FLOP formula.

Fake-group runs start a Python process of ``tests/torch_gloo.py`` under
its own timeout: a default process group left in a test worker would
break later tests."""
import os
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.launch import hlo_analysis as H
from repro_torch.kernels.flash_attention import ops as K5
from repro_torch.kernels.flash_attention.ref import key_mask
from repro_torch.launch import cost_analysis as CA
from repro_torch.models.attention import MaskSpec

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_gloo  # noqa: E402


# ------------------------------------------------------------------ roofline
@pytest.mark.parametrize("terms", [
    (2.17e14, 1.3e13, 3.9e11, 5.56e16, 256),     # collective-bound
    (3.4e14, 1.0e11, 1.0e9, 5.56e16, 256),       # compute-bound
    (1.0e9, 8.9e11, 1.0e6, 2.3e12, 512),         # memory-bound
    (0.0, 0.0, 0.0, 0.0, 4),                     # nothing counted
])
def test_roofline_with_reference_constants_equals_reference(terms):
    got = CA.roofline(*terms, peak_flops=H.PEAK_FLOPS, hbm_bw=H.HBM_BW,
                      net_bw=H.ICI_BW)
    assert got == H.roofline(*terms)


def test_roofline_takes_the_h100_datasheet_rates():
    r = CA.roofline(989.4e12, 3.35e12, 50e9, 989.4e12 * 256, 256)
    assert r["compute_s"] == r["memory_s"] == r["collective_s"] == 1.0
    assert r["useful_flop_ratio"] == 1.0 and r["mfu_bound"] == 1.0
    assert (CA.PEAK_FLOPS, CA.HBM_BW, CA.NET_BW) == (989.4e12, 3.35e12,
                                                     50e9)


# ------------------------------------------------------- plain-tensor counts
def test_plain_matmul_flops_exact():
    a, b = torch.randn(64, 32), torch.randn(32, 48)
    with CA.CostCounter() as c:
        a @ b
    assert c.flops == 2 * 64 * 32 * 48
    assert c.traffic == 4 * (64 * 32 + 32 * 48 + 64 * 48)
    x, w = torch.randn(3, 8, 16), torch.randn(3, 16, 4)
    with CA.CostCounter() as c:
        torch.bmm(x, w)
        torch.einsum("bsd,bdf->bsf", x, w)
    assert c.flops == 2 * (2 * 3 * 8 * 16 * 4)


def test_traffic_counts_slices_not_buffers():
    big = torch.randn(1024, 64)
    with CA.CostCounter() as c:
        big[:8] * 2.0            # a view moves nothing; the product 2 x 8 rows
        big[:, :4].t()           # views only
    assert c.traffic == 2 * 8 * 64 * 4
    assert c.flops == 0


def test_count_ops_and_live_bytes():
    a = torch.randn(16, 16)
    with CA.CostCounter(a) as c:
        b = a @ a
        d = b @ a
        e = d + b                # b, d and e alive at once
        del b, d
        f = e * 2.0              # e and f: fewer than the peak
    assert CA.count_ops(c, ("mm", "add", "all-gather")) == {
        "mm": 2, "add": 1, "all-gather": 0}
    mem = c.memory(f)
    nb = 16 * 16 * 4
    assert mem["argument_size_in_bytes"] == nb
    assert mem["temp_size_in_bytes"] == 3 * nb
    assert c.live_bytes == 2 * nb
    assert mem["output_size_in_bytes"] == nb
    assert mem["alias_size_in_bytes"] == 0


def test_flops_of_is_the_counter_the_card_check_reads():
    a, b = torch.randn(8, 4), torch.randn(4, 2)
    fl, out = CA.flops_of(torch.matmul, a, b)
    assert fl == 2 * 8 * 4 * 2 and out.shape == (8, 2)


# --------------------------------------------------------------- DTensors
@pytest.fixture(scope="module")
def fake_counts():
    return torch_gloo.run_ranks("fake_counts", 16, timeout=240,
                                n_procs=1)[0]


def test_sharded_matmul_flops_exact_per_device(fake_counts):
    M, K, N = 64, 32, 48
    both = fake_counts["both"]
    # [M/4, K] @ [K, N/4] on every one of 16 ranks
    assert both["placements"] == ["S(0)", "S(1)"]
    assert both["flops"] == 2 * M * K * N / 16
    assert both["traffic"] == 4 * (M // 4 * K + K * N // 4 + M // 4 * N // 4)
    part = fake_counts["partial"]
    # the contraction split over "model": a partial sum, the work / 16
    assert part["placements"] == ["S(0)", "P(sum)"]
    assert part["flops"] == 2 * M * K * N / 16
    assert part["traffic"] == 4 * (M // 4 * K // 4 + K // 4 * N
                                   + M // 4 * N)
    rep = fake_counts["replicated"]
    # every rank does all the work
    assert rep["flops"] == 2 * M * K * N
    assert all(v["colls"] == {} for v in (both, part, rep))


def test_redistribute_counts_one_all_gather(fake_counts):
    g = fake_counts["gather"]["all-gather"]
    nb = 16 * 48 * 4             # the result's local shard: [M/4, N]
    assert g == {"count": 1.0, "bytes": nb, "wire_bytes": nb * 3 / 4}


def test_traffic_of_a_slice_of_a_dtensor(fake_counts):
    assert fake_counts["slice"] == {"traffic": 2 * 8 * 64 * 4, "flops": 0.0}


def test_an_op_dtensor_cannot_place_raises_with_its_name(fake_counts):
    """``Reshard`` replicates nothing behind DTensor's back: an op without
    a sharding strategy raises, and the dry run's error names it."""
    assert "aten.searchsorted" in fake_counts["unplaceable"]


def test_an_unresolved_collective_group_raises(fake_counts):
    """The ring factor needs the group's size: no size is assumed."""
    assert "no-such-group" in fake_counts["unresolved_group"]


# ----------------------------------------------------------------------- K5
MASKS = [(7, 7, "causal", 0, 0), (7, 9, "causal", 3, 2),
         (9, 7, "causal", 0, 5), (5, 5, "full", 0, 0),
         (16, 16, "causal", 4, 6), (12, 8, "causal", 0, 0),
         (64, 64, "causal", 16, 0)]


@pytest.mark.parametrize("S,T,kind,window,prefix", MASKS)
def test_visible_pairs_count_the_mask(S, T, kind, window, prefix):
    causal = kind == "causal"
    want = int(key_mask(S, T, causal, window, prefix, "cpu").sum())
    assert K5.visible_pairs(S, T, causal, window, prefix) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_fake_gives_shape_and_dtype_and_launches_nothing(dtype):
    from torch._subclasses.fake_tensor import FakeTensorMode
    before = K5.LAUNCHES
    with FakeTensorMode():
        q = torch.empty(2, 40, 8, 192, dtype=dtype)
        k = torch.empty(2, 40, 2, 192, dtype=dtype)
        v = torch.empty(2, 40, 2, 128, dtype=dtype)
        out = K5.flash_sdpa(q, k, v, MaskSpec("causal", 8, 4), 4, 0.1)
    assert out.shape == (2, 40, 8 * 128) and out.dtype == dtype
    assert K5.LAUNCHES == before


@pytest.mark.parametrize("S,T,kind,window,prefix", MASKS[:4])
def test_k5_flop_formula_counts_what_the_kernel_computes(S, T, kind, window,
                                                         prefix):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, S, 4, 16, generator=g)
    k = torch.randn(2, T, 2, 16, generator=g)
    v = torch.randn(2, T, 2, 8, generator=g)
    mask = MaskSpec(kind, window, prefix)
    pairs = int(key_mask(S, T, kind == "causal", window, prefix,
                         "cpu").sum())
    want = 2 * 2 * 4 * (16 + 8) * pairs
    with FlopCounterMode(display=False) as fc:
        K5.flash_sdpa(q, k, v, mask, 2, 0.25)
    assert fc.get_total_flops() == want
    with CA.CostCounter() as c:
        out = K5.flash_sdpa(q, k, v, mask, 2, 0.25)
    assert c.flops == want
    assert CA.count_ops(c, ("flash_fwd",)) == {"flash_fwd": 1}
    # the op runs the plain version on the CPU, unchanged
    from repro_torch.kernels.flash_attention.ref import flash_sdpa_ref
    assert torch.equal(out, flash_sdpa_ref(q, k, v, mask, 2, 0.25))


def test_k5_full_attention_formula_is_4bhsthd():
    assert K5.flop_count((2, 128, 8, 64), (2, 256, 8, 64), (2, 256, 8, 64),
                         1, 0.1, False, 0, 0) == 4 * 2 * 8 * 128 * 256 * 64
