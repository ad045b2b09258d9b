"""Inputs at the seams of the per-level kernels' lane-group design, and the
wrappers' refusals.

K3 (``csrc/feature_branch.cu``) gives each query a group of lanes, each
holding 32 slots of a row, and gathers the group's 64- or 128-slot masks
by shuffles; K4 (``csrc/leaf_probe.cu``) does the same for a leaf's tags,
16 slots a lane.
A wrong shift or lane shows only at the 32- and 64-slot boundaries, a
wrong early exit only in runs that survive to the last round.
:func:`k3_edge_inputs` and :func:`k4_edge_inputs` put the work there:
``tests/test_torch_level_kernels.py`` holds the port's CPU path against
the JAX package on them, ``tests/test_torch_cuda.py`` the kernels against
their plain versions on a card (and the planted faults of ``K3_MUTANTS``
and ``K4_MUTANTS``). The tests here hold the generators to what they
promise and the wrappers' input checks, which run on CPU tensors. The
module imports no JAX, so the card's tests can import it.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.feature_branch import cuda as k3cuda
from repro_torch.kernels.feature_branch.ref import feature_compare_rounds
from repro_torch.kernels.leaf_probe import cuda as k4cuda
from repro_torch.kernels.leaf_probe.ref import leaf_probe_ref

# node sizes around the 32- and 64-slot words, and the trivial nodes
K3_KNUMS = (0, 1, 2, 31, 32, 33, 63, 64, 65, 127, 128)
# equal runs that start or end at a word boundary
K3_RUNS = ((0, 32), (31, 33), (32, 64), (30, 65), (63, 65), (64, 128),
           (33, 63), (0, 128))
# bytes on both sides of the sign bit: an unsigned compare done signed
# orders 0x80-0xff below 0x00-0x7f
K3_BYTES = np.array([0x00, 0x01, 0x7F, 0x80, 0xFE, 0xFF], np.uint8)
K4_SLOTS = (0, 31, 32, 63, 64, 127)     # lone candidates
K4_PAIRS = ((31, 32), (63, 64), (0, 127), (32, 127), (64, 65))
K3_SHAPES = tuple((fs, ns) for fs in (1, 2, 4, 8, 12) for ns in (64, 128))


def k3_edge_inputs(seed: int, B: int, fs: int, ns: int):
    """``(feats [B, fs, ns] u8, qfeat [B, fs] u8, knum [B], pcmp [B])``.

    A quarter each: random sorted rows over the 6 bytes of ``K3_BYTES``
    (runs survive a few rounds); every anchor equal to the query's byte in every row but
    the last, where the equal run is one of ``K3_RUNS`` (the run survives
    to the last round, and resolves there when it misses the node); the
    same run in row 0 and random rows after it; every anchor equal in
    every row (unresolved after fs rounds). knum cycles through
    ``K3_KNUMS`` (those <= ns), pcmp is 0 but for every seventh query."""
    rng = np.random.default_rng(seed)
    feats = np.sort(rng.choice(K3_BYTES, size=(B, fs, ns)), -1)
    qfeat = rng.choice(K3_BYTES, size=(B, fs))
    part = np.arange(B) * 4 // B
    slot = np.arange(ns)
    for b in np.nonzero(part > 0)[0]:
        lo, hi = K3_RUNS[b % len(K3_RUNS)]
        run = (slot >= lo) & (slot < min(hi, ns))
        row_of_run = fs - 1 if part[b] == 1 else 0
        qfeat[b, row_of_run] = q = K3_BYTES[1 + b % 4]
        if part[b] in (1, 3):
            feats[b] = qfeat[b][:, None]
        if part[b] in (1, 2):
            feats[b, row_of_run] = np.where(slot < lo, q - 1,
                                            np.where(run, q, q + 1))
    knums = np.array([k for k in K3_KNUMS if k <= ns], np.int32)
    knum = knums[np.arange(B) % knums.size]
    pcmp = np.zeros(B, np.int32)
    pcmp[::7] = rng.choice(np.array([-1, 1], np.int32), size=pcmp[::7].size)
    return feats, qfeat, knum, pcmp


def k4_edge_inputs(seed: int, B: int, ns: int):
    """``(tags [B, ns] u8, occ [B, ns] bool, qtag [B] u8)``: random rows
    over 3 tag values, then rows whose only candidate is one of
    ``K4_SLOTS`` (< ns), rows with the two of a ``K4_PAIRS`` pair, rows of
    matching tags none of them occupied, and rows with every slot a
    candidate."""
    rng = np.random.default_rng(seed)
    tags = rng.integers(0, 3, size=(B, ns), dtype=np.uint8)
    occ = rng.random((B, ns)) < 0.6
    qtag = rng.integers(0, 4, size=B, dtype=np.uint8)
    picks = ([(s,) for s in K4_SLOTS if s < ns]
             + [p for p in K4_PAIRS if p[1] < ns])
    for i, b in enumerate(range(0, B, 3)):
        kind = i % (len(picks) + 2)
        tags[b] = qtag[b] + 1
        occ[b] = kind != len(picks)              # occupied, no tag match
        if kind == len(picks) + 1:               # matching, none occupied
            tags[b] = qtag[b]
        elif kind < len(picks):
            occ[b] = rng.random(ns) < 0.5
            tags[b, list(picks[kind])] = qtag[b]
            occ[b, list(picks[kind])] = True
    tags[1] = qtag[1]
    occ[1] = True                                # every slot a candidate
    return tags, occ, qtag


@pytest.mark.parametrize("fs,ns", K3_SHAPES)
def test_k3_edge_inputs_reach_the_seams(fs, ns):
    """On the plain version: queries take every round, some stay
    unresolved after the last, some resolve at it, and the runs end on
    both sides of the 32- and 64-slot boundaries."""
    B = 301
    inp = [torch.from_numpy(x) for x in k3_edge_inputs(fs * ns, B, fs, ns)]
    idx, resolved, lo, hi, rounds = feature_compare_rounds(
        *inp, collect_stats=True)
    took_all = rounds == fs
    assert bool((took_all & ~resolved).any())
    live = (inp[2] > 1) & (inp[3] == 0)
    assert bool((took_all & resolved & live).any())
    ends = set(hi[~resolved].tolist()) | set(lo[~resolved].tolist())
    assert {31, 32} <= ends or ns == 64 and 31 in ends
    assert 63 in ends or 64 in ends
    if ns == 128:
        assert {63, 64} <= ends


@pytest.mark.parametrize("ns", (64, 128))
def test_k4_edge_inputs_reach_the_seams(ns):
    B = 200
    tags, occ, qtag = (torch.from_numpy(x) for x in k4_edge_inputs(ns, B, ns))
    cand, first, count = leaf_probe_ref(tags, occ, qtag)
    want = {s for s in K4_SLOTS if s < ns}
    alone = first[count == 1].tolist()
    assert want <= set(alone)
    assert ns in first.tolist() and int(count.max()) == ns
    paired = {tuple(np.nonzero(c.numpy())[0]) for c in cand[count == 2]}
    assert {p for p in K4_PAIRS if p[1] < ns} <= paired


def _k3_tensors(B=8, fs=4, ns=64):
    return (torch.zeros((B, fs, ns), dtype=torch.uint8),
            torch.zeros((B, fs), dtype=torch.uint8),
            torch.ones(B, dtype=torch.int32), torch.zeros(B, dtype=torch.int32))


def _unaligned(shape, dtype, offset):
    """A contiguous view of ``shape`` starting ``offset`` bytes into a
    fresh buffer."""
    n = int(np.prod(shape))
    buf = torch.zeros(n + 64, dtype=torch.uint8)
    base = (-buf.data_ptr()) % 64                # a 64-byte aligned start
    return buf[base + offset:base + offset + n].view(dtype).view(shape)


def test_k3_check_inputs_takes_aligned_views():
    feats, qfeat, knum, pcmp = _k3_tensors()
    k3cuda.check_inputs(feats, qfeat, knum, pcmp)
    k3cuda.check_inputs(_unaligned((8, 4, 64), torch.uint8, 16), qfeat, knum,
                        pcmp)
    k3cuda.check_inputs(feats[:0], qfeat[:0], knum[:0], pcmp[:0])


@pytest.mark.parametrize("offset", (1, 8))
def test_k3_check_inputs_refuses_unaligned_feats(offset):
    _, qfeat, knum, pcmp = _k3_tensors()
    feats = _unaligned((8, 4, 64), torch.uint8, offset)
    assert feats.is_contiguous() and feats.data_ptr() % 16 == offset
    with pytest.raises(ValueError, match="aligned"):
        k3cuda.check_inputs(feats, qfeat, knum, pcmp)


@pytest.mark.parametrize("case", ("knum_dtype", "qfeat_shape", "ns",
                                  "not_contiguous", "feats_dim"))
def test_k3_check_inputs_refuses(case):
    feats, qfeat, knum, pcmp = _k3_tensors()
    args = {"knum_dtype": (feats, qfeat, knum.long(), pcmp),
            "qfeat_shape": (feats, qfeat[:, :3].contiguous(), knum, pcmp),
            "ns": (feats[..., :32].contiguous(), qfeat, knum, pcmp),
            "not_contiguous": (feats.transpose(1, 2).contiguous()
                               .transpose(1, 2), qfeat, knum, pcmp),
            "feats_dim": (feats[0], qfeat, knum, pcmp)}[case]
    err = TypeError if case == "knum_dtype" else ValueError
    with pytest.raises(err):
        k3cuda.check_inputs(*args)


def test_k4_check_inputs_takes_aligned_views():
    tags = torch.zeros((8, 128), dtype=torch.uint8)
    occ = torch.zeros((8, 128), dtype=torch.bool)
    qtag = torch.zeros(8, dtype=torch.uint8)
    k4cuda.check_inputs(tags, occ, qtag)
    k4cuda.check_inputs(_unaligned((8, 128), torch.uint8, 32),
                        _unaligned((8, 128), torch.bool, 48), qtag)
    k4cuda.check_inputs(tags[:0], occ[:0], qtag[:0])


@pytest.mark.parametrize("which", ("tags", "occ"))
@pytest.mark.parametrize("offset", (1, 4))
def test_k4_check_inputs_refuses_unaligned(which, offset):
    tags = torch.zeros((8, 64), dtype=torch.uint8)
    occ = torch.zeros((8, 64), dtype=torch.bool)
    qtag = torch.zeros(8, dtype=torch.uint8)
    if which == "tags":
        tags = _unaligned((8, 64), torch.uint8, offset)
    else:
        occ = _unaligned((8, 64), torch.bool, offset)
    with pytest.raises(ValueError, match="aligned"):
        k4cuda.check_inputs(tags, occ, qtag)


@pytest.mark.parametrize("case", ("occ_dtype", "qtag_shape", "ns",
                                  "not_contiguous"))
def test_k4_check_inputs_refuses(case):
    tags = torch.zeros((8, 64), dtype=torch.uint8)
    occ = torch.zeros((8, 64), dtype=torch.bool)
    qtag = torch.zeros(8, dtype=torch.uint8)
    args = {"occ_dtype": (tags, occ.to(torch.uint8), qtag),
            "qtag_shape": (tags, occ, qtag[:7]),
            "ns": (tags[:, :32].contiguous(), occ[:, :32].contiguous(), qtag),
            "not_contiguous": (torch.zeros((64, 64), dtype=torch.uint8)
                               .t()[:8], occ, qtag)}[case]
    err = TypeError if case == "occ_dtype" else ValueError
    with pytest.raises(err):
        k4cuda.check_inputs(*args)
