"""The write path's dedupe wrapper (``kernels/dedupe``) on the CPU: it runs
the plain version there (``batch_ops.dedupe_last_wins`` in lane order),
the kernel binding refuses what the kernel does not take, and every write
op (update, remove, insert) dedupes through the wrapper and drains its
probe steps into ``op.dedupe_probes``. The kernel itself is held against
the plain version on the card in ``tests/test_torch_cuda.py``. Imports no
JAX."""
import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import batch_ops as B
from repro_torch.core import keys as K
from repro_torch.core.fbtree import TreeConfig, bulk_build
from repro_torch.kernels.dedupe import cuda, ops

from chip_smoke import dedupe_cases

CASES = dedupe_cases(seed=5, lanes=4096)


@pytest.fixture(autouse=True)
def _obs_isolation():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def _last_lanes(qb, ql):
    """Winners by a dict: the last lane of each (bytes, length)."""
    last = {(r.tobytes(), int(n)): i for i, (r, n) in enumerate(zip(qb, ql))}
    win = np.zeros(len(ql), bool)
    win[list(last.values())] = True
    return win


@pytest.mark.parametrize("name", sorted(CASES))
def test_wrapper_on_the_cpu_is_the_plain_version(name):
    qb, ql = (torch.from_numpy(a) for a in CASES[name])
    assert qb.shape[0] == ql.shape[0] >= 1
    winners, conflicts, probes = ops.dedupe_last_lanes(qb, ql,
                                                       count_probes=True)
    want_w, want_c = B.dedupe_last_wins(
        qb, ql, torch.arange(qb.shape[0], dtype=torch.int32))
    assert probes is None
    assert winners.dtype == torch.bool and conflicts.dtype == torch.int32
    assert torch.equal(winners, want_w) and torch.equal(conflicts, want_c)
    assert np.array_equal(winners.numpy(), _last_lanes(*CASES[name]))
    assert int(conflicts) == qb.shape[0] - int(winners.sum())


def test_cases_cover_each_load_width_and_the_skew():
    assert {cuda.word_bytes(torch.from_numpy(CASES[n][0])) for n in
            ("width21", "width28", "zipf", "width32")} == {1, 8}
    qb, ql = CASES["length_only"]
    rows = {r.tobytes() for r in qb}
    assert len({(r.tobytes(), int(n)) for r, n in zip(qb, ql)}) == 3 * len(rows)
    _, counts = np.unique(CASES["zipf"][0], axis=0, return_counts=True)
    assert counts.max() > 0.02 * len(CASES["zipf"][1])      # a hot key


def test_table_capacity_and_load_width():
    assert [cuda.table_capacity(b) for b in (1, 2, 3, 4, 5, 4_194_304)] == [
        4, 4, 8, 8, 16, 8_388_608]
    for b in range(1, 300):
        cap = cuda.table_capacity(b)
        assert cap >= 2 * b and cap & (cap - 1) == 0 and (cap < 8 or cap < 4 * b)
    buf = torch.zeros(64 * 33, dtype=torch.uint8)
    assert cuda.word_bytes(buf[:64 * 32].view(64, 32)) == 8
    assert cuda.word_bytes(buf[8:8 + 64 * 32].view(64, 32)) == 8
    assert cuda.word_bytes(buf[:64 * 28].view(64, 28)) == 1
    assert cuda.word_bytes(buf[4:4 + 64 * 24].view(64, 24)) == 1
    assert cuda.word_bytes(buf[1:1 + 64 * 24].view(64, 24)) == 1


def _bad_inputs():
    qb = torch.zeros((8, 24), dtype=torch.uint8)
    ql = torch.full((8,), 23, dtype=torch.int32)
    return {
        "qb_1d": (qb[0], ql, None, ValueError),
        "qb_width_0": (qb[:, :0], ql, None, ValueError),
        "qb_dtype": (qb.to(torch.int32), ql, None, TypeError),
        "ql_dtype": (qb, ql.long(), None, TypeError),
        "ql_shape": (qb, ql[:7], None, ValueError),
        "qb_not_contiguous": (qb[:, ::2], ql, None, ValueError),
        "capacity_below_b": (qb, ql, 4, ValueError),
        "capacity_not_pow2": (qb, ql, 12, ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_binding_refuses_what_the_kernel_does_not_take(case):
    qb, ql, cap, err = _bad_inputs()[case]
    with pytest.raises(err):
        cuda.check_inputs(qb, ql, cap)
    with pytest.raises(ValueError):          # and no CPU tensor is launched
        cuda.launch(qb, ql, capacity=cap)


def test_binding_takes_a_full_power_of_two_table():
    qb = torch.zeros((8, 24), dtype=torch.uint8)
    ql = torch.full((8,), 23, dtype=torch.int32)
    cuda.check_inputs(qb, ql, 8)
    cuda.check_inputs(qb[:1], ql[:1], 4)
    cuda.check_inputs(qb, ql)


def _tree(n=300, seed=3, W=8):
    rng = np.random.default_rng(seed)
    base = np.sort(rng.choice(1 << 40, n, replace=False))
    ks = K.make_keyset([int(x).to_bytes(W, "big") for x in base], W)
    cfg = TreeConfig.plan(max_keys=2048, key_width=W)
    return bulk_build(cfg, ks, np.arange(n, dtype=np.int32), target="cpu"), base


def test_write_ops_dedupe_through_the_wrapper_and_drain_probes(monkeypatch):
    """update, remove and insert call the wrapper once each with
    ``count_probes`` as telemetry stands; a probe count the wrapper returns
    (the kernel's, on the card) drains into ``op.dedupe_probes{op=...}``;
    the masked and absent-duplicate lanes resolve as the plain version
    says: the last lane of a key wins, masked lanes never write."""
    tree, base = _tree()
    W = 8
    calls = []
    real = ops.dedupe_last_lanes

    def spy(qb, ql, count_probes=False):
        calls.append(count_probes)
        w, c, _ = real(qb, ql, count_probes)
        return w, c, torch.tensor(qb.shape[0] + 100, dtype=torch.int64)

    monkeypatch.setattr(ops, "dedupe_last_lanes", spy)
    obs.enable()
    present = [int(x) for x in base[:40]]
    absent = [7, 11, 7, 13, 11, 7]            # absent keys, repeated
    keys = present + present[:10] + absent
    ks = K.make_keyset([k.to_bytes(W, "big") for k in keys], W)
    vals = np.arange(len(keys), dtype=np.int32) + 1000
    mask = np.ones(len(keys), bool)
    mask[45] = False                          # a masked duplicate's last lane
    t1, rep = B.update_batch(tree, ks.bytes, ks.lens, vals, mask=mask)
    assert int(rep.conflicts) == 10 + 3
    got, _ = B.lookup_batch(t1, ks.bytes[:40], ks.lens[:40])
    want = vals[:40].copy()
    want[:10] = vals[40:50]
    want[5] = 5                  # lane 45 masked: key 5 keeps its built value
    assert np.array_equal(got.numpy(), want)
    t2, rep, _ = B.insert_batch(tree, ks.bytes, ks.lens, vals)
    got, rep2 = B.lookup_batch(t2, ks.bytes, ks.lens)
    assert bool(rep2.found.all())
    assert int(t2.arrays.key_count) == tree.arrays.key_count + 3
    for k, v in ((7, vals[-1]), (11, vals[-2]), (13, vals[-3])):
        i = keys.index(k)
        assert int(got[i]) == v, k
    B.remove_batch(tree, ks.bytes, ks.lens)
    assert calls == [True, True, True]
    for op in ("update", "insert", "remove"):
        assert obs.get_metric("op.dedupe_probes", op=op).value == len(
            keys) + 100, op
