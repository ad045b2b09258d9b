"""The port's copy of the §4 protocol simulator (``repro_torch.core.protocol``)
against the reference's.

Mirrors ``tests/test_protocol.py``'s three tests on the port's ``Sim``,
``run_schedule`` and ``check_invariants``, and adds one check: the same
ops, schedule and seed give the reference's trace — the commit log, the
final contents and the leaf chain — entry for entry.
"""
from hypothesis import HealthCheck, given, settings, strategies as st

from repro.core import protocol as rprotocol
from repro_torch.core.protocol import Sim, check_invariants, run_schedule

op_st = st.tuples(st.sampled_from(["lookup", "update", "insert", "remove"]),
                  st.integers(0, 30))


def _ops(sim, ops):
    gens = []
    for i, (kind, key) in enumerate(ops):
        if kind == "lookup":
            gens.append(sim.lookup(key))
        elif kind == "update":
            gens.append(sim.update(key, ("u", i)))
        elif kind == "insert":
            gens.append(sim.insert(key, ("i", i)))
        else:
            gens.append(sim.remove(key))
    return gens


@settings(deadline=None, max_examples=60,
          suppress_health_check=list(HealthCheck))
@given(ops=st.lists(op_st, min_size=2, max_size=24),
       schedule=st.lists(st.integers(0, 7), min_size=0, max_size=400),
       init=st.sets(st.integers(0, 30), max_size=12),
       seed=st.integers(0, 2**32 - 1))
def test_interleaved_ops_linearize(ops, schedule, init, seed):
    sim = Sim(keys=init, seed=seed)
    run_schedule(sim, _ops(sim, ops), iter(schedule))
    check_invariants(sim)


@settings(deadline=None, max_examples=20,
          suppress_health_check=list(HealthCheck))
@given(st.integers(0, 2**32 - 1))
def test_update_contention_single_key(seed):
    """Many updates on ONE key (the paper's high-contention case): exactly
    one final value, and it must be some committed update's value."""
    sim = Sim(keys=[5], seed=seed)
    gens = [sim.update(5, ("u", i)) for i in range(8)]
    run_schedule(sim, gens, None, rng=seed)
    check_invariants(sim)
    assert sim.contents()[5][0] in ("u", "init", "i")


def test_split_during_update_chases_sibling():
    """Deterministic schedule: update stalls, split migrates the kv, update
    must chase the sibling and still commit (paper Fig. 10 bottom)."""
    sim = Sim(keys=range(0, 8))          # leaf NS=8 -> full
    upd = sim.update(7, ("u", 0))
    ins = sim.insert(100, ("i", 0))      # forces split of the full leaf
    for _ in range(3):
        next(upd)
    for _ in ins:
        pass
    for _ in upd:
        pass
    check_invariants(sim)
    assert sim.contents()[7] == ("u", 0)


def _trace(sim):
    chain = [(n.version, n.high_key, n.ordered,
              sorted(kv for kv in n.kvs if kv is not None))
             for n in sim.leaf_chain()]
    return list(sim.log), sim.contents(), chain


@settings(deadline=None, max_examples=40,
          suppress_health_check=list(HealthCheck))
@given(ops=st.lists(op_st, min_size=2, max_size=24),
       schedule=st.lists(st.integers(0, 7), min_size=0, max_size=200),
       init=st.sets(st.integers(0, 30), max_size=12),
       seed=st.integers(0, 2**32 - 1))
def test_same_schedule_gives_the_reference_trace(ops, schedule, init, seed):
    """One (ops, schedule, seed) triple: the port's simulator commits the
    reference's log in the reference's order and ends in the same tree;
    the seeded fallback scheduling draws alike once the schedule runs
    dry."""
    rsim = rprotocol.Sim(keys=init, seed=seed)
    rprotocol.run_schedule(rsim, _ops(rsim, ops), iter(schedule))
    psim = Sim(keys=init, seed=seed)
    run_schedule(psim, _ops(psim, ops), iter(schedule))
    assert _trace(psim) == _trace(rsim)
    assert psim.rng.getstate() == rsim.rng.getstate()
