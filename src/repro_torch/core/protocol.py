"""Instruction-interleaved simulator of the paper's §4 synchronization protocol
— the port's own copy of ``repro.core.protocol`` (pure Python: the same
``Sim``, ``run_schedule`` and ``check_invariants``; one schedule gives one
trace in both packages).

The paper's concurrency claims (latch-free update via CAS, optimistic version
validation, Blink-style splits with `splitting` bit and cross-node tracking)
are shared-memory-thread semantics with no analogue inside one batched
device step (DESIGN.md §2). This module validates them *literally*: every shared
memory access is an atomic step of a coroutine, and a scheduler interleaves
coroutines arbitrarily. Hypothesis drives schedules in tests and checks
linearizability-style invariants.

Implemented faithfully from the paper:
  * control word per node: version | splitting | ordered | locked | deleted
    (Fig. 7); insert/remove bump the version, update does NOT (§4.2);
  * optimistic reads: begin_read / end_read validation loop (Fig. 8);
  * latch-free update: read slot -> CAS(kv, old, new); on failure re-validate
    version, check high_key, hop to sibling or retry (§4.4, Fig. 9/10);
  * kv migration during split uses ATOMIC_EXCHANGE(slot, None) so concurrent
    CAS updates fail and chase the sibling pointer (§4.4);
  * insert: lock leaf; full leaf -> set splitting, move upper half to new
    sibling, link, lock parent, insert anchor, bump parent version, clear
    splitting (§4.2 structure modification).
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Any, Dict, Generator, List, Optional, Tuple

__all__ = ["Sim", "Node", "run_schedule", "check_invariants"]

NS = 8  # small node size so schedules hit splits quickly


@dataclass
class Node:
    leaf: bool = True
    version: int = 0
    splitting: bool = False
    ordered: bool = True
    locked: bool = False
    deleted: bool = False
    # leaf payload: slot -> (key, val) or None  (kvs pointer array + bitmap)
    kvs: List[Optional[Tuple[Any, Any]]] = field(default_factory=lambda: [None] * NS)
    high_key: Any = None          # None = +inf
    next: Optional["Node"] = None


class Sim:
    """A two-level tree (root anchor table + leaf chain) with stepwise ops.

    Each public op returns a generator; every ``yield`` is a preemption point
    (the paper's unit of atomicity: one load / CAS / store).
    """

    def __init__(self, keys=(), seed: int = 0xFB):
        self.root_version = 0
        self.root_locked = False
        first = Node()
        self.anchors: List[Tuple[Any, Node]] = [(None, first)]  # sorted (low_key, node)
        self.log: List[Tuple] = []  # commit log: (op, key, val, info)
        # explicit seeded RNG: run_schedule's fallback scheduling draws from
        # it, so a failing hypothesis example replays deterministically from
        # (ops, schedule, seed) alone — no module-level random state
        self.rng = random.Random(seed)
        for k in sorted(keys):
            list(self.insert(k, ("init", k)))

    # ---- root helpers (anchor table guarded by root version/lock) ----
    def _locate(self, key) -> Node:
        node = self.anchors[0][1]
        for low, n in self.anchors:
            if low is None or (key is not None and key >= low):
                node = n
        return node

    # ---- control-word primitives ----
    def _begin_read(self, n: Node):
        return (n.version, n.splitting)

    def _end_read(self, n: Node, snap) -> bool:
        return (not n.locked) and n.version == snap[0]

    # ---------------- lookup (Fig. 8) ----------------
    def lookup(self, key) -> Generator:
        while True:
            node = self._locate(key)
            yield
            while True:
                snap = self._begin_read(node)
                yield
                # to_sibling: high-key check
                if node.high_key is not None and key >= node.high_key and node.next:
                    node = node.next
                    continue
                val = None
                for slot in range(NS):
                    kv = node.kvs[slot]          # atomic pointer load
                    if kv is not None and kv[0] == key:
                        val = kv[1]
                        break
                yield
                if val is not None:
                    # found: return immediately without validation (Fig. 8 L13)
                    self.log.append(("lookup", key, val, None))
                    return val
                if self._end_read(node, snap):
                    self.log.append(("lookup", key, None, None))
                    return None
                yield  # validation failed -> retry node

    # ---------------- latch-free update (§4.4) ----------------
    def update(self, key, new_val) -> Generator:
        while True:
            node = self._locate(key)
            yield
            retries = 0
            while True:
                snap = self._begin_read(node)
                yield
                if node.high_key is not None and key >= node.high_key and node.next:
                    node = node.next
                    continue
                slot_idx, old = None, None
                for slot in range(NS):
                    kv = node.kvs[slot]
                    if kv is not None and kv[0] == key:
                        slot_idx, old = slot, kv
                        break
                yield
                if slot_idx is not None:
                    # the only serialized step: CAS on the kv pointer
                    if node.kvs[slot_idx] is old:          # CAS succeeds
                        node.kvs[slot_idx] = (key, new_val)
                        self.log.append(("update", key, new_val, "ok"))
                        return True
                    yield  # CAS failed: kv exchanged (migration) or replaced
                    if node.version != snap[0]:
                        # moved by split/merge: re-check high key, chase sibling
                        continue
                    retries += 1
                    continue
                # not found in this node: only a validated snapshot (no lock
                # held, version unchanged, not splitting) proves real absence
                if self._end_read(node, snap) and not node.splitting:
                    self.log.append(("update", key, None, "miss"))
                    return False
                yield              # changed / mid-split: kv may have moved
                continue

    # ---------------- insert with split (§4.2) ----------------
    def insert(self, key, val) -> Generator:
        while True:
            node = self._locate(key)
            yield
            # acquire write lock (spin)
            while node.locked:
                yield
            node.locked = True
            yield
            # re-validate residence after locking
            if node.high_key is not None and key >= node.high_key and node.next:
                node.locked = False
                node = node.next
                continue
            if node.deleted:
                node.locked = False
                yield
                continue
            # existing key -> treat as update-under-lock
            for slot in range(NS):
                kv = node.kvs[slot]
                if kv is not None and kv[0] == key:
                    node.kvs[slot] = (key, val)
                    node.locked = False
                    self.log.append(("insert", key, val, "overwrite"))
                    return True
            free = [s for s in range(NS) if node.kvs[s] is None]
            if free:
                node.kvs[free[0]] = (key, val)
                node.version += 1          # insert bumps version (§4.2)
                node.locked = False
                self.log.append(("insert", key, val, "ok"))
                return True
            # ---- split: link technique ----
            node.splitting = True
            yield
            items = sorted(kv for kv in node.kvs if kv is not None)
            mid = len(items) // 2
            split_key = items[mid][0]
            new = Node()
            new.high_key = node.high_key
            new.next = node.next
            yield
            # migrate upper half: latest = ATOMIC_EXCHANGE(slot, NULL); install
            # latest into the new node (§4.4 — the exchange *obtains the latest
            # pointer*, so a racing CAS update either lands before the exchange
            # and is carried over, or observes NULL and chases the sibling)
            j = 0
            for s in range(NS):
                kv = node.kvs[s]
                if kv is not None and kv[0] >= split_key:
                    latest, node.kvs[s] = node.kvs[s], None  # atomic exchange
                    new.kvs[j] = latest
                    j += 1
                    yield
            node.high_key = split_key
            node.next = new
            node.version += 1
            yield
            # step (2): insert anchor into parent under parent lock
            while self.root_locked:
                yield
            self.root_locked = True
            yield
            self.anchors.append((split_key, new))
            self.anchors.sort(key=lambda t: (t[0] is not None, t[0]))
            self.root_version += 1
            self.root_locked = False
            node.splitting = False         # cross-node tracking end (§4.3)
            node.locked = False
            yield
            # retry the original insert (now guaranteed space somewhere)
            continue

    # ---------------- remove ----------------
    def remove(self, key) -> Generator:
        while True:
            node = self._locate(key)
            yield
            while node.locked:
                yield
            node.locked = True
            yield
            if node.high_key is not None and key >= node.high_key and node.next:
                node.locked = False
                node = node.next
                continue
            ok = False
            for slot in range(NS):
                kv = node.kvs[slot]
                if kv is not None and kv[0] == key:
                    node.kvs[slot] = None   # exchange
                    ok = True
                    break
            if ok:
                node.version += 1           # remove bumps version
            node.locked = False
            self.log.append(("remove", key, None, "ok" if ok else "miss"))
            return ok

    # ---- inspection ----
    def leaf_chain(self) -> List[Node]:
        out = []
        n = self.anchors[0][1]
        while n is not None:
            out.append(n)
            n = n.next
        return out

    def contents(self) -> Dict[Any, Any]:
        d = {}
        for n in self.leaf_chain():
            for kv in n.kvs:
                if kv is not None:
                    assert kv[0] not in d, "duplicate key across leaves"
                    d[kv[0]] = kv[1]
        return d


def run_schedule(sim: Sim, ops: List[Generator], schedule,
                 rng: Optional[random.Random] = None) -> None:
    """Interleave op coroutines. ``schedule`` yields indices into live ops
    (ints; modulo live count) — hypothesis supplies arbitrary schedules.

    Once the schedule is exhausted (or when it is ``None``) the remaining
    steps draw from ``rng`` — an explicit ``random.Random`` (or an int
    seed), defaulting to the simulator's own seeded ``sim.rng`` — so a
    replay of the same (ops, schedule, seed) triple is bit-for-bit
    deterministic."""
    live = list(ops)
    if rng is None:
        rnd = sim.rng
    elif isinstance(rng, int):
        rnd = random.Random(rng)
    else:
        rnd = rng
    it = iter(schedule) if schedule is not None else None
    guard = 0
    while live:
        guard += 1
        if guard > 200_000:
            raise RuntimeError("schedule did not terminate (livelock?)")
        if it is not None:
            try:
                i = next(it) % len(live)
            except StopIteration:
                it = None
                continue
        else:
            i = rnd.randrange(len(live))
        try:
            next(live[i])
        except StopIteration:
            live.pop(i)


def check_invariants(sim: Sim) -> None:
    """Post-quiescence invariants (linearizability-style)."""
    # 1. leaf chain strictly ordered and consistent with high keys
    chain = sim.leaf_chain()
    prev_max = None
    for n in chain:
        ks = sorted(kv[0] for kv in n.kvs if kv is not None)
        if ks:
            if prev_max is not None:
                assert ks[0] > prev_max, "chain order violated"
            prev_max = ks[-1]
        if n.high_key is not None:
            assert all(k < n.high_key for k in ks), "high_key violated"
    # 2. final value of each key equals the last committed write in the log
    expect: Dict[Any, Any] = {}
    for op, key, val, info in sim.log:
        if op == "insert" and info in ("ok", "overwrite"):
            expect[key] = val
        elif op == "update" and info == "ok":
            expect[key] = val
        elif op == "remove" and info == "ok":
            expect.pop(key, None)
    got = sim.contents()
    assert got == expect, f"lost/phantom updates: {got} != {expect}"
    # 3. every lookup returned a value some write actually installed
    writes: Dict[Any, set] = {}
    for op, key, val, info in sim.log:
        if op in ("insert", "update") and val is not None and info in (
                "ok", "overwrite"):
            writes.setdefault(key, set()).add(val)
    for op, key, val, _ in sim.log:
        if op == "lookup" and val is not None:
            assert val in writes.get(key, set()), "lookup returned garbage"
