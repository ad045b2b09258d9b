"""Seeded, replayable fault injection for the tree lifecycle (DESIGN.md §8) —
the port's counterpart of ``repro.core.faults``.

The harness mirrors ``core.protocol.Sim``'s determinism contract: a
``FaultPlan(seed=...)`` replays the exact same fault schedule for the same
sequence of instrumented calls, so every chaos failure is reproducible
from its seed. Faults come in four kinds:

* ``abort``       raise :class:`FaultInjected` at a lifecycle step — the
  staged build dies, the published version must keep serving.
* ``corrupt``     structurally damage a **staged** (never published) tree;
  ``core.fsck.check_tree`` must catch it before the swap.
* ``drop_shard``  raise :class:`ShardDropped` at a dispatch site — the
  shard is unreachable for this launch (its arrays are intact; only the
  dispatch fails). Random-mode drops are *sticky* until :meth:`heal`,
  modeling a down shard; explicit ``FaultSpec`` drops fire per their
  ``nth``/``count`` window, modeling transient flakes that retries absorb.
* ``delay``       sleep a bounded jitter before a routed op (exercises the
  async combine without changing results).

Fault *sites* are dotted names (``lifecycle.rebuild.gather``,
``shard.dispatch.lookup``, ...); specs match them with ``fnmatch``
patterns. Instrumented code calls :meth:`FaultPlan.fire` at each site —
with no plan (or a disarmed one) that is a no-op, so fault-free paths stay
bit-identical to the uninstrumented code.
"""
from __future__ import annotations

import dataclasses
import random
import time
from fnmatch import fnmatch
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs

__all__ = ["FaultInjected", "ShardDropped", "FaultSpec", "FaultPlan",
           "RetryPolicy", "CORRUPTIONS", "corrupt_tree"]


class FaultInjected(RuntimeError):
    """An injected fault fired at ``site`` (kind ``abort`` unless raised as
    a subclass). Carries enough context to assert on in tests."""

    def __init__(self, site: str, kind: str = "abort",
                 shard: Optional[int] = None):
        self.site = site
        self.kind = kind
        self.shard = shard
        at = f" shard={shard}" if shard is not None else ""
        super().__init__(f"injected {kind} at {site}{at}")


class ShardDropped(FaultInjected):
    """A shard was unreachable for one dispatch attempt. The shard's
    arrays are intact — only this launch failed — so retry/degrade is the
    correct response, never data re-construction."""

    def __init__(self, site: str, shard: Optional[int] = None):
        super().__init__(site, kind="drop_shard", shard=shard)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One deterministic fault: fire ``kind`` at sites matching ``site``
    (an ``fnmatch`` pattern), on visits ``[nth, nth + count)`` of that
    spec's per-(spec, shard) counter (``count=-1`` = every visit from
    ``nth`` on). ``shard`` narrows dispatch faults to one shard."""
    site: str
    kind: str = "abort"
    nth: int = 0
    count: int = -1
    shard: Optional[int] = None
    delay: float = 0.0


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped-exponential-backoff retry for routed dispatch. ``sleep`` is
    injectable so tests and the chaos sweep run at full speed."""
    max_attempts: int = 3
    base_delay: float = 0.001
    max_delay: float = 0.05
    sleep: Callable[[float], None] = time.sleep

    def delays(self):
        d = self.base_delay
        for _ in range(max(0, self.max_attempts - 1)):
            yield d
            d = min(d * 2.0, self.max_delay)


class FaultPlan:
    """A replayable fault schedule.

    Two modes, composable:

    * **explicit** — a tuple of :class:`FaultSpec`; deterministic given the
      call sequence (used by regression tests).
    * **random**   — ``p={"abort": 0.3, "drop_shard": 0.2, ...}`` draws
      from a private ``random.Random(seed)`` at each eligible site; the
      same seed replays the same schedule (used by the chaos sweep).

    ``disarm()`` turns the plan off (recovery phases run fault-free);
    ``heal()`` clears sticky shard drops. ``events`` logs every fired
    fault as ``(site, kind, shard)`` for replay comparison.
    """

    KINDS = ("abort", "corrupt", "drop_shard", "delay")
    # random-mode faults only fire where they are meaningful
    _RANDOM_PREFIX = {"abort": "lifecycle.", "drop_shard": "shard.dispatch",
                      "delay": "shard.dispatch"}

    def __init__(self, specs: Tuple[FaultSpec, ...] = (), seed: int = 0xFB,
                 p: Optional[Dict[str, float]] = None,
                 sleep: Optional[Callable[[float], None]] = None):
        for s in specs:
            if s.kind not in self.KINDS:
                raise ValueError(f"unknown fault kind {s.kind!r}; "
                                 f"one of {self.KINDS}")
        self.specs = tuple(specs)
        self.seed = int(seed)
        self.rng = random.Random(self.seed)
        self.p = dict(p or {})
        self.sleep = sleep if sleep is not None else (
            lambda s: time.sleep(min(s, 0.005)))
        self.armed = True
        self.events: List[Tuple[str, str, Optional[int]]] = []
        self._visits: Dict[Tuple[int, Optional[int]], int] = {}
        self._dropped: set = set()

    # ------------------------------------------------------------ control
    def disarm(self):
        self.armed = False

    def arm(self):
        self.armed = True

    def heal(self, shard: Optional[int] = None):
        """Clear sticky shard drops (all shards, or one)."""
        if shard is None:
            self._dropped.clear()
        else:
            self._dropped.discard(shard)

    # ------------------------------------------------------------- firing
    def _spec_fires(self, si: int, spec: FaultSpec, site: str,
                    shard: Optional[int]) -> bool:
        if not fnmatch(site, spec.site):
            return False
        if spec.shard is not None and spec.shard != shard:
            return False
        key = (si, shard)
        n = self._visits.get(key, 0)
        self._visits[key] = n + 1
        if n < spec.nth:
            return False
        return spec.count < 0 or n < spec.nth + spec.count

    def fire(self, site: str, shard: Optional[int] = None, **ctx) -> None:
        """Instrumentation hook: raise/delay if a fault is scheduled here.

        ``corrupt`` faults never fire here — they go through
        :meth:`corrupt_staged` (they need the staged object in hand).
        """
        if not self.armed:
            return
        if (shard is not None and shard in self._dropped
                and site.startswith("shard.dispatch")):
            self.events.append((site, "drop_shard", shard))
            obs.event("fault", site=site, kind="drop_shard", seed=self.seed,
                      shard=shard)
            raise ShardDropped(site, shard=shard)
        for si, spec in enumerate(self.specs):
            if spec.kind == "corrupt":
                continue
            if self._spec_fires(si, spec, site, shard):
                self._do(spec.kind, site, shard, delay=spec.delay,
                         sticky=False)
        for kind in sorted(self.p):
            if kind == "corrupt":
                continue
            prefix = self._RANDOM_PREFIX.get(kind, "")
            if not site.startswith(prefix):
                continue
            if self.rng.random() < self.p[kind]:
                self._do(kind, site, shard, sticky=True)

    def _do(self, kind: str, site: str, shard: Optional[int],
            delay: float = 0.0, sticky: bool = False):
        self.events.append((site, kind, shard))
        obs.event("fault", site=site, kind=kind, seed=self.seed,
                  shard=shard)
        if kind == "abort":
            raise FaultInjected(site, "abort", shard)
        if kind == "drop_shard":
            if sticky and shard is not None:
                self._dropped.add(shard)
            raise ShardDropped(site, shard=shard)
        if kind == "delay":
            self.sleep(delay if delay > 0 else self.rng.uniform(0, 0.003))

    def corrupt_staged(self, site: str, obj):
        """Maybe structurally corrupt a staged tree. Returns
        ``(obj', fired)`` — ``obj`` untouched when nothing fires. Only ever
        called on staged (unpublished) objects by the lifecycle layer."""
        if not self.armed:
            return obj, False
        fired = False
        for si, spec in enumerate(self.specs):
            if spec.kind != "corrupt":
                continue
            if self._spec_fires(si, spec, site, None):
                fired = True
        if not fired and self.rng.random() < self.p.get("corrupt", 0.0):
            fired = True
        if not fired:
            return obj, False
        obj2, kind = corrupt_tree(obj, self.rng)
        self.events.append((site, f"corrupt:{kind}", None))
        obs.event("fault", site=site, kind=f"corrupt:{kind}",
                  seed=self.seed)
        return obj2, True


# --------------------------------------------------------------------------
# structural corruptions — every one is guaranteed fsck-detectable
# --------------------------------------------------------------------------

CORRUPTIONS = ("anchor_swap", "chain_break", "high_key", "phantom_slot",
               "knum_bump", "dup_keyid", "key_count")


def _with_levels(tree, levels):
    from .fbtree import Level
    lv = tuple(Level(*l) for l in levels)
    # deliberately NOT refreshing `stacked`: a real torn write desyncs the
    # layouts, and fsck's coherence check must catch that too
    return tree.replace(levels=lv)


def _apply_corruption(tree, rng: random.Random, kind: str):
    """Try one corruption on an FBTree; None when inapplicable. Every
    choice draws from ``rng`` as the reference does, so one seed damages
    the same slot in both packages; the damaged arrays are clones."""
    a = tree.arrays
    leaf_count = int(a.leaf_count)
    kc = int(a.key_count)
    occ = a.leaf_occ[:leaf_count].cpu().numpy()

    if kind == "chain_break":
        ln = a.leaf_next.clone()
        ln[0] = 0                      # self-cycle (lone leaf included)
        return tree.replace(leaf_next=ln)

    if kind == "key_count":
        if not occ.any():
            return None
        return tree.replace(key_count=torch.zeros_like(a.key_count))

    if kind == "high_key":
        lh = a.leaf_high.clone()
        lh_np = a.leaf_high.cpu().numpy()
        kid = a.leaf_keyid.cpu().numpy()
        cand = [i for i in range(leaf_count)
                if lh_np[i] != -1 and occ[i].any()]
        if not cand:
            return None
        i = cand[rng.randrange(len(cand))]
        slot = int(np.nonzero(occ[i])[0][0])
        lh[i] = int(kid[i, slot])      # a key in the leaf: key < high fails
        return tree.replace(leaf_high=lh)

    if kind == "phantom_slot":
        free = ~occ
        if not free.any():
            return None
        r, s = map(int, np.argwhere(free)[rng.randrange(free.sum())])
        lo = a.leaf_occ.clone()
        lk = a.leaf_keyid.clone()
        lo[r, s] = True
        lk[r, s] = kc                  # points past the pool watermark
        return tree.replace(leaf_occ=lo, leaf_keyid=lk)

    if kind == "dup_keyid":
        live = np.argwhere(occ)
        if live.shape[0] < 2:
            return None
        (r1, s1), (r2, s2) = live[0], live[1]
        lk = a.leaf_keyid.clone()
        lk[int(r2), int(s2)] = lk[int(r1), int(s1)]
        return tree.replace(leaf_keyid=lk)

    # inner-level corruptions work on the bottom inner level
    bot = len(a.levels) - 1
    lv = a.levels[bot]
    cnt = int(lv.count)
    knum = lv.knum.cpu().numpy()

    if kind == "anchor_swap":
        rows = [r for r in range(cnt) if knum[r] >= 2]
        if not rows:
            return None
        r = rows[rng.randrange(len(rows))]
        anchors = lv.anchors.clone()
        anchors[r, [0, 1]] = lv.anchors[r, [1, 0]]
        levels = [list(l) for l in a.levels]
        levels[bot][5] = anchors
        return _with_levels(tree, levels)

    if kind == "knum_bump":
        ns = tree.config.ns
        rows = [r for r in range(cnt) if knum[r] < ns]
        if not rows:
            return None
        r = rows[rng.randrange(len(rows))]
        kn = lv.knum.clone()
        kn[r] += 1                     # exposes an EMPTY pad lane
        levels = [list(l) for l in a.levels]
        levels[bot][0] = kn
        return _with_levels(tree, levels)

    raise ValueError(f"unknown corruption kind {kind!r}")


def corrupt_tree(tree, rng: random.Random, kind: Optional[str] = None):
    """Structurally corrupt a tree (FBTree or ShardedTree) such that
    ``core.fsck`` is guaranteed to flag it. Returns ``(tree', kind)``; the
    input tree is untouched.

    With ``kind=None`` a random applicable corruption is chosen;
    ``chain_break`` is the universal fallback (applies to any tree). A
    ShardedTree draws its victim shard from ``rng`` before the shard's
    corruption, as the reference does, so one seed damages the same shard
    the same way in both packages.
    """
    if hasattr(tree, "shards"):        # ShardedTree (duck-typed: no import
        s = rng.randrange(len(tree.shards))   # cycle with shard)
        t2, k = corrupt_tree(tree.shards[s], rng, kind=kind)
        shards = list(tree.shards)
        shards[s] = t2
        return tree.replace(shards=tuple(shards)), k
    kinds = [kind] if kind is not None else list(CORRUPTIONS)
    if kind is None:
        rng.shuffle(kinds)
    for k in kinds + ["chain_break"]:
        t2 = _apply_corruption(tree, rng, k)
        if t2 is not None:
            return t2, k
    raise AssertionError("unreachable: chain_break always applies")
