"""Run one cell of ``BENCHMARK.json``: set up the index and its traffic,
drive the window, judge the answers against the reference, and report.

The system under test is the port's on-card FB+-tree
(``repro_torch.core.batch_ops`` with ``TraversalEngine("fused",
collect_stats=False)``), built by ``fbtree.bulk_build(device=True)``. Load
is a closed loop of batch calls with ``in_flight`` calls outstanding: the
harness issues call ``i + 1``, then waits for call ``i``.

A traffic file lists the calls of one round (``rounds``); round ``r`` runs
them in order. A lookup, update or scan takes entry ``r % pool`` of its own
pool of query batches drawn at set-up; an update writes ``vbase + r``,
fresh values each round; an insert takes the ``r``-th of the ``rounds``
batches of fresh keys its entry asks for, and the window closes early if
they run out. Every lookup and scan keeps the answers of ``sample_lanes``
of its lanes (drawn from the seed). After the window the reference replays
every call in order and judges what each call kept.
"""
import gc
import importlib
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import dists, keysets, trace
from .geometry import BulkLoad
from .reference.index import SortedKeys, last_wins, pack

ROOT = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks", "chip_smoke"}
VALUE_BASE = 1 << 30        # update values: vbase in [0, 2**30) plus round
CHUNK = 512                 # rounds of kept answers a device buffer holds


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def _name_ok(name: str) -> str:
    if not name or not all(c.isalnum() or c in "_.-" for c in name):
        raise ValueError(f"bad name {name!r}")
    return name


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic and
    the metrics it reports, each found by name. ``config`` and ``traffic``
    override entries of the files (the tests run cells small)."""

    def __init__(self, name: str, root: Path = ROOT, config=None,
                 traffic=None):
        spec = _json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; have {sorted(cells)}")
        w = cells[name]
        cfgs = {c["name"]: c for c in spec["configs"]}
        self.name, self.chips = name, int(w["chips"])
        self.config = {**_json(root / cfgs[w["config"]]["file"]),
                       **(config or {})}
        tpath = root / "bench" / "traffic" / f"{_name_ok(w['traffic'])}.json"
        self.traffic = {**_json(tpath), **(traffic or {})}

        def mine(m):
            return "workloads" not in m or name in m["workloads"]
        self.end_to_end = [m for m in spec["end_to_end"] if mine(m)]
        self.per_layer = [m for m in spec["per_layer"] if mine(m)]


class Port:
    """The system under test: the port's on-card tree and its batch ops."""

    name = "port"

    def __init__(self, kb, kl, vals, config: dict, device):
        from repro_torch.core import batch_ops, fbtree
        from repro_torch.core.keys import KeySet
        from repro_torch.core.traverse import TraversalEngine
        n, L = kb.shape
        cfg = fbtree.TreeConfig.plan(
            max_keys=int(n * config["capacity_factor"]), key_width=L,
            ns=config["ns"], fs=config["fs"], leaf_fill=config["leaf_fill"],
            inner_fill=config["inner_fill"])
        self.ops = batch_ops
        self.engine = TraversalEngine("fused", collect_stats=False)
        self.tree = fbtree.bulk_build(
            cfg, KeySet(kb.numpy(), kl.numpy()), vals.numpy(), device=True,
            target=device.type)

    def lookup(self, qb, ql):
        vals, rep = self.ops.lookup_batch(self.tree, qb, ql, engine=self.engine)
        return vals, rep.found

    def update(self, qb, ql, vals):
        self.tree, rep = self.ops.update_batch(self.tree, qb, ql, vals,
                                               engine=self.engine)
        return rep.found

    def scan(self, qb, ql, max_items: int):
        kid, val, emitted, _ = self.ops.range_scan(
            self.tree, qb, ql, max_items=max_items, engine=self.engine)
        return kid, val, emitted

    def insert(self, qb, ql, vals):
        self.tree, rep, _ = self.ops.insert_batch(self.tree, qb, ql, vals,
                                                  engine=self.engine)
        return rep.found

    def resolve(self, kid):
        """The key bytes and lengths of key ids a scan emitted."""
        a = self.tree.arrays
        k = torch.clamp(kid, min=0).long()
        return a.key_bytes[k], a.key_lens[k]

    def save(self):
        return self.tree

    def restore(self, state):
        self.tree = state

    def close(self):
        self.tree = None


def _bytes(ts) -> int:
    """Bytes the caching allocator gives the tensors: 512-byte blocks."""
    return sum(-(-t.numel() * t.element_size() // 512) * 512 for t in ts)


class Setup:
    """What the calls of a cell are drawn from: the loaded keys, the
    traffic's request distribution, the pool size and the sample size."""

    def __init__(self, kb, kl, rng, traffic, device):
        self.kb, self.kl, self.rng, self.device = kb, kl, rng, device
        self.P, self.S = int(traffic["pool"]), int(traffic["sample_lanes"])
        self.params = traffic["distribution"]
        self.dist = dists.load(self.params["name"])

    def queries(self, B: int):
        """``P`` batches of ``B`` loaded keys drawn by the distribution."""
        idx = self.dist.draw(self.rng, self.kb.shape[0], (self.P, B),
                             self.params, self.kb.device)
        return self.kb[idx].contiguous(), self.kl[idx].contiguous()

    def sample(self, B: int):
        """For each pool entry, the sorted lanes whose answers are judged."""
        return torch.stack([torch.from_numpy(np.sort(self.rng.choice(
            B, size=min(self.S, B), replace=False))) for _ in range(self.P)]
        ).to(self.device)


class Kept:
    """The answers of a call's sampled lanes, one row a round, in device
    buffers grown ``CHUNK`` rounds at a time. A window adds no Python
    object that outlives its call: with torch loaded, the collector's
    full passes, which such objects bring on, stall the host for 0.1 s
    or more."""

    def __init__(self, device, *cols):
        self.device, self.cols, self.chunks, self.n = device, cols, [], 0

    def put(self, r: int, *vals):
        c, i = divmod(r, CHUNK)
        if c == len(self.chunks):
            self.chunks.append([torch.empty((CHUNK,) + tuple(shape), dtype=dt,
                                            device=self.device)
                                for shape, dt in self.cols])
        for buf, v in zip(self.chunks[c], vals):
            buf[i] = v
        self.n = max(self.n, r + 1)

    def __getitem__(self, r: int):
        c, i = divmod(r, CHUNK)
        return [buf[i] for buf in self.chunks[c]]

    def column(self, k: int) -> torch.Tensor:
        """Column ``k`` of every row kept, round by round."""
        return torch.cat([ch[k] for ch in self.chunks])[:self.n]

    def tensors(self):
        return [t for ch in self.chunks for t in ch]


class Op:
    """One call of the round. ``issue`` enqueues it on the system and, with
    ``keep``, keeps the answers of the sampled lanes in ``kept`` (a row a
    round); ``replay`` brings the reference through the same call and
    judges what round ``r`` kept."""

    op = ""
    batch = 0
    wrong = compared = 0
    kept = None

    def pools(self):
        return []

    def tensors(self):
        return self.pools() + (self.kept.tensors() if self.kept else [])

    def resolve(self, sut):
        pass


def _cached(memo: dict, ref, e: int, f):
    """``f()`` for pool entry ``e`` while the reference's keys stand as
    they were when it was last worked out (inserts move ranks)."""
    if memo.get(e, (None,))[0] != ref.version:
        memo[e] = (ref.version, f())
    return memo[e][1]


class Lookup(Op):
    op = "lookup"

    def __init__(self, spec, su: Setup):
        self.batch = B = int(spec["batch"])
        self.qb, self.ql = su.queries(B)
        self.P, self.sample = su.P, su.sample(B)
        S = self.sample.shape[1]
        self.kept = Kept(su.device, ((S,), torch.int32), ((S,), torch.bool))
        self.memo = {}

    def pools(self):
        return [self.qb, self.ql, self.sample]

    def issue(self, sut, r, keep):
        e = r % self.P
        v, f = sut.lookup(self.qb[e], self.ql[e])
        if keep:
            s = self.sample[e]
            self.kept.put(r, v[s], f[s])

    def replay(self, ref, r):
        e = r % self.P
        s = self.sample[e]
        rank, want_f = _cached(self.memo, ref, e, lambda: ref.search(
            self.qb[e][s], self.ql[e][s]))
        want_v = ref.vals[torch.clamp(rank, max=ref.n - 1)]
        got_v, got_f = self.kept[r]
        self.wrong = self.wrong + ((got_f != want_f) | (
            want_f & (got_v.to(torch.int64) != want_v))).sum()
        self.compared += s.shape[0]


class Update(Op):
    op = "update"

    def __init__(self, spec, su: Setup):
        self.batch = B = int(spec["batch"])
        self.qb, self.ql = su.queries(B)
        self.P = su.P
        self.vbase = torch.from_numpy(su.rng.integers(
            0, VALUE_BASE, size=(su.P, B), dtype=np.int32)).to(su.device)
        self.vbuf = torch.empty((B,), dtype=torch.int32, device=su.device)
        self.memo = {}

    def pools(self):
        return [self.qb, self.ql, self.vbase, self.vbuf]

    def issue(self, sut, r, keep):
        e = r % self.P
        torch.add(self.vbase[e], r, out=self.vbuf)
        sut.update(self.qb[e], self.ql[e], self.vbuf)

    def replay(self, ref, r):
        e = r % self.P

        def where():
            rank, found = ref.search(self.qb[e], self.ql[e])
            return rank, last_wins(rank) & found
        rank, keep = _cached(self.memo, ref, e, where)
        ref.vals[rank[keep]] = self.vbase[e][keep].to(torch.int64) + r


class Scan(Op):
    op = "scan"

    def __init__(self, spec, su: Setup):
        self.batch = B = int(spec["batch"])
        self.M = int(spec["max_items"])
        self.qb, self.ql = su.queries(B)
        self.P, self.sample = su.P, su.sample(B)
        S, M = self.sample.shape[1], self.M
        self.kept = Kept(su.device, ((S, M), torch.int32),
                         ((S, M), torch.int32), ((S,), torch.int32))

    def pools(self):
        return [self.qb, self.ql, self.sample]

    def issue(self, sut, r, keep):
        e = r % self.P
        kid, v, n = sut.scan(self.qb[e], self.ql[e], self.M)
        if keep:
            s = self.sample[e]
            self.kept.put(r, kid[s], v[s], n[s])

    def resolve(self, sut):
        """Key ids name rows of the program's key pool, which only grows
        while the window runs: read the keys they name before it goes."""
        if not self.kept.chunks:
            return
        kb, kl = sut.resolve(self.kept.column(0))
        self.got_words = pack(kb.reshape(-1, kb.shape[-1]), kl.reshape(-1)
                              ).reshape(kb.shape[:-1] + (-1,))

    def replay(self, ref, r):
        e = r % self.P
        s = self.sample[e]
        rank, _ = ref.search(self.qb[e][s], self.ql[e][s])
        words, vals, valid = ref.rows(rank, self.M)
        _, got_v, got_n = self.kept[r]
        bad = got_n != valid.sum(1)
        bad |= (valid & ((self.got_words[r] != words).any(-1)
                         | (got_v.to(torch.int64) != vals))).any(1)
        self.wrong = self.wrong + bad.sum()
        self.compared += s.shape[0]


class Insert(Op):
    """Fresh keys, ``batch`` a round for ``rounds`` rounds, in the order
    they were made; fresh key ``i`` carries the record id ``n + i``."""

    op = "insert"

    def __init__(self, spec, su: Setup, fresh):
        self.batch = B = int(spec["batch"])
        fkb, fkl, n = fresh
        self.rounds = int(spec["rounds"])
        m = self.rounds * B
        self.kb = fkb[:m].reshape(self.rounds, B, -1).to(su.device)
        self.kl = fkl[:m].reshape(self.rounds, B).to(su.device)
        self.vals = (n + torch.arange(m, dtype=torch.int32)
                     ).reshape(self.rounds, B).to(su.device)

    def pools(self):
        return [self.kb, self.kl, self.vals]

    def issue(self, sut, r, keep):
        sut.insert(self.kb[r], self.kl[r], self.vals[r])

    def replay(self, ref, r):
        ref.insert(self.kb[r], self.kl[r], self.vals[r])


OPS = {"lookup": Lookup, "update": Update, "scan": Scan, "insert": Insert}


class Clock:
    """Completion marks: CUDA events on the card, nothing on the CPU, where
    every call has finished when it returns."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    @staticmethod
    def wait(ev):
        if ev is not None:
            ev.synchronize()

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device="cuda", system=None, t_start=None) -> dict:
    """Run ``cell`` and return its result line (a dict). ``system`` builds
    the system under test from ``(kb, kl, vals, config, device)``; default
    the port. ``t_start`` is the host time the run began (for
    ``setup_s``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    phases, last = {}, [t_start]

    def phase(name):
        now = time.perf_counter()
        phases[name], last[0] = now - last[0], now

    phase("imports")
    device = torch.device(device)
    cfg, tr = cell.config, cell.traffic
    s = seed % (1 << 64)
    rng = np.random.default_rng([s, 2])
    clock = Clock(device)
    if clock.cuda:
        torch.empty(1, device=device)
        clock.sync()
    phase("device_init")

    # ---- set-up: keys, values, the query pools, the index
    n = int(cfg["recordcount"])
    specs = tr["rounds"]
    n_fresh = sum(int(o["batch"]) * int(o["rounds"]) for o in specs
                  if o["op"] == "insert")
    kb, kl = keysets.load(cfg["key_set"]).generate(n + n_fresh, s, device)
    phase("keys")
    su = Setup(kb[:n], kl[:n], rng, tr, device)
    ops = [OPS[o["op"]](o, su, (kb[n:], kl[n:], n)) if o["op"] == "insert"
           else OPS[o["op"]](o, su) for o in specs]
    kb, kl = kb[:n].cpu(), kl[:n].cpu()
    del su
    vals = torch.arange(n, dtype=torch.int32)        # record ids
    phase("traffic")
    sut = (system or Port)(kb, kl, vals, cfg, device)
    clock.sync()
    phase("build")

    # warm-up: every call of two rounds on state that is then thrown away
    state = sut.save()
    for r in range(2):
        for o in ops:
            o.issue(sut, r, False)
    clock.sync()
    sut.restore(state)
    del state
    clock.sync()
    phase("warm_up")
    setup_peak = torch.cuda.max_memory_allocated() if clock.cuda else 0
    if clock.cuda:
        torch.cuda.reset_peak_memory_stats()

    # ---- the window
    in_flight = int(tr["in_flight"])
    rounds_max = min([1 << 62] + [o.rounds for o in ops if o.op == "insert"])
    # Flat lists of ints, five a call (op index, round, t_issue, t_return,
    # t_done) and three a host span (op index or -1 for a wait, start,
    # end), in ns: ints are no objects the collector tracks.
    calls, spans = [], []
    WAIT = -1
    pending = []
    n_ops = 0
    clk = time.perf_counter_ns
    full_gc = gc.get_stats()[2]["collections"]
    with trace.profiled(traced) as prof:
        clock.sync()
        anchor = trace.anchor() if traced else clk()
        t0 = clk()
        setup_s = time.perf_counter() - t_start
        r = 0
        while clk() - t0 < seconds * 1e9 and r < rounds_max:
            for j, o in enumerate(ops):
                t_i = clk()
                o.issue(sut, r, True)
                t_r = clk()
                n_ops += o.batch
                calls += (j, r, t_i, t_r, 0)
                spans += (j, t_i, t_r)
                pending.append((len(calls) - 1, clock.mark()))
                if len(pending) >= in_flight:
                    c, ev = pending.pop(0)
                    w0 = clk()
                    clock.wait(ev)
                    calls[c] = clk()
                    spans += (WAIT, w0, calls[c])
            r += 1
        for c, ev in pending:
            w0 = clk()
            clock.wait(ev)
            calls[c] = clk()
            spans += (WAIT, w0, calls[c])
        t_end = clk()
        clock.sync()
    window_s = (t_end - t0) * 1e-9
    full_gc = gc.get_stats()[2]["collections"] - full_gc
    calls = [tuple(calls[i:i + 5]) for i in range(0, len(calls), 5)]
    spans = [("wait" if spans[i] == WAIT else f"call.{ops[spans[i]].op}",
              spans[i + 1], spans[i + 2]) for i in range(0, len(spans), 3)]
    window_peak = torch.cuda.max_memory_allocated() if clock.cuda else 0
    memory_peak = max(setup_peak, window_peak)
    harness_bytes = _bytes([t for o in ops for t in o.tensors()])
    for o in ops:
        o.resolve(sut)
    sut.close()
    del sut
    loaded = sorted({k.split(".")[0] for k in sys.modules} & BANNED)

    # ---- the reference replays the window and judges the kept answers
    t_ref = time.perf_counter()
    ref = SortedKeys(kb.to(device), kl.to(device), vals.to(device))
    for j, r_, *_ in calls:
        ops[j].replay(ref, r_)
    n_wrong = sum(int(o.wrong) for o in ops)
    n_compared = sum(o.compared for o in ops)
    t_ref = time.perf_counter() - t_ref

    lat_ms = [(c[4] - c[2]) * 1e-6 for c in calls]
    result = {
        "correct": (n_wrong == 0 and n_compared > 0 and not loaded),
        "attempted": n_ops,
        "failed": n_wrong,
    }
    if traced:
        t = trace.Trace.from_profiler(prof, anchor, spans, (t0, t_end))
        ctx = dict(cell=cell, config=cfg, ops=ops, calls=calls, trace=t,
                   reference=ref, key_width=kb.shape[1],
                   shape=BulkLoad(n, cfg["leaf_fill"], cfg["inner_fill"],
                                  cfg["inner_levels"]))
        metrics = {}
        for m in cell.per_layer:
            v = load_metric(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": t.top_ops(),
                               "idle_gaps": t.idle_gaps()}
        k1 = [(s_ - t.window[0], t.window[1] - e_) for n_, s_, e_ in
              t.device_ops if "fused_descent" in n_]
        log(f"trace: offset_ns {t.offset_ns} device ops {len(t.device_ops)} "
            f"busy_s {t.busy_s} window_s {t.window_s} calls {len(calls)} "
            f"K1 launches {len(k1)} K2 launches {t.count('fused_scan')}; "
            f"first K1 {k1[0][0] if k1 else None} ns after the window "
            f"opened, last {k1[-1][1] if k1 else None} ns before it closed")
    else:
        e2e = {"ops_per_s": n_ops / window_s,
               "batch_p95_ms": float(np.percentile(lat_ms, 95)),
               "setup_s": setup_s}
        if clock.cuda:             # the allocator's peak exists on the card
            e2e["bytes_per_key"] = (window_peak - harness_bytes) / n
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in e2e}
    del ref
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if clock.cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if clock.cuda else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": memory_peak,
    }
    if traced:
        result["device"].update(busy_s=t.busy_s, window_s=t.window_s)
    result["checks"] = {
        "wrong_answers": {"value": n_wrong, "limit": 0, "must_be": "<="},
        "answers_compared": {"value": n_compared, "limit": 1, "must_be": ">="},
        "jax_modules_loaded": {"value": len(loaded), "limit": 0,
                               "must_be": "<="},
    }
    log(f"cell {cell.name} seed {seed} system {getattr(system, 'name', 'port')}"
        f" window_s {window_s} calls {len(calls)} rounds {r} "
        f"full_gc_passes {full_gc} harness_bytes {harness_bytes} window_peak "
        f"{window_peak} reference_s {t_ref}")
    log("setup_s by phase: " + " ".join(f"{k} {v:.3f}"
                                        for k, v in phases.items()))
    for j, o in enumerate(ops):
        ms = [(c[4] - c[2]) * 1e-6 for c in calls if c[0] == j]
        host = [(c[3] - c[2]) * 1e-6 for c in calls if c[0] == j]
        if ms:
            log(f"{o.op} calls {len(ms)} batch_ms median "
                f"{statistics.median(ms)} p95 {np.percentile(ms, 95)} max "
                f"{max(ms)} host_ms mean {statistics.fmean(host)}")
    if loaded:
        log(f"modules the port must not load are loaded: {loaded}")
    return result


def load_metric(name: str):
    return importlib.import_module(f"bench.metrics.{_name_ok(name)}")


def main(argv=None, t_start=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cell = Cell(a.workload)
    if not torch.cuda.is_available():
        log("no CUDA device: this benchmark measures the port on the card")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} present")
        return 2
    result = run_cell(cell, a.seed, a.seconds, bool(a.trace),
                      t_start=t_start)
    for k, c in result["checks"].items():
        log(f"check {k} {c['value']} {c['must_be']} {c['limit']}")
    if result["checks"]["jax_modules_loaded"]["value"]:
        return 3
    print(json.dumps(result), flush=True)
    return 0
