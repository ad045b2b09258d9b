"""Multi-process CPU checks of the port's parallel layer over ``gloo``.

:func:`run_ranks` starts ``world`` Python processes of this file, one a
rank, joined by ``init_process_group("gloo", tcp://localhost:<free
port>)``; each runs one scenario and prints its result as a JSON line.
Imports torch and the port only (no JAX): the parent test holds the
results against the reference.

  PYTHONPATH=src python tests/torch_gloo.py <scenario> <rank> <world> <port>
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(scenario: str, world: int, timeout: float,
              n_procs: int = 0) -> list:
    """Each rank's JSON result; fails if a rank fails or the run outlasts
    ``timeout`` seconds (every process is killed then). ``n_procs`` starts
    only that many of the ranks (a ``fake_`` scenario's one process
    stands for every rank of its fake group)."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), scenario, str(r),
         str(world), str(port)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(n_procs or world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-4000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


# ------------------------------------------------------------ the scenarios
def _expected_slice(full, spec, coord, sizes, names):
    """The block of ``full`` that the rank at mesh coordinate ``coord``
    holds under ``spec``: each entry's axes, major to minor in mesh
    order, index one equal chunk of its dim."""
    from repro_torch.parallel.sharding import spec_names
    idx = []
    for dim, e in enumerate(spec):
        k, num = 0, 1
        for a in spec_names(e):
            i = names.index(a)
            k, num = k * sizes[i] + coord[i], num * sizes[i]
        chunk = full.shape[dim] // num
        idx.append(slice(k * chunk, (k + 1) * chunk))
    return full[tuple(idx)]


def place(rank: int, world: int) -> dict:
    """A SMOKE model's params placed by ``param_shardings`` on a (2, 2)
    ("data", "model") DeviceMesh, fsdp off and on: every local shard
    against the slice its spec names; ``shard`` on a DTensor under
    ``ShardCtx``."""
    import torch
    import torch.utils._pytree as pytree
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import device_mesh, make_mesh
    from repro_torch.models import lm
    from repro_torch.parallel import sharding as SH
    mesh = make_mesh((2, 2), ("data", "model"))
    dm = device_mesh(mesh)
    names, sizes = list(dm.mesh_dim_names), list(dm.shape)
    coord = dm.get_coordinate()
    params = lm.init_params(get_config("qwen3-14b", smoke=True),
                            torch.Generator().manual_seed(0))
    res = {"rank": rank, "coord": list(coord), "leaves": 0, "sharded": 0,
           "bad": [], "specs": {}}
    for fsdp in (False, True):
        on_dm = SH.param_shardings(params, dm, fsdp=fsdp)
        on_abstract = SH.param_shardings(params, mesh, fsdp=fsdp)
        flat = pytree.tree_flatten_with_path(params)[0]
        shs = pytree.tree_leaves(on_dm)
        for (path, p), sh, sh_a in zip(flat, shs,
                                       pytree.tree_leaves(on_abstract)):
            key = f"{fsdp}:{SH._path_str(path)}"
            res["specs"][key] = [list(e) if isinstance(e, tuple) else e
                                 for e in sh.spec]
            if sh.spec != sh_a.spec:
                res["bad"].append(f"{key}: {sh.spec} on the DeviceMesh, "
                                  f"{sh_a.spec} on the abstract mesh")
            dt = distribute_tensor(p, dm, sh.placements)
            want = _expected_slice(p, sh.spec, coord, sizes, names)
            res["leaves"] += 1
            res["sharded"] += int(want.numel() < p.numel())
            if not torch.equal(dt.to_local(), want):
                res["bad"].append(key)
    # a tuple entry shards major to minor in mesh order, as JAX does
    t = torch.arange(64 * 4).reshape(64, 4)
    spec = SH.P(("data", "model"), None)
    dt = distribute_tensor(t, dm, SH.to_placements(spec, dm))
    res["tuple_placements"] = [str(p) for p in dt.placements]
    res["tuple_rows"] = [int(dt.to_local()[0, 0]) // 4,
                         int(dt.to_local()[-1, 0]) // 4]
    res["tuple_ok"] = bool(torch.equal(
        dt.to_local(), _expected_slice(t, spec, coord, sizes, names)))
    x = torch.randn(4, 8, 16, generator=torch.Generator().manual_seed(1))
    xd = distribute_tensor(x, dm, [Replicate(), Replicate()])
    res["outside_ctx_identity"] = SH.shard(xd, "bsd") is xd
    with SH.ShardCtx(dm):
        res["plain_identity"] = SH.shard(x, "bsd") is x
        y = SH.shard(xd, "bsd")
    res["bsd_placements"] = [str(p) for p in y.placements]
    res["bsd_local_ok"] = bool(torch.equal(
        y.to_local(), x[coord[0] * 2:(coord[0] + 1) * 2]))
    return res


def pipeline(rank: int, world: int) -> dict:
    """``pipeline_apply`` across ``world`` ranks (one stage each) against
    the stages applied in sequence, microbatch by microbatch."""
    import numpy as np
    import torch
    from repro_torch.launch.mesh import device_mesh, make_pipeline_mesh
    from repro_torch.parallel.pipeline import pipeline_apply
    dm = device_mesh(make_pipeline_mesh(world, device="cpu"))
    rng = np.random.default_rng(0)
    W = torch.from_numpy(rng.standard_normal((world, 16, 16)) * 0.5)
    x = torch.from_numpy(rng.standard_normal((8, 16)))

    def stage(w, h):
        return torch.tanh(h @ w)

    y = pipeline_apply(dm, stage, W, x, n_micro=4)
    want = []
    for m in range(4):
        h = x[m * 2:(m + 1) * 2]
        for s in range(world):
            h = stage(W[s], h)
        want.append(h)
    want = torch.cat(want)
    return {"rank": rank, "max_abs_diff": float((y - want).abs().max()),
            "equal": bool(torch.equal(y, want)),
            "max_abs_y": float(y.abs().max())}


# (arch, optimizer): SMOKE dense and MoE under AdamW (``opt_for``'s pick at
# SMOKE size), and deepseek-v3 (MLA, MoE) under Adafactor, ``opt_for``'s
# pick at full width
STEP_CASES = (("yi-9b", "adamw"), ("llama4-scout-17b-a16e", "adamw"),
              ("deepseek-v3-671b", "adafactor"))
STEP_B, STEP_S = 4, 32
STEP_LR = 1e-2          # a bf16 parameter moves by several ulps in a step


def _comm_counts(cm) -> dict:
    """``CommDebugMode``'s counts keyed by the op's name."""
    return {str(k).split(".")[-1]: int(v)
            for k, v in cm.get_comm_counts().items() if v}


def _step_setup(arch: str, kind: str, dtype: str = "bfloat16"):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sharding as SH
    from repro_torch.train import optim as O
    from repro_torch.train.train_step import state_template
    cfg = dataclasses.replace(get_config(arch, smoke=True), remat="full",
                              param_dtype=dtype)
    ocfg = O.OptConfig(kind=kind, lr=STEP_LR, warmup=0)
    mesh = make_mesh((2, 2), ("data", "model"))
    tmpl = state_template(cfg, ocfg)
    psh = SH.param_shardings(tmpl["params"], mesh, fsdp=True)
    osh = O.opt_state_shardings(tmpl["opt"], psh, mesh)
    return cfg, ocfg, mesh, tmpl, {"params": psh, "opt": osh}


def _diffs(got, want) -> dict:
    """{leaf path: (max |got - want|, max |want|)} of two trees, ``got``'s
    DTensors gathered whole (every rank joins the gathers)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.train.tree import tree_paths
    out = {}
    for (path, g), (_, w) in zip(tree_paths(got), tree_paths(want)):
        if isinstance(g, DTensor):
            g = g.full_tensor()
        g, w = g.float(), w.float()
        out[path] = (float((g - w).abs().max()), float(w.abs().max()))
    return out


def _train_step(arch: str, kind: str, fake: bool,
                dtype: str = "bfloat16") -> dict:
    """One train step of ``arch``'s SMOKE config (FSDP, full remat, as the
    dry run's optimized profile trains; optimizer ``kind`` at lr
    ``STEP_LR`` from its first step) on DTensors over a (2, 2) ("data",
    "model") DeviceMesh, ``shard`` at every block: on real tensors (the
    gloo group; every rank also runs the one-process step on a copy of
    the same state and batch) or on fake ones (a fake group, counted by
    the dry run's ``CostCounter``). Returns the losses, the gradients',
    the updated optimizer state's and parameters' differences from the
    one-process step's (leaf by leaf, with the one-process leaf's
    largest magnitude), the collectives ``CommDebugMode`` and the counter
    saw and the reshards ``Reshard`` made."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.common import smoke_batch
    from repro_torch.launch import cost_analysis as CA
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel.dtensor import Reshard
    from repro_torch.train.train_step import (_grads_of, init_state,
                                              make_train_step)
    from repro_torch.train.tree import tree_map
    cfg, ocfg, mesh, tmpl, sh = _step_setup(arch, kind, dtype)
    dm = device_mesh(mesh, "cpu")
    step = make_train_step(cfg, ocfg, shard=SH.shard)
    res = {"arch": arch, "kind": kind}
    batch = smoke_batch(cfg, B=STEP_B, S=STEP_S, seed=0, device="cpu")
    bsh = SH.batch_shardings(batch, mesh)
    cm = CommDebugMode()
    if fake:
        with FakeTensorMode():
            state = D.place_tree(tmpl, sh, dm, "cpu")
            dbatch = D.place_tree(batch, bsh, dm, "cpu")
            with cm, SH.ShardCtx(mesh), implicit_replication(), \
                    CA.CostCounter() as counter, Reshard():
                step(state, dbatch)
        res["counter"] = {k: int(v["count"])
                          for k, v in counter.colls.items()}
        res["comm"] = _comm_counts(cm)
        return res

    def placed(t, s):       # a copy: the step writes the state in place
        return distribute_tensor(t.clone(), dm, s.placements)
    state = init_state(cfg, ocfg, torch.Generator().manual_seed(0))
    one = tree_map(lambda t: t.clone(), state)
    dstate = tree_map(placed, state, sh)
    dbatch = tree_map(placed, batch, bsh)
    g1, _ = _grads_of(one["params"], cfg, batch)
    one, m1 = step(one, batch)
    with SH.ShardCtx(mesh), implicit_replication(), Reshard() as rs:
        gd, _ = _grads_of(dstate["params"], cfg, dbatch, SH.shard)
    with cm, SH.ShardCtx(mesh), implicit_replication(), Reshard() as rs2:
        dstate, m = step(dstate, dbatch)
    res["comm"] = _comm_counts(cm)
    res["reshards"] = {k: rs.counts.get(k, 0) + rs2.counts.get(k, 0)
                       for k in set(rs.counts) | set(rs2.counts)}
    res["loss"] = float(m["loss"].full_tensor())
    res["loss_one_process"] = float(m1["loss"])
    res["grad_norm"] = float(m["grad_norm"].full_tensor())
    res["grad_norm_one_process"] = float(m1["grad_norm"])
    res["dtype"] = str(cfg.dtype)
    res["grads"] = _diffs(gd, g1)
    res["opt"] = _diffs({k: v for k, v in dstate["opt"].items()
                         if k != "step"},
                        {k: v for k, v in one["opt"].items() if k != "step"})
    res["step"] = [int(dstate["opt"]["step"].full_tensor()),
                   int(one["opt"]["step"])]
    res["params"] = _diffs(dstate["params"], one["params"])
    res["moved"] = _diffs(one["params"], state["params"])
    return res


def train_step(rank: int, world: int) -> dict:
    """Each case in bf16 (as it trains) and in float32 (where the sums'
    order moves the gradients by ~1e-7 of their size, and so no MoE
    routing decision: the leaf-by-leaf check)."""
    return {"rank": rank,
            "runs": [_train_step(a, k, fake=False) for a, k in STEP_CASES],
            "float32": [_train_step(a, k, fake=False, dtype="float32")
                        for a, k in STEP_CASES]}


def fake_train_step(rank: int, world: int) -> dict:
    return {"rank": rank, "runs": [_train_step(a, k, fake=True)
                                   for a, k in STEP_CASES]}


def fake_counts(rank: int, world: int) -> dict:
    """The dry run's counter on hand-countable DTensor ops over a fake
    (4, 4) ("data", "model") mesh: a matmul with its output sharded on
    both mesh dims, one whose contraction is sharded (a partial sum over
    "model"), one replicated, an all-gather, and a slice of a large
    tensor; an op DTensor cannot place (under ``Reshard``) and a
    collective over a group that cannot be resolved."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch import cost_analysis as CA
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import device_mesh, make_mesh
    from repro_torch.parallel.dtensor import Reshard
    dm = device_mesh(make_mesh((4, 4), ("data", "model")), "cpu")
    M, K, N = 64, 32, 48

    def dt(shape, pl):
        local = list(shape)
        for md, p in enumerate(pl):
            if isinstance(p, Shard):
                local[p.dim] //= 4
        return DTensor.from_local(torch.empty(local), dm, pl,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=(shape[1], 1))
    R = Replicate()
    res = {}
    with FakeTensorMode():
        cases = {
            "both": (dt((M, K), [Shard(0), R]), dt((K, N), [R, Shard(1)])),
            "partial": (dt((M, K), [Shard(0), Shard(1)]),
                        dt((K, N), [R, Shard(0)])),
            "replicated": (dt((M, K), [R, R]), dt((K, N), [R, R])),
        }
        for name, (a, b) in cases.items():
            with CA.CostCounter() as c:
                out = a @ b
            res[name] = {"flops": c.flops, "traffic": c.traffic,
                         "placements": [str(p) for p in out.placements],
                         "colls": c.colls}
        c_both = cases["both"][0] @ cases["both"][1]
        with CA.CostCounter() as c:
            c_both.redistribute(dm, [Shard(0), R])
        res["gather"] = c.colls
        big = dt((1024, 64), [R, R])
        with CA.CostCounter() as c:
            big[:8] * 2.0
        res["slice"] = {"traffic": c.traffic, "flops": c.flops}
        # an op DTensor has no strategy for raises through Reshard
        try:
            with Reshard():
                torch.searchsorted(cases["both"][0], cases["both"][0])
            res["unplaceable"] = "ran"
        except Exception as e:
            res["unplaceable"] = D._failed_op(e)
    # a collective whose process group cannot be resolved raises
    try:
        CA._group_size(torch.ops._c10d_functional.all_reduce.default,
                       (torch.empty(2), "sum", "no-such-group"), {})
        res["unresolved_group"] = "resolved"
    except RuntimeError as e:
        res["unresolved_group"] = str(e)
    return res


def fake_param_bytes(rank: int, world: int) -> dict:
    """yi-9b's and deepseek-v3's parameters (FSDP off and on) and their
    optimizer states (ZeRO-1 AdamW; deepseek's Adafactor too) placed by
    the dry run on a fake 16 x 16 mesh: the bytes of rank 0's shards."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._pytree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import device_mesh, make_production_mesh
    from repro_torch.parallel import sharding as SH
    from repro_torch.train import optim as O
    from repro_torch.train.train_step import state_template
    mesh = make_production_mesh()
    dm = device_mesh(mesh, "cpu")

    def local_bytes(tree):
        return sum(t.to_local().numel() * t.to_local().element_size()
                   for t in tree_leaves(tree))
    res = {}
    with FakeTensorMode():
        for arch in ("yi-9b", "deepseek-v3-671b"):
            cfg = get_config(arch)
            for kind in ("adamw", "adafactor"):
                ocfg = O.OptConfig(kind=kind)
                tmpl = state_template(cfg, ocfg)
                for fsdp in (False, True):
                    psh = SH.param_shardings(tmpl["params"], mesh, fsdp=fsdp)
                    osh = O.opt_state_shardings(tmpl["opt"], psh, mesh)
                    key = f"{arch}:{kind}:{fsdp}"
                    res[key + ":params"] = local_bytes(
                        D.place_tree(tmpl["params"], psh, dm, "cpu"))
                    res[key + ":opt"] = sum(
                        local_bytes(D.place_tree(tmpl["opt"][k], osh[k], dm,
                                                 "cpu"))
                        for k in tmpl["opt"])
    return res


def solo_cells(rank: int, world: int) -> dict:
    """``dryrun.run_cell`` (which makes and destroys its own fake group)
    on SMOKE configs over a (2, 2) mesh, every shape kind, and the
    pipeline dry run at a small size."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import dryrun_pipeline as DP
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2, 2), ("data", "model"))
    out = {"cells": []}
    for arch, shape in (("yi-9b", "train_4k"), ("yi-9b", "prefill_32k"),
                        ("yi-9b", "decode_32k"),
                        ("llama4-scout-17b-a16e", "train_4k"),
                        ("falcon-mamba-7b", "long_500k"),
                        ("yi-9b", "long_500k")):
        cfg = get_config(arch, smoke=True)
        r = D.run_cell(arch, shape, "single", profile="optimized",
                       device="cpu", cfg=cfg, amesh=mesh,
                       shape_override=dict(seq_len=64, global_batch=4))
        r.pop("trace", None)
        out["cells"].append(r)
    out["pipeline"] = DP.run("cpu", config=dict(
        n_stages=2, repl=2, d=64, ff=128, layers_per_stage=2, n_micro=4,
        mb=2, seq=8))
    return out


SCENARIOS = {"place": place, "pipeline": pipeline, "train_step": train_step,
             "fake_train_step": fake_train_step, "fake_counts": fake_counts,
             "fake_param_bytes": fake_param_bytes, "solo_cells": solo_cells}


def main():
    scenario, rank, world, port = (sys.argv[1], int(sys.argv[2]),
                                   int(sys.argv[3]), int(sys.argv[4]))
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    if scenario.startswith("solo_"):          # makes its own groups
        print(json.dumps(SCENARIOS[scenario](rank, world)), flush=True)
        return
    if scenario.startswith("fake_"):
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", rank=rank, world_size=world,
                                store=FakeStore())
    else:
        dist.init_process_group("gloo",
                                init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
    try:
        out = SCENARIOS[scenario](rank, world)
    finally:
        dist.destroy_process_group()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
