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


def run_ranks(scenario: str, world: int, timeout: float) -> list:
    """Each rank's JSON result; fails if a rank fails or the run outlasts
    ``timeout`` seconds (every process is killed then)."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), scenario, str(r),
         str(world), str(port)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
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


SCENARIOS = {"place": place, "pipeline": pipeline}


def main():
    scenario, rank, world, port = (sys.argv[1], int(sys.argv[2]),
                                   int(sys.argv[3]), int(sys.argv[4]))
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        out = SCENARIOS[scenario](rank, world)
    finally:
        dist.destroy_process_group()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
