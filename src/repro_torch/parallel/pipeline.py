"""GPipe-style pipeline parallelism — the port's counterpart of
``repro.parallel.pipeline``.

The schedule is the reference's: M microbatches flow through P stages in
M + P - 1 ticks; at tick t stage s runs microbatch t - s when that
microbatch exists, then hands its output to stage s + 1 (the reference's
ring ``ppermute``). The last stage writes microbatch t - s of the output,
and that output is what is returned. (The reference returns the output of
a stage that never wrote it, all zeros, for more than one stage: ROADMAP
queue 3.) The bubble is (P - 1) / (M + P - 1) of the ticks.

Two ways to run it:

- in one process, on a mesh of :func:`launch.mesh.make_pipeline_mesh`:
  stage s runs on the mesh's device s (on the card, every stage on
  ``cuda:0``); a stage with no microbatch at a tick computes nothing.
  Autograd runs through it, so a train step can differentiate it;
- across processes, on a ``DeviceMesh`` with a ``"stage"`` dim: each rank
  is one stage, the hand-off is ``dist.batch_isend_irecv`` and the last
  stage broadcasts the output to every rank. Forward only (no autograd
  across ranks yet: ROADMAP).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.utils._pytree as pytree

from ..launch.mesh import mesh_axes

__all__ = ["pipeline_apply", "bubble_fraction", "HANDOFFS"]

# the hand-offs this process made across ranks: [count, bytes] of sends and
# receives (``dist.batch_isend_irecv`` reaches no dispatch mode to count it)
HANDOFFS = {"send": [0, 0], "recv": [0, 0]}


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """The ticks a stage idles: (P - 1) / (M + P - 1)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)


def _is_device_mesh(mesh) -> bool:
    return hasattr(mesh, "get_group") and hasattr(mesh, "mesh_dim_names")


def pipeline_apply(mesh, stage_fn: Callable, params_stacked, x,
                   n_micro: int):
    """Run x [M*mb, ...] through the mesh's ``"stage"`` stages.

    params_stacked: pytree with leading dim P (one slice per stage).
    stage_fn(stage_params, x_mb) -> x_mb (same shape and dtype).
    """
    n_stages = mesh_axes(mesh)["stage"]
    assert x.shape[0] % n_micro == 0
    mb = x.shape[0] // n_micro
    if _is_device_mesh(mesh):
        return _across_ranks(mesh, stage_fn, params_stacked, x, n_micro, mb,
                             n_stages)
    devices = getattr(mesh, "devices", None) or (x.device,) * n_stages
    stage_params = [pytree.tree_map(lambda a, s=s: a[s].to(devices[s]),
                                    params_stacked)
                    for s in range(n_stages)]
    out = [None] * n_micro
    inbox = [None] * n_stages            # what each stage runs next tick
    for t in range(n_micro + n_stages - 1):
        nxt = [None] * n_stages
        for s in range(n_stages):
            mb_id = t - s
            if not 0 <= mb_id < n_micro:
                continue
            cur = x[mb_id * mb:(mb_id + 1) * mb].to(devices[0]) \
                if s == 0 else inbox[s]
            y = stage_fn(stage_params[s], cur)
            if s == n_stages - 1:
                out[mb_id] = y
            else:
                nxt[s + 1] = y.to(devices[s + 1])
        inbox = nxt
    return torch.cat(out, dim=0)


def _handoff(kind: str, t) -> None:
    HANDOFFS[kind][0] += 1
    HANDOFFS[kind][1] += t.numel() * t.element_size()


@torch.no_grad()
def _across_ranks(mesh, stage_fn, params_stacked, x, n_micro: int, mb: int,
                  n_stages: int):
    import torch.distributed as dist
    group = mesh.get_group("stage")
    sid = mesh.get_local_rank("stage")
    rank_of = [dist.get_global_rank(group, i) for i in range(n_stages)]
    pl = pytree.tree_map(lambda a: a[sid], params_stacked)
    out = torch.zeros_like(x)
    dist.barrier(group=group)
    cur = None
    for t in range(n_micro + n_stages - 1):
        mb_id = t - sid
        ops = []
        if 0 <= mb_id < n_micro:
            if sid == 0:
                cur = x[mb_id * mb:(mb_id + 1) * mb]
            y = stage_fn(pl, cur)
            if sid == n_stages - 1:
                out[mb_id * mb:(mb_id + 1) * mb] = y
            else:
                ops.append(dist.P2POp(dist.isend, y.contiguous(),
                                      rank_of[sid + 1], group))
                _handoff("send", y)
        if sid > 0 and 0 <= t + 1 - sid < n_micro:   # next tick's input
            cur = torch.empty((mb,) + tuple(x.shape[1:]), dtype=x.dtype,
                              device=x.device)
            ops.append(dist.P2POp(dist.irecv, cur, rank_of[sid - 1], group))
            _handoff("recv", cur)
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    dist.broadcast(out, src=rank_of[-1], group=group)
    return out
