"""Pipeline-parallel dry run at production scale — the port's counterpart
of ``repro.launch.dryrun_pipeline``: the reference's GPipe configuration
(4 stages x 128 ``"repl"`` ranks; d 4,096, ff 16,384, 8 layers a stage; 8
microbatches of 4 x 1,024 tokens, bf16; forward only) through
``parallel.pipeline.pipeline_apply`` on a ``DeviceMesh`` of a fake
process group of 512 ranks, on fake tensors.

The fake group makes this process one rank, so the trace runs once for
each stage (as that stage's first rank) and reports the largest of them:
the FLOPs and hand-offs a device makes. The hand-offs are
``dist.batch_isend_irecv`` sends and receives, counted by
``pipeline.HANDOFFS`` (no dispatch mode sees them); their wire bytes are
the bytes a device sends. The reference counts ``collective-permute``
ops instead, one a tick.

  PYTHONPATH=src python -m repro_torch.launch.dryrun_pipeline [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..parallel import pipeline as PP
from . import cost_analysis as CA
from .dryrun import fake_group
from .mesh import device_mesh, make_mesh

__all__ = ["CONFIG", "stage_fn", "run", "main"]

CONFIG = {"n_stages": 4, "repl": 128, "d": 4096, "ff": 16384,
          "layers_per_stage": 8, "n_micro": 8, "mb": 4, "seq": 1024}


def stage_fn(pl_params, x):
    """A stage's dense stack: h + tanh(h @ wi) @ wo a layer."""
    wi, wo = pl_params
    for j in range(wi.shape[0]):
        x = x + torch.tanh(x @ wi[j]) @ wo[j]
    return x


def _trace_stage(rank: int, device: str, c) -> dict:
    """One trace as global rank ``rank``: its FLOPs, traffic and
    hand-offs."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    P, n_micro = c["n_stages"], c["n_micro"]
    n = P * c["repl"]
    with fake_group(n, rank=rank):
        dmesh = device_mesh(make_mesh((P, c["repl"]), ("stage", "repl")),
                            device)
        for k in PP.HANDOFFS:
            PP.HANDOFFS[k] = [0, 0]
        with FakeTensorMode():
            bf = torch.bfloat16
            wi = torch.empty((P, c["layers_per_stage"], c["d"], c["ff"]),
                             dtype=bf, device=device)
            wo = torch.empty((P, c["layers_per_stage"], c["ff"], c["d"]),
                             dtype=bf, device=device)
            x = torch.empty((n_micro * c["mb"], c["seq"], c["d"]), dtype=bf,
                            device=device)
            with CA.CostCounter(tag_ops=False) as counter:
                PP.pipeline_apply(dmesh, stage_fn, (wi, wo), x,
                                  n_micro=n_micro)
    return {"stage": rank // c["repl"], "flops": counter.flops,
            "traffic": counter.traffic,
            "sends": PP.HANDOFFS["send"][0],
            "recvs": PP.HANDOFFS["recv"][0],
            "send_bytes": PP.HANDOFFS["send"][1],
            "recv_bytes": PP.HANDOFFS["recv"][1]}


def run(device: str = "cuda", config=None) -> dict:
    c = dict(CONFIG, **(config or {}))
    t0 = time.time()
    stages = [_trace_stage(s * c["repl"], device, c)
              for s in range(c["n_stages"])]
    P, M = c["n_stages"], c["n_micro"]
    wire = max(st["send_bytes"] for st in stages)
    return {
        "status": "ok", "stages": P, "n_micro": M,
        "compile_s": round(time.time() - t0, 1),
        "collective_permutes": max(st["sends"] for st in stages),
        "p2p_handoffs_pd": max(st["sends"] + st["recvs"] for st in stages),
        "permute_wire_GB_pd": round(wire / 1e9, 2),
        "flops_per_device": max(st["flops"] for st in stages),
        "gpipe_bubble_fraction": round(PP.bubble_fraction(P, M), 3),
        "per_stage": stages,
        "roofline": CA.roofline(max(st["flops"] for st in stages),
                                max(st["traffic"] for st in stages), wire,
                                0.0, P * c["repl"]),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    rec = run(args.device)
    print(json.dumps({k: v for k, v in rec.items()
                      if k not in ("per_stage", "roofline")}))
    return rec


if __name__ == "__main__":
    main()
