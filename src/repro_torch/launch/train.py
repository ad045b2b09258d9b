"""End-to-end training loop: data pipeline -> train step ->
checkpoint/restart with watchdog and optional failure injection — the
port's counterpart of ``repro.launch.train``. It runs on the card unless
asked for the CPU. Each step runs under ``parallel.sharding.ShardCtx`` of
the mesh with ``shard`` as the train step's hook, as the reference's
does; on the one-device mesh every placement is the whole tensor.

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --smoke \\
      --steps 50 --batch 8 --seq 128 --ckpt /tmp/ck --inject-failure 23 \\
      [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ..configs import get_config
from ..models.config import ModelConfig
from ..parallel import sharding as SH
from ..train import checkpoint as CK
from ..train import ft
from ..train import optim as O
from ..train.data import DataConfig, TokenStream
from ..train.train_step import init_state, make_train_step, state_template
from .mesh import make_local_mesh

__all__ = ["train_loop", "main"]


def train_loop(cfg: ModelConfig, steps: int, batch: int, seq: int,
               ckpt_dir=None, save_every: int = 50, lr: float = 1e-3,
               inject_failure=None, mesh=None, log_every: int = 10,
               seed: int = 0, n_micro: int = 1, compress: bool = False):
    """Train ``cfg`` for ``steps`` steps of ``TokenStream`` batches on
    ``mesh``'s device (``make_local_mesh()``: the card). The state starts
    from ``init_state`` under a generator seeded with ``seed``, or from the
    newest checkpoint under ``ckpt_dir``. Returns the reference's dict
    (losses by step, restarts, stragglers and the final state) and the
    watchdog's step ``durations`` in seconds, each ending in the step's
    ``float(loss)``, which waits for the device."""
    ocfg = O.OptConfig(lr=lr, warmup=min(20, steps // 5 or 1),
                       total_steps=steps)
    mesh = mesh or make_local_mesh()
    dev = mesh.device
    ctx = SH.ShardCtx(mesh)
    data = TokenStream(DataConfig(vocab=cfg.vocab, global_batch=batch,
                                  seq_len=seq, seed=seed), cfg)
    step_fn = make_train_step(cfg, ocfg, shard=SH.shard, n_micro=n_micro,
                              compress=compress)
    watchdog = ft.Watchdog()
    plan = ft.FailurePlan({inject_failure: "worker-loss"}
                          if inject_failure is not None else {})
    losses = {}

    state_box = {}

    def make_runner(start_step: int):
        state_box.pop("state", None)       # free the old state first
        if ckpt_dir and CK.latest_step(ckpt_dir) is not None:
            state, _ = CK.restore(ckpt_dir, state_template(cfg, ocfg),
                                  device=dev)
        else:
            state = init_state(cfg, ocfg,
                               torch.Generator(device=dev).manual_seed(seed))
        state_box["state"] = state

        def run_one(step: int) -> float:
            plan.check(step)
            b = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch_at(step).items()}
            with ctx:
                state_box["state"], metrics = step_fn(state_box["state"], b)
            loss = float(metrics["loss"])
            losses[step] = loss
            if step % log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.2f}", flush=True)
            return loss
        return run_one

    def saver(step: int):
        if ckpt_dir:
            state_box["writer"] = CK.save(ckpt_dir, step, state_box["state"],
                                          keep=3, async_=True)

    def restorer() -> int:
        if ckpt_dir:
            s = CK.latest_step(ckpt_dir)
            return s if s is not None else 0
        return 0

    log = ft.run_with_restarts(steps, make_runner, save_every, saver,
                               restorer, watchdog=watchdog)
    if ckpt_dir:
        # the last async write may be of this same step: let it finish
        # first (the reference's loop races two writers on one .tmp dir)
        if "writer" in state_box:
            state_box["writer"].join()
        CK.save(ckpt_dir, steps, state_box["state"], keep=3, async_=False)
    return {"losses": losses, "restarts": log["restarts"],
            "stragglers": watchdog.stragglers,
            "durations": watchdog.durations,
            "state": state_box["state"]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--inject-failure", type=int, default=None)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--vocab", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.vocab:
        cfg = dataclasses.replace(cfg, vocab=args.vocab)
    t0 = time.time()
    out = train_loop(cfg, args.steps, args.batch, args.seq,
                     ckpt_dir=args.ckpt, save_every=args.save_every,
                     lr=args.lr, inject_failure=args.inject_failure,
                     mesh=make_local_mesh(device=args.device),
                     n_micro=args.n_micro, compress=args.compress)
    ls = sorted(out["losses"].items())
    first = np.mean([l for _, l in ls[:5]])
    last = np.mean([l for _, l in ls[-5:]])
    print(json.dumps({"first5_loss": round(float(first), 4),
                      "last5_loss": round(float(last), 4),
                      "restarts": len(out["restarts"]),
                      "wall_s": round(time.time() - t0, 1)}))


if __name__ == "__main__":
    main()
