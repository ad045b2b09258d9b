"""Serving entry point: batched requests through the Engine + FB+-tree prefix
cache — the port's counterpart of ``repro.launch.serve``. Like it, it
serves an arch's reduced (``SMOKE``) config with random weights; it runs
on the card unless asked for the CPU:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \\
      --requests 24 --shared-prefix 48 [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..configs import get_config
from ..core.fbtree import resolve_target
from ..models import lm
from ..serving import Engine, ServeConfig

__all__ = ["make_requests", "main"]


def make_requests(n: int, vocab: int, shared_prefix: int, plen: int,
                  n_families: int = 4, seed: int = 0):
    """Request mix with skewed shared prefixes (system prompts) — the
    paper's zipfian key distribution analogue. The same numpy draws as the
    reference, so one seed gives both packages the same prompts."""
    rng = np.random.default_rng(seed)
    fams = [rng.integers(0, vocab, size=shared_prefix) for _ in
            range(n_families)]
    out = []
    for i in range(n):
        fam = fams[int(rng.zipf(1.5)) % n_families]
        tail = rng.integers(0, vocab, size=plen - shared_prefix)
        out.append(np.concatenate([fam, tail]).astype(np.int32))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=96)
    ap.add_argument("--shared-prefix", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_target(args.device)
    cfg = get_config(args.arch, smoke=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init_params(cfg, gen)
    scfg = ServeConfig(max_batch=args.max_batch,
                       s_max=args.prompt_len + args.max_new + 8,
                       block_tokens=16, n_pages=512,
                       max_new_tokens=args.max_new)
    eng = Engine(cfg, params, scfg)
    reqs = make_requests(args.requests, cfg.vocab, args.shared_prefix,
                         args.prompt_len)
    t0 = time.time()
    done = eng.run(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    toks = sum(len(r.out) for r in done)
    print(json.dumps({
        "device": str(dev),
        "requests": len(done),
        "all_done": all(r.done for r in done),
        "new_tokens": toks,
        "tok_per_s": round(toks / dt, 1),
        "prefix_hit_rate": round(eng.prefix.hit_rate(), 3),
        "tree_stats": eng.prefix.stats,
        "decode_steps": eng.steps,
    }))


if __name__ == "__main__":
    main()
