"""Serving entry point: batched requests through the Engine + FB+-tree prefix
cache — the port's counterpart of ``repro.launch.serve``. Like it, it
serves an arch's reduced (``SMOKE``) config with random weights; it runs
on the card unless asked for the CPU:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \\
      --requests 24 --shared-prefix 48 [--device cpu]

Any decoder-only GQA arch of the registry serves, the MoE llama4-scout
included (``--arch llama4-scout-17b-a16e``); an MLA arch (deepseek-v3) is
refused by the engine, whose page store holds GQA pages, and so are the
vlm (paligemma-3b) and enc-dec (whisper-medium) families, as the
reference's engine refuses them. Those three are served through
``models.lm.prefill`` and ``models.lm.decode_step``, the vlm with its
image patches (``batch["patches"]``, decode positions counting them), the
enc-dec with its frames (``batch["frames"]``, encoded once in the
prefill); ``chip_smoke.py``'s ``serve-moe``, ``serve-vlm`` and
``serve-whisper`` phases do so on the card at full width, and
``chip_smoke.rehearse_serve_vlm()`` / ``rehearse_serve_whisper()`` on the
CPU at SMOKE size. ``--full`` serves
the published widths instead of ``SMOKE``'s (on the card; ``--layers``
cuts the depth so the weights fit, e.g. llama4-scout at 8 layers is ~39 GB
of bf16 weights):

  python -m repro_torch.launch.serve --arch llama4-scout-17b-a16e --full \\
      --layers 8 --prompt-len 3072 --shared-prefix 2048 --requests 8

The page store holds every block of the requests (``--pages``, at least
512 as the reference's), so nothing is evicted: the engine, like the
reference's, does not pin the pages a wave matched, and a publish that
evicted one before its load would load another block's KV. A smaller
``--pages`` is refused.
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

__all__ = ["make_requests", "pages_needed", "main"]

BLOCK_TOKENS = 16


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


def pages_needed(n_requests: int, prompt_len: int,
                 block_tokens: int = BLOCK_TOKENS) -> int:
    """Pages for every full block of every request: a run over this many
    never evicts."""
    return n_requests * (prompt_len // block_tokens)


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
    ap.add_argument("--full", action="store_true",
                    help="the arch's published widths, not its SMOKE config")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--pages", type=int, default=None,
                    help="page store size (default: every block of the "
                         "requests, at least 512)")
    args = ap.parse_args(argv)
    need = pages_needed(args.requests, args.prompt_len)
    if args.pages is None:
        args.pages = max(512, need)
    elif args.pages < need:
        ap.error(f"--pages {args.pages} cannot hold the requests' {need} "
                 f"blocks; the engine does not pin matched pages, so an "
                 f"eviction could load another block's KV")
    dev = resolve_target(args.device)
    over = {} if args.layers is None else {"n_layers": args.layers}
    cfg = get_config(args.arch, smoke=not args.full, **over)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init_params(cfg, gen)
    scfg = ServeConfig(max_batch=args.max_batch,
                       s_max=args.prompt_len + args.max_new + 8,
                       block_tokens=BLOCK_TOKENS, n_pages=args.pages,
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
        "pages": args.pages,
        "all_done": all(r.done for r in done),
        "new_tokens": toks,
        "tok_per_s": round(toks / dt, 1),
        "prefix_hit_rate": round(eng.prefix.hit_rate(), 3),
        "tree_stats": eng.prefix.stats,
        "decode_steps": eng.steps,
    }))


if __name__ == "__main__":
    main()
