"""Train a small LM end to end through the PyTorch/CUDA port, as
``examples/train_lm.py`` does: the synthetic pipeline, async
checkpointing, an injected worker failure at step 60 (auto-restart from
the latest checkpoint) and the straggler watchdog.

  PYTHONPATH=src python examples/train_lm_torch.py [--steps 200] [--device cpu]

(A reduced qwen3-family model; on the card its attention runs the
flash-attention kernel where a sequence is long enough.)
"""
import argparse
import dataclasses
import json
import tempfile

import numpy as np

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.train import train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a new temporary one)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    cfg = get_config("qwen3-14b", smoke=True)
    cfg = dataclasses.replace(cfg, n_layers=4, d_model=128, d_ff=384,
                              vocab=2048, n_heads=8, n_kv_heads=4,
                              head_dim=16)
    ck = args.ckpt or tempfile.mkdtemp(prefix="fbtree_train_ck_")
    out = train_loop(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                     ckpt_dir=ck, save_every=25, lr=2e-3,
                     inject_failure=min(60, args.steps - 2),
                     mesh=make_local_mesh(device=args.device))
    ls = sorted(out["losses"].items())
    print(json.dumps({
        "first5": round(float(np.mean([l for _, l in ls[:5]])), 3),
        "last5": round(float(np.mean([l for _, l in ls[-5:]])), 3),
        "restarts": out["restarts"],
        "stragglers_flagged": len(out["stragglers"]),
        "ckpt_dir": ck,
    }, indent=1))


if __name__ == "__main__":
    main()
