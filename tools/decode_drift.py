#!/usr/bin/env python3
"""Where a mamba1 model's decode step departs from its forward, layer by
layer, on the card.

One sequence of ``--tokens`` tokens (drawn from ``--seed`` as
``chip_smoke._inputs`` draws them) goes through falcon-mamba-7b's layers
twice: the teacher-forced forward over all of them, and a decode step of
the last token from each layer's prefill state of the tokens before it.
Each layer's input to the decode step is the decode path's own output of
the layer before, so differences compound as they do in
``lm.decode_step``. It prints one JSON line for layer 0's intermediates
(the block input, the in_proj product, the conv after silu, dt) and one a
layer (max |diff| of the block's output at that token, how many of its
d_model entries differ, the largest entry), then the card's name and
power limit. Run on the card:

    python3 tools/decode_drift.py [--arch falcon-mamba-7b] [--dtype bfloat16]

``--smoke --device cpu --tokens 300`` rehearses it on the CPU at SMOKE
size.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _diff(a, b) -> dict:
    a, b = a.float(), b.float()
    return dict(max_abs_diff=float((a - b).abs().max()),
                n_diff=int((a != b).sum()), numel=a.numel(),
                max_abs=float(b.abs().max()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="falcon-mamba-7b")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--tokens", type=int, default=2100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import blocks as BLK
    from repro_torch.models import lm
    from repro_torch.models import mamba as M
    from repro_torch.models.layers import apply_norm
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("decode_drift: no CUDA device", file=sys.stderr)
        return 2
    cfg = get_config(args.arch, smoke=args.smoke, param_dtype=args.dtype)
    if cfg.family != "ssm" or cfg.ssm_version != 1:
        print(f"decode_drift: {args.arch} is not a mamba1 stack",
              file=sys.stderr)
        return 2
    p = lm.init_params(cfg, torch.Generator(device=dev)
                       .manual_seed(args.seed))
    toks = cs._inputs(cfg, 1, args.tokens, 0, args.seed + 2, dev)["tokens"]
    n = args.tokens - 1
    with torch.inference_mode():
        x = p["embed"][toks.long()]
        xd = x[:, n:n + 1].clone()
        for j in range(cfg.n_layers):
            pl = lm.layer_params(p["seg0"], j)
            mx = pl["mixer"]
            h = apply_norm(x, pl["ln1"], cfg.norm, cfg.norm_eps)
            hd = apply_norm(xd, pl["ln1"], cfg.norm, cfg.norm_eps)
            _, st = M.mamba1_forward(mx, cfg, h[:, :n])
            if j == 0:
                ins = M.mamba1_inputs(mx, cfg, h)
                xm = (hd[:, 0] @ mx["in_proj"])[..., :cfg.d_inner]
                conv = torch.cat([st.conv[:, :, 1:], xm[:, :, None]], dim=-1)
                xc = F.silu(M._conv_step(conv, mx["conv_w"], mx["conv_b"]))
                dbl = xc @ mx["x_proj"]
                dt = M._softplus(dbl[..., :cfg.dtr] @ mx["dt_w"]
                                 + mx["dt_b"]).float()
                print(json.dumps({
                    "layer0": True,
                    "input": _diff(hd[:, 0], h[:, n]),
                    "in_proj": _diff(hd[:, 0] @ mx["in_proj"],
                                     (h @ mx["in_proj"])[:, n]),
                    "conv_silu": _diff(xc, ins[3][:, n].to(xc.dtype)),
                    "dt": _diff(dt, ins[0][:, n])}), flush=True)
            y, _ = BLK.block_forward(pl, cfg, "mamba1", x, None, None)
            yd, _ = BLK.block_decode(pl, cfg, "mamba1", xd, None,
                                     M.MambaState(st.conv.clone(),
                                                  st.ssm.clone()))
            print(json.dumps({"layer": j, **_diff(yd[:, 0], y[:, n])}),
                  flush=True)
            x, xd = y, yd
    print(cs._smi() if dev.type == "cuda" else "cpu", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
