#!/usr/bin/env python3
"""Check and time versions of K5, the flash-attention kernel, on the card.

Versions run in turns, at the shape the served path gives K5.

Each version is a CUDA source with K5's C interface, given as ``name=path``
(default: the checkout's ``src/repro_torch/csrc/flash_attention.cu``). For
each version, one JSON line each:

- its SASS (``cuobjdump -sass``): the highest register a bf16 kernel names,
  its local-memory stores (spills) and its HGMMA and MUFU.EX2 counts;
- checks: v = the identity (head dims 128 and 64, causal and not: the
  register layout of p and the descriptor of the transposed v) and
  ``chip_smoke.k5_sweep`` in bf16, each as its worst error over the bound;
- times, in the order a, b, ..., b, a: ``chip_smoke.k5_timing`` (causal,
  CUDA-event median of ``--runs``, beside ``scaled_dot_product_attention``)
  and the same widths with the full mask (kernel and library, CUDA events).

The inputs are yi-9b's prefill widths (S = T = 3,072, 32 query and 4 kv
heads, head dim 128, bf16), drawn from a generator seeded with ``--seed``.
Run on a machine with a card, from the checkout's root:
``python3 tools/k5_bench.py [name=path ...]``.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402


def sass_stats(lib: Path) -> list:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300).stdout
    stats = []
    for sec in out.split("Function : ")[1:]:
        name = sec.split("\n", 1)[0].strip()
        regs = [int(x) for x in re.findall(r"\bR(\d+)\b", sec)]
        stats.append(dict(fn=name, max_reg=max(regs, default=None),
                          stl=sec.count("STL"), hgmma=sec.count("HGMMA"),
                          mufu_ex2=sec.count("MUFU.EX2")))
    return stats


def identity_checks(cuda, cs, gen) -> dict:
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    out = {}
    for hd, causal in ((128, False), (128, True), (64, False)):
        q = torch.randn((1, 200, hd), generator=gen, device="cuda").bfloat16()
        k = torch.randn((1, hd, hd), generator=gen, device="cuda").bfloat16()
        v = torch.eye(hd, device="cuda", dtype=torch.bfloat16)[None]
        kw = dict(scale=hd ** -0.5, kv_len=hd, causal=causal, window=0,
                  prefix_len=0)
        got, _ = cuda.launch(q[:, None], k[:, None], v[:, None], n_rep=1,
                             **kw)
        want = flash_attention_ref(q, k, v, **kw)
        out[f"hd{hd}_{'causal' if causal else 'full'}"] = cs._err_over_tol(
            got[:, :, 0], want, cs.k5_tolerance(q, k, v, want, **kw))[
                "max_err_over_tol"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("versions", nargs="*", metavar="name=path")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--runs", type=int, default=25)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("k5_bench: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F
    import chip_smoke as cs
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.flash_attention import cuda, ops
    from repro_torch.models.attention import FULL

    versions = dict(v.split("=", 1) for v in args.versions) or {
        "checkout": str(cuda.SOURCE)}
    versions = {k: Path(v).resolve() for k, v in versions.items()}
    nvcc.build(list(versions.values()))

    def use(path):
        cuda.SOURCE, cuda._FN = path, None

    print(json.dumps({"card": cs._smi(), "torch": torch.__version__}))
    for name, path in versions.items():
        for st in sass_stats(nvcc.library_path(path)):
            print(json.dumps({"version": name, **st}))
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    B, S, H, Hk, hd = 1, 3072, 32, 4, 128
    q = torch.randn((B, S, H, hd), generator=gen, device="cuda").bfloat16()
    k = torch.randn((B, S, Hk, hd), generator=gen, device="cuda").bfloat16()
    v = torch.randn((B, S, Hk, hd), generator=gen, device="cuda").bfloat16()
    for name, path in versions.items():
        use(path)
        sweep = cs.k5_sweep(torch.device("cuda"), torch.bfloat16, args.seed)
        print(json.dumps({"version": name,
                          "identity_err_over_tol": identity_checks(cuda, cs,
                                                                   gen),
                          "sweep_err_over_tol": sweep["max_err_over_tol"],
                          "sweep_failures": len(sweep["failures"])}))
    qh = q.transpose(1, 2)
    kh = k.repeat_interleave(H // Hk, dim=2).transpose(1, 2)
    vh = v.repeat_interleave(H // Hk, dim=2).transpose(1, 2)
    full_flops = 2 * 2 * S * S * H * hd
    order = list(versions) + list(versions)[::-1]
    for name in order:
        use(versions[name])
        t = cs.k5_timing(q, k, v, H // Hk, args.runs)
        kern = lambda: ops.flash_sdpa(q, k, v, FULL, H // Hk, hd ** -0.5)
        lib = lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                     scale=hd ** -0.5)
        kern(), lib()
        f_ms, _ = cs._event_ms(kern, args.runs)
        l_ms, _ = cs._event_ms(lib, args.runs)
        print(json.dumps({"version": name, "causal_ms": t["ms"],
                          "causal_min_ms": t["min_ms"],
                          "causal_max_ms": t["max_ms"],
                          "causal_tflops": t["tflops_per_s"],
                          "causal_library_ms": t["library_ms"],
                          "full_ms": f_ms,
                          "full_tflops": full_flops / f_ms / 1e9,
                          "full_library_ms": l_ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
