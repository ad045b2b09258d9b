#!/usr/bin/env python3
"""Check and time versions of K5, the flash-attention kernel, on the card.

Versions run in turns, at the shapes the served paths give K5.

Each version is a CUDA source with K5's C interface, given as ``name=path``
(default: the checkout's ``src/repro_torch/csrc/flash_attention.cu``). For
each version, one JSON line each:

- its SASS (``cuobjdump -sass``) per function: the highest register a
  kernel names, its local-memory stores (spills), its HGMMA and MUFU.EX2
  counts and ``sass_sha``, a hash of its instructions with addresses,
  encodings and branch-label numbers taken out; with several versions, a
  ``sass_same`` line names, for each function of the first, the functions
  of the others whose instructions are the same;
- checks: v = the identity (head dims 64, 128, (192, 128) and 256, causal
  and not: the register layout of p and the descriptor of the transposed
  v) and ``chip_smoke.k5_sweep`` in bf16 and float32, each as its worst
  error over the bound (a version that refuses a width reports the error);
- times, in the order a, b, ..., b, a, at each shape of ``--shapes``
  (``chip_smoke.k5_timing`` with the shape's mask: kernel, plain version
  and ``scaled_dot_product_attention``, CUDA-event medians of ``--runs``;
  a version that refuses a shape skips it):
  ``yi`` yi-9b's prefill (S = T = 3,072, 32 query and 4 kv heads, head dim
  128, causal) and ``yi-full`` the same without a mask; ``mla``
  deepseek-v3's layer 0 (3,072 tokens, 128 heads, q/k 192, v 128);
  ``vlm`` paligemma-3b's served prefill (4 x (256 patches + 2,048 text
  tokens), 8 query heads and 1 kv head of 256, the prefix-LM mask over
  256) and ``vlm-8k`` one 8,192-token sequence of it; ``enc`` whisper-
  medium's encoder (2 x 32,768 frames, 16 heads of 64, no mask) and
  ``cross`` its cross attention (2 x 256 decoder tokens over 32,768
  frames).

Inputs are bf16, drawn from a generator seeded with ``--seed``. Run on a
machine with a card, from the checkout's root:
``python3 tools/k5_bench.py [name=path ...] [--shapes yi,mla,...]
[--no-time]``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402


def _sass_sha(sec: str) -> str:
    """A hash of one function's instructions: each ``/*addr*/ INSTR ;``
    without its address and encoding, branch labels numbered from 0 in
    the order they appear (the library numbers them across functions)."""
    labels = {}
    ins = []
    for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", sec):
        ins.append(re.sub(r"\.L_x_\d+", lambda x: labels.setdefault(
            x.group(0), f".L{len(labels)}"), m.group(1).strip()))
    return hashlib.sha256("\n".join(ins).encode()).hexdigest()[:16]


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
                          mufu_ex2=sec.count("MUFU.EX2"),
                          sass_sha=_sass_sha(sec)))
    return stats


# (q/k head dim, v head dim): v is the hv x hv identity over T = hv keys
IDENTITY = ((128, 128), (64, 64), (192, 128), (256, 256))


def identity_checks(cuda, cs, gen) -> dict:
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    out = {}
    for hd, hv in IDENTITY:
        for causal in (False, True):
            q = torch.randn((1, 200, hd), generator=gen,
                            device="cuda").bfloat16()
            k = torch.randn((1, hv, hd), generator=gen,
                            device="cuda").bfloat16()
            v = torch.eye(hv, device="cuda", dtype=torch.bfloat16)[None]
            kw = dict(scale=hd ** -0.5, kv_len=hv, causal=causal, window=0,
                      prefix_len=0)
            name = f"{hd}_{hv}_{'causal' if causal else 'full'}"
            try:
                got, _ = cuda.launch(q[:, None], k[:, None], v[:, None],
                                     n_rep=1, **kw)
            except (RuntimeError, ValueError) as e:
                out[name] = f"refused: {e}"
                continue
            want = flash_attention_ref(q, k, v, **kw)
            out[name] = cs._err_over_tol(
                got[:, :, 0], want, cs.k5_tolerance(q, k, v, want, **kw))[
                    "max_err_over_tol"]
    return out


# name: (B, S, T, H, Hk, hd, hv, mask)
SHAPES = {
    "yi": (1, 3072, 3072, 32, 4, 128, 128, ("causal", 0, 0)),
    "yi-full": (1, 3072, 3072, 32, 4, 128, 128, ("full", 0, 0)),
    "mla": (1, 3072, 3072, 128, 128, 192, 128, ("causal", 0, 0)),
    "vlm": (4, 2304, 2304, 8, 1, 256, 256, ("causal", 0, 256)),
    "vlm-8k": (1, 8192, 8192, 8, 1, 256, 256, ("causal", 0, 256)),
    "enc": (2, 32768, 32768, 16, 16, 64, 64, ("full", 0, 0)),
    "cross": (2, 256, 32768, 16, 16, 64, 64, ("full", 0, 0)),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("versions", nargs="*", metavar="name=path")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--runs", type=int, default=25)
    p.add_argument("--shapes", default="yi,yi-full,mla",
                   help=f"comma-separated, of {','.join(SHAPES)}")
    p.add_argument("--no-time", action="store_true",
                   help="SASS and checks only")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("k5_bench: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.flash_attention import cuda
    from repro_torch.models.attention import MaskSpec

    versions = dict(v.split("=", 1) for v in args.versions) or {
        "checkout": str(cuda.SOURCE)}
    versions = {k: Path(v).resolve() for k, v in versions.items()}
    nvcc.build(list(versions.values()))

    def use(path):
        cuda.SOURCE, cuda._FN = path, None

    print(json.dumps({"card": cs._smi(), "torch": torch.__version__}))
    sass = {}
    for name, path in versions.items():
        sass[name] = sass_stats(nvcc.library_path(path))
        for st in sass[name]:
            print(json.dumps({"version": name, **st}))
    names = list(versions)
    for st in sass[names[0]]:
        print(json.dumps({"sass_same": st["fn"], **{
            n: [o["fn"] for o in sass[n] if o["sass_sha"] == st["sass_sha"]]
            for n in names[1:]}}))
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for name, path in versions.items():
        use(path)
        line = {"version": name,
                "identity_err_over_tol": identity_checks(cuda, cs, gen)}
        for dt in (torch.bfloat16, torch.float32):
            try:
                sw = cs.k5_sweep(torch.device("cuda"), dt, args.seed)
                line[f"sweep_{dt}"] = dict(
                    err_over_tol=sw["max_err_over_tol"],
                    failed_cases=sw["failed_cases"])
            except (RuntimeError, ValueError) as e:
                line[f"sweep_{dt}"] = f"refused: {e}"
        print(json.dumps(line), flush=True)
    if args.no_time:
        return 0
    for shape in args.shapes.split(","):
        B, S, T, H, Hk, hd, hv, mask = SHAPES[shape]
        q = torch.randn((B, S, H, hd), generator=gen, device="cuda").bfloat16()
        k = torch.randn((B, T, Hk, hd), generator=gen, device="cuda").bfloat16()
        v = torch.randn((B, T, Hk, hv), generator=gen, device="cuda").bfloat16()
        for name in names + names[::-1]:
            use(versions[name])
            try:
                t = cs.k5_timing(q, k, v, H // Hk, args.runs,
                                 mask=MaskSpec(*mask), plain_runs=1,
                                 metric=f"k5_bench_{shape}")
            except (RuntimeError, ValueError) as e:
                print(json.dumps({"version": name, "shape": shape,
                                  "refused": str(e)}), flush=True)
                continue
            print(json.dumps({"version": name, "shape": shape, **{
                k: t[k] for k in ("ms", "min_ms", "max_ms", "plain_ms",
                                  "library_ms", "library_backend",
                                  "bound_ms", "bound_share",
                                  "tflops_per_s")}}), flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
