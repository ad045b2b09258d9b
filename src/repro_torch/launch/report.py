"""Markdown tables from dry-run and perf-iteration records — the port's
own copy of ``repro.launch.report``: the same tables, row for row, from
the same records.

  PYTHONPATH=src python -m repro_torch.launch.report \\
      [--single out/dryrun_single.json] [--multi out/dryrun_multi.json] \\
      [--perf out/perf_iters.jsonl] > tables.md
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

__all__ = ["dryrun_rows", "render", "main"]


def _load(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        if path.endswith(".jsonl"):
            return [json.loads(l) for l in f if l.strip()]
        return json.load(f)


def _md_table(rows: List[Dict], cols: List[str]) -> str:
    out = ["| " + " | ".join(cols) + " |",
           "|" + "|".join("---" for _ in cols) + "|"]
    for r in rows:
        out.append("| " + " | ".join(str(r.get(c, "")) for c in cols) + " |")
    return "\n".join(out)


def _fmt(x, nd=2):
    if isinstance(x, float):
        if x != 0 and (abs(x) < 0.001 or abs(x) >= 10000):
            return f"{x:.2e}"
        return f"{x:.{nd}f}"
    return x


def dryrun_rows(recs, include_mem=False):
    rows = []
    for r in recs:
        row = {"arch": r["arch"], "shape": r["shape"]}
        if r["status"] == "skipped":
            row.update(status="skip", note="sub-quadratic attn required")
        elif r["status"] == "error":
            row.update(status="ERR", note=str(r.get("error"))[:60])
        else:
            rf = r["roofline"]
            row.update(
                status="ok",
                compile_s=_fmt(r["compile_s"], 1),
                Tcomp_s=_fmt(rf["compute_s"], 3),
                Tmem_s=_fmt(rf["memory_s"], 3),
                Tcoll_s=_fmt(rf["collective_s"], 3),
                dominant=rf["dominant"],
                useful=_fmt(rf["useful_flop_ratio"], 3),
                mfu_bound=_fmt(rf["mfu_bound"], 4),
            )
            if include_mem and r.get("memory_analysis"):
                m = r["memory_analysis"]
                gb = (m.get("argument_size_in_bytes", 0)
                      + m.get("temp_size_in_bytes", 0)) / 2**30
                row["dev_GiB"] = _fmt(gb, 1)
        rows.append(row)
    return rows


def render(single, multi, perf) -> str:
    """The tables the reference's ``main`` prints after its first line."""
    out = ["", "### Dry-run table — single pod (16×16 = 256 chips)\n"]
    cols = ["arch", "shape", "status", "compile_s", "dev_GiB", "Tcomp_s",
            "Tmem_s", "Tcoll_s", "dominant", "useful", "mfu_bound"]
    out.append(_md_table(dryrun_rows(single, include_mem=True), cols))
    out.append("\n### Dry-run table — multi-pod (2×16×16 = 512 chips)\n")
    out.append(_md_table(dryrun_rows(multi, include_mem=True), cols))
    if perf:
        out.append("\n### Perf-iteration log (hillclimbed cells)\n")
        rows = []
        for r in perf:
            if r["status"] != "ok":
                rows.append({"iter": r["iter"], "status": "ERR",
                             "note": str(r.get("error"))[:60]})
                continue
            rf = r["roofline"]
            rows.append({
                "iter": r["iter"], "status": "ok",
                "Tcomp_s": _fmt(rf["compute_s"], 2),
                "Tmem_s": _fmt(rf["memory_s"], 2),
                "Tcoll_s": _fmt(rf["collective_s"], 2),
                "bound_s": _fmt(rf["bound_step_s"], 2),
                "dominant": rf["dominant"],
                "useful": _fmt(rf["useful_flop_ratio"], 3),
                "mfu_bound": _fmt(rf["mfu_bound"], 4),
            })
        out.append(_md_table(rows, ["iter", "status", "Tcomp_s", "Tmem_s",
                                    "Tcoll_s", "bound_s", "dominant",
                                    "useful", "mfu_bound"]))
    return "\n".join(out) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--single", default="out/dryrun_single.json")
    ap.add_argument("--multi", default="out/dryrun_multi.json")
    ap.add_argument("--perf", default="out/perf_iters.jsonl")
    args = ap.parse_args(argv)
    print("<!-- generated by repro_torch.launch.report -->")
    print(render(_load(args.single), _load(args.multi), _load(args.perf)),
          end="")


if __name__ == "__main__":
    main()
