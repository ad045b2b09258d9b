"""Run the control of a cell on the card: the reference with one guarantee
broken (``reference/control.py``: lookups answered by leaf and hash tag
alone, without the full-key compare) put in the program's place, through
the same window, traffic and judge as a benchmark run:

    python3 bench/control.py --workload ycsb-c --seconds 3 --seeds 1 2 3

Prints one JSON line a seed with the numbers the judge compared. Every
seed has to come out not correct. The benchmark's own runs never run it.
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402
from bench.reference.control import HashtagOnly  # noqa: E402


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    cell = harness.Cell(a.workload)
    for seed in a.seeds:
        res = harness.run_cell(cell, seed, a.seconds, False,
                               system=HashtagOnly)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "system": HashtagOnly.name,
                          "correct": res["correct"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
