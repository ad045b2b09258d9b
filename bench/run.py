"""Run one cell of the port's benchmark:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. Prints the result as one JSON line on standard output; exits with
another code than 0, and prints no result, where there is no card, too few
cards, or the port loaded JAX or the JAX package.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / sub)
# Compiled bytecode of everything the run imports (torch's thousands of
# modules above all) is kept inside the checkout, so that only the first
# run compiles it, also where the environment asks Python not to write
# bytecode or the installed packages ship none.
sys.dont_write_bytecode = False
sys.pycache_prefix = str(ROOT / "build" / "pycache")

from bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
