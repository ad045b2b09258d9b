"""End-to-end serving example through the PyTorch/CUDA port: batched
requests with skewed shared prefixes through the port's Engine and its
FB+-tree prefix cache, with ``examples/serve_lm.py``'s arguments.

  PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]

Further arguments go to ``repro_torch.launch.serve`` (``--full``,
``--layers N``, ``--pages N``, ...).
"""
import sys

from repro_torch.launch import serve

ARGS = ["--arch", "yi-9b", "--requests", "24", "--prompt-len", "96",
        "--shared-prefix", "64", "--max-new", "12", "--max-batch", "4"]


def main(argv=None):
    serve.main(ARGS + list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
