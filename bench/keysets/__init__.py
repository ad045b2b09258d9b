"""Key sets, one module each, found by the name a configuration gives.

A module holds ``WIDTH`` (bytes of the fixed-width key row) and
``generate(n, seed, device) -> (kb uint8 [n, WIDTH], kl int32 [n])``: the
keys of records ``0 .. n - 1``, distinct and zero-padded, record ``i`` in
row ``i``, as tensors on ``device``. The same seed gives the same keys;
a key set whose source names its keys without a seed ignores it.
"""
import importlib


def load(name: str):
    """The key-set module called ``name``."""
    return importlib.import_module(f"bench.keysets.{name}")
