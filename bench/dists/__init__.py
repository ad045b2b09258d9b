"""Request distributions, one module each, found by the name a traffic file
gives. A module holds ``draw(rng, n_keys, shape, params, device) -> int64
[shape]``: ``shape[0]`` batches of ``shape[1]`` indices into the loaded
keys, drawn with the numpy generator ``rng`` (so the same seed gives the
same requests on every machine) and returned as a tensor on ``device``.
``params`` is the traffic file's ``distribution`` object.
"""
import importlib


def load(name: str):
    """The distribution module called ``name``."""
    return importlib.import_module(f"bench.dists.{name}")
