"""Serving layer: FB+-tree prefix cache, page pool, paged serving engine.

Stable public surface — import from here, not from the submodules:

    from repro_torch.serving import PrefixCache, PagePool, Engine, ...
"""
from .engine import Engine, Request, ServeConfig
from .pages import PagePool
from .prefix_cache import PrefixCache, chain_keys

__all__ = [
    "PrefixCache", "chain_keys",
    "PagePool",
    "Engine", "Request", "ServeConfig",
]
