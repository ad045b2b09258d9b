"""Carry model parameters, or a whole train state, between the reference
and the port.

:func:`params_from_numpy` turns a tree given as nested dicts of numpy
arrays (the reference's pytree after ``jax.device_get``) into the port's
dict of tensors, key for key; :func:`params_to_numpy` is its inverse, for
the tests. Any such tree goes across: the parameters, or the train state
``{"params", "opt", "error_fb"}`` with AdamW's ``m``, ``v``, ``master`` or
Adafactor's ``vr``, ``vc``, and the int32 scalar ``step`` (a 0-d tensor
here, a 0-d array there), so both packages can start from one state.
bf16 arrays arrive as ``ml_dtypes.bfloat16`` numpy arrays, which
``torch.from_numpy`` refuses, so they travel as their 16-bit patterns
(``int16`` views), bit for bit. The MoE trees (the float32 ``router``, the
``router_bias`` buffer, stacked experts, the ``mtp`` subtree) are such
trees too, and so are the vlm's ``proj`` and the enc-dec's ``enc`` and
``dec_pos``. :func:`cache_from_numpy` and :func:`cache_to_numpy` carry a
decode cache (the reference's ``KVCache``, ``MLACache`` or ``MambaState``,
a named tuple of arrays; the enc-dec's dict of a ``KVCache`` and two
arrays; the hybrid's dict of ``MambaState``s and a ``KVCache``) across to
the port's of the same fields and back.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .layers import Params

__all__ = ["params_from_numpy", "params_to_numpy", "cache_from_numpy",
           "cache_to_numpy"]


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    # np.array copies: the source may be read-only
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree: Mapping, device) -> Params:
    """Nested dicts of numpy arrays (params or a train state) -> the same
    dicts of tensors on ``device``, dtypes kept."""
    return {k: params_from_numpy(v, device) if isinstance(v, Mapping)
            else _tensor(v, device) for k, v in tree.items()}


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes    # comes with the reference's numpy side only
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(params: Params) -> dict:
    """The inverse of :func:`params_from_numpy`: tensors -> numpy arrays
    (bf16 as ``ml_dtypes.bfloat16``)."""
    return {k: params_to_numpy(v) if isinstance(v, Mapping) else _array(v)
            for k, v in params.items()}


def _cache_kinds() -> dict:
    """The port's cache named tuples by their fields."""
    from .attention import KVCache
    from .mamba import MambaState
    from .mla import MLACache
    return {kind._fields: kind for kind in (KVCache, MLACache, MambaState)}


def cache_from_numpy(cache, device):
    """A reference decode cache (``KVCache(k, v)``, ``MLACache(ckv,
    krope)`` or ``MambaState(conv, ssm)`` of arrays, or a dict of such
    tuples and arrays: the enc-dec's ``{"self": KVCache, "cross_k",
    "cross_v"}``, the hybrid's ``{"grp": MambaState, "attn": KVCache,
    "tail": MambaState}``) -> the port's cache of those fields, tensors on
    ``device``, bit for bit. The tuple's fields say which it is."""
    if isinstance(cache, Mapping):
        return {k: cache_from_numpy(v, device) if hasattr(v, "_fields")
                else _tensor(np.asarray(v), device) for k, v in cache.items()}
    kind = _cache_kinds()[tuple(cache._fields)]
    return kind(*(_tensor(np.asarray(a), device) for a in cache))


def cache_to_numpy(cache) -> dict:
    """A port cache (``KVCache``, ``MLACache`` or ``MambaState``) ->
    {field: numpy array} (bf16 as ``ml_dtypes.bfloat16``); the enc-dec's
    and the hybrid's dicts -> the same keys, each named tuple as such a
    dict."""
    if isinstance(cache, Mapping):
        return {k: cache_to_numpy(v) if hasattr(v, "_fields") else _array(v)
                for k, v in cache.items()}
    return {f: _array(t) for f, t in zip(cache._fields, cache)}
