"""Carry a tree built elsewhere into the port.

:func:`tree_from_numpy` turns a tree given as plain numpy data — its
``TreeConfig`` fields and its ``TreeArrays`` fields, keyed by the
reference's field names — into the port's :class:`FBTree` on one device.
It lets code read trees the reference package built (tests make the numpy
side with ``jax.device_get``) without this package importing it.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from .fbtree import FBTree, Level, TreeArrays, TreeConfig, resolve_target

__all__ = ["tree_from_numpy"]

_TORCH_DTYPES = {
    np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8, np.dtype(np.bool_): torch.bool,
    np.dtype(np.float32): torch.float32,
}


def _torch_dtype(dt) -> torch.dtype:
    if isinstance(dt, torch.dtype):
        return dt
    try:
        return _TORCH_DTYPES[np.dtype(dt)]
    except (TypeError, KeyError):
        raise ValueError(f"tree_from_numpy: unsupported val_dtype {dt!r}")


def _tensor(a, dev: torch.device) -> torch.Tensor:
    # np.array copies: the source may be read-only, and keeps 0-d scalars 0-d
    return torch.from_numpy(np.array(a)).to(dev)


def _level(d: Mapping, dev: torch.device) -> Level:
    return Level(*(_tensor(d[f], dev)
                   for f in Level._fields))


def tree_from_numpy(config_fields: Mapping, arrays: Mapping,
                    target: Optional[str] = None) -> FBTree:
    """Build an :class:`FBTree` from numpy data.

    ``config_fields`` holds the ``TreeConfig`` fields (``val_dtype`` may be
    a numpy-compatible dtype; it becomes the matching torch dtype).
    ``arrays`` holds every ``TreeArrays`` field as a numpy array, except
    ``levels`` (a list of per-level dicts keyed by ``Level`` field names)
    and ``stacked`` (one such dict). ``target`` follows
    :func:`repro_torch.core.fbtree.bulk_build`: ``None`` is the card.
    """
    dev = resolve_target(target)
    cfg_kw = dict(config_fields)
    cfg_kw["val_dtype"] = _torch_dtype(cfg_kw.get("val_dtype", torch.int32))
    cfg_kw["level_caps"] = tuple(int(c) for c in cfg_kw["level_caps"])
    cfg = TreeConfig(**cfg_kw)
    out = {}
    for f in TreeArrays._fields:
        if f == "levels":
            out[f] = tuple(_level(d, dev) for d in arrays[f])
        elif f == "stacked":
            out[f] = _level(arrays[f], dev)
        else:
            out[f] = _tensor(arrays[f], dev)
    out["leaf_val"] = out["leaf_val"].to(cfg.val_dtype)
    return FBTree(cfg, TreeArrays(**out))
