"""Carry model parameters between the reference and the port.

:func:`params_from_numpy` turns a parameter tree given as nested dicts of
numpy arrays (the reference's pytree after ``jax.device_get``) into the
port's dict of tensors, key for key; :func:`params_to_numpy` is its
inverse, for the tests. bf16 arrays arrive as ``ml_dtypes.bfloat16`` numpy
arrays, which ``torch.from_numpy`` refuses, so they travel as their 16-bit
patterns (``int16`` views), bit for bit.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .layers import Params

__all__ = ["params_from_numpy", "params_to_numpy"]


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    # np.array copies: the source may be read-only
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree: Mapping, device) -> Params:
    """Nested dicts of numpy arrays -> the same dicts of tensors on
    ``device``."""
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
