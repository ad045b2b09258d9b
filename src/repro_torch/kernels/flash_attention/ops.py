"""Wrapper for the flash-attention forward kernel (K5) — the port's
counterpart of ``repro.kernels.flash_attention.ops``.

:func:`flash_sdpa` is what ``models.attention.sdpa`` calls above
``FLASH_THRESH``: q [B,S,H,hd], k/v [B,T,Hk,hv] -> [B,S,H*hv]. For tensors
on the card it launches the CUDA kernel (``cuda.py``) once, or raises; for
tensors on the CPU it runs the plain torch version (``ref.py``). Unlike the
reference's wrapper, nothing is padded and kv is not repeated: the kernel
masks its edges and reads kv head ``h // n_rep`` for query head ``h``.
``LAUNCHES`` counts the kernel launches made in this process. The backward
(a recompute in the reference) comes with training.
"""
from __future__ import annotations

from . import cuda
from .ref import flash_sdpa_ref

__all__ = ["flash_sdpa", "LAUNCHES"]

LAUNCHES = 0


def flash_sdpa(q, k, v, mask, n_rep: int, scale: float):
    """q [B,S,H,hd], k/v [B,T,Hk,hv] -> [B,S,H*hv]; ``mask`` is a
    ``models.attention.MaskSpec`` (kind, window, prefix_len)."""
    global LAUNCHES
    if not q.is_cuda:
        return flash_sdpa_ref(q, k, v, mask, n_rep, scale)
    B, S, H, _ = q.shape
    out, launched = cuda.launch(
        q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
        n_rep=n_rep, scale=scale, kv_len=k.shape[1],
        causal=mask.kind == "causal", window=mask.window,
        prefix_len=mask.prefix_len)
    LAUNCHES += launched
    return out.reshape(B, S, H * v.shape[-1])
