"""Plain torch version of the hashtag leaf filter, the counterpart of
``repro.kernels.leaf_probe.ref``. The CPU path of ``ops`` runs it, and the
kernel (``csrc/leaf_probe.cu``) is held against it on the card."""
from __future__ import annotations

import torch

__all__ = ["leaf_probe_ref"]


def leaf_probe_ref(tags, occ, qtag):
    """``tags [B, ns] u8``, ``occ [B, ns]`` (bool or 0/1), ``qtag [B] u8``
    -> ``(cand [B, ns] u8 0/1, first [B] int32, count [B] int32)``;
    ``first`` is ``ns`` where no slot is a candidate."""
    ns = tags.shape[-1]
    cand = (tags == qtag[:, None]) & (occ != 0)
    lane = torch.arange(ns, dtype=torch.int32, device=tags.device)[None, :]
    first = torch.where(cand, lane, ns).amin(-1).to(torch.int32)
    count = cand.sum(-1, dtype=torch.int32)
    return cand.to(torch.uint8), first, count
