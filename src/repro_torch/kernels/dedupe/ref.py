"""Plain torch version of the write path's last-lane-wins dedupe:
``core.batch_ops.dedupe_last_wins`` (a full lexicographic sort of the
batch, as the JAX package's ``jnp.lexsort``) in lane order. The CPU path of
``ops`` runs it, and the kernel (``csrc/dedupe.cu``) is held against it on
the card."""
from __future__ import annotations

from typing import Tuple

import torch

from ...core import batch_ops

__all__ = ["dedupe_ref"]


def dedupe_ref(qb: torch.Tensor, ql: torch.Tensor,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The last lane of each key (all ``L`` bytes and the length) wins.
    Returns ``(winners bool [B], conflicts int32 scalar)``."""
    seq = torch.arange(qb.shape[0], dtype=torch.int32, device=qb.device)
    return batch_ops.dedupe_last_wins(qb, ql, seq)
