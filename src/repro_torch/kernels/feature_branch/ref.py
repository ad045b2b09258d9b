"""Plain torch version of the feature-comparison rounds (paper Fig. 6
l.7-19), the counterpart of ``repro.kernels.feature_branch.kernel``'s
``feature_compare_rounds``.

It is the one definition of the parity-critical round loop on the torch
side: ``core.branch`` resolves every level through it, and the CUDA kernels
share its ``__device__`` twin in ``csrc/feature_rounds.cuh``.
"""
from __future__ import annotations

import torch

__all__ = ["feature_compare_rounds"]


def feature_compare_rounds(feats, qfeat, knum, pcmp, *, collect_stats: bool):
    """Equal-run narrowing over ``fs`` feature rows, with the prefix and
    trivial-node overrides folded in.

    ``feats [B, fs, ns] u8``, ``qfeat [B, fs] u8``, ``knum``/``pcmp [B]``
    int32. Returns ``(idx, resolved, run_lo, run_hi, rounds)``, each ``[B]``
    (``resolved`` bool, the rest int32). ``resolved`` includes ``pcmp != 0``
    and ``knum <= 1``, so ``~resolved`` is exactly the set of lanes billed
    for the suffix binary search; ``rounds`` is zeroed on trivial nodes and
    stays all-zero when ``collect_stats`` is off.
    """
    B, fs, ns = feats.shape
    dev = feats.device
    lane = torch.arange(ns, dtype=torch.int32, device=dev)[None, :]
    knum = knum.to(torch.int32)
    eq = lane < knum[:, None]                    # [B, ns]
    resolved = torch.zeros(B, dtype=torch.bool, device=dev)
    idx = torch.zeros(B, dtype=torch.int32, device=dev)
    rounds = torch.zeros(B, dtype=torch.int32, device=dev)
    kmax = torch.clamp(knum - 1, min=0)

    for fid in range(fs):
        qb = qfeat[:, fid:fid + 1]               # [B, 1] uint8
        frow = feats[:, fid, :]                  # [B, ns] uint8
        m = (frow == qb) & eq
        none_eq = ~m.any(-1)
        less = (frow < qb) & eq
        lo = torch.where(eq, lane, ns).amin(-1)
        cnt_less = less.sum(-1, dtype=torch.int32)
        res_idx = torch.minimum(torch.clamp(lo + cnt_less - 1, min=0), kmax)
        newly = none_eq & ~resolved
        idx = torch.where(newly, res_idx.to(torch.int32), idx)
        if collect_stats:
            rounds = rounds + (~resolved).to(torch.int32)
        resolved = resolved | none_eq
        eq = torch.where(resolved[:, None], eq, m)

    run_lo = torch.where(eq, lane, ns).amin(-1).to(torch.int32)
    run_hi = torch.where(eq, lane, -1).amax(-1).to(torch.int32)

    idx = torch.where(pcmp < 0, 0, idx)
    idx = torch.where(pcmp > 0, kmax, idx)
    resolved = resolved | (pcmp != 0)
    trivial = knum <= 1
    idx = torch.where(trivial, 0, idx).to(torch.int32)
    resolved = resolved | trivial
    if collect_stats:
        rounds = torch.where(trivial, 0, rounds)
    return idx, resolved, run_lo, run_hi, rounds
