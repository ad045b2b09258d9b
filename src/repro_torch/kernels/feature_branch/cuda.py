"""Bind the per-level feature-comparison CUDA kernel
(``csrc/feature_branch.cu``, sm_90a) with ``ctypes``; ``kernels/nvcc.py``
builds it at first use. Nothing here runs at import time."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..nvcc import CSRC, check, load

__all__ = ["launch", "SOURCE"]

SOURCE = CSRC / "feature_branch.cu"
_FN: Optional[ctypes._CFuncPtr] = None


def _fn():
    global _FN
    if _FN is None:
        fn = load(SOURCE).fbt_feature_branch
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def launch(feats: torch.Tensor, qfeat: torch.Tensor, knum: torch.Tensor,
           pcmp: torch.Tensor, *, collect_stats: bool):
    """Launch the kernel on the current stream of ``feats``'s device.

    ``feats [B, fs, ns] u8``, ``qfeat [B, fs] u8``, ``knum``/``pcmp [B]``
    int32, all contiguous on one card. Returns ``(idx, resolved, run_lo,
    run_hi, rounds)``, each ``[B]`` int32; ``rounds`` is all-zero (and not
    computed) unless ``collect_stats``. Raises on any tensor the kernel does
    not take and on a failed launch.
    """
    dev = feats.device
    if dev.type != "cuda":
        raise ValueError("feature_branch.launch takes CUDA tensors")
    if feats.dim() != 3:
        raise ValueError(f"feature_branch: feats must be [B, fs, ns], got "
                         f"{tuple(feats.shape)}")
    B, fs, ns = feats.shape
    if ns not in (64, 128):
        raise ValueError(f"feature_branch: the kernel is built for ns in "
                         f"(64, 128), got ns={ns}")
    i32, u8 = torch.int32, torch.uint8
    for name, t, dt, shape in (("feats", feats, u8, (B, fs, ns)),
                               ("qfeat", qfeat, u8, (B, fs)),
                               ("knum", knum, i32, (B,)),
                               ("pcmp", pcmp, i32, (B,))):
        check("feature_branch", name, t, dt, shape, dev)
    idx, resolved, run_lo, run_hi = (torch.empty((B,), dtype=i32, device=dev)
                                     for _ in range(4))
    rounds = (torch.empty if collect_stats else torch.zeros)(
        (B,), dtype=i32, device=dev)
    if B == 0:
        return idx, resolved, run_lo, run_hi, rounds
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(feats.data_ptr(), qfeat.data_ptr(), knum.data_ptr(),
                 pcmp.data_ptr(), idx.data_ptr(), resolved.data_ptr(),
                 run_lo.data_ptr(), run_hi.data_ptr(), rounds.data_ptr(),
                 B, fs, ns, int(collect_stats), stream)
    if err != 0:
        raise RuntimeError(f"feature_branch: kernel launch failed with CUDA "
                           f"error {err}")
    return idx, resolved, run_lo, run_hi, rounds
