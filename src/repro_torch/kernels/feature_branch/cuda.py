"""Bind the per-level feature-comparison CUDA kernel
(``csrc/feature_branch.cu``, sm_90a) with ``ctypes``; ``kernels/nvcc.py``
builds it at first use. Nothing here runs at import time.

:func:`check_inputs` holds every check of :func:`launch` but the device, so
it runs on CPU tensors too."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..nvcc import CSRC, attributes, check, load

__all__ = ["launch", "check_inputs", "kernel_attributes", "lanes_per_query",
           "SOURCE", "ALIGN"]

SOURCE = CSRC / "feature_branch.cu"
ALIGN = 16        # bytes: each lane loads its part of a row as one vector
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


def check_inputs(feats: torch.Tensor, qfeat: torch.Tensor,
                 knum: torch.Tensor, pcmp: torch.Tensor) -> None:
    """Raise on inputs the kernel does not take, wherever they lie: shapes,
    dtypes, one device, contiguity, ns in (64, 128), and a ``feats`` whose
    base is not 16-byte aligned (the kernel loads each row in 16-byte
    vectors; a row of ``fs * ns`` bytes keeps that alignment, but a view
    into a larger buffer need not start on it). Nothing is copied."""
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
        check("feature_branch", name, t, dt, shape, feats.device)
    if feats.numel() and feats.data_ptr() % ALIGN:
        raise ValueError(f"feature_branch: feats base address "
                         f"{feats.data_ptr():#x} is not {ALIGN}-byte "
                         f"aligned")


def launch(feats: torch.Tensor, qfeat: torch.Tensor, knum: torch.Tensor,
           pcmp: torch.Tensor, *, collect_stats: bool):
    """Launch the kernel on the current stream of ``feats``'s device.

    ``feats [B, fs, ns] u8`` (16-byte aligned), ``qfeat [B, fs] u8``,
    ``knum``/``pcmp [B]`` int32, all contiguous on one card. Returns
    ``(idx, resolved, run_lo, run_hi, rounds)``, each ``[B]`` int32;
    ``rounds`` is all-zero (and not computed) unless ``collect_stats``.
    Raises on any tensor the kernel does not take (:func:`check_inputs`)
    and on a failed launch.
    """
    dev = feats.device
    if dev.type != "cuda":
        raise ValueError("feature_branch.launch takes CUDA tensors")
    check_inputs(feats, qfeat, knum, pcmp)
    B, fs, ns = feats.shape
    i32 = torch.int32
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


def lanes_per_query(ns: int) -> int:
    """Lanes of the kernel's group for one query at ``ns`` (32 / lanes
    queries a warp)."""
    fn = load(SOURCE).fbt_feature_branch_lanes
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(ns)


def kernel_attributes(ns: int, fs: int, *, stats: bool) -> dict:
    """What the instantiation a launch at ``ns``, ``fs`` and ``stats``
    takes asks of the current card: registers and local memory (spills) a
    thread, static and dynamic shared memory and threads a block, and the
    blocks that fit on one SM."""
    return attributes(load(SOURCE).fbt_feature_branch_attrs, "feature_branch",
                      ns, fs, int(stats))
