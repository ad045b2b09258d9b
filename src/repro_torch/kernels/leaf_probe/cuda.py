"""Bind the hashtag leaf-filter CUDA kernel (``csrc/leaf_probe.cu``,
sm_90a) with ``ctypes``; ``kernels/nvcc.py`` builds it at first use.
Nothing here runs at import time.

:func:`check_inputs` holds every check of :func:`launch` but the device, so
it runs on CPU tensors too."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..nvcc import CSRC, attributes, check, load

__all__ = ["launch", "check_inputs", "kernel_attributes", "lanes_per_query",
           "SOURCE", "ALIGN"]

SOURCE = CSRC / "leaf_probe.cu"
ALIGN = 16        # bytes: each lane loads and stores 16 slots as one vector
_FN: Optional[ctypes._CFuncPtr] = None


def _fn():
    global _FN
    if _FN is None:
        fn = load(SOURCE).fbt_leaf_probe
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def check_inputs(tags: torch.Tensor, occ: torch.Tensor,
                 qtag: torch.Tensor) -> None:
    """Raise on inputs the kernel does not take, wherever they lie: shapes,
    dtypes, one device, contiguity, ns in (64, 128), and a ``tags`` or
    ``occ`` whose base is not 16-byte aligned (the kernel loads 16 slots a
    lane as one vector; a row of ns bytes keeps that alignment, but a view
    into a larger buffer need not start on it). Nothing is copied."""
    if tags.dim() != 2:
        raise ValueError(f"leaf_probe: tags must be [B, ns], got "
                         f"{tuple(tags.shape)}")
    B, ns = tags.shape
    if ns not in (64, 128):
        raise ValueError(f"leaf_probe: the kernel is built for ns in "
                         f"(64, 128), got ns={ns}")
    for name, t, dt, shape in (("tags", tags, torch.uint8, (B, ns)),
                               ("occ", occ, torch.bool, (B, ns)),
                               ("qtag", qtag, torch.uint8, (B,))):
        check("leaf_probe", name, t, dt, shape, tags.device)
    for name, t in (("tags", tags), ("occ", occ)):
        if B and t.data_ptr() % ALIGN:
            raise ValueError(f"leaf_probe: {name} base address "
                             f"{t.data_ptr():#x} is not {ALIGN}-byte "
                             f"aligned")


def launch(tags: torch.Tensor, occ: torch.Tensor, qtag: torch.Tensor):
    """Launch the kernel on the current stream of ``tags``'s device.

    ``tags [B, ns] u8``, ``occ [B, ns] bool`` (both 16-byte aligned),
    ``qtag [B] u8``, contiguous on one card. Returns ``(cand [B, ns] u8,
    first [B] int32, count [B] int32)``. Raises on any tensor the kernel
    does not take (:func:`check_inputs`) and on a failed launch.
    """
    dev = tags.device
    if dev.type != "cuda":
        raise ValueError("leaf_probe.launch takes CUDA tensors")
    check_inputs(tags, occ, qtag)
    B, ns = tags.shape
    cand = torch.empty((B, ns), dtype=torch.uint8, device=dev)
    first = torch.empty((B,), dtype=torch.int32, device=dev)
    count = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return cand, first, count
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(tags.data_ptr(), occ.data_ptr(), qtag.data_ptr(),
                 cand.data_ptr(), first.data_ptr(), count.data_ptr(), B, ns,
                 stream)
    if err != 0:
        raise RuntimeError(f"leaf_probe: kernel launch failed with CUDA "
                           f"error {err}")
    return cand, first, count


def lanes_per_query(ns: int) -> int:
    """Lanes of the kernel's group for one query at ``ns`` (32 / lanes
    queries a warp)."""
    fn = load(SOURCE).fbt_leaf_probe_lanes
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(ns)


def kernel_attributes(ns: int) -> dict:
    """What the instantiation a launch at ``ns`` takes asks of the current
    card: registers and local memory (spills) a thread, static and dynamic
    shared memory and threads a block, and the blocks that fit on one
    SM."""
    return attributes(load(SOURCE).fbt_leaf_probe_attrs, "leaf_probe", ns)
