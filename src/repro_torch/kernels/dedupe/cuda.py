"""Bind the last-lane-wins dedupe CUDA kernel (``csrc/dedupe.cu``, sm_90a)
with ``ctypes``; ``kernels/nvcc.py`` builds it at first use. Nothing here
runs at import time.

:func:`check_inputs` holds every check of :func:`launch` but the device, so
it runs on CPU tensors too."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..nvcc import CSRC, attributes, check, load

__all__ = ["launch", "check_inputs", "table_capacity", "word_bytes",
           "kernel_attributes", "SOURCE", "WORDS", "MAX_LANES"]

SOURCE = CSRC / "dedupe.cu"
WORDS = (8, 1)            # bytes a load of a key row, widest first
MAX_LANES = 1 << 30       # lanes are int32 and the table holds 2B of them
_FN: Optional[ctypes._CFuncPtr] = None


def _fn():
    global _FN
    if _FN is None:
        fn = load(SOURCE).fbt_dedupe
        fn.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def table_capacity(B: int) -> int:
    """The table's entries for a batch of ``B`` lanes: the power of two at
    or above ``2 B`` (a load of at most one half when every lane is
    distinct), and at least 4 (the fill stores 16 bytes a thread)."""
    return max(4, 1 << (2 * B - 1).bit_length())


def word_bytes(qb: torch.Tensor) -> int:
    """The widest load (:data:`WORDS`) that the row width and the base
    address of ``qb`` both allow."""
    L = qb.shape[1]
    return next(w for w in WORDS if L % w == 0 and qb.data_ptr() % w == 0)


def check_inputs(qb: torch.Tensor, ql: torch.Tensor,
                 capacity: Optional[int] = None) -> None:
    """Raise on inputs the kernel does not take, wherever they lie: ``qb``
    not a ``[B, L]`` uint8 tensor with ``L >= 1``, ``ql`` not int32 ``[B]``
    on the same device, either not contiguous, more than
    :data:`MAX_LANES` lanes, or a ``capacity`` that is not a power of two at
    least ``max(B, 4)`` (below ``B`` distinct keys could fill the table and
    a probe would never end). Nothing is copied."""
    if qb.dim() != 2 or qb.shape[1] < 1:
        raise ValueError(f"dedupe: qb must be [B, L] with L >= 1, got "
                         f"{tuple(qb.shape)}")
    B, L = qb.shape
    if B > MAX_LANES:
        raise ValueError(f"dedupe: {B} lanes, the kernel takes at most "
                         f"{MAX_LANES}")
    check("dedupe", "qb", qb, torch.uint8, (B, L), qb.device)
    check("dedupe", "ql", ql, torch.int32, (B,), qb.device)
    if capacity is not None and (capacity < max(B, 4)
                                 or capacity & (capacity - 1)):
        raise ValueError(f"dedupe: table capacity {capacity} must be a "
                         f"power of two of at least max(B, 4) = "
                         f"{max(B, 4)}")


def launch(qb: torch.Tensor, ql: torch.Tensor, *,
           capacity: Optional[int] = None, count_probes: bool = False):
    """Launch the kernel's three passes (fill, insert, resolve) on the
    current stream of ``qb``'s device.

    ``qb [B, L] u8`` and ``ql [B] int32``, contiguous on one card. Returns
    ``(winners [B] bool, conflicts int32 scalar, probes)``: a lane wins
    when no later lane holds the same ``L`` bytes and length, conflicts is
    ``B - sum(winners)``, and ``probes`` is an int64 scalar, the probe
    steps past a lane's home entry summed over the batch, with
    ``count_probes``, else ``None``. ``capacity`` (tests only) overrides
    :func:`table_capacity` to force probe chains. The table and the lanes'
    entries are freed on return. Raises on any tensor the kernel does not
    take (:func:`check_inputs`) and on a failed launch.
    """
    dev = qb.device
    if dev.type != "cuda":
        raise ValueError("dedupe.launch takes CUDA tensors")
    check_inputs(qb, ql, capacity)
    B, L = qb.shape
    winners = torch.empty((B,), dtype=torch.bool, device=dev)
    conflicts = torch.empty((), dtype=torch.int32, device=dev)
    probes = (torch.empty((), dtype=torch.int64, device=dev)
              if count_probes else None)
    if B == 0:
        conflicts.zero_()
        if probes is not None:
            probes.zero_()
        return winners, conflicts, probes
    cap = table_capacity(B) if capacity is None else capacity
    work = torch.empty((cap + B,), dtype=torch.int32, device=dev)
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(qb.data_ptr(), ql.data_ptr(), work.data_ptr(),
                 work[cap:].data_ptr(), winners.data_ptr(),
                 conflicts.data_ptr(),
                 probes.data_ptr() if probes is not None else None, B, L,
                 cap, word_bytes(qb), stream)
    if err != 0:
        raise RuntimeError(f"dedupe: kernel launch failed with CUDA error "
                           f"{err}")
    return winners, conflicts, probes


def kernel_attributes(word: int) -> dict:
    """What the insert pass for rows read in ``word``-byte loads asks of the
    current card: registers and local memory (spills) a thread, static and
    dynamic shared memory and threads a block, and the blocks that fit on
    one SM."""
    return attributes(load(SOURCE).fbt_dedupe_attrs, "dedupe", word)
