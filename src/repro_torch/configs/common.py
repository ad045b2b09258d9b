"""Shared shape-suite definitions and input specs — the port's counterpart
of ``repro.configs.common``.

Every architecture is paired with the LM shape set:
    train_4k     seq 4096,   global_batch 256   (training)
    prefill_32k  seq 32768,  global_batch 32    (inference prefill)
    decode_32k   seq 32768,  global_batch 128   (one-token decode, full cache)
    long_500k    seq 524288, global_batch 1     (long-context decode;
                                                 SSM/hybrid archs only)

``input_specs`` returns tensors on the meta device (shape and dtype, no
storage; the reference's ``ShapeDtypeStruct``s). Modality frontends are
stubs: [vlm] supplies precomputed patch embeddings, [audio] precomputed
frame embeddings.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..core.fbtree import resolve_target
from ..models.config import ModelConfig

__all__ = ["ShapeSpec", "SHAPES", "applicable", "input_specs", "smoke_batch"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """(runs?, reason). long_500k needs sub-quadratic attention."""
    if shape == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, ("full-attention arch: 500k decode would need a 500k "
                       "dense KV per layer and quadratic prefill — skipped "
                       "per brief (run for SSM/hybrid only)")
    return True, ""


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape) -> Dict[str, torch.Tensor]:
    """Model-input stand-ins (meta tensors) for one (arch x shape) cell;
    ``shape`` a name of :data:`SHAPES` or a :class:`ShapeSpec`."""
    sp = shape if isinstance(shape, ShapeSpec) else SHAPES[shape]
    B, S = sp.global_batch, sp.seq_len
    i32 = torch.int32
    if sp.kind in ("train", "prefill"):
        if cfg.family == "vlm":
            # patch prefix + text fill the assigned sequence length
            s_txt = S - cfg.n_patches
            return {"tokens": _spec((B, s_txt), i32),
                    "patches": _spec((B, cfg.n_patches, cfg.frontend_dim),
                                     torch.bfloat16)}
        if cfg.family == "encdec":
            return {"tokens": _spec((B, S), i32),
                    "frames": _spec((B, S, cfg.frontend_dim),
                                    torch.bfloat16)}
        return {"tokens": _spec((B, S), i32)}
    # decode: one new token against a cache of S positions
    return {"tokens": _spec((B,), i32), "pos": _spec((B,), i32)}


def smoke_batch(cfg: ModelConfig, B: int = 2, S: int = 32, seed: int = 0,
                device=None):
    """Small concrete batch for smoke runs (reduced configs), drawn from a
    ``torch.Generator`` seeded with ``seed`` on the CPU and moved to
    ``device`` (the card unless ``"cpu"`` is asked for). Other numbers
    than the reference's: another generator."""
    gen = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                     dtype=torch.int32)}
    if cfg.family == "vlm":
        batch["patches"] = torch.randn(
            (B, cfg.n_patches, cfg.frontend_dim), generator=gen
        ).to(torch.bfloat16)
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(
            (B, S, cfg.frontend_dim), generator=gen).to(torch.bfloat16)
    dev = resolve_target(device)
    return {k: v.to(dev) for k, v in batch.items()}
