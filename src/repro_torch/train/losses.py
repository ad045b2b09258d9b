"""Loss assembly — the port's counterpart of ``repro.train.losses``:
shifted-token cross entropy plus the MoE auxiliary loss. The vlm and
DeepSeek MTP branches raise until their families are ported."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..models import lm
from ..models.config import ModelConfig
from ..models.layers import softmax_xent

__all__ = ["AUX_COEF", "loss_fn"]

AUX_COEF = 0.01


def loss_fn(params, cfg: ModelConfig, batch: Dict
            ) -> Tuple[torch.Tensor, Dict]:
    """-> (loss, metrics {"ce", "aux", "loss"}), float32 scalars."""
    if cfg.family == "vlm" or cfg.mtp:
        raise NotImplementedError(
            f"{cfg.name}: the vlm text-only loss and the MTP loss need the "
            f"vlm and moe families' forward, not ported yet (ROADMAP queue "
            f"1, \"The other model families\")")
    logits, aux, _ = lm.forward(params, cfg, batch)
    tokens = batch["tokens"]
    ce = softmax_xent(logits[:, :-1], tokens[:, 1:])
    loss = ce + AUX_COEF * aux
    return loss, {"ce": ce, "aux": aux, "loss": loss}
