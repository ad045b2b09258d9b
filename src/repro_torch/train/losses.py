"""Loss assembly — the port's counterpart of ``repro.train.losses``:
shifted-token cross entropy (for vlm over the text positions only, after
the image patches), plus the MoE auxiliary loss and DeepSeek's MTP loss
(token t+2 from the trunk at t)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..models import lm
from ..models.config import ModelConfig
from ..models.layers import softmax_xent

__all__ = ["AUX_COEF", "loss_fn"]

AUX_COEF = 0.01


def loss_fn(params, cfg: ModelConfig, batch: Dict, shard=lm.NOSHARD
            ) -> Tuple[torch.Tensor, Dict]:
    """-> (loss, metrics {"ce", "aux", ["mtp_ce",] "loss"}), float32
    scalars. ``shard`` is ``lm.forward``'s hook."""
    logits, aux, hidden = lm.forward(params, cfg, batch, shard)
    tokens = batch["tokens"]
    if cfg.family == "vlm":        # text positions only
        logits = logits[:, cfg.n_patches:]
    ce = softmax_xent(logits[:, :-1], tokens[:, 1:])
    loss = ce + AUX_COEF * aux
    metrics = {"ce": ce, "aux": aux}
    if cfg.mtp:
        mlogits = lm.mtp_logits(params, cfg, hidden, tokens, shard)
        mtp_ce = softmax_xent(mlogits[:, :-2], tokens[:, 2:])
        loss = loss + cfg.mtp_weight * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    metrics["loss"] = loss
    return loss, metrics
