"""Deterministic, seekable synthetic data pipeline — a copy of
``repro.train.data`` (numpy only; the port imports nothing of the
reference, so it keeps its own).

Every batch is a pure function of (seed, step, shard_id) via Philox counters,
so restarts — including *elastic* restarts onto a different data-shard count —
reproduce the exact global token stream (fault-tolerance requirement).
The token distribution is a two-level Markov-ish mixture over a zipfian
vocabulary: structured enough for a ~100M model to visibly learn in a few
hundred steps, cheap enough to generate at line rate on host CPUs.
Batches are numpy arrays, as the reference's; the caller moves them to
its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.3
    n_states: int = 64           # markov states


def _rng(cfg: DataConfig, step: int, stream: int) -> np.random.Generator:
    k0 = np.uint64((cfg.seed * 0x9E3779B97F4A7C15 + stream + 1) % 2**64)
    k1 = np.uint64(step + 2)
    return np.random.Generator(np.random.Philox(key=[k0, k1]))


def _zipf_probs(cfg: DataConfig) -> np.ndarray:
    r = np.arange(1, cfg.vocab + 1, dtype=np.float64)
    p = r ** (-cfg.zipf_a)
    return p / p.sum()


class TokenStream:
    """Seekable batch source: ``batch_at(step)`` is stateless."""

    def __init__(self, cfg: DataConfig, model_cfg: Optional[ModelConfig] = None):
        self.cfg = cfg
        self.model_cfg = model_cfg
        base = _rng(cfg, -1, 0)
        # per-state token tables: each markov state prefers a band of tokens
        self._state_shift = base.integers(0, cfg.vocab, size=cfg.n_states)
        self._trans = base.integers(0, cfg.n_states,
                                    size=(cfg.n_states, 4))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        g = _rng(cfg, step, 0)
        B, S = cfg.global_batch, cfg.seq_len
        # zipf draws + per-position state shift (adds learnable structure)
        u = g.random((B, S))
        toks = np.minimum((u ** (-1.0 / (cfg.zipf_a - 1.0))).astype(np.int64),
                          cfg.vocab - 1)
        states = np.zeros((B,), np.int64)
        shift = np.empty((B, S), np.int64)
        for t in range(0, S, 64):          # state evolves per 64-token block
            shift[:, t:t + 64] = self._state_shift[states][:, None]
            states = self._trans[states, g.integers(0, 4, size=B)]
        toks = ((toks + shift) % cfg.vocab).astype(np.int32)
        batch = {"tokens": toks}
        mc = self.model_cfg
        if mc is not None and mc.family == "vlm":
            batch["patches"] = g.standard_normal(
                (B, mc.n_patches, mc.frontend_dim)).astype(np.float32)
        if mc is not None and mc.family == "encdec":
            batch["frames"] = g.standard_normal(
                (B, S, mc.frontend_dim)).astype(np.float32)
        return batch

    def shard_batch_at(self, step: int, shard_id: int, n_shards: int):
        """The shard_id-th slice of the global batch (host-local loading on a
        real fleet; sliced from the deterministic global stream so any
        (shard_id, n_shards) factorization yields the same global data)."""
        full = self.batch_at(step)
        B = self.cfg.global_batch
        assert B % n_shards == 0
        per = B // n_shards
        return {k: v[shard_id * per:(shard_id + 1) * per] for k, v in
                full.items()}

    def iter_from(self, step: int) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(step)
            step += 1
