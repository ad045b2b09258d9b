"""Batched serving engine: continuous batching + FB+-tree prefix cache —
the port's counterpart of ``repro.serving.engine``.

Requests are admitted in waves; each wave's prompts are matched against the
prefix cache (one batched tree lookup), prefilled, and the KV of their hit
blocks is loaded from the page store; then the batch is decoded step-wise
in a fixed-size continuous batch. Finished slots are refilled immediately.

Everything lives on the device of the parameters: the KV cache, the page
store and the prefix cache's tree. The page store is a bf16 tensor (the
reference keeps a host float32 numpy array; every value written to it is a
bf16 cache entry, so this is exact), and admission writes a request's slot
of the cache in place rather than copying the whole cache through the host.
Model calls run under ``torch.inference_mode()``. It serves the dense and
MoE GQA decoders (yi-9b, llama4-scout); an MLA model (deepseek-v3) is
refused at construction, since the page store holds GQA k/v pages only,
as the reference's does.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import obs
from ..core.traverse import TraversalEngine
from ..models import lm
from ..models.config import ModelConfig
from .prefix_cache import PrefixCache

__all__ = ["ServeConfig", "Request", "Engine"]


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    s_max: int = 256
    block_tokens: int = 32
    n_pages: int = 1024
    max_new_tokens: int = 32
    # traversal engine for the prefix-cache tree (None -> core default)
    tree_backend: Optional[str] = None
    tree_layout: Optional[str] = None
    # prefix-cache tree shards (>1 routes through repro_torch.shard,
    # DESIGN.md §7)
    tree_shards: int = 1
    # fault-injection plan for the cache's lifecycle + shard dispatch
    # (core.faults.FaultPlan; None = fault-free serving)
    faults: Optional[object] = None


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    cached_blocks: int = 0
    t0: float = 0.0       # arrival stamp (perf_counter) — request-latency
    #                       histogram observes done-time minus this


class Engine:
    def __init__(self, cfg: ModelConfig, params, scfg: ServeConfig):
        if cfg.family in ("ssm", "hybrid", "encdec", "vlm"):
            raise ValueError("the engine serves decoder-only KV families")
        if cfg.attention == "mla":
            # as in the reference, whose page store holds GQA k/v pages of
            # [block, n_kv, hd] only: serve MLA through lm.prefill and
            # lm.decode_step
            raise ValueError(
                f"{cfg.name}: the engine's page store holds GQA k/v pages, "
                f"not MLA's latent cache; serve it through lm.prefill and "
                f"lm.decode_step")
        self.cfg, self.params, self.scfg = cfg, params, scfg
        self.device = params["embed"].device
        with torch.inference_mode():
            self.cache = lm.init_cache(cfg, scfg.max_batch, scfg.s_max,
                                       device=self.device)
            # page store: [n_pages, L, 2, block, kv, hd]
            self.page_kv = torch.zeros(
                (scfg.n_pages, cfg.n_layers, 2, scfg.block_tokens,
                 cfg.n_kv_heads, cfg.hd), dtype=torch.bfloat16,
                device=self.device)
        self.pos = np.zeros(scfg.max_batch, np.int32)
        self.live: List[Optional[Request]] = [None] * scfg.max_batch
        # serving is throughput-only: run the tree stats-free (DESIGN.md §3)
        tree_engine = (TraversalEngine(scfg.tree_backend or "torch",
                                       scfg.tree_layout, collect_stats=False)
                       if (scfg.tree_backend or scfg.tree_layout) else None)
        self.prefix = PrefixCache(scfg.n_pages, scfg.block_tokens,
                                  engine=tree_engine,
                                  n_shards=scfg.tree_shards,
                                  faults=scfg.faults, target=self.device)
        self.steps = 0
        self._blocks_hit = 0     # prefix-cache blocks served from the store
        self._blocks_seen = 0    # prompt blocks offered to the cache

    def _prefill(self, toks: torch.Tensor):
        return lm.prefill(self.params, self.cfg, {"tokens": toks},
                          self.scfg.s_max)

    # ------------------------------------------------------------- plumbing
    def _store_blocks(self, c, page_ids: np.ndarray, first_block: int):
        """Copy blocks ``first_block...`` of a prefill cache ``c`` (batch
        row 0) into pages ``page_ids``."""
        bt, n = self.scfg.block_tokens, len(page_ids)
        ids = torch.as_tensor(page_ids, dtype=torch.long, device=self.device)
        b0 = first_block * bt
        for j, t in enumerate((c.k, c.v)):
            blk = t[:, 0, b0:b0 + n * bt]            # [L, n*bt, kv, hd]
            blk = blk.reshape(blk.shape[0], n, bt, *blk.shape[2:])
            self.page_kv[ids, :, j] = blk.transpose(0, 1)

    def _load_blocks(self, slot: int, page_ids: Sequence[int]):
        """Overwrite the first ``len(page_ids)`` blocks of ``slot``'s cache
        with the pages' KV, in place."""
        bt, n = self.scfg.block_tokens, len(page_ids)
        ids = torch.as_tensor(list(page_ids), dtype=torch.long,
                              device=self.device)
        for j, t in enumerate((self.cache.k, self.cache.v)):
            blk = self.page_kv[ids, :, j].transpose(0, 1)  # [L, n, bt, kv, hd]
            t[:, slot, :n * bt] = blk.reshape(blk.shape[0], n * bt,
                                              *blk.shape[3:])

    # --------------------------------------------------------------- admit
    def admit(self, reqs: List[Request]):
        """Fill free slots; batched prefix match across the whole wave."""
        waves = [r for r in reqs][: self.live.count(None)]
        if not waves:
            return
        with obs.span("serve.admit", wave=len(waves)), torch.inference_mode():
            self._admit_wave(waves)

    def _admit_wave(self, waves: List[Request]):
        with obs.span("serve.cache_lookup"):
            hit_blocks, pages = self.prefix.match([r.prompt for r in waves])
        if obs.enabled():
            bt = self.scfg.block_tokens
            self._blocks_hit += int(sum(hit_blocks))
            self._blocks_seen += int(sum(
                r.prompt.shape[0] // bt for r in waves))
            if self._blocks_seen:
                obs.gauge("serve.hit_rate").set(
                    self._blocks_hit / self._blocks_seen)
            obs.counter("serve.admitted").inc(len(waves))
        for r, hb, pg in zip(waves, hit_blocks, pages):
            slot = self.live.index(None)
            r.cached_blocks = hb
            # prefill the whole prompt for the engine cache (single call),
            # but only *new* blocks are published to the page store
            n = r.prompt.shape[0]
            toks = torch.as_tensor(r.prompt, dtype=torch.int32,
                                   device=self.device)[None]
            with obs.span("serve.prefill", rid=r.rid):
                logits, c = self._prefill(toks)
            for t, ct in ((self.cache.k, c.k), (self.cache.v, c.v)):
                t[:, slot] = 0
                t[:, slot, :n] = ct[:, 0, :n]
            if pg:   # demonstrate reuse: overwrite hit blocks from the store
                self._load_blocks(slot, pg)
            new_ids = self.prefix.publish(r.prompt, hb)
            if new_ids is not None and new_ids.size:
                self._store_blocks(c, new_ids, hb)
            self.pos[slot] = n
            # greedy over float32 logits; ties go to the first maximum
            r.out.append(int(torch.argmax(logits[0].float())))
            self.live[slot] = r

    # ---------------------------------------------------------------- step
    def step(self):
        """One decode step for every live slot (continuous batch)."""
        toks = np.zeros(self.scfg.max_batch, np.int32)
        for i, r in enumerate(self.live):
            if r is not None:
                toks[i] = r.out[-1]
        with obs.span("serve.decode"), torch.inference_mode():
            logits, self.cache = lm.decode_step(
                self.params, self.cfg,
                torch.as_tensor(toks, device=self.device),
                torch.as_tensor(self.pos, device=self.device), self.cache)
            nxt = torch.argmax(logits.float(), -1).cpu().numpy()
        for i, r in enumerate(self.live):
            if r is None:
                continue
            self.pos[i] += 1
            r.out.append(int(nxt[i]))
            if (len(r.out) >= self.scfg.max_new_tokens
                    or self.pos[i] + 1 >= self.scfg.s_max):
                r.done = True
                self.live[i] = None
                if obs.enabled():
                    obs.counter("serve.completed").inc()
                    if r.t0:
                        obs.histogram("serve.request_latency_s").observe(
                            time.perf_counter() - r.t0)
        self.steps += 1

    def run(self, requests: List[np.ndarray], max_steps: int = 10_000
            ) -> List[Request]:
        t0 = time.perf_counter()
        queue = [Request(i, np.asarray(p, np.int32), t0=t0) for i, p in
                 enumerate(requests)]
        pending = list(queue)
        while (pending or any(self.live)) and self.steps < max_steps:
            if pending and None in self.live:
                n_free = self.live.count(None)
                self.admit(pending[:n_free])
                pending = pending[n_free:]
            if any(r is not None for r in self.live):
                self.step()
        return queue
