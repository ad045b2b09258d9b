"""Model configuration for the 10 architectures — a copy of
``repro.models.config`` (it is data).

One dataclass covers every family (dense / moe / ssm / hybrid / encdec / vlm);
family-specific fields are ignored elsewhere. All dims come from public
literature; `param_count()` gives (total, active) parameter counts. The one
change: :attr:`ModelConfig.dtype` is the torch dtype of ``param_dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    vocab: int
    # ---- attention ----
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    attention: str = "gqa"           # gqa | mla | none
    rope_theta: float = 10_000.0
    pos: str = "rope"                # rope | learned | none
    window: int = 0                  # 0 = full attention; >0 sliding window
    # ---- MLA (deepseek) ----
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # ---- mlp ----
    d_ff: int = 0
    mlp: str = "swiglu"              # swiglu | geglu | relu2 | gelu
    norm: str = "rms"                # rms | ln
    norm_eps: float = 1e-5
    # ---- MoE ----
    n_experts: int = 0               # routed experts (0 = dense)
    top_k: int = 1
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    n_dense_layers: int = 0          # leading dense layers (deepseek: 3)
    d_ff_dense: int = 0              # their ff width
    router: str = "softmax"          # softmax | sigmoid (deepseek)
    capacity_factor: float = 1.25
    moe_impl: str = "scatter"        # scatter (optimized) | gshard (baseline)
    # ---- MTP (deepseek) ----
    mtp: bool = False
    mtp_weight: float = 0.1
    # ---- SSM ----
    ssm_state: int = 0
    ssm_version: int = 1             # 1 = mamba1 (falcon), 2 = mamba2 (zamba)
    d_conv: int = 4
    expand: int = 2
    ssm_headdim: int = 64            # mamba2 head dim
    dt_rank: int = 0                 # mamba1; 0 -> d_model // 16
    ssm_scan: str = "assoc"          # assoc | cumsum (§Perf lever)
    # ---- hybrid (zamba2) ----
    shared_attn_period: int = 0      # every k-th block is the shared attn block
    shared_lora_rank: int = 0        # per-occurrence LoRA on the shared block
    # ---- enc-dec (whisper) ----
    n_enc_layers: int = 0
    enc_seq: int = 0                 # encoder positions (stub frame embeddings)
    frontend_dim: int = 0            # stub frontend embedding width
    # ---- vlm (paligemma) ----
    n_patches: int = 0               # image prefix length
    # ---- misc ----
    tie_embeddings: bool = True
    param_dtype: str = "bfloat16"
    remat: str = "none"              # none | full | dots  (activation ckpt)

    # ----------------------------------------------------------------- helpers
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dtr(self) -> int:
        return self.dt_rank or max(1, self.d_model // 16)

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def moe_layer_ids(self) -> Tuple[int, ...]:
        if self.n_experts == 0:
            return ()
        return tuple(range(self.n_dense_layers, self.n_layers))

    def hybrid_pattern(self) -> Tuple[str, ...]:
        """Block type per position for hybrid archs ('m'=mamba, 'a'=shared attn)."""
        if self.family != "hybrid":
            return ()
        p = []
        for i in range(self.n_layers):
            if self.shared_attn_period and (i + 1) % self.shared_attn_period == 0:
                p.append("a")
            else:
                p.append("m")
        return tuple(p)

    # -------------------------------------------------------------- param count
    def _attn_params(self) -> int:
        d, H, Hk, hd = self.d_model, self.n_heads, self.n_kv_heads, self.hd
        if self.attention == "mla":
            qr, kr = self.q_lora_rank, self.kv_lora_rank
            nope, rope, vh = self.qk_nope_head_dim, self.qk_rope_head_dim, self.v_head_dim
            return (d * qr + qr * H * (nope + rope)           # q down/up
                    + d * (kr + rope)                          # kv down + shared k_rope
                    + kr * H * (nope + vh)                     # kv up
                    + H * vh * d)                              # o
        n = d * H * hd + 2 * d * Hk * hd + H * hd * d
        if self.qkv_bias:
            n += H * hd + 2 * Hk * hd
        return n

    def _mlp_params(self, ff: int) -> int:
        d = self.d_model
        if self.mlp in ("swiglu", "geglu"):
            return 3 * d * ff
        return 2 * d * ff

    def _moe_layer_params(self) -> Tuple[int, int]:
        """(total, active) params of one MoE layer's FFN part."""
        d, fe = self.d_model, self.d_ff_expert
        per = self._mlp_params(fe) // (self.d_model * 0 + 1)
        per = 3 * d * fe if self.mlp in ("swiglu", "geglu") else 2 * d * fe
        router = d * self.n_experts
        shared = self.n_shared_experts * per
        total = self.n_experts * per + shared + router
        active = self.top_k * per + shared + router
        return total, active

    def _mamba_params(self) -> int:
        d, di, ds = self.d_model, self.d_inner, self.ssm_state
        if self.ssm_version == 1:
            return (d * 2 * di + di * self.d_conv            # in_proj + conv
                    + di * (self.dtr + 2 * ds)               # x_proj
                    + self.dtr * di + di                     # dt_proj
                    + di * ds + di                           # A, D
                    + di * d)                                # out_proj
        nh = self.n_ssm_heads
        return (d * (2 * di + 2 * ds + nh)                   # in_proj(z,x,B,C,dt)
                + (di + 2 * ds) * self.d_conv
                + nh + nh + di                               # A, D, norm
                + di * d)

    def param_count(self) -> Tuple[int, int]:
        """(total, active) parameter counts (embeddings included once)."""
        d = self.d_model
        emb = self.vocab * d
        head = 0 if self.tie_embeddings else self.vocab * d
        norms = 2 * d * self.n_layers + d
        total = active = emb + head + norms

        if self.family in ("dense", "vlm"):
            per = self._attn_params() + self._mlp_params(self.d_ff)
            total += per * self.n_layers
            active = total
        elif self.family == "moe":
            attn = self._attn_params()
            mt, ma = self._moe_layer_params()
            n_moe = self.n_layers - self.n_dense_layers
            dense = self._mlp_params(self.d_ff_dense or self.d_ff)
            total += (attn + dense) * self.n_dense_layers + (attn + mt) * n_moe
            active += (attn + dense) * self.n_dense_layers + (attn + ma) * n_moe
            if self.mtp:
                mt2, ma2 = self._moe_layer_params()
                total += attn + mt2 + 2 * d * d
                active += attn + ma2 + 2 * d * d
        elif self.family == "ssm":
            total += self._mamba_params() * self.n_layers
            active = total
        elif self.family == "hybrid":
            pat = self.hybrid_pattern()
            nm = pat.count("m")
            na = pat.count("a")
            shared = self._attn_params() + self._mlp_params(self.d_ff)
            lora = na * self.shared_lora_rank * 2 * d * 4 if self.shared_lora_rank else 0
            total += self._mamba_params() * nm + shared + lora
            active = total
        elif self.family == "encdec":
            per = self._attn_params() + self._mlp_params(self.d_ff)
            enc = per * self.n_enc_layers
            dec = (2 * self._attn_params() + self._mlp_params(self.d_ff)) * self.n_layers
            pos = 2 * self.enc_seq * d + self.frontend_dim * d  # learned pos + proj
            total += enc + dec + pos
            active = total
        if self.family == "vlm":
            total += self.frontend_dim * d  # projector
            active = total
        return int(total), int(active)
