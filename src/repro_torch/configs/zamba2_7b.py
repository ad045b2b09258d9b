"""zamba2-7b [hybrid] — Mamba-2 backbone with a shared attention block.

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64
[arXiv:2411.15242; unverified]. Every 6th block applies the single *shared*
attention+MLP block (params reused across its 13 occurrences, per-occurrence
LoRA rank 128 on wq — simplified-faithful to zamba2's shared-block design).
Runs long_500k: mamba decode is O(1); shared-attn decode is linear in cache.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, vocab=32000,
    n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, mlp="swiglu", norm="rms",
    rope_theta=10_000.0, tie_embeddings=True,
    ssm_state=64, ssm_version=2, d_conv=4, expand=2, ssm_headdim=64,
    shared_attn_period=6, shared_lora_rank=128,
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    n_layers=7, d_model=64, vocab=512,
    n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, mlp="swiglu", norm="rms", tie_embeddings=True,
    ssm_state=8, ssm_version=2, d_conv=4, expand=2, ssm_headdim=16,
    shared_attn_period=3, shared_lora_rank=8,
)
