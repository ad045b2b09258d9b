"""llama4-scout-17b-a16e [moe] — 16 routed experts, top-1, + shared expert.

48L d_model=5120 40H (GQA kv=8) d_ff=8192(expert) vocab=202048, MoE 16e top-1
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]. Early-fusion multimodality
is out of scope for the LM backbone cell (text path only, per assignment).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, vocab=202048,
    n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, mlp="swiglu", norm="rms",
    rope_theta=500_000.0, tie_embeddings=False,
    n_experts=16, top_k=1, n_shared_experts=1, d_ff_expert=8192,
    router="softmax", capacity_factor=1.25, moe_impl="gshard",
)

SMOKE = ModelConfig(
    name="llama4-scout-smoke", family="moe",
    n_layers=2, d_model=64, vocab=512,
    n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, mlp="swiglu", norm="rms", tie_embeddings=False,
    n_experts=4, top_k=1, n_shared_experts=1, d_ff_expert=96,
    router="softmax", moe_impl="scatter",
)
