"""qwen3-14b [dense] — GQA with per-head qk RMS-norm, no bias.

40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936
[hf:Qwen/Qwen3-8B family; hf].
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, vocab=151936,
    n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=17408, mlp="swiglu", norm="rms",
    qk_norm=True, rope_theta=1_000_000.0, tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="qwen3-smoke", family="dense",
    n_layers=2, d_model=64, vocab=512,
    n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=160, mlp="swiglu", norm="rms",
    qk_norm=True, tie_embeddings=False,
)
