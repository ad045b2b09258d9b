"""yi-9b [dense] — llama-architecture GQA.

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000
[arXiv:2403.04652; hf].
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, vocab=64000,
    n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, mlp="swiglu", norm="rms",
    rope_theta=10_000.0, tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="yi-smoke", family="dense",
    n_layers=2, d_model=64, vocab=512,
    n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, mlp="swiglu", norm="rms", tie_embeddings=False,
)
