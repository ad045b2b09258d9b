"""nemotron-4-15b [dense] — GQA with squared-ReLU MLP, LayerNorm.

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000
[arXiv:2402.16819; unverified].
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, vocab=256000,
    n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=24576, mlp="relu2", norm="ln",
    rope_theta=10_000.0, tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="nemotron-smoke", family="dense",
    n_layers=2, d_model=64, vocab=512,
    n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=192, mlp="relu2", norm="ln", tie_embeddings=False,
)
