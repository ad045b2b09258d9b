"""qwen2.5-14b [dense] — GQA with QKV bias.

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064
[hf:Qwen/Qwen2.5-0.5B family; hf].
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, vocab=152064,
    n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=13824, mlp="swiglu", norm="rms",
    qkv_bias=True, rope_theta=1_000_000.0, tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="qwen2.5-smoke", family="dense",
    n_layers=2, d_model=64, vocab=512,
    n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=160, mlp="swiglu", norm="rms",
    qkv_bias=True, tie_embeddings=False,
)
