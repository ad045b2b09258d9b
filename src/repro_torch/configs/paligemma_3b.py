"""paligemma-3b [vlm] — SigLIP patch-embedding stub + gemma-style decoder.

18L d_model=2048 8H (GQA kv=1, head_dim=256) d_ff=16384 vocab=257216
[arXiv:2407.07726; hf]. The SigLIP frontend is a stub: ``input_specs``
supplies precomputed patch embeddings (width 1152 = SigLIP-So400m); the
backbone projects and prepends them with a bidirectional prefix-LM mask.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, vocab=257216,
    n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, mlp="geglu", norm="rms",
    rope_theta=10_000.0, tie_embeddings=True,
    n_patches=256, frontend_dim=1152,
)

SMOKE = ModelConfig(
    name="paligemma-smoke", family="vlm",
    n_layers=2, d_model=64, vocab=512,
    n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, mlp="geglu", norm="rms", tie_embeddings=True,
    n_patches=8, frontend_dim=24,
)
