"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP.

61L d_model=7168 128H (MLA: q_lora 1536, kv_lora 512, nope 128, rope 64,
v 128) d_ff=2048(expert) vocab=129280, 3 leading dense layers (d_ff 18432),
sigmoid router with bias-corrected aux-loss-free top-8
[arXiv:2412.19437; hf].
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, vocab=129280,
    n_heads=128, n_kv_heads=128,
    attention="mla",
    q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    d_ff=2048, mlp="swiglu", norm="rms",
    rope_theta=10_000.0, tie_embeddings=False,
    n_experts=256, top_k=8, n_shared_experts=1, d_ff_expert=2048,
    n_dense_layers=3, d_ff_dense=18432,
    router="sigmoid", capacity_factor=1.25, moe_impl="gshard",
    mtp=True, mtp_weight=0.1,
)

SMOKE = ModelConfig(
    name="deepseek-v3-smoke", family="moe",
    n_layers=3, d_model=64, vocab=512,
    n_heads=4, n_kv_heads=4,
    attention="mla",
    q_lora_rank=32, kv_lora_rank=16,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    d_ff=64, mlp="swiglu", norm="rms", tie_embeddings=False,
    n_experts=4, top_k=2, n_shared_experts=1, d_ff_expert=64,
    n_dense_layers=1, d_ff_dense=128,
    router="sigmoid", moe_impl="scatter",
    mtp=True, mtp_weight=0.1,
)
