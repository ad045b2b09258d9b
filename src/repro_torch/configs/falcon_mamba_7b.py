"""falcon-mamba-7b [ssm] — attention-free Mamba-1 stack.

64L d_model=4096 (attn-free) vocab=65024, ssm_state=16, expand=2, d_conv=4,
dt_rank=256 [arXiv:2410.05355; unverified]. Runs the long_500k shape (O(1)
decode state; no KV cache).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, vocab=65024,
    d_ff=0, norm="rms", tie_embeddings=True,
    ssm_state=16, ssm_version=1, d_conv=4, expand=2, dt_rank=256,
)

SMOKE = ModelConfig(
    name="falcon-mamba-smoke", family="ssm",
    n_layers=2, d_model=64, vocab=512,
    d_ff=0, norm="rms", tie_embeddings=True,
    ssm_state=8, ssm_version=1, d_conv=4, expand=2, dt_rank=8,
)
