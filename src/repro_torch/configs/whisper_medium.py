"""whisper-medium [audio] — encoder-decoder transformer backbone.

24L(enc) + 24L(dec) d_model=1024 16H (MHA kv=16) d_ff=4096 vocab=51865
[arXiv:2212.04356; unverified]. The conv/mel frontend is a stub:
``input_specs`` supplies precomputed frame embeddings (width 128); learned
position tables are sized to the assigned 32k shapes (adaptation noted in
DESIGN.md — original Whisper caps at 1500 frames / 448 tokens).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, n_enc_layers=24, d_model=1024, vocab=51865,
    n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, mlp="gelu", norm="ln", pos="learned",
    tie_embeddings=True,
    enc_seq=32768, frontend_dim=128,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="encdec",
    n_layers=2, n_enc_layers=2, d_model=64, vocab=512,
    n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, mlp="gelu", norm="ln", pos="learned",
    tie_embeddings=True,
    enc_seq=64, frontend_dim=24,
)
