"""seamless-m4t-medium — encoder-decoder multimodal [arXiv:2308.11596].

Pool spec: 12L (encoder) + 12L (decoder) d_model=1024 16H (kv=16) d_ff=4096
vocab=256206.  The audio frontend is a stub per the assignment:
``input_specs`` provides precomputed frame embeddings for the encoder.
Non-gated (plain ReLU) MLP as in the NLLB/seamless transformer.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,
    enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256_206,
    head_dim=64,
    rope_theta=10_000.0,
    frontend="audio",
    act="plain",
    max_seq=32_768,
)

SMOKE = ModelConfig(
    name="seamless-smoke",
    family="encdec",
    n_layers=2,
    enc_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    head_dim=16,
    frontend="audio",
    act="plain",
    max_seq=256,
    remat="none",
)
