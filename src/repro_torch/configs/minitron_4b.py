"""minitron-4b — pruned Nemotron [arXiv:2407.14679].

Pool spec: 32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=9216,
    vocab=256_000,
    head_dim=128,
    rope_theta=10_000.0,
    max_seq=32_768,
)

SMOKE = ModelConfig(
    name="minitron-smoke",
    family="dense",
    n_layers=2,
    d_model=48,
    n_heads=6,
    n_kv_heads=2,
    d_ff=96,
    vocab=256,
    head_dim=8,
    max_seq=256,
    remat="none",
)
