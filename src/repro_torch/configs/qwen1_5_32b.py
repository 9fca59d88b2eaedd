"""qwen1.5-32b [hf:Qwen family].

Pool spec: 64L d_model=5120 40H (GQA kv=40 — i.e. MHA) d_ff=27392
vocab=152064, QKV bias.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27_392,
    vocab=152_064,
    head_dim=128,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    max_seq=32_768,
)

SMOKE = ModelConfig(
    name="qwen1.5-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=160,
    vocab=256,
    head_dim=16,
    qkv_bias=True,
    max_seq=256,
    remat="none",
)
