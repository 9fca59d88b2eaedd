"""qwen2-vl-2b — VLM backbone with M-RoPE [arXiv:2409.12191].

Pool spec: 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.  The
vision frontend is a stub per the assignment: ``input_specs`` provides
precomputed patch embeddings plus (t, h, w) M-RoPE position ids.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151_936,
    head_dim=128,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    mrope=True,
    mrope_sections=(16, 24, 24),  # halves of head_dim: 16+24+24 = 64
    frontend="vision",
    max_seq=32_768,
)

SMOKE = ModelConfig(
    name="qwen2-vl-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    head_dim=16,
    qkv_bias=True,
    mrope=True,
    mrope_sections=(2, 3, 3),
    frontend="vision",
    max_seq=256,
    remat="none",
)
