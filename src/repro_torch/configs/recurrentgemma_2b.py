"""recurrentgemma-2b — Griffin: RG-LRU + local attention 2:1 [arXiv:2402.19427].

Pool spec: 26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000, pattern
(rglru, rglru, local) cycled, sliding window 2048, lru_width 2560.
Sub-quadratic: runs the long_500k shape.
"""

from repro_torch.models.config import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256_000,
    head_dim=256,
    rope_theta=10_000.0,
    window=2048,
    pattern=("rglru", "rglru", "local"),
    rglru=RGLRUConfig(lru_width=2560, d_conv=4, window=2048),
    logits_softcap=30.0,
    tie_embeddings=True,
    max_seq=524_288,
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke",
    family="hybrid",
    n_layers=4,  # one full cycle + one leftover rglru
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=128,
    vocab=256,
    head_dim=16,
    window=32,
    pattern=("rglru", "rglru", "local"),
    rglru=RGLRUConfig(lru_width=64, d_conv=4, window=32),
    logits_softcap=30.0,
    max_seq=256,
    remat="none",
)
