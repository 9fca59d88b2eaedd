"""moonshot-v1-16b-a3b — Kimi/Moonlight-style MoE.

[hf:moonshotai/Moonlight-16B-A3B; pool spec]: 48L d_model=2048 16H (GQA
kv=16) d_ff=1408 (expert hidden) vocab=163840, MoE 64 experts top-6.
"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=163_840,
    head_dim=128,
    rope_theta=50_000.0,
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408),
    max_seq=32_768,
)

SMOKE = ModelConfig(
    name="moonshot-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=96,
    vocab=256,
    head_dim=16,
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=96, capacity_factor=2.0),
    max_seq=256,
    remat="none",
)
