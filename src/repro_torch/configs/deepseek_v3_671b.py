"""deepseek-v3-671b — MLA + fine-grained MoE + MTP [arXiv:2412.19437].

Pool spec: 61L d_model=7168 128H d_ff=2048 (routed-expert hidden)
vocab=129280, MoE 1 shared + 256 routed top-8, MLA, MTP.  First 3 layers use
a dense FFN of 18432 (paper §4.2); MLA ranks q=1536 / kv=512, head dims
128 nope + 64 rope, v 128.
"""

from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=2048,
    vocab=129_280,
    head_dim=128,
    rope_theta=10_000.0,
    moe=MoEConfig(
        num_experts=256,
        top_k=8,
        d_expert=2048,
        num_shared=1,
        d_shared=2048,
        first_k_dense=3,
        d_ff_dense=18_432,
    ),
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_dim=128,
    ),
    mtp=True,
    max_seq=32_768,
)

SMOKE = ModelConfig(
    name="deepseek-smoke",
    family="moe",
    n_layers=3,  # 1 dense + 2 MoE — exercises first_k_dense
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=64,
    vocab=256,
    head_dim=16,
    moe=MoEConfig(
        num_experts=8,
        top_k=2,
        d_expert=64,
        num_shared=1,
        d_shared=64,
        first_k_dense=1,
        d_ff_dense=128,
        capacity_factor=2.0,
    ),
    mla=MLAConfig(
        q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8, v_dim=16
    ),
    mtp=True,
    max_seq=256,
    remat="none",
)
