"""granite-4.0-h-small — IBM Granite 4.0-H Small (32B total, ~9B active):
Mamba-2 and NoPE GQA layers, each followed by a fine-grained MoE with a
shared expert.

[hf:ibm-granite/granite-4.0-h-small, config.json]: 40L d_model=4096; a
period of 10 layers, 9 Mamba-2 (128 heads of 64, d_state 128, one group,
conv 4, chunk 256) and one attention layer at position 5 (32 heads, 8 KV
heads of 128, no positional embedding, softmax scale 1/128); every layer's
FFN routes over 72 experts of 768, top 10, beside a shared SwiGLU of 1536;
vocab 100352, tied; multipliers: embedding 12, residual 0.22, logits 1/16;
RMSNorm eps 1e-5.  Not in ``ARCH_IDS``: the JAX package has no such
architecture.
"""

from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig

PERIOD = ("ssm_moe",) * 5 + ("attn_moe",) + ("ssm_moe",) * 4

CONFIG = ModelConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=768,
    vocab=100_352,
    head_dim=128,
    layer_types=PERIOD * 4,
    moe=MoEConfig(num_experts=72, top_k=10, d_expert=768, num_shared=1, d_shared=1536,
                  dropless=True),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256, n_groups=1),
    tie_embeddings=True,
    norm_eps=1e-5,
    max_seq=131_072,
    nope=True,
    attn_scale=1 / 128,
    embed_scale=12.0,
    residual_scale=0.22,
    logits_scale=1 / 16,
)

SMOKE = ModelConfig(
    name="granite-smoke",
    family="hybrid",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=32,
    vocab=256,
    head_dim=16,
    layer_types=("ssm_moe", "attn_moe", "ssm_moe"),
    moe=MoEConfig(num_experts=8, top_k=3, d_expert=32, num_shared=1, d_shared=48,
                  experts_held=4, dropless=True),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=16),
    tie_embeddings=True,
    norm_eps=1e-5,
    max_seq=256,
    remat="none",
    nope=True,
    attn_scale=1 / 16,
    embed_scale=12.0,
    residual_scale=0.22,
    logits_scale=1 / 16,
)
