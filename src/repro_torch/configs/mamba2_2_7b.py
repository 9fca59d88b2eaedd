"""mamba2-2.7b — SSD (state-space duality) [arXiv:2405.21060].

Pool spec: 64L d_model=2560 (attention-free) vocab=50280, ssm_state=128,
expand 2, head_dim 64.  Sub-quadratic: runs the long_500k shape.
"""

from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=1,  # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab=50_280,
    head_dim=64,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=128),
    tie_embeddings=True,
    max_seq=524_288,
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab=256,
    head_dim=16,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=16),
    max_seq=256,
    remat="none",
)
