"""mistral-nemo-12b [hf:mistralai/Mistral-Nemo-Base-2407].

Pool spec: 40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, 128k
context (head_dim fixed at 128, rope theta 1M).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab=131_072,
    head_dim=128,
    rope_theta=1_000_000.0,
    max_seq=131_072,
)

SMOKE = ModelConfig(
    name="mistral-nemo-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    head_dim=16,
    max_seq=256,
    remat="none",
)
