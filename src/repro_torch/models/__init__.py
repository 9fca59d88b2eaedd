from . import attention, blocks, bridge, layers, lm, moe, rglru, ssm
from .config import MLAConfig, ModelConfig, MoEConfig, RGLRUConfig, SSMConfig

__all__ = [
    "attention", "blocks", "bridge", "layers", "lm", "moe", "rglru", "ssm",
    "MLAConfig", "ModelConfig", "MoEConfig", "RGLRUConfig", "SSMConfig",
]
