from . import attention, blocks, bridge, layers, lm, moe
from .config import MLAConfig, ModelConfig, MoEConfig, RGLRUConfig, SSMConfig

__all__ = [
    "attention", "blocks", "bridge", "layers", "lm", "moe",
    "MLAConfig", "ModelConfig", "MoEConfig", "RGLRUConfig", "SSMConfig",
]
