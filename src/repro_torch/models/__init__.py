from . import attention, blocks, bridge, layers, lm
from .config import MLAConfig, ModelConfig, MoEConfig, RGLRUConfig, SSMConfig

__all__ = [
    "attention", "blocks", "bridge", "layers", "lm",
    "MLAConfig", "ModelConfig", "MoEConfig", "RGLRUConfig", "SSMConfig",
]
