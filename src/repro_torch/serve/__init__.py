from .engine import (
    abstract_caches,
    cache_pspecs,
    cache_shardings,
    jit_decode_step,
    jit_prefill_step,
    Replica,
    ServeFuture,
    ServePool,
)

__all__ = [
    "abstract_caches",
    "cache_pspecs",
    "cache_shardings",
    "jit_decode_step",
    "jit_prefill_step",
    "Replica",
    "ServeFuture",
    "ServePool",
]
