from .engine import (
    abstract_caches,
    jit_decode_step,
    jit_prefill_step,
    Replica,
    ServeFuture,
    ServePool,
)

# The reference also exports cache_pspecs and cache_shardings, the sharded
# cache layout; they come with the port's parallel slice.
__all__ = [
    "abstract_caches",
    "jit_decode_step",
    "jit_prefill_step",
    "Replica",
    "ServeFuture",
    "ServePool",
]
