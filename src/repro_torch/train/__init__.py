from .step import (
    abstract_train_state,
    batch_pspecs,
    make_train_step,
    train_shardings,
)

__all__ = [
    "abstract_train_state",
    "batch_pspecs",
    "make_train_step",
    "train_shardings",
]
