"""The training step: loss -> grads -> AdamW, as in ``repro/train/step.py``,
on one device.

``make_train_step(cfg, opt_cfg)`` builds the step function;
``abstract_train_state`` gives the parameter and optimizer trees' shapes on
the ``meta`` device (nothing allocated).  The reference's mesh layouts
(``train_shardings``, ``batch_pspecs``) and its jitted, sharded step
(``jit_train_step``) come with the port's parallel slice: they raise.
"""

from __future__ import annotations

from repro_torch.autodiff import value_and_grad
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, cosine_lr
from repro_torch.roadmap import not_ported

__all__ = [
    "abstract_train_state",
    "batch_pspecs",
    "make_train_step",
    "train_shardings",
]


def abstract_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig):
    """(params, opt_state) as ``meta`` tensors: shapes and dtypes only."""
    params = lm.init(cfg, None, device="meta")
    return params, adamw_init(params, opt_cfg)


def train_shardings(cfg: ModelConfig, ctx, opt_cfg: AdamWConfig):
    raise not_ported("sharded training")


def batch_pspecs(batch: dict, ctx) -> dict:
    raise not_ported("sharded training")


def jit_train_step(cfg: ModelConfig, ctx, opt_cfg: AdamWConfig, batch_sds: dict, **kwargs):
    raise not_ported("sharded training")


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    *,
    schedule: dict | None = None,
):
    """(params, opt_state, batch) -> (params', opt_state', metrics).

    ``schedule``: optional {"warmup": int, "total": int} enabling the cosine
    LR schedule keyed off opt_state['count'].  The update is written into
    ``params`` and ``opt_state``'s moments (``adamw_update`` works in
    place), as the reference's ``jit_train_step`` donates their buffers.
    Metrics ``loss``, ``ce`` and ``grad_norm`` are 0-dim f32 tensors.
    """
    grad_fn = value_and_grad(lambda p, b: lm.loss_fn(p, b, cfg))

    def train_step(params, opt_state, batch):
        (loss, metrics), grads = grad_fn(params, batch)
        lr_scale = cosine_lr(opt_state["count"], **schedule) if schedule else 1.0
        new_params, new_opt, om = adamw_update(
            grads, opt_state, params, opt_cfg, lr_scale
        )
        out_metrics = {
            "loss": loss.float(),
            "ce": metrics["ce"],
            "grad_norm": om["grad_norm"],
        }
        return new_params, new_opt, out_metrics

    return train_step
