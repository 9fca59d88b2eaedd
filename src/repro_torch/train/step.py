"""The training step: loss -> grads -> AdamW, as in ``repro/train/step.py``.

``make_train_step(cfg, opt_cfg, ctx=...)`` builds the step function;
``train_shardings``/``abstract_train_state`` build the matching sharding and
``meta`` trees so the SAME code path serves (a) real training on whatever
mesh exists and (b) the dry-run (fake tensors, nothing allocated).

Sharding layout (see ``repro_torch.parallel.sharding``):
  params/opt : TP over 'model', FSDP over 'data', replicated over 'pod'
               (m/v moments inherit the param sharding -> ZeRO with no
               replicated optimizer state)
  batch      : leading batch dim over ('pod', 'data')
  metrics    : replicated scalars (plain tensors on return)
"""

from __future__ import annotations

from repro_torch.autodiff import value_and_grad
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, cosine_lr
from repro_torch.parallel.sharding import (
    NamedSharding,
    ParallelContext,
    distribute_tree,
    mesh_region,
    shardings_for,
)

__all__ = [
    "abstract_train_state",
    "batch_pspecs",
    "batch_shardings",
    "jit_train_step",
    "make_train_step",
    "train_shardings",
]


def abstract_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig):
    """(params, opt_state, logical axes): ``meta`` tensors, shapes and dtypes
    only, and the parameters' axes tree."""
    params, axes = lm.init_shapes(cfg)
    return params, adamw_init(params, opt_cfg), axes


def train_shardings(cfg: ModelConfig, ctx: ParallelContext, opt_cfg: AdamWConfig):
    """(param_shardings, opt_shardings) :class:`NamedSharding` trees, or
    (None, None) without a mesh."""
    if ctx.mesh is None:
        return None, None
    params, _, axes = abstract_train_state(cfg, opt_cfg)
    param_sh = shardings_for(axes, ctx, params)
    # moments share the param layout; count is a replicated scalar
    opt_sh = {"m": param_sh, "v": param_sh, "count": NamedSharding(ctx.mesh, ())}
    return param_sh, opt_sh


def batch_pspecs(batch: dict, ctx: ParallelContext) -> dict:
    """Spec per batch entry: batch dim over the DP axes.

    Handles [B,S] token/label arrays, [B,S,d] embeddings, [3,B,S] M-RoPE
    position ids, and scalar entries (e.g. decode ``pos``).  Without a mesh
    every entry is replicated.
    """

    def one(name: str, leaf) -> tuple:
        shape = leaf.shape
        if len(shape) == 0:
            return ()
        if name == "positions" and len(shape) == 3 and shape[0] == 3:
            return (None, ctx.dp_spec(shape[1]))
        return (ctx.dp_spec(shape[0]), *([None] * (len(shape) - 1)))

    return {k: one(k, v) for k, v in batch.items()}


def batch_shardings(batch: dict, ctx: ParallelContext):
    if ctx.mesh is None:
        return {k: None for k in batch}
    return {k: NamedSharding(ctx.mesh, s) for k, s in batch_pspecs(batch, ctx).items()}


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    *,
    ctx: ParallelContext | None = None,
    schedule: dict | None = None,
):
    """(params, opt_state, batch) -> (params', opt_state', metrics).

    ``schedule``: optional {"warmup": int, "total": int} enabling the cosine
    LR schedule keyed off opt_state['count'].  The update is written into
    ``params`` and ``opt_state``'s moments (``adamw_update`` works in
    place), as the reference's ``jit_train_step`` donates their buffers.
    Metrics ``loss``, ``ce`` and ``grad_norm`` are 0-dim f32 tensors.  With
    a ``ctx`` that holds a mesh the trees are DTensors, laid out as
    :func:`jit_train_step` places them.
    """
    grad_fn = value_and_grad(lambda p, b: lm.loss_fn(p, b, cfg, ctx))

    @mesh_region
    def train_step(params, opt_state, batch, ctx=ctx):
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


def jit_train_step(
    cfg: ModelConfig,
    ctx: ParallelContext,
    opt_cfg: AdamWConfig,
    batch_sds: dict | None = None,
    *,
    schedule: dict | None = None,
):
    """The train step with explicit in/out layouts (the reference's
    ``jax.jit`` with shardings): parameters and moments are placed by
    :func:`train_shardings`, the batch by :func:`batch_shardings`, and the
    new trees come back in the same layout, always written in place (the
    reference donates their buffers).  Metrics come back as plain replicated
    scalars.  Without a mesh it is :func:`make_train_step`."""
    step = make_train_step(cfg, opt_cfg, ctx=ctx, schedule=schedule)
    if ctx.mesh is None:
        return step
    param_sh, opt_sh = train_shardings(cfg, ctx, opt_cfg)

    def sharded_step(params, opt_state, batch):
        params = distribute_tree(params, param_sh)
        opt_state = distribute_tree(opt_state, opt_sh)
        batch = distribute_tree(batch, batch_shardings(batch, ctx))
        new_p, new_o, metrics = step(params, opt_state, batch)
        metrics = {k: v.full_tensor() if hasattr(v, "full_tensor") else v
                   for k, v in metrics.items()}
        return distribute_tree(new_p, param_sh), distribute_tree(new_o, opt_sh), metrics

    return sharded_step
