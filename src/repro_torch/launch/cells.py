"""Dry-run cells: one traced step per (arch x shape x mesh), as in
``repro/launch/cells.py``.

``trace_cell`` runs the cell's step once under ``FakeTensorMode`` -- nothing
is allocated, so the full-size configs (the 671B one included) trace on a
CPU -- on whatever mesh the context holds (a fake process group of 256 or
512 ranks in ``repro_torch.launch.dryrun``), with an
:class:`~repro_torch.launch.op_analysis.OpCounter` counting the local ops.
``analyze`` turns the counts into the roofline record, on the H100's
constants: per-device FLOPs, bytes and collective payloads, the memory one
device holds, and which of the three terms dominates.  The numbers are
analytic (fake tensors): nothing here is measured on a card.
"""

from __future__ import annotations

import os
import time

import torch

from repro_torch.configs.base import Shape, input_specs
from repro_torch.models import lm
from repro_torch.models.bridge import flatten
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel.sharding import (
    ParallelContext,
    distribute_tree,
    serve_context,
    shardings_for,
)
from repro_torch.serve.engine import (
    _param_shardings,
    abstract_caches,
    cache_shardings,
    jit_decode_step,
    jit_prefill_step,
)
from repro_torch.train.step import (
    abstract_train_state,
    batch_shardings,
    jit_train_step,
    train_shardings,
)

from .op_analysis import analyze_ops, local_bytes

__all__ = ["trace_cell", "analyze", "HW", "param_bytes_per_device", "roofline_terms"]

# NVIDIA H100 SXM5 80 GB (name as the card reports it: "NVIDIA H100 80GB
# HBM3"), at its 700 W power limit: spec-sheet peaks per card.
HW = {
    "device": "NVIDIA H100 80GB HBM3",
    "power_limit_w": 700.0,
    "peak_flops": 989.4e12,  # bf16 dense tensor-core FLOP/s
    "hbm_bw": 3.35e12,  # HBM3 bytes/s
    "link_bw": 450e9,  # NVLink 4 bytes/s per direction
    "hbm_bytes": 80e9,  # 80 GB
}


def _fake_like(tree):
    """A tree of fake tensors (under the active ``FakeTensorMode``) with the
    shapes and dtypes of ``tree``'s ``meta`` tensors."""
    if isinstance(tree, dict):
        return {k: _fake_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fake_like(v) for v in tree)
    if tree is None:
        return None
    return torch.empty(tree.shape, dtype=tree.dtype)


def trace_cell(cfg: ModelConfig, shape: Shape, ctx: ParallelContext, breakdown: bool = False):
    """Trace the cell's step once.  Returns (costs, meta): the per-device
    :class:`OpCosts` (with its per-op ``breakdown`` when asked, see
    :class:`~repro_torch.launch.op_analysis.OpBreakdown`) and a dict of the
    memory one device holds (parameters, optimizer state, caches, batch,
    and the peak while the step runs) and the seconds the trace took.

    With a mesh, the step first runs once uncounted: DTensor infers each
    new op's layout by running it on global-shape tensors, and the counted
    run then finds those plans in its caches."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.time()
    mesh = ctx.mesh
    mem: dict[str, int] = {}
    with FakeTensorMode():
        batch = _fake_like(input_specs(cfg, shape))
        if shape.kind == "train":
            opt_cfg = AdamWConfig(moment_dtype="bfloat16")
            params, opt, _ = abstract_train_state(cfg, opt_cfg)
            params, opt = _fake_like(params), _fake_like(opt)
            fn = jit_train_step(cfg, ctx, opt_cfg, batch)
            if mesh is not None:
                p_sh, o_sh = train_shardings(cfg, ctx, opt_cfg)
                params, opt = distribute_tree(params, p_sh), distribute_tree(opt, o_sh)
                batch = distribute_tree(batch, batch_shardings(batch, ctx))
            args = (params, opt, batch)
            mem["param_bytes"], mem["opt_bytes"] = local_bytes(params), local_bytes(opt)
        elif shape.kind == "prefill":
            params = _fake_like(lm.init_shapes(cfg)[0])
            fn = jit_prefill_step(cfg, ctx, batch)
            if mesh is not None:
                params = distribute_tree(params, _param_shardings(cfg, ctx))
                batch = distribute_tree(batch, batch_shardings(batch, ctx))
            args = (params, batch)
            mem["param_bytes"] = local_bytes(params)
        elif shape.kind == "decode":
            b, s = shape.global_batch, shape.seq_len
            serve_layout = os.environ.get("REPRO_SERVE_LAYOUT", "1") != "0"
            params = _fake_like(lm.init_shapes(cfg)[0])
            caches = _fake_like(abstract_caches(cfg, b, s))
            fn = jit_decode_step(cfg, ctx, b, s, serve_layout=serve_layout)
            if mesh is not None:
                sctx = serve_context(mesh, cfg.moe.num_experts if cfg.moe else 0) \
                    if serve_layout else ctx
                params = distribute_tree(params, _param_shardings(cfg, sctx))
                caches = distribute_tree(caches, cache_shardings(cfg, sctx, b, s))
            # the last slot: every cached position is attended
            args = (params, batch["tokens"], caches, s - 1)
            mem["param_bytes"], mem["cache_bytes"] = local_bytes(params), local_bytes(caches)
        else:
            raise ValueError(shape.kind)
        mem["batch_bytes"] = local_bytes(batch)
        if mesh is not None:
            fn(*args)
        _, costs, peak = analyze_ops(fn, *args, base_bytes=local_bytes(args),
                                     breakdown=breakdown)
    mem["peak_bytes"] = int(peak)
    return costs, {"memory": mem, "trace_s": round(time.time() - t0, 2)}


def param_bytes_per_device(cfg: ModelConfig, ctx: ParallelContext) -> int:
    """Parameter bytes one device holds under ``ctx``'s rules, from the
    specs alone (no process group needed: ``ctx.mesh`` may be a stand-in
    that carries axis sizes)."""
    params, axes = lm.init_shapes(cfg)
    total = 0
    for sh, t in zip(flatten(shardings_for(axes, ctx, params)).values(),
                     flatten(params).values()):
        split = 1
        for entry in sh.spec:
            for a in () if entry is None else ((entry,) if isinstance(entry, str) else entry):
                split *= ctx.size(a)
        total += t.numel() * t.element_size() // split
    return total


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float) -> dict[str, float]:
    """The three roofline terms in seconds, per card on :data:`HW`."""
    return {
        "t_compute": flops_per_dev / HW["peak_flops"],
        "t_memory": bytes_per_dev / HW["hbm_bw"],
        "t_collective": coll_bytes_per_dev / HW["link_bw"],
    }


def analyze(costs, meta: dict, cfg: ModelConfig, shape: Shape, chips: int) -> dict:
    """Roofline record for one traced cell, with the reference's keys
    (``fits_hbm16g`` becomes ``fits_hbm80g``; the reference's ``xla_*``
    keys have no counterpart)."""
    flops, byts = float(costs.flops), float(costs.bytes)
    coll = {k: int(v) for k, v in costs.coll.items()}
    coll_total = costs.coll_bytes
    terms = roofline_terms(flops, byts, coll_total)
    dom = max(terms, key=terms.get)
    # MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) for train cells,
    # else forward-only 2*N*D; D = tokens
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        model_flops = 6 * n_active * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        model_flops = 2 * n_active * shape.global_batch * shape.seq_len
    else:
        model_flops = 2 * n_active * shape.global_batch  # one token per sequence
    flops_global = flops * chips
    live = meta["memory"]["peak_bytes"]
    return {
        "arch": cfg.name,
        "shape": shape.name,
        "kind": shape.kind,
        "chips": chips,
        "flops_per_device": flops,
        "bytes_per_device": byts,
        "collective_bytes_per_device": coll_total,
        "collectives": coll,
        **terms,
        "dominant": dom,
        "model_flops": float(model_flops),
        "useful_flops_ratio": model_flops / flops_global if flops_global else float("nan"),
        "memory": meta["memory"],
        "live_bytes_per_device": int(live),
        "fits_hbm80g": bool(live <= HW["hbm_bytes"]),
        "trace_s": meta["trace_s"],
        "hw": HW,
    }
