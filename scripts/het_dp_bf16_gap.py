#!/usr/bin/env python3
"""How far a bf16 heterogeneous-DP gradient moves when the microbatches are
assigned otherwise, in the JAX reference and in the PyTorch port, on the
same weights and microbatches, on the CPU.

The combined gradient of ``HetDPTrainer`` is the full-batch gradient
whoever ran each microbatch, up to rounding: each worker sums its
gradients in the parameters' dtype, in the order its tasks ran, and the
workers' sums are added in worker order.  In bf16 a different assignment
rounds those sums at other places.  For each trial this script draws
``--microbatches`` microbatches of ``--mb-size`` x ``--seq`` tokens from
``SyntheticLM`` (seed = the trial), and runs one pool of ``--workers``
workers whose last is ``--slow``x slow (steals happen) and one pool of one
worker over them, and prints the relative L2 distance ``|pool - one| /
|one|`` between the two combined gradients, the largest of the same
distance taken leaf by leaf (and that leaf's key), and their max|d|, with
each run's tasks per worker.  The reference's combined gradient is read where
its ``HetDPTrainer.step`` hands it to ``adamw_update``; the port's comes
from ``HetDPTrainer.gradient``.  These are the numbers behind the bf16
bound of ``chip_smoke.py``'s phase 18.

    PYTHONPATH=src python scripts/het_dp_bf16_gap.py --arch phi4-mini-3.8b \
        --layers 1 2 --seq 64 --trials 2

``--smoke`` runs the SMOKE config (seconds).  The config is cut to each
``--layers`` depth, and ``--d-model`` narrows it (heads, KV heads and
d_ff scaled with it, head_dim and the vocabulary kept): at full width the
reference's trainer holds f32 moments and a host accumulator per worker,
over 30 GB at one layer.  The weights are the reference's ``lm.init(key
0)`` in bf16, bridged to the port.  Each line is a JSON object.

This script is one of the places outside the tests where the port meets
the reference: it imports both.
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as jconfigs
import repro.runtime.het_dp as jhet
from repro.checkpoint.store import _flatten
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.models import lm as jlm
import repro_torch.configs as tconfigs
from repro_torch.models import lm as tlm
from repro_torch.models.bridge import flatten, params_from_flat
from repro_torch.runtime.het_dp import HetDPTrainer, WorkerSpec


def gap(got: dict[str, np.ndarray], want: dict[str, np.ndarray]):
    """(relative L2, (the worst leaf's relative L2, its key), max|d|) of two
    flat gradient trees, in f64."""
    num = den = 0.0
    worst = 0.0
    leaf = (0.0, "")
    for k, w in want.items():
        d = got[k].astype(np.float64) - w.astype(np.float64)
        dd, ww = float((d * d).sum()), float((w.astype(np.float64) ** 2).sum())
        num += dd
        den += ww
        worst = max(worst, float(np.abs(d).max()))
        rel = (dd / ww) ** 0.5 if ww else (0.0 if dd == 0 else float("inf"))
        leaf = max(leaf, (rel, k))
    return (num / den) ** 0.5, leaf, worst


def reference_gradient(cfg, params, mbs, workers, base):
    """The reference's combined gradient of one step, and its tasks per worker."""
    seen = {}
    update = jhet.adamw_update

    def record(grads, opt_state, p, opt_cfg, lr_scale=1.0):
        seen["g"] = {k: np.asarray(v, np.float32) for k, v in _flatten(grads).items()}
        return update(grads, opt_state, p, opt_cfg, lr_scale)

    jhet.adamw_update = record
    try:
        tr = jhet.HetDPTrainer(lambda p, b: jlm.loss_fn(p, b, cfg), params,
                               [jhet.WorkerSpec(*w) for w in workers], base_task_time=base)
        m = tr.step([{k: jnp.asarray(v) for k, v in mb.items()} for mb in mbs])
    finally:
        jhet.adamw_update = update
    return seen["g"], m["tasks_per_worker"]


def port_gradient(cfg, params, mbs, workers, base):
    tr = HetDPTrainer(lambda p, b: tlm.loss_fn(p, b, cfg), params,
                      [WorkerSpec(*w) for w in workers], base_task_time=base)
    g, m = tr.gradient([{k: torch.from_numpy(v.copy()) for k, v in mb.items()} for mb in mbs])
    return {k: v.float().numpy() for k, v in flatten(g).items()}, m["tasks_per_worker"]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--layers", type=int, nargs="+", default=[1])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--d-model", type=int, default=0, help="narrow the config to this width")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--mb-size", type=int, default=2)
    ap.add_argument("--microbatches", type=int, default=9)
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--slow", type=float, default=4.0)
    ap.add_argument("--base-task-time", type=float, default=0.5,
                    help="seconds a worker sleeps per task, times its slowdown")
    ap.add_argument("--trials", type=int, default=2)
    args = ap.parse_args()

    torch.set_num_threads(max(1, torch.get_num_threads()))
    pool = [(f"w{i}", 1.0) for i in range(args.workers - 1)] + [("slow", args.slow)]
    for layers in args.layers:
        get = (jconfigs.get_smoke, tconfigs.get_smoke) if args.smoke else \
            (jconfigs.get_config, tconfigs.get_config)
        jcfg, tcfg = (g(args.arch).with_(n_layers=layers) for g in get)
        if args.d_model:
            f = args.d_model / jcfg.d_model
            cut = dict(d_model=args.d_model, n_heads=round(jcfg.n_heads * f),
                       n_kv_heads=max(1, round(jcfg.n_kv_heads * f)), d_ff=round(jcfg.d_ff * f),
                       head_dim=jcfg.head_dim_)
            jcfg, tcfg = jcfg.with_(**cut), tcfg.with_(**cut)
        t0 = time.perf_counter()
        jp, _ = jlm.init(jcfg, jax.random.key(0))
        tp = params_from_flat(_flatten(jp), device="cpu", dtype=torch.bfloat16)
        for trial in range(args.trials):
            data = SyntheticLM(DataConfig(vocab=jcfg.vocab, seq_len=args.seq,
                                          global_batch=args.mb_size * args.microbatches,
                                          seed=trial))
            b = data.batch_at(0)
            mbs = [{k: v[i::args.microbatches] for k, v in b.items()}
                   for i in range(args.microbatches)]
            for name, fn, cfg, params in (("reference", reference_gradient, jcfg, jp),
                                          ("port", port_gradient, tcfg, tp)):
                g_pool, tasks = fn(cfg, params, mbs, pool, args.base_task_time)
                g_one, _ = fn(cfg, params, mbs, [("solo", 1.0)], 0.0)
                rel, (leaf_rel, leaf), worst = gap(g_pool, g_one)
                row = {"framework": name, "arch": args.arch, "layers": layers,
                       "smoke": args.smoke, "d_model": jcfg.d_model, "trial": trial,
                       "tokens": args.mb_size * args.seq,
                       "microbatches": args.microbatches, "tasks_per_worker": tasks,
                       "rel_l2": rel, "leaf_rel_l2_max": leaf_rel, "worst_leaf": leaf,
                       "max_abs": worst,
                       "seconds": round(time.perf_counter() - t0, 1)}
                print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
