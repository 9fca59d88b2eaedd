"""Run a function on ``world`` ranks of a ``gloo`` process group, one CPU
process a rank, for the port's sharded tests.

``run_group(world, "module:function", payload, tmp_path)`` starts ``world``
Python processes.  Each joins the group through a ``FileStore`` under
``tmp_path``, calls ``function(rank, world, payload)`` (``payload`` a
picklable object: numpy arrays, numbers, strings) and rank 0 pickles what
it returns.  The group gets its own timeout; a hung or failed rank kills
the others, and the call raises with the ranks' error output.  The
functions run in processes that import torch and ``repro_torch``, never
JAX: the parent holds the reference's side.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_BOOT = textwrap.dedent(
    """
    import os, pickle, sys
    sys.path[:0] = [{src!r}, {tests!r}]
    import importlib
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store = dist.FileStore({store!r}, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    mod, fn = {target!r}.split(":")
    with open({payload!r}, "rb") as f:
        payload = pickle.load(f)
    out = getattr(importlib.import_module(mod), fn)(rank, world, payload)
    if rank == 0:
        with open({result!r}, "wb") as f:
            pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    """
)


def run_group(world: int, target: str, payload, tmp_path, timeout: float = 300.0):
    """Run ``target`` on ``world`` gloo ranks; returns rank 0's result."""
    tmp = Path(tmp_path)
    tmp.mkdir(parents=True, exist_ok=True)
    paths = {k: str(tmp / f"{k}_{os.getpid()}_{time.monotonic_ns()}")
             for k in ("store", "payload", "result")}
    with open(paths["payload"], "wb") as f:
        pickle.dump(payload, f)
    code = _BOOT.format(src=str(ROOT / "src"), tests=str(ROOT / "tests"), target=target,
                        **paths)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONWARNINGS="ignore")
    env.pop("XLA_FLAGS", None)
    logs = [tmp / f"rank{r}_{os.getpid()}.log" for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(world)], env=env,
                              stdout=subprocess.DEVNULL, stderr=open(logs[r], "w"))
             for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if any(p.returncode != 0 for p in procs):
        errs = "\n".join(f"--- rank {r} (rc {p.returncode}):\n{logs[r].read_text()[-3000:]}"
                         for r, p in enumerate(procs))
        raise RuntimeError(f"{target} on {world} ranks failed:\n{errs}")
    with open(paths["result"], "rb") as f:
        return pickle.load(f)


# ------------------------------------------------------------------ workers
# Each worker takes (rank, world, payload) and returns plain numpy/floats.

def _mesh(payload):
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.parallel.sharding import make_context

    data, model, pod = payload["mesh"]
    return make_context(make_debug_mesh(data, model, pod))


def _np(t):
    import torch

    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    return t.detach().float().numpy() if torch.is_tensor(t) else t


def _cfg(payload):
    import dataclasses

    from repro_torch.configs import get_smoke

    cfg = get_smoke(payload["arch"]).with_(dtype="float32", **payload.get("overrides", {}))
    if cfg.moe is not None and payload.get("cf") is not None:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=payload["cf"]))
    return cfg


def serve_worker(rank, world, payload):
    """Forward, prefill, then decode of one SMOKE arch, sharded on the
    payload's mesh and unsharded; returns both sides' logits."""
    import torch

    from repro_torch.models import lm
    from repro_torch.models.bridge import params_from_flat
    from repro_torch.serve import engine

    cfg = _cfg(payload)
    params = params_from_flat(payload["params"], device="cpu", dtype=torch.float32)
    ctx = _mesh(payload)
    batch = {k: torch.from_numpy(v) for k, v in payload["batch"].items()}
    nxt = torch.from_numpy(payload["next"])
    s, n = payload["s0"], nxt.shape[1]
    out = {"plain": {}, "sharded": {}}

    fwd, _ = lm.forward(params, batch, cfg)
    pl, pc = lm.prefill(params, batch, cfg)
    pc = lm.pad_caches(pc, cfg, s + n)
    out["plain"] = {"forward": fwd, "prefill": pl, "decode": []}
    for i in range(n):
        dl, pc = lm.decode_step(params, nxt[:, i:i + 1], pc, s + i, cfg)
        out["plain"]["decode"].append(dl)

    from repro_torch.parallel.sharding import distribute_tree
    from repro_torch.train.step import batch_shardings

    dparams = distribute_tree(params, engine._param_shardings(cfg, ctx))
    fwd, _ = lm.forward(dparams, distribute_tree(batch, batch_shardings(batch, ctx)), cfg, ctx)
    sl, sc = engine.jit_prefill_step(cfg, ctx, batch)(params, batch)
    sc = lm.pad_caches(sc, cfg, s + n)
    dec = engine.jit_decode_step(cfg, ctx, nxt.shape[0], s + n)
    out["sharded"] = {"forward": fwd, "prefill": sl, "decode": []}
    for i in range(n):
        dl, sc = dec(params, nxt[:, i:i + 1], sc, s + i)
        out["sharded"]["decode"].append(dl)
    from repro_torch.autodiff import tree_leaves
    from repro_torch.parallel.sharding import split_over_sequence

    res = {side: {k: [_np(t) for t in v] if isinstance(v, list) else _np(v)
                  for k, v in d.items()} for side, d in out.items()}
    res["split_caches"] = sum(map(split_over_sequence, tree_leaves(sc)))
    return res


def train_worker(rank, world, payload):
    """``jit_train_step`` over the payload's batches on its mesh; returns
    each step's metrics and the final parameters, whole."""
    import torch

    from repro_torch.models.bridge import flatten, params_from_flat
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.step import jit_train_step

    cfg = _cfg(payload)
    params = params_from_flat(payload["params"], device="cpu", dtype=torch.float32)
    ocfg = AdamWConfig(lr=payload["lr"])
    opt = adamw_init(params, ocfg)
    step = jit_train_step(cfg, _mesh(payload), ocfg, schedule=payload.get("schedule"))
    metrics = []
    for b in payload["batches"]:
        params, opt, m = step(params, opt, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "params": {k: _np(v) for k, v in flatten(params).items()},
            "placements": {k: str(getattr(v, "placements", None))
                           for k, v in flatten(params).items()}}


def moe_worker(rank, world, payload):
    """``moe_apply`` in the training layout (experts over 'model') and in
    the serving layout (full EP), against the one-device dispatch: the
    serving layout on all tokens, the training layout on each data shard's
    tokens (its capacity is a shard's, as in the reference's
    ``shard_map``)."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import moe
    from repro_torch.models.bridge import params_from_flat
    from repro_torch.parallel.sharding import (
        distribute,
        distribute_tree,
        serve_context,
        shardings_for,
    )
    from repro_torch.models.lm import logical_axes

    cfg = _cfg(payload)
    p = params_from_flat(payload["moe"], device="cpu", dtype=torch.float32)
    x = torch.from_numpy(payload["x"])
    ti, tw = torch.from_numpy(payload["top_i"]), torch.from_numpy(payload["top_w"])
    train = _mesh(payload)
    serve = serve_context(train.mesh, cfg.moe.num_experts)
    out = {"whole": _np(moe.moe_apply(p, x, ti, tw, cfg)),
           "per_shard": [_np(moe.moe_apply(p, xs, a, b, cfg)) for xs, a, b in
                         zip(x.chunk(train.size(train.dp_axes)),
                             ti.chunk(train.size(train.dp_axes)),
                             tw.chunk(train.size(train.dp_axes)))]}
    axes = logical_axes({"moe": p})["moe"]
    for name, ctx in (("train", train), ("serve", serve)):
        dp = distribute_tree(p, shardings_for(axes, ctx, p))
        rows = (ctx.dp_axes if len(ctx.dp_axes) > 1 else ctx.dp_axes[0], None, None)
        xs, tis, tws = (distribute(t, ctx.mesh, rows) for t in (x, ti, tw))
        with implicit_replication():
            out[name] = _np(moe.moe_apply(dp, xs, tis, tws, cfg, ctx))
        out[name + "_ep_axes"] = ctx.ep_axes
    return out


def restore_worker(rank, world, payload):
    """Restore a checkpoint into the mesh's layout; returns the leaves
    whole, with their placements."""
    from repro_torch.checkpoint import store
    from repro_torch.models import lm
    from repro_torch.models.bridge import flatten
    from repro_torch.serve.engine import _param_shardings
    from repro_torch.configs import get_smoke

    import torch

    cfg = get_smoke(payload["arch"])
    ctx = _mesh(payload)
    template = lm.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    tree, step = store.restore(payload["dir"], template, shardings=_param_shardings(cfg, ctx))
    flat = flatten(tree)
    return {"step": step, "leaves": {k: v.full_tensor().view(torch.int16).numpy()
                                     if v.dtype == torch.bfloat16 else v.full_tensor().numpy()
                                     for k, v in flat.items()},
            "sharded": sum(any(p.is_shard() for p in v.placements) for v in flat.values())}


def _sched_mesh(world):
    from repro_torch.launch.mesh import make_workers_mesh

    return make_workers_mesh(world)


def _state_np(state):
    return {k: v.numpy().copy() for k, v in state._asdict().items()}


def _same_state(a, b) -> str | None:
    """The first field in which two scheduler states differ bit for bit
    (NaN equals NaN), else None."""
    import torch

    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        same = (x == y) | (x.isnan() & y.isnan()) if x.is_floating_point() else x == y
        if x.shape != y.shape or not bool(same.all()):
            return name
    return None


def sched_worker(rank, world, payload):
    """The multi-rank device scheduler on a ("workers",) mesh of all ranks,
    for each job of the payload (see ``tests/test_torch_device_sched_ranks.py``):

    replay   rounds fed the given Gumbel draws (``[rounds, P, W]``, each rank
             its rows); the whole state after every round
    ranks_vs_one  rounds fed the given draws, beside the one-process
             round on the same draws: every rank's block must equal its
             rows bit for bit after every round; the whole final state, the
             rounds and the makespan
    seed     ``virtual_run(mesh=..., seed=s)`` against ``virtual_run(seed=s)``
    split    the ValueErrors of a worker count the ranks do not divide
    """
    import torch

    from repro_torch.core import device_sched as ds

    mesh = _sched_mesh(world)
    out = []
    for job in payload:
        kind, p, speeds, tasks, radius, max_steal = (job[k] for k in (
            "kind", "p", "speeds", "tasks", "radius", "max_steal"))
        packed = job.get("packed", True)
        b, first = p // world, rank * (p // world)
        counts = [tasks // p + (1 if i < tasks % p else 0) for i in range(p)]
        if kind == "split":
            errs = []
            for make in (lambda: ds.init_state(p, counts, speeds, radius, tasks, "cpu", mesh=mesh),
                         lambda: ds.make_round_fn(p, radius, max_steal, device="cpu", mesh=mesh),
                         lambda: ds.virtual_run(p, speeds, tasks, radius, device="cpu", mesh=mesh)):
                try:
                    make()
                    errs.append(None)
                except ValueError as e:
                    errs.append(str(e))
            out.append(errs)
            continue
        if kind == "seed":
            mine, rounds, makespan = ds.virtual_run(
                p, speeds, tasks, radius, max_steal, seed=job["seed"], device="cpu",
                packed=packed, mesh=mesh)
            whole, want_rounds, want_ms = ds.virtual_run(
                p, speeds, tasks, radius, max_steal, seed=job["seed"], device="cpu",
                packed=packed)
            got = ds.gather_state(mine, mesh)
            out.append({"field": _same_state(got, whole), "rounds": (rounds, want_rounds),
                        "makespan": (makespan, want_ms)})
            continue
        state = ds.init_state(p, counts, speeds, radius, tasks, "cpu", mesh=mesh)
        step = ds.make_round_fn(p, radius, max_steal, packed=packed, device="cpu", mesh=mesh)
        w = 2 * radius + 1
        if kind == "replay":
            states = [_state_np(ds.gather_state(state, mesh))]
            for g in job["gumbel"]:
                state = step(state, gumbel=torch.from_numpy(g[first:first + b]))
                states.append(_state_np(ds.gather_state(state, mesh)))
            out.append(states)
            continue
        assert kind == "ranks_vs_one", kind
        whole = ds.init_state(p, counts, speeds, radius, tasks, "cpu")
        one = ds.make_round_fn(p, radius, max_steal, packed=packed, device="cpu")
        draws = job["gumbel"]
        rounds = 0
        while int((whole.tail - whole.head).sum()) > 0:
            if rounds == len(draws):
                raise AssertionError(f"the run outlasts its {len(draws)} rounds of draws")
            g = torch.from_numpy(draws[rounds])
            whole = one(whole, gumbel=g)
            state = step(state, gumbel=g[first:first + b])
            rounds += 1
            rows = ds.SchedState(*(t[first:first + b] for t in whole))
            field = _same_state(state, rows)
            if field is not None:
                raise AssertionError(f"rank {rank}: round {rounds}, field {field} differs")
        final = ds.gather_state(state, mesh)
        out.append({"rounds": rounds, "state": _state_np(final),
                    "makespan": float(ds._over_axis(state.clock.max(), "max", mesh, "workers"))})
    return out


def vocab_worker(rank, world, payload):
    """The vocab-parallel lookup and log-softmax (``parallel.sharding``'s
    ``vocab_lookup``, ``vocab_log_prob``) on the payload's mesh, the table
    and the logits split over 'model' by vocab and the rows over 'data',
    against the same functions on plain tensors: values and gradients
    (whole), the table gradient's placements, and the ValueErrors of a
    vocab that 'model' does not divide and of a label outside the
    vocabulary (through ``lm.loss_fn``)."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_smoke
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import distribute, distribute_tree, vocab_log_prob, \
        vocab_lookup
    from repro_torch.train.step import batch_shardings, train_shardings
    from repro_torch.optim.adamw import AdamWConfig

    ctx = _mesh(payload)
    mesh = ctx.mesh
    table, tokens = (torch.from_numpy(payload[k]) for k in ("table", "tokens"))
    logits, labels = (torch.from_numpy(payload[k]) for k in ("logits", "labels"))
    out = {}
    for name, fn, x, idx, spec in (
            ("lookup", vocab_lookup, table, tokens, ("model", None)),
            ("log_prob", vocab_log_prob, logits, labels, ("data", None, "model"))):
        plain = x.clone().requires_grad_()
        y = fn(plain, idx)
        (g_plain,) = torch.autograd.grad((y * y).sum(), plain)
        with implicit_replication():
            dx = distribute(x, mesh, spec).requires_grad_()
            dy = fn(dx, distribute(idx, mesh, ("data",) + (None,) * (idx.ndim - 1)))
            (g,) = torch.autograd.grad((dy * dy).sum(), dx)
        out[name] = {"plain": _np(y), "sharded": _np(dy), "grad_plain": _np(g_plain),
                     "grad": _np(g), "grad_placements": [repr(p) for p in g.placements]}
    errs = {}
    odd = distribute(table[:-1].contiguous(), mesh, (None, None))  # 255 rows
    for what, call in (("lookup", lambda: vocab_lookup(odd, tokens)),
                       ("log_prob", lambda: vocab_log_prob(
                           distribute(logits[..., :-1].contiguous(), mesh, (None,) * 3), labels))):
        try:
            with implicit_replication():
                call()
            errs[what] = None
        except ValueError as e:
            errs[what] = str(e)
    cfg = get_smoke("phi4-mini-3.8b").with_(dtype="float32")
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    params = distribute_tree(params, train_shardings(cfg, ctx, AdamWConfig())[0])
    toks = torch.from_numpy(payload["tokens"][:, :8].copy())
    bad = {"tokens": toks, "labels": toks.clone().fill_(cfg.vocab)}
    try:
        lm.loss_fn(params, distribute_tree(bad, batch_shardings(bad, ctx)), cfg, ctx)
        errs["label"] = None
    except ValueError as e:
        errs["label"] = str(e)
    out["errors"] = errs
    return out


def collectives_worker(rank, world, payload):
    """``parallel.collectives`` over each set of axes of the payload on a
    2x2x2 ("pod", "data", "model") mesh: each rank's row of ``x`` summed
    (``all_reduce``), maxed, gathered (``all_gather``) and scaled by its
    sum of squares over the ranks (``sum_shares``); the results, the
    gradients of the given cotangents (this rank's block of each) and the
    collectives each forward and backward ran, by kind, as the counting
    dispatch mode files them.  Returns every rank's, in rank order."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.op_analysis import analyze_ops
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import axis_names

    mesh = make_debug_mesh(2, 2, 2)
    names = axis_names(mesh)

    def calls(costs):
        return {k: v.calls for k, v in costs.breakdown["coll"].items() if k != "-"}

    mine = {}
    for axes, cases in payload["cases"].items():
        rest = [a for a in names if a not in axes]
        fns = {"sum": lambda b: coll.all_reduce(b, mesh, axes),
               "max": lambda b: coll.all_reduce(b, mesh, axes, op="max"),
               "gather": lambda b: coll.all_gather(b, mesh, axes),
               "shares": lambda b: b * coll.sum_shares((b * b).sum(), mesh, axes)}
        for op, fn in fns.items():
            x = torch.from_numpy(payload["x"][rank:rank + 1]).requires_grad_(op != "max")
            y, fwd, _ = analyze_ops(fn, x, breakdown=True)
            rec = {"y": y.detach().numpy(), "fwd": calls(fwd)}
            if op != "max":
                blk = coll.linear_index(mesh, rest if op == "sum" else names)
                ct = torch.from_numpy(cases[op][blk * y.shape[0]:(blk + 1) * y.shape[0]])
                (g,), bwd, _ = analyze_ops(torch.autograd.grad, y, x, ct, breakdown=True)
                rec.update(grad=g.numpy(), bwd=calls(bwd))
            mine[(axes, op)] = rec
    every = [None] * world
    dist.all_gather_object(every, mine)
    return every
