"""Training driver: any token-in arch on one device, as
``repro/launch/train.py`` drives the reference; on the card by default
(``--device cpu`` runs it on the host).

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \
        --device cpu --smoke --steps 20 --batch 4 --seq 128 --ckpt /tmp/ckpt

Weights are random, drawn from a ``torch.Generator`` seeded with ``--seed``;
batches come from the copied ``SyntheticLM``.  Fault tolerance: periodic
async checkpoints in the reference's format, resume on start (into the
current mesh's layout, whatever mesh wrote them).

``--mesh DATAxMODEL`` runs the reference's sharded step
(``jit_train_step``) on a ``DATA x MODEL`` mesh, one rank a process, under
``torchrun`` (``gloo`` on the CPU, ``nccl`` on cards):

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch phi4-mini-3.8b --device cpu --smoke --mesh 2x2 --steps 4

Every rank draws the same weights and batches and keeps its own pieces;
rank 0 prints and writes the checkpoints.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import store
from repro_torch.configs.base import ARCH_IDS, get_config, get_smoke
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.parallel.sharding import make_context
from repro_torch.train.step import jit_train_step, train_shardings


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda by default; a cuda "
                         "request without a card fails)")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--mesh", default="", help="DATAxMODEL, e.g. 2x4")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if cfg.frontend != "none" or cfg.enc_layers:
        raise SystemExit(
            "train driver feeds token batches; use examples/het_train.py for "
            "frontend-stubbed archs"
        )
    dev = resolve_device(args.device)
    ctx, rank = make_context(None), 0
    if args.mesh:
        ctx, rank, dev = _mesh_context(args.mesh, dev)
    opt_cfg = AdamWConfig(lr=args.lr)

    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    opt_state = adamw_init(params, opt_cfg)
    param_sh, opt_sh = train_shardings(cfg, ctx, opt_cfg)

    data = SyntheticLM(
        DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
                   seed=args.seed)
    )
    start = 0
    ckpt = store.AsyncCheckpointer(args.ckpt) if args.ckpt and rank == 0 else None
    if args.ckpt and store.latest_step(args.ckpt) is not None:
        shardings = None if param_sh is None else {"params": param_sh, "opt": opt_sh}
        restored, start = store.restore(
            args.ckpt, {"params": params, "opt": opt_state}, shardings=shardings
        )
        params, opt_state = restored["params"], restored["opt"]
        if rank == 0:
            print(f"resumed from step {start}")

    step_fn = jit_train_step(
        cfg, ctx, opt_cfg, schedule={"warmup": 10, "total": max(args.steps, 20)},
    )
    for step in range(start, args.steps):
        t0 = time.time()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % args.log_every == 0 and rank == 0:
            loss = float(metrics["loss"])
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} "
                  f"dt {time.time()-t0:6.2f}s")
        if args.ckpt and ((step + 1) % args.ckpt_every == 0 or step + 1 == args.steps):
            _save(ckpt, step + 1, {"params": params, "opt": opt_state})
    if ckpt:
        ckpt.wait()
    if rank == 0:
        print("done")


def _mesh_context(mesh: str, dev: torch.device):
    """(context, rank, device) of a ``DATAxMODEL`` mesh over the ranks
    ``torchrun`` started (its environment names them)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    data, model = (int(x) for x in mesh.lower().split("x"))
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    rank = dist.get_rank()
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return make_context(make_debug_mesh(data, model)), rank, dev


def _save(ckpt, step: int, tree) -> None:
    """Checkpoint ``tree``: every rank gathers its DTensors whole (a
    collective), the writer (rank 0's ``ckpt``) saves them."""
    from repro_torch.autodiff import tree_map

    whole = tree_map(lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t, tree)
    if ckpt is not None:
        ckpt.save(step, whole)


if __name__ == "__main__":
    main()
