"""End-to-end driver on the PyTorch port: LM training with A2WS-scheduled
heterogeneous data parallelism, fault injection and checkpoint/restart, as
``examples/het_train.py`` runs the JAX reference.

The global batch is cut into microbatch TASKS; worker groups (one fast, one
deliberately slow, one that dies mid-run) own A2WS deques of them.  Fast
workers steal microbatches from stragglers, the dying worker's tasks are
re-queued and finished by survivors, and the driver restarts from the last
checkpoint after removing it.  The combined gradient is exact regardless of
who computed what, so A2WS changes step latency, never semantics.

Runs on the card by default (each worker on a CUDA stream of its own);
``--device cpu`` runs it on the host.  The model is a SMOKE config with
random weights drawn from a seeded ``torch.Generator``.

    PYTHONPATH=src python examples/het_train_torch.py --device cpu
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs import get_smoke
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.bridge import flatten
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.fault_tolerance import ResilientDriver
from repro_torch.runtime.het_dp import HetDPTrainer, WorkerSpec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda by default; a cuda request without a card fails)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--mb-size", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--fail-step", type=int, default=12)
    ap.add_argument("--compress", action="store_true",
                    help="int8+error-feedback gradient compression")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch)
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    n_params = sum(t.numel() for t in flatten(params).values())
    print(f"arch {cfg.name}: {n_params/1e6:.2f}M params on {dev}, "
          f"{args.microbatches} microbatch tasks/step")

    data = SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq,
        global_batch=args.mb_size * args.microbatches, seed=0,
    ))

    def loss_fn(p, batch):
        return lm.loss_fn(p, batch, cfg)

    def make_microbatches(step):
        b = data.batch_at(step)
        return [
            {k: torch.from_numpy(v[i::args.microbatches].copy()).to(dev) for k, v in b.items()}
            for i in range(args.microbatches)
        ]

    workers = [
        WorkerSpec("fast-pod"),
        WorkerSpec("throttled-pod", slow_factor=5.0),
        WorkerSpec("flaky-pod", fail_at_step=args.fail_step),
    ]
    trainer = HetDPTrainer(
        loss_fn, params, workers,
        AdamWConfig(lr=args.lr, weight_decay=0.0),
        compress=args.compress, base_task_time=0.01,
    )
    with tempfile.TemporaryDirectory(prefix="het_train_ckpt_") as ckpt_dir:
        driver = ResilientDriver(trainer, make_microbatches, ckpt_dir, ckpt_every=5)
        report = driver.run(args.steps)

    print(f"steps run:        {report.steps_run}")
    print(f"restarts:         {report.restarts}")
    print(f"removed workers:  {report.removed_workers}")
    print(f"final loss:       {report.final_loss:.4f}")
    tot = [0] * 3
    for st in trainer.history:
        for i, c in enumerate(st.per_worker_tasks):
            if i < len(tot):
                tot[i] += c
    print(f"microbatches/worker (lifetime): {tot} — the straggler ran fewer, "
          "thanks to stealing")


if __name__ == "__main__":
    main()
