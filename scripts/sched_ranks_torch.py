"""Run the port's device scheduler across ranks: each rank of the process
group that ``torchrun`` starts holds a block of the workers, on a 1-D
("workers",) mesh of the whole group (``repro_torch.core.device_sched`` with
``mesh=``).  Rank 0 prints the rounds, the makespan and the tasks executed
per speed quarter {24, 16, 4, 1}; ``--check`` also runs the one-process
scheduler on the same seed on rank 0 and fails unless the whole state, the
rounds and the makespan are equal.

    torchrun --nproc-per-node 4 scripts/sched_ranks_torch.py --device cpu --check
    torchrun --nproc-per-node 1 scripts/sched_ranks_torch.py --check     # one card, nccl
    torchrun --nproc-per-node 4 scripts/sched_ranks_torch.py --backend gloo
        # four ranks sharing one card: NCCL takes one rank a card

The configuration is scripts/sched_cell.py's: 256 workers, radius 51,
max_steal 16, 30 tasks a worker, victims drawn from a generator seeded 0.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import torch
import torch.distributed as dist

from repro_torch.core import device_sched as ds
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_workers_mesh
from sched_cell_torch import MAX_STEAL, NUM_TASKS, P, RADIUS, SPEEDS


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", action="store_true", help="i32 exchanges instead of u16")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", help="default: nccl on cuda, gloo on the CPU")
    ap.add_argument("--check", action="store_true",
                    help="hold the run to the one-process scheduler on rank 0")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count())
    dist.init_process_group(args.backend or ("nccl" if dev.type == "cuda" else "gloo"))
    try:
        run = dict(num_workers=P, speeds=SPEEDS, num_tasks=NUM_TASKS, radius=RADIUS,
                   max_steal=MAX_STEAL, device=dev, packed=not args.baseline)
        mesh = make_workers_mesh(dist.get_world_size())
        t0 = time.perf_counter()
        block, rounds, makespan = ds.virtual_run(**run, mesh=mesh)
        wall = time.perf_counter() - t0
        state = ds.gather_state(block, mesh)
        if dist.get_rank() == 0:
            quarters = state.executed.cpu().view(4, -1).sum(1).tolist()
            n = dist.get_world_size()
            print(f"{n} ranks ({dist.get_backend()}) x {P // n} workers on {dev}: {rounds} "
                  f"rounds, makespan {makespan}, executed per speed quarter {quarters}, "
                  f"{wall:.3f} s")
            if args.check:
                whole, want_rounds, want_ms = ds.virtual_run(**run)
                same = all(bool(((a == b) | (a.isnan() & b.isnan())).all())
                           if a.is_floating_point() else torch.equal(a, b)
                           for a, b in zip(state, whole))
                print(f"one process: {want_rounds} rounds, makespan {want_ms}; "
                      f"state {'equal' if same else 'DIFFERENT'}")
                if not (same and rounds == want_rounds and makespan == want_ms):
                    raise SystemExit(1)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
