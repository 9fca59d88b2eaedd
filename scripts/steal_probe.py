#!/usr/bin/env python3
"""When A2WS steals in a closed pool of few tasks: sleep tasks on the
threaded ``WorkerPool`` (the port's byte-identical copy of the reference's),
the last worker slower than the others.

Each line is a JSON object: the task count, the fast and slow task times
(seconds), the seed, the tasks each worker ran and the steals.  A worker's
queue is invisible to thieves until it finishes its first task and
publishes it on the info ring, and with two tasks a worker it pops its
last task at that same boundary, so with 6 tasks over 3 workers the slow
worker is never stolen from; with 9 it is.  The numbers behind
``chip_smoke.py``'s TRAIN_TASKS.

    PYTHONPATH=src python scripts/steal_probe.py
"""

from __future__ import annotations

import argparse
import json
import time

from repro_torch.core.a2ws import WorkerPool


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tasks", type=int, nargs="+", default=[6, 9, 12])
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--fast", type=float, default=0.2)
    ap.add_argument("--slow", type=float, nargs="+", default=[0.35, 0.8, 2.0])
    ap.add_argument("--seeds", type=int, default=3)
    args = ap.parse_args()
    last = args.workers - 1
    for n in args.tasks:
        for slow in args.slow:
            for seed in range(args.seeds):
                pool = WorkerPool(list(range(n)), args.workers,
                                  lambda w, _t, s=slow: time.sleep(s if w == last else args.fast),
                                  seed=seed)
                st = pool.run()
                print(json.dumps({"tasks": n, "fast_s": args.fast, "slow_s": slow, "seed": seed,
                                  "tasks_per_worker": st.per_worker_tasks,
                                  "steals": len(st.steals), "makespan_s": st.makespan}),
                      flush=True)


if __name__ == "__main__":
    main()
