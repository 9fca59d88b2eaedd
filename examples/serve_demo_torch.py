"""Continuous-batching serving on PyTorch with A2WS request scheduling across
heterogeneous model replicas: requests stream into a LIVE pool (open-arrival
mode, DESIGN.md §Open-arrival), replicas are workers, and fast replicas steal
queued requests from slow ones mid-flight — including requests submitted
after the pool started, across wave boundaries, with no teardown in between.
The torch counterpart of ``examples/serve_demo.py``; the replicas share one
set of random weights, each generating on a CUDA stream of its own.

    PYTHONPATH=src python examples/serve_demo_torch.py                # on a card
    PYTHONPATH=src python examples/serve_demo_torch.py --device cpu
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_smoke
from repro_torch.device import resolve_device
from repro_torch.launch.serve import make_decode, make_replica_generate
from repro_torch.models import lm
from repro_torch.serve.engine import Replica, ServePool

NUM_REQUESTS = 16
PROMPT_LEN = 12
NEW_TOKENS = 6


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", choices=ARCH_IDS, default="mistral-nemo-12b",
                    help="serves the architecture's SMOKE config")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch)
    dev = resolve_device(args.device)
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    decode = make_decode(cfg)
    rng = np.random.default_rng(0)
    requests = [{"tokens": rng.integers(0, cfg.vocab, PROMPT_LEN)}
                for _ in range(NUM_REQUESTS)]
    pool = ServePool([
        Replica("fast-replica", make_replica_generate(cfg, params, NEW_TOKENS, decode)),
        Replica("slow-replica", make_replica_generate(cfg, params, NEW_TOKENS, decode),
                slow_factor=4.0),
    ])
    pool.start()  # boots once; lives across both waves below
    t0 = time.perf_counter()
    responses, stats = pool.submit_all(requests)
    dt = time.perf_counter() - t0
    print(f"wave 1 on {params['embed'].device}: served {len(responses)} requests x "
          f"{NEW_TOKENS} tokens in {dt:.2f}s ({len(responses)*NEW_TOKENS/dt:.1f} tok/s)")
    print(f"  requests/replica: {stats.per_worker_tasks} "
          f"(steals: {len(stats.steals)}) — fast replica served more")
    print(f"  sample completion: {responses[0]['completion']}")

    # wave 2 streams into the SAME live pool — every request is pinned to the
    # slow replica at submit time, so each one served by the fast replica was
    # stolen mid-flight after injection.
    futs = [pool.submit(r, replica=1) for r in requests]
    for f in futs:
        f.result(timeout=300)
    stolen = sum(1 for f in futs if f.worker == 0)
    final = pool.shutdown()
    pct = final.latency_percentiles()
    print(f"wave 2 (streamed, all pinned to slow replica): "
          f"{stolen}/{len(futs)} rescued by the fast replica via steals")
    print("  pool-lifetime latency p50/p95/p99 = "
          + "/".join(f"{pct[q]*1e3:.0f}ms" for q in (50.0, 95.0, 99.0)))


if __name__ == "__main__":
    main()
