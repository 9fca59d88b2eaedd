"""Where the port's decode step spends its time on the card.

Builds phi4-mini-3.8b at full width in bf16 (random weights from a seeded
``torch.Generator``; the SMOKE config when ``--device cpu``, which only
rehearses the script) and measures, at batch 1 against a 160-token cache:

1. the wall time of a decode step (synchronised host clock);
2. under ``torch.profiler``, the device time its kernels take (the union of
   their intervals), their count, and so the share of the step the device
   sits idle, with the kernels that take the most time;
3. how replicas on one card slow each other down: the aggregate decode
   steps per second of 1, 2 and 3 replica threads in one process (each on
   its own CUDA stream with its own caches, sharing the weights, as
   ``ServePool`` runs them), then of 2 and 3 replica processes (each with
   its own copy of the weights).  Threads share the process's interpreter
   lock and caching allocator; processes share only the card and its
   driver.

    PYTHONPATH=src python scripts/profile_serve_torch.py            # on a card
    PYTHONPATH=src python scripts/profile_serve_torch.py --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch
from torch.autograd import DeviceType

from repro_torch.configs import get_config, get_smoke
from repro_torch.device import resolve_device
from repro_torch.models import lm

ARCH = "phi4-mini-3.8b"
CACHE = 160
POS0 = 128
PROFILE_STEPS = 10
CONTEND_STEPS = 30  # decode steps each replica runs in part 3


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build(dev):
    cfg = get_config(ARCH) if dev.type == "cuda" else get_smoke(ARCH)
    return cfg, lm.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)


def decode_loop(cfg, params, caches, tok, steps: int) -> None:
    for i in range(steps):
        lm.decode_step(params, tok, caches, POS0 + i % (CACHE - POS0), cfg)


def union_us(intervals) -> float:
    """Total length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def replica_process(device: str, barrier, out) -> None:
    """One replica in a process of its own: its weights, its caches, its
    decode loop, started with its peers' at ``barrier``."""
    dev = torch.device(device)
    cfg, params = build(dev)
    tok = torch.zeros((1, 1), dtype=torch.long, device=dev)
    caches = lm.init_caches(cfg, 1, CACHE, device=dev)
    decode_loop(cfg, params, caches, tok, 4)  # warm-up
    sync(dev)
    barrier.wait(timeout=300)
    t0 = time.perf_counter()
    decode_loop(cfg, params, caches, tok, CONTEND_STEPS)
    sync(dev)
    out.put(time.perf_counter() - t0)


def report(n: int, what: str, wall: float) -> None:
    print(f"{n} replica {what}, {CONTEND_STEPS} decode steps each: {wall:.3f} s, "
          f"{n * CONTEND_STEPS / wall:.2f} steps/s together "
          f"({1e3 * wall / CONTEND_STEPS:.2f} ms per step of each)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg, params = build(dev)
    tok = torch.zeros((1, 1), dtype=torch.long, device=dev)
    caches = lm.init_caches(cfg, 1, CACHE, device=dev)
    decode_loop(cfg, params, caches, tok, 4)  # warm-up
    sync(dev)
    if dev.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(dev)}")

    t0 = time.perf_counter()
    decode_loop(cfg, params, caches, tok, PROFILE_STEPS)
    sync(dev)
    step_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    print(f"{cfg.name}: decode batch 1, {CACHE}-token cache: {step_ms:.4f} ms per step "
          f"(host clock, synchronised)")

    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        decode_loop(cfg, params, caches, tok, PROFILE_STEPS)
        sync(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if kernels:
        busy = union_us((e.time_range.start, e.time_range.end) for e in kernels)
        print(f"profiled: {len(kernels) / PROFILE_STEPS:.1f} kernels per step, device busy "
              f"{busy / 1e3 / PROFILE_STEPS:.4f} ms per step of "
              f"{wall_us / 1e3 / PROFILE_STEPS:.4f} (idle share {1 - busy / wall_us:.1%})")
        by_name: dict[str, float] = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            print(f"  {us / 1e3 / PROFILE_STEPS:9.4f} ms/step  {name[:100]}")
    else:
        print("profiled: no device events recorded; device busy time not measured")
    ops = [e for e in prof.events() if e.device_type == DeviceType.CPU and e.name.startswith("aten::")]
    top = sum(1 for e in ops if e.cpu_parent is None)
    print(f"host: {top / PROFILE_STEPS:.1f} top-level aten ops per step")

    for n in (1, 2, 3):
        own = [lm.init_caches(cfg, 1, CACHE, device=dev) for _ in range(n)]
        streams = [torch.cuda.Stream(dev) if dev.type == "cuda" else None for _ in range(n)]

        def worker(i: int) -> None:
            s = streams[i]
            with torch.cuda.stream(s) if s is not None else contextlib.nullcontext():
                decode_loop(cfg, params, own[i], tok, CONTEND_STEPS)
                if s is not None:
                    s.synchronize()

        sync(dev)
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        report(n, "thread(s)", time.perf_counter() - t0)

    mp = torch.multiprocessing.get_context("spawn")
    for n in (2, 3):
        barrier, out = mp.Barrier(n), mp.SimpleQueue()
        procs = [mp.Process(target=replica_process, args=(str(dev), barrier, out))
                 for _ in range(n)]
        try:
            for p in procs:
                p.start()
            for p in procs:
                p.join(timeout=600)
            if any(p.exitcode != 0 for p in procs):
                raise RuntimeError(f"replica processes exited {[p.exitcode for p in procs]}")
            report(n, "processes", max(out.get() for _ in range(n)))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()


if __name__ == "__main__":
    main()
