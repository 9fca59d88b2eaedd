"""Measure one round of the port's device scheduler on the card, at the
configuration of scripts/sched_cell.py: P=256 workers, radius 51 (20% of P),
max_steal 16, 7680 tasks, speeds {24, 16, 4, 1} in contiguous quarters.

For each variant (baseline, packed) it records:

* the device ms of one round (CUDA events around each of ``TIMED_ROUNDS``
  rounds after warm-up, median), and the host's enqueue time of the same
  calls;
* the kernels one round launches, their busy time on the device, and the
  host ops that cost the most host time (torch.profiler over 10 rounds);
* the bytes one round must move, reckoned from the tensors' shapes, and the
  time they take at 3.35 TB/s.  The reference's collective bytes (ring
  shifts, request and payload all_to_all) are device-memory traffic here:
  one process holds every worker, so each exchanged buffer is written once
  by its senders and read once by its receivers;
* the whole run to completion: rounds, makespan, wall time.

Every round is applied to one fixed mid-run state (the state after
``WARM_ROUNDS`` rounds, when steals are under way), so every timed round does
the same work.  The variants are measured in turns (baseline, packed,
packed, baseline), so that drift on the machine shows as a gap between two
measurements of one variant.  Prints one JSON line per measurement and
writes the whole record, the busiest kernels and host ops included, to
``--out`` when given.

    python scripts/sched_cell_torch.py --out sched_cell_torch.json  # on the card
    python scripts/sched_cell_torch.py --device cpu
        # rehearsal on the CPU: host times only, device fields null

``--dryrun [--variant baseline|packed]`` is instead the counterpart of
scripts/sched_cell.py: one round of the multi-rank scheduler on a 1-D
("workers",) mesh of a fake group of 256 ranks, one worker a rank, traced as
rank 0 on fake tensors under ``OpCounter``.  It writes
experiments/dryrun_torch/a2ws-sched__round__16x16__<variant>.json with the
reference record's keys: the per-device collective bytes by kind, which must
equal the reference's, and the eager ops' bytes and live bytes beside the
reference's HLO figures (eager ops are not fused HLO, so those differ).
Analytic, on a CPU: nothing in it is measured on a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import torch

from repro_torch.core import device_sched as ds
from repro_torch.device import resolve_device

P = 256
RADIUS = 51  # 20% of 256 (the paper's operating point)
MAX_STEAL = 16
NUM_TASKS = 256 * 30
SPEEDS = [s for s in (24.0, 16.0, 4.0, 1.0) for _ in range(P // 4)]
WARM_ROUNDS = 5
TIMED_ROUNDS = 60
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak
# scripts/sched_cell.py's records (the reference's round lowered on 256
# forced host devices of a CPU, analyze_hlo and memory_analysis), per device
REFERENCE = {
    "baseline": {"collectives": {"all-reduce": 8, "collective-permute": 1224,
                                 "all-to-all": 17408},
                 "bytes_per_device": 5_594_683, "live_bytes_per_device": 171_892},
    "packed": {"collectives": {"all-reduce": 8, "collective-permute": 1224,
                               "all-to-all": 8704},
               "bytes_per_device": 5_731_943, "live_bytes_per_device": 172_916},
}
DRYRUN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "experiments",
                          "dryrun_torch")


def round_bytes(p: int, radius: int, max_steal: int, cap: int, packed: bool) -> dict:
    """Bytes one round must move: the state read once and written once, and
    each exchanged buffer written once and read once."""
    w = 2 * radius + 1
    state = p * cap * 4 + 3 * p * w * 4 + 6 * p * 4  # queue, 3 windows, 6 vectors
    req = p * p * (2 if packed else 4)
    payload = p * p * max_steal * (2 if packed and cap < 0xFFFF else 4)
    ring = 2 * 3 * p * radius * 4  # the two shifted halves of the windows
    exchange = 2 * (req + payload + ring)
    total = 2 * state + exchange
    return {"state_bytes": 2 * state, "exchange_bytes": exchange, "total_bytes": total,
            "bytes_ms_at_3_35_TBps": total / HBM_BYTES_PER_S * 1e3}


def profile_round(round_fn, state, gen, n: int) -> dict:
    """Kernels per round and their summed device time, over ``n`` rounds."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            round_fn(state, gen)
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    host = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("aten::"):
            host[e.name] = host.get(e.name, 0.0) + e.self_cpu_time_total
    top_host = sorted(host.items(), key=lambda kv: -kv[1])[:8]
    rec = {"top_host_ops_us_per_round": [[k, v / n] for k, v in top_host]}
    if not kernels:
        return {**rec, "kernels_per_round": None, "kernel_busy_ms_per_round": None,
                "note": "the profiler recorded no device events"}
    names = {}
    for e in kernels:
        name = e.name.removeprefix("void ").removeprefix("at::native::")[:100]
        names[name] = names.get(name, 0) + 1
    top = sorted(names.items(), key=lambda kv: -kv[1])[:12]
    return {
        **rec,
        "kernels_per_round": len(kernels) / n,
        "kernel_busy_ms_per_round": sum(e.device_time for e in kernels) / 1e3 / n,
        "top_kernels": [[k, v / n] for k, v in top],
    }


def measure(packed: bool, dev: torch.device) -> dict:
    cuda = dev.type == "cuda"
    round_fn = ds.make_round_fn(P, RADIUS, MAX_STEAL, packed=packed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    base, rem = divmod(NUM_TASKS, P)
    counts = [base + (1 if i < rem else 0) for i in range(P)]
    state = ds.init_state(P, counts, SPEEDS, RADIUS, NUM_TASKS, device=dev)
    for _ in range(WARM_ROUNDS):
        state = round_fn(state, gen)
    for _ in range(5):  # warm-up of the timed call
        round_fn(state, gen)
    if cuda:
        torch.cuda.synchronize()
    dev_ms, host_ms = [], []
    for _ in range(TIMED_ROUNDS):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        round_fn(state, gen)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            stop.record()
            torch.cuda.synchronize()
            dev_ms.append(start.elapsed_time(stop))
    rec = {
        "variant": "packed" if packed else "baseline",
        "timed_rounds": TIMED_ROUNDS,
        "round_ms_median": statistics.median(dev_ms) if cuda else None,
        "round_ms_min": min(dev_ms) if cuda else None,
        "host_enqueue_ms_median": statistics.median(host_ms),
        **round_bytes(P, RADIUS, MAX_STEAL, NUM_TASKS, packed),
    }
    if cuda:
        rec.update(profile_round(round_fn, state, gen, 10))
        rec["host_bound"] = rec["host_enqueue_ms_median"] >= 0.9 * rec["round_ms_median"]
    t0 = time.perf_counter()
    final, n_rounds, makespan = ds.virtual_run(
        P, SPEEDS, NUM_TASKS, RADIUS, MAX_STEAL, device=dev, packed=packed,
        generator=torch.Generator().manual_seed(0))
    rec.update(run_rounds=n_rounds, run_makespan=makespan,
               run_wall_s=time.perf_counter() - t0,
               run_executed_sum=int(final.executed.sum()))
    return rec


def dryrun_record(variant: str, p: int = P, radius: int = RADIUS, max_steal: int = MAX_STEAL,
                  num_tasks: int = NUM_TASKS) -> dict:
    """One round on a ("workers",) mesh of ``p`` ranks, one worker a rank,
    traced as rank 0 of a fake group on fake tensors: the roofline record
    with the reference's keys.  Makes the fake group if none exists."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.cells import roofline_terms
    from repro_torch.launch.dryrun import init_fake_group
    from repro_torch.launch.mesh import make_workers_mesh
    from repro_torch.launch.op_analysis import OpCounter, local_bytes

    init_fake_group(p)
    mesh = make_workers_mesh(p)
    speeds = [s for s in (24.0, 16.0, 4.0, 1.0) for _ in range(p // 4)]
    base, rem = divmod(num_tasks, p)
    counts = [base + (1 if i < rem else 0) for i in range(p)]
    state = ds.init_state(p, counts, speeds, radius, num_tasks, device="cpu", mesh=mesh)
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = ds.SchedState(*(mode.from_tensor(t) for t in state))
        gumbel = mode.from_tensor(torch.zeros(state.queue.shape[0], 2 * radius + 1))
        with OpCounter(local_bytes(fake)) as counter:
            ds.a2ws_round(fake, radius=radius, max_steal=max_steal,
                          packed=variant == "packed", gumbel=gumbel, mesh=mesh)
    costs = counter.costs
    terms = roofline_terms(costs.flops, costs.bytes, costs.coll_bytes)
    return {
        "arch": "a2ws-sched",
        "shape": f"round_p{p}_r{radius}",
        "kind": "sched",
        "variant": variant,
        "chips": p,
        "mesh": "16x16",
        "status": "ok",
        "flops_per_device": costs.flops,
        "bytes_per_device": costs.bytes,
        "collective_bytes_per_device": costs.coll_bytes,
        "collectives": {k: int(v) for k, v in costs.coll.items()},
        **terms,
        "dominant": max(terms, key=terms.get),
        "live_bytes_per_device": int(counter.peak_bytes),
        "ops_per_device": costs.ops,
        "trace_s": time.perf_counter() - t0,
        "reference": REFERENCE[variant] if (p, radius, max_steal, num_tasks) == (
            P, RADIUS, MAX_STEAL, NUM_TASKS) else None,
    }


def dryrun(variants) -> None:
    """Write and print the dry-run record of each variant; exit non-zero if
    its collective bytes differ from the reference's."""
    bad = []
    for variant in variants:
        rec = dryrun_record(variant)
        path = os.path.join(DRYRUN_DIR, f"a2ws-sched__round__16x16__{variant}.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(json.dumps({k: rec[k] for k in (
            "variant", "collectives", "collective_bytes_per_device", "bytes_per_device",
            "live_bytes_per_device", "ops_per_device", "t_collective", "dominant",
            "reference")}))
        if rec["collectives"] != REFERENCE[variant]["collectives"]:
            bad.append(variant)
    if bad:
        raise SystemExit(f"collective bytes differ from the reference's: {bad}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="path of the JSON record")
    ap.add_argument("--dryrun", action="store_true",
                    help="count one round on a fake group of 256 ranks instead")
    ap.add_argument("--variant", choices=("baseline", "packed"),
                    help="with --dryrun: this variant only (default both)")
    args = ap.parse_args()
    if args.dryrun:
        dryrun([args.variant] if args.variant else ["baseline", "packed"])
        return
    dev = resolve_device(args.device)
    card = None
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None
        print(f"[sched-cell] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}")
    out = {
        "arch": "a2ws-sched", "shape": f"round_p{P}_r{RADIUS}", "device": str(dev),
        "card": card, "torch": torch.__version__, "max_steal": MAX_STEAL,
        "num_tasks": NUM_TASKS, "warm_rounds": WARM_ROUNDS,
        "variants": [measure(packed, dev) for packed in (False, True, True, False)],
    }
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    for rec in out["variants"]:
        print(json.dumps({k: v for k, v in rec.items() if not k.startswith("top_")}))


if __name__ == "__main__":
    main()
