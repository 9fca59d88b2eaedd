"""Serving launcher: greedy generation on a reduced config, on the card by
default (``--device cpu`` runs it on the host).

Closed batch:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \
        --requests 8 --prompt-len 32 --new-tokens 16

Open-arrival continuous batching (DESIGN.md §Open-arrival): requests arrive
as a Poisson stream into a live ``ServePool`` over heterogeneous replicas —
fast replicas steal queued requests from slow ones mid-flight, and the
launcher reports per-request latency percentiles:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \
        --requests 24 --prompt-len 16 --new-tokens 8 \
        --open-arrival --rate 8 --replicas 2 --slow-factor 4

The replicas share one set of weights.  On a card each replica generates on
a CUDA stream of its own and returns only once that stream is done, so the
pool's steal equations price service times.  The scheduling flags
(``--policy``, ``--autoscale-max``, ``--limp-*``, ``--topology``,
``--net-faults``, ``--migration-cost``) are the reference launcher's
(``repro/launch/serve.py``).  Weights are random, drawn from a
``torch.Generator`` seeded with ``--seed``.
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from repro_torch.configs.base import ARCH_IDS, get_smoke
from repro_torch.core.limp import LimpConfig, SlowdownEvent, SlowdownSchedule
from repro_torch.core.netfault import parse_netfaults
from repro_torch.core.policy import POLICIES
from repro_torch.core.topology import parse_topology
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serve.engine import AutoscaleConfig, Replica, ServePool, jit_decode_step


def make_decode(cfg):
    """One decode step, reusable across requests and replicas."""
    return jit_decode_step(cfg)


def generate(cfg, params, tokens: torch.Tensor, new_tokens: int, decode=None):
    """Greedy generation for a [B, S] prompt batch (mesh-free path); returns
    the [B, new_tokens] generated ids on the prompt's device, enqueued on
    the current stream."""
    b, s = tokens.shape
    cache_len = s + new_tokens
    caches = lm.init_caches(cfg, b, cache_len, device=tokens.device)
    # prefill re-runs through decode_step to keep the cache length fixed
    # (the simple path of the reference's launcher).
    if decode is None:
        decode = make_decode(cfg)
    out = []
    tok = tokens[:, :1]
    for i in range(s + new_tokens - 1):
        logits, caches = decode(params, tok, caches, i)
        if i + 1 < s:
            tok = tokens[:, i + 1 : i + 2]
        else:
            tok = logits[:, -1].argmax(-1)[:, None]
            out.append(tok)
    return torch.cat(out, dim=1)


def make_replica_generate(cfg, params, new_tokens: int, decode=None):
    """``gen(request) -> {"completion": [ids]}`` for one replica.

    ``request["tokens"]`` is a 1-D array of prompt ids.  On a card the
    replica owns a CUDA stream, and ``gen`` returns only once that stream has
    finished the request (the copy of the completion to the host waits for
    it).  The caches are the request's own, so in-place updates never cross
    replica threads.
    """
    dev = params["embed"].device
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    decode = decode or make_decode(cfg)

    def gen(request: dict) -> dict:
        ctx = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
        with ctx:
            toks = torch.as_tensor(np.asarray(request["tokens"]), device=dev)[None, :]
            out = generate(cfg, params, toks, new_tokens, decode=decode)
            return {"completion": out[0].cpu().tolist()}

    return gen


def _closed_main(cfg, params, args) -> None:
    rng = np.random.default_rng(args.seed)
    dev = params["embed"].device
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, (args.requests, args.prompt_len)), device=dev
    )
    t0 = time.time()
    out = generate(cfg, params, prompts, args.new_tokens).cpu()
    dt = time.time() - t0
    total = args.requests * args.new_tokens
    print(f"generated {total} tokens in {dt:.2f}s "
          f"({total/dt:.1f} tok/s) on {dev}; sample: {out[0].numpy()[:8]}")


def _open_main(cfg, params, args) -> None:
    """Continuous batching: Poisson arrivals into a live heterogeneous pool."""
    rng = np.random.default_rng(args.seed)
    decode = make_decode(cfg)

    def replica(name: str, slow_factor: float = 1.0) -> Replica:
        return Replica(name, make_replica_generate(cfg, params, args.new_tokens, decode),
                       slow_factor=slow_factor)

    replicas = [replica("replica0")]
    for r in range(1, args.replicas):
        # replicas share the weights; heterogeneity is emulated by
        # slow_factor (on real hardware: different device slices)
        replicas.append(replica(f"replica{r}", args.slow_factor))
    # one warm-up so first-call costs don't poison the latency stats
    replicas[0].generate({"tokens": np.zeros(args.prompt_len, np.int64)})
    autoscale = None
    if args.autoscale_max > args.replicas:
        # Elastic pool (DESIGN.md §Elasticity): surge replicas boot at full
        # speed (fresh capacity) and drain back out once the backlog clears.
        autoscale = AutoscaleConfig(
            factory=lambda wid: replica(f"surge{wid}"),
            min_replicas=args.replicas,
            max_replicas=args.autoscale_max,
        )
    slowdown = None
    limp = None
    if args.limp_slowdown > 1.0:
        # Straggler fault (DESIGN.md §Straggler plane): one replica limps
        # mid-run; the detector (unless disabled) re-prices its queue so
        # the healthy replicas strip it and new requests route around it.
        if not 0 <= args.limp_replica < args.replicas:
            raise SystemExit("--limp-replica must name a boot replica")
        slowdown = SlowdownSchedule((
            SlowdownEvent(args.limp_replica, args.limp_after, args.limp_slowdown),
        ))
        if args.limp_factor > 1.0:
            limp = LimpConfig(limp_factor=args.limp_factor)
    netfaults = parse_netfaults(args.net_faults, args.replicas)
    pool = ServePool(replicas, seed=args.seed, policy=args.policy,
                     autoscale=autoscale, slowdown=slowdown, limp=limp,
                     topology=parse_topology(args.topology, args.replicas),
                     migration_cost=args.migration_cost,
                     netfaults=netfaults)
    pool.start()
    t0 = time.perf_counter()

    futs = []
    for _ in range(args.requests):
        time.sleep(float(rng.exponential(1.0 / args.rate)))
        req = {"tokens": rng.integers(0, cfg.vocab, (args.prompt_len,))}
        futs.append(pool.submit(req))
    for f in futs:
        f.result(timeout=600)
    scale_outs = sum(1 for e in pool.scale_events if e[1] == "out")
    peak = pool.peak_live
    stats = pool.shutdown()
    pct = stats.latency_percentiles()
    per_rep = stats.per_worker_tasks
    print(f"served {len(futs)} streamed requests [{args.policy}] on "
          f"{params['embed'].device}; requests/replica={per_rep} "
          f"steals={len(stats.steals)}")
    if autoscale is not None:
        print(f"autoscaler: peak {peak} replicas, {scale_outs} scale-outs")
    if slowdown is not None:
        flips = ", ".join(f"replica{w} {'limp' if f else 'recovered'}"
                          f" @{t - t0:.2f}s" for t, w, f in pool.limp_log)
        print(f"limp detector: {flips or 'no transitions'}")
    if netfaults is not None:
        print(f"fault fabric: {stats.net_failed} dropped steal requests, "
              f"{stats.lease_expired} leases expired")
    print("latency p50/p95/p99 = "
          + "/".join(f"{pct[q]*1e3:.0f}ms" for q in (50.0, 95.0, 99.0)))
    print(f"sample completion: {futs[0].result()['completion'][:8]}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda by default; a cuda "
                         "request without a card fails)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--open-arrival", action="store_true",
                    help="stream requests into a live ServePool")
    ap.add_argument("--rate", type=float, default=4.0,
                    help="Poisson arrival rate, requests/sec (open mode)")
    ap.add_argument("--replicas", type=int, default=2,
                    help="model replicas in the pool (open mode)")
    ap.add_argument("--slow-factor", type=float, default=4.0,
                    help="slowdown of replicas 1.. vs replica 0 (open mode)")
    ap.add_argument("--policy", choices=POLICIES, default="a2ws",
                    help="scheduling policy for the replica pool (open mode)")
    ap.add_argument("--autoscale-max", type=int, default=0,
                    help="elastic pool: scale out to at most this many "
                         "replicas under backlog, drain back when idle "
                         "(0 = fixed pool; open mode)")
    ap.add_argument("--limp-slowdown", type=float, default=0.0,
                    help="straggler fault: limp one replica to this multiple "
                         "of its normal service time (0/1 = no fault; "
                         "open mode)")
    ap.add_argument("--limp-replica", type=int, default=0,
                    help="which boot replica the straggler fault hits")
    ap.add_argument("--limp-after", type=float, default=0.5,
                    help="seconds after start() the straggler fault begins")
    ap.add_argument("--topology", default="none",
                    help="network-cost model pricing steals between replicas "
                         "(DESIGN.md §Topology plane): none | "
                         "uniform:LAT:PER_TASK | two-level:K:INTRA:CROSS | "
                         "fat-tree:K:HOP (costs in seconds; open mode)")
    ap.add_argument("--net-faults", default="none",
                    help="network-fault plane on the replica steal fabric "
                         "(DESIGN.md §Fault fabric): none | drop:PROB | "
                         "delay:SEC | partition:START:DUR[:K] — combinable "
                         "with '+', e.g. drop:0.1+partition:5:30:2 "
                         "(open mode)")
    ap.add_argument("--migration-cost", type=float, default=0.0,
                    help="per-request warm-state cost of serving a stolen "
                         "request cold, folded into every remote link of "
                         "--topology (seconds; open mode)")
    ap.add_argument("--limp-factor", type=float, default=4.0,
                    help="limp detector threshold: flag a replica whose "
                         "recent service time exceeds its baseline by this "
                         "factor (<=1 disables detection — the count-based "
                         "ablation)")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch)
    if cfg.frontend != "none" or cfg.enc_layers:
        raise SystemExit("the serving launcher handles token-in archs")
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = lm.init(cfg, gen, device=dev)
    if args.open_arrival:
        _open_main(cfg, params, args)
    else:
        _closed_main(cfg, params, args)


if __name__ == "__main__":
    main()
