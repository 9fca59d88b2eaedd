#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels to their plain
versions.  Run from the root of a checkout:

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):

1. device   the card's name, count, and nvidia-smi's name and power limit;
2. build    nvcc builds every kernel from the sources in the checkout;
3. check    each kernel against its plain PyTorch version on the card, on
            the reference's shape sweep, ragged shapes and the full 512^3
            width, in float32 (within 2e-5) and bfloat16 (within 0.15);
4. time     each kernel at the main path's shape with CUDA events, beside
            its plain version, its bound and a device-to-device copy;
5. main     the main path at full width: 6 seismic shots of a 512^3 model,
            400 steps each, scheduled by A2WS over 3 workers (worker 2 made
            4x slow), each worker on its own stream; launch counts are set
            to 0 just before and read just after;
6. parity   one shot alone, timed per step through the kernel and through
            the plain version; the kernel's seismogram must equal the A2WS
            run's bit for bit and the plain one within 1e-4 of its peak;
7. serve-check  phi4-mini-3.8b at full width in bf16 on the card, weights
            drawn from a seeded torch.Generator: prefill's last logits
            against token-by-token decode_step's for a 128-token prompt, and
            one decode_step after pad_caches against forward at that position
            (bf16 within BF16_LOGIT_ATOL, a relative L2 gap within
            BF16_LOGIT_REL_L2, the same argmax); the same in f32 at full
            width and 2 layers within the reference's own 2e-3;
8. serve-time   decode ms per token at batch 1 and 8 against a 160-token
            cache, prefill ms for 128 tokens and one request alone (128
            prompt + 32 new tokens), CUDA events, beside their bounds;
9. serve-main   the serving main path: an open-arrival A2WS ServePool of 3
            replicas sharing the weights, each on its own stream, slowdowns
            {1, 1, 4}, 12 Poisson requests of 128 + 32 tokens at 1.5x the rate
            one replica sustains alone; every request is served, and
            requests served by each replica, one of them stolen, give the
            same completion run alone;
10. sched   the device scheduler (``repro_torch.core.device_sched``): Eq. 5
            and the γ-rounding on 10^5 random windows on the card against
            the CPU (rates within SCHED_RTOL, γ equal); ``virtual_run`` at
            scripts/sched_cell.py's configuration (P=256, R=51, max_steal
            16, 7680 tasks), packed and baseline, on the card against the
            same run on the CPU with the same draws (integer state equal,
            makespan within SCHED_RTOL; a split is traced to its first round
            and field), conservation of every task id, tasks executed per
            speed quarter and tasks moved; the same at P=1024, R=204, then
            its ms per round and peak memory.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a card, or outside a checkout,
it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

N = 512            # full width: a 512^3 shot volume, 134 M cells
NT = 400           # steps per shot
NUM_SHOTS = 6
SLOWDOWN = {0: 1.0, 1: 1.0, 2: 4.0}
FP32_TOL = 2e-5    # the reference's own fp32 tolerance
BF16_TOL = 0.15    # the reference's own bf16 tolerance
SEIS_REL_TOL = 1e-4  # summation order and FMA differ; error grows over NT steps
CHECK_SHAPES = [
    (8, 16, 16), (16, 16, 16), (16, 24, 16), (32, 16, 32), (8, 8, 8),  # reference sweep
    (13, 17, 29), (1, 9, 130), (1, 1, 1), (5, 1, 3), (9, 33, 65),       # ragged
    (N, N, N),                                                          # full width
]
# H100 SXM published peaks (NVIDIA data sheet, at a 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FD3D_FLOP_PER_CELL = 42  # 25 taps (13 mul, 24 add), the divide, the leapfrog's 4
BF16_FLOP_PER_S = 989e12
SERVE_ARCH = "phi4-mini-3.8b"
PROMPT = 128         # prompt tokens of the serving phases
NEW_TOKENS = 32      # tokens generated per request
DECODE_CACHE = 160   # cache length of the decode timing
POOL_SLOW = (1.0, 1.0, 4.0)
POOL_REQUESTS = 12
RATE_X = 1.5         # arrival rate, in multiples of one replica's rate alone
F32_LOGIT_TOL = 2e-3  # atol = rtol, the reference's own (tests/test_decode_consistency.py)
# bf16 at full width: prefill and decode round the activations to bf16 at
# different places (blocked vs direct softmax, 128-row vs 1-row products),
# ~10 roundings a layer over 32 layers, and the random-weight logits reach
# ~5 (std ~1).  Two H100 runs showed max|d| 0.0938 (prefill vs decode) and
# 0.0811 (decode vs forward), relative L2 gap 1.84e-2; the f32 run of the same
# checks agrees within 2e-3, so what is left is rounding.  Held with an
# absolute bound only, about 2x the worst seen, plus the relative L2 gap and
# the argmax, which must match in every comparison:
BF16_LOGIT_ATOL = 0.2
BF16_LOGIT_REL_L2 = 0.05
# Phase 10: scripts/sched_cell.py's configuration, and the same at 4x the workers.
SCHED_CELL = (256, 51, 16, 30)   # P, radius (20% of P), max_steal, tasks per worker
SCHED_BIG = (1024, 204, 16, 30)
SCHED_WINDOWS = 100_000
SCHED_RTOL = 1e-6
SCHED_MAX_ROUNDS = 4096


class SmokeError(RuntimeError):
    pass


def need(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def timed_ms(torch, fn, iters: int, warmup: int) -> float:
    """Mean device ms per call of ``fn`` over ``iters`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def fields(torch, shape, dtype, gen):
    u = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    u_prev = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    c2dt2 = torch.full(shape, 0.1, device="cuda", dtype=dtype)
    return u, u_prev, c2dt2


def run() -> dict:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SmokeError("no CUDA device: torch.cuda.is_available() is false")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    need(os.path.isdir(os.path.join(src, "repro_torch")),
         f"no repro_torch package under {src}: run from a checkout")
    sys.path.insert(0, src)
    from repro_torch.core import A2WSRuntime, SlowdownEvent, SlowdownSchedule
    from repro_torch.kernels.fd3d import fd3d as fd3d_kernel
    from repro_torch.kernels.fd3d import ref
    from repro_torch.seismic import make_demo_model, make_shot_grid, run_shot
    from repro_torch.seismic.tasks import make_shot_task

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device ---------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    need(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"[device] {kind} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"[device] nvidia-smi: {smi.stdout.strip().splitlines()[0]}")

    # 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    fd3d_kernel.build()
    print(f"[build] fd3d: {time.perf_counter() - t0:.2f} s")
    for line in fd3d_kernel.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build]   {line.strip()}")

    # 3. kernel against plain -------------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    dx = 10.0
    fp32_err = 0.0
    for shape in CHECK_SHAPES:
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
            u, u_prev, c2dt2 = fields(torch, shape, dtype, gen)
            got = fd3d_kernel.fd3d_cuda(u, u_prev, c2dt2, dx=dx).float()
            want = ref.fd3d_step(u, u_prev, c2dt2, dx).float()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            ok = torch.allclose(got, want, rtol=tol, atol=tol)
            print(f"[check] fd3d {shape} {str(dtype)[6:]}: max|d| {err:.3e} "
                  f"(tol {tol}) {'ok' if ok else 'FAIL'}")
            need(ok, f"fd3d kernel disagrees with plain at {shape} {dtype}: {err}")
            if dtype == torch.float32:
                fp32_err = max(fp32_err, err)
            del u, u_prev, c2dt2, got, want

    # 4. timing at the main path's shape ---------------------------------
    shape = (N, N, N)
    cells = N ** 3
    u, u_prev, c2dt2 = fields(torch, shape, torch.float32, gen)
    kernel_ms = timed_ms(torch, lambda: fd3d_kernel.fd3d_cuda(u, u_prev, c2dt2, dx=dx),
                         iters=50, warmup=5)
    plain_ms = timed_ms(torch, lambda: ref.fd3d_step(u, u_prev, c2dt2, dx),
                        iters=10, warmup=2)
    dst = torch.empty_like(u)
    copy_ms = timed_ms(torch, lambda: dst.copy_(u), iters=50, warmup=5)
    step_bytes = 4 * cells * 4  # u, u_prev, c2dt2 read once, out written once
    bytes_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = FD3D_FLOP_PER_CELL * cells / FP32_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"[time] fd3d {shape} float32: kernel {kernel_ms:.4f} ms/step, "
          f"plain {plain_ms:.4f} ms/step, bound {bound_ms:.4f} ms "
          f"(bytes {bytes_ms:.4f}, operations {ops_ms:.4f})")
    print(f"[time] fd3d achieved {step_bytes / kernel_ms / 1e6:.1f} GB/s "
          f"({bound_ms / kernel_ms:.1%} of the bound); device copy_ "
          f"{2 * cells * 4 / copy_ms / 1e6:.1f} GB/s ({copy_ms:.4f} ms for "
          f"{cells * 4 / 1e6:.0f} MB)")
    del u, u_prev, c2dt2, dst
    torch.cuda.empty_cache()

    # 5. main path: shots scheduled by A2WS at full width ------------------
    model = make_demo_model(n=N, device="cuda")
    shots = make_shot_grid(model, NUM_SHOTS)
    need(model.cfl_ok(), "demo model violates CFL")
    seismograms: dict = {}
    task_fn = make_shot_task(model, NT, len(SLOWDOWN), seismograms)
    slowdown = SlowdownSchedule(
        [SlowdownEvent(w, 0.0, f) for w, f in SLOWDOWN.items() if f != 1.0]
    )
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rt = A2WSRuntime(shots, len(SLOWDOWN), task_fn, seed=0, slowdown=slowdown)
    fd3d_kernel.launches = 0
    t0 = time.perf_counter()
    stats = rt.run()
    wall = time.perf_counter() - t0
    launches = fd3d_kernel.launches
    peak_mem = torch.cuda.max_memory_allocated()
    print(f"[main] A2WS {NUM_SHOTS} shots x {NT} steps of {shape}, "
          f"{len(SLOWDOWN)} workers, slowdowns {SLOWDOWN}: makespan "
          f"{stats.makespan:.3f} s (wall {wall:.3f} s), tasks/worker "
          f"{stats.per_worker_tasks}, steals {len(stats.steals)}, "
          f"max_memory_allocated {peak_mem / 2**30:.2f} GiB")
    print(f"[main] fd3d launches {launches} (expected {NUM_SHOTS * NT})")
    need(not rt.errors, f"worker errors: {rt.errors}")
    need(sum(stats.per_worker_tasks) == NUM_SHOTS,
         f"{sum(stats.per_worker_tasks)} tasks ran, expected {NUM_SHOTS}")
    need(len(seismograms) == NUM_SHOTS, f"{len(seismograms)} seismograms")
    for key, seis in seismograms.items():
        need(seis.shape == (NT, len(shots[0].receivers)), f"seismogram {key} shape {seis.shape}")
        need(bool(np.isfinite(seis).all()) and bool(np.abs(seis).max() > 0),
             f"seismogram {key} not finite and non-zero")
    need(launches == NUM_SHOTS * NT,
         f"fd3d launched {launches} times on the main path, expected {NUM_SHOTS * NT}")

    # 6. one shot alone, timed, and its parity at full width ---------------
    shot = shots[0]

    def timed_shot(backend):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        seis = run_shot(model, shot.src, shot.rec_array(), NT, backend=backend)
        stop.record()
        torch.cuda.synchronize()
        return seis.cpu().numpy(), start.elapsed_time(stop) / NT

    alone, step_ms = timed_shot(None)
    want, plain_step_ms = timed_shot("ref")
    print(f"[time] run_shot {shape} alone, {NT} steps: kernel path {step_ms:.4f} "
          f"ms/step (fd3d {kernel_ms:.4f} of it), plain path {plain_step_ms:.4f} ms/step")
    need(np.array_equal(alone, seismograms[shot.src]),
         "the shot run alone differs from the same shot run on a worker's stream")
    peak = float(np.abs(want).max())
    seis_err = float(np.abs(alone - want).max())
    print(f"[parity] shot {shot.src} kernel vs plain on the card: max|d| "
          f"{seis_err:.3e}, peak {peak:.3e}, ratio {seis_err / peak:.3e} "
          f"(tol {SEIS_REL_TOL}); A2WS run's seismogram bit-identical")
    need(peak > 0 and seis_err <= SEIS_REL_TOL * peak, "seismogram parity failed")

    del model, shots, seismograms, task_fn, rt, alone, want
    torch.cuda.empty_cache()
    serve_phases(torch, np, gen, torch.device("cuda"))
    sched_phase(torch, np, torch.device("cuda"))

    print(json.dumps({"kernels": [{
        "name": "fd3d_step",
        "route": "cuda",
        "source": "src/repro_torch/kernels/fd3d/csrc/fd3d.cu",
        "replaces": "src/repro/kernels/fd3d/fd3d.py:73",
        "launches": launches,
        "max_abs_err": fp32_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }]}))
    return {"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}


def _gb(nbytes: float) -> str:
    return f"{nbytes / 1e9:.3f} GB"


def compare_logits(torch, got, want, atol: float, rtol: float, rel_l2: float,
                   what: str) -> None:
    """``got`` against ``want`` within ``atol + rtol * |want|``, a relative L2
    gap of at most ``rel_l2``, and the same argmax."""
    err = (got - want).abs().max().item()
    rel = ((got - want).norm() / want.norm()).item()
    same = bool((got.argmax(-1) == want.argmax(-1)).all())
    ok = torch.allclose(got, want, atol=atol, rtol=rtol)
    print(f"[serve-check] {what}: max|d| {err:.4e} (atol {atol}, rtol {rtol}; max|logit| "
          f"{want.abs().max().item():.4f}), relative L2 {rel:.3e} (limit {rel_l2}), same "
          f"argmax {same} {'ok' if ok and rel <= rel_l2 and same else 'FAIL'}")
    need(ok, f"{what}: max|d| {err} beyond atol {atol}, rtol {rtol}")
    need(rel <= rel_l2, f"{what}: relative L2 gap {rel} beyond {rel_l2}")
    need(same, f"{what}: argmax differs")
    need(bool(torch.isfinite(got).all()), f"{what}: logits not finite")


def check_consistency(torch, lm, cfg, params, toks, tols, label: str) -> None:
    """prefill's last logits vs token-by-token decode_step, then one
    decode_step after pad_caches vs forward at that position; ``tols`` is
    ``(atol, rtol, rel_l2)``."""
    dev = toks.device
    pre, caches = lm.prefill(params, {"tokens": toks[:, :PROMPT]}, cfg)
    dc = lm.init_caches(cfg, 1, PROMPT, device=dev)
    for i in range(PROMPT):
        step, dc = lm.decode_step(params, toks[:, i : i + 1], dc, i, cfg)
    del dc
    compare_logits(torch, pre, step, *tols, f"{label}: prefill vs {PROMPT} decode steps, last logits")
    caches = lm.pad_caches(caches, cfg, PROMPT + 1)
    nxt, _ = lm.decode_step(params, toks[:, PROMPT : PROMPT + 1], caches, PROMPT, cfg)
    del caches
    full, _ = lm.forward(params, {"tokens": toks}, cfg)
    compare_logits(torch, nxt, full[:, PROMPT : PROMPT + 1], *tols,
                   f"{label}: decode_step after pad_caches vs forward at position {PROMPT}")


def serve_phases(torch, np, gen, dev) -> None:
    """Phases 7-9: the dense-family serving path at full width on ``dev``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_decode, make_replica_generate
    from repro_torch.models import lm
    from repro_torch.models.bridge import flatten
    from repro_torch.serve import Replica, ServePool

    cfg = get_config(SERVE_ARCH)
    h, hkv, hd, L = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, cfg.n_layers

    # 7. serve-check ------------------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = flatten(params)
    n_params = sum(t.numel() for t in leaves.values())
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves.values())
    need(n_params == cfg.param_count(), f"{n_params} parameters, expected {cfg.param_count()}")
    embed_rows = cfg.vocab_padded * cfg.d_model
    step_params = n_params - embed_rows  # what one decode step reads in full
    print(f"[serve-check] {SERVE_ARCH} full width: {L} layers, d_model {cfg.d_model}, "
          f"{h}/{hkv} heads of {hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
          f"{n_params:,} parameters, {_gb(weight_bytes)} in bf16, drawn in {init_s:.2f} s; "
          f"max_memory_allocated {_gb(torch.cuda.max_memory_allocated())}")
    toks = torch.randint(0, cfg.vocab, (1, PROMPT + 1), device=dev, generator=gen)
    check_consistency(torch, lm, cfg, params, toks, (BF16_LOGIT_ATOL, 0.0, BF16_LOGIT_REL_L2),
                      f"bf16, {L} layers")
    cfg32 = cfg.with_(n_layers=2, dtype="float32")
    p32 = lm.init(cfg32, torch.Generator(device=dev).manual_seed(1), device=dev,
                  dtype=torch.float32)
    check_consistency(torch, lm, cfg32, p32, toks, (F32_LOGIT_TOL, F32_LOGIT_TOL, F32_LOGIT_TOL),
                      "f32, 2 layers")
    del p32
    torch.cuda.empty_cache()
    print(f"[serve-check] max_memory_allocated {_gb(torch.cuda.max_memory_allocated())}")

    # 8. serve-time -------------------------------------------------------
    def kv_bytes(b, s):  # one layer stack's K and V, bf16
        return 2 * L * b * s * hkv * hd * 2

    def bound(nbytes, flops):
        b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
        return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations")

    for bsz in (1, 8):
        caches = lm.init_caches(cfg, bsz, DECODE_CACHE, device=dev)
        tok = torch.randint(0, cfg.vocab, (bsz, 1), device=dev, generator=gen)
        pos = iter(range(PROMPT, DECODE_CACHE))
        t_host = []

        def step():
            t = time.perf_counter()
            lm.decode_step(params, tok, caches, next(pos), cfg)
            t_host.append(time.perf_counter() - t)

        ms = timed_ms(torch, step, iters=24, warmup=4)
        host_ms = 1e3 * sum(t_host[4:]) / len(t_host[4:])
        nbytes = (2 * step_params + bsz * cfg.d_model * 2 + kv_bytes(bsz, DECODE_CACHE)
                  + bsz * cfg.vocab_padded * 4)
        flops = bsz * (2 * step_params + 4 * L * h * hd * DECODE_CACHE)
        bms, by = bound(nbytes, flops)
        print(f"[serve-time] decode batch {bsz}, {DECODE_CACHE}-token cache: {ms:.4f} ms "
              f"per step ({ms / bsz:.4f} ms per token), host enqueue {host_ms:.4f} ms per "
              f"step; bound {bms:.4f} ms ({by}: {_gb(nbytes)} at 3.35 TB/s) = "
              f"{bms / ms:.1%} of it")
        del caches
    ptoks = torch.randint(0, cfg.vocab, (1, PROMPT), device=dev, generator=gen)
    ms = timed_ms(torch, lambda: lm.prefill(params, {"tokens": ptoks}, cfg), iters=5, warmup=2)
    nbytes = 2 * step_params + PROMPT * cfg.d_model * 2 + kv_bytes(1, PROMPT) + cfg.vocab_padded * 4
    flops = 2 * PROMPT * step_params + 2 * L * h * hd * PROMPT * (PROMPT + 1)
    bms, by = bound(nbytes, flops)
    print(f"[serve-time] prefill {PROMPT} tokens: {ms:.4f} ms; bound {bms:.4f} ms ({by}) "
          f"= {bms / ms:.1%} of it")

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (POOL_REQUESTS, PROMPT))
    decode = make_decode(cfg)
    alone_gen = make_replica_generate(cfg, params, NEW_TOKENS, decode)
    alone_gen({"tokens": prompts[1][:2]})  # warm-up of the replica's stream
    t0 = time.perf_counter()
    alone = alone_gen({"tokens": prompts[0]})["completion"]
    service_s = time.perf_counter() - t0
    rate = RATE_X / service_s
    steps = PROMPT + NEW_TOKENS - 1
    print(f"[serve-time] one request alone ({PROMPT} prompt + {NEW_TOKENS} new tokens, "
          f"{steps} decode steps): {service_s:.3f} s = {1e3 * service_s / steps:.4f} ms per "
          f"step; one replica sustains {1 / service_s:.4f} requests/s")

    # 9. serve-main -------------------------------------------------------
    replicas = [Replica(f"replica{i}", make_replica_generate(cfg, params, NEW_TOKENS, decode),
                        slow_factor=f) for i, f in enumerate(POOL_SLOW)]
    pool = ServePool(replicas, seed=0)
    torch.cuda.synchronize()
    pool.start()
    arrivals = rng.exponential(1.0 / rate, POOL_REQUESTS)
    t0 = time.perf_counter()
    futs = []
    for dt, prompt in zip(arrivals, prompts):
        time.sleep(float(dt))
        # round-robin, as the pool's own routing, but named: see the replay
        futs.append(pool.submit({"tokens": prompt}, replica=len(futs) % len(POOL_SLOW)))
    deadline = time.perf_counter() + 900
    while not all(f.done() for f in futs) and time.perf_counter() < deadline:
        time.sleep(0.05)
    need(all(f.done() for f in futs), "requests unresolved after 900 s")
    wall = max(f.end_t for f in futs) - t0
    live = pool.live_replicas()
    stats = pool.shutdown()
    errors = [f.error for f in futs if f.error is not None]
    need(not errors, f"requests failed: {errors}")
    need(live == list(range(len(POOL_SLOW))), f"replicas died: live {live}")
    lens = [len(f.result()["completion"]) for f in futs]
    need(lens == [NEW_TOKENS] * POOL_REQUESTS, f"completion lengths {lens}")
    need(sum(stats.per_worker_tasks) == POOL_REQUESTS,
         f"requests per replica {stats.per_worker_tasks} do not sum to {POOL_REQUESTS}")
    pct = stats.latency_percentiles()
    print(f"[serve-main] A2WS ServePool, {len(POOL_SLOW)} replicas sharing {SERVE_ARCH} on "
          f"their own streams, slowdowns {list(POOL_SLOW)}; {POOL_REQUESTS} Poisson requests "
          f"of {PROMPT} + {NEW_TOKENS} tokens at {rate:.4f}/s ({RATE_X}x one replica)")
    print(f"[serve-main] requests/replica {stats.per_worker_tasks}, steals "
          f"{len(stats.steals)}, latency p50/p95/p99 {pct[50.0]:.3f}/{pct[95.0]:.3f}/"
          f"{pct[99.0]:.3f} s, makespan {stats.makespan:.3f} s (first arrival to last "
          f"completion {wall:.3f} s), {POOL_REQUESTS * NEW_TOKENS / wall:.2f} generated "
          f"tokens/s; max_memory_allocated {_gb(torch.cuda.max_memory_allocated())}")
    # Replay alone: request 0 (the first arrival, served by replica 0 into an
    # empty pool), and for replicas 1 and 2 a request each served, a stolen
    # one where there is one (it landed on another replica's deque); at least
    # one replayed request must have been stolen.
    landed = [k % len(POOL_SLOW) for k in range(POOL_REQUESTS)]
    stolen = [k for k, f in enumerate(futs) if f.worker != landed[k]]
    need(bool(stolen), "no request left the replica it was submitted to")
    picks = {0: alone}
    for r in range(1, len(POOL_SLOW)):
        served = [k for k, f in enumerate(futs) if f.worker == r]
        need(bool(served), f"replica {r} served no request")
        picks.setdefault(next((k for k in served if k in stolen), served[0]), None)
    if not any(k in stolen for k in picks):
        picks[stolen[0]] = None
    for k in picks:
        want = picks[k] if picks[k] is not None else alone_gen({"tokens": prompts[k]})["completion"]
        same_as_alone(torch, np, lm, cfg, params, decode, dev, prompts[k], want,
                      futs[k].result()["completion"],
                      f"request {k} (submitted to replica {landed[k]}, served by replica "
                      f"{futs[k].worker}{', stolen' if k in stolen else ''})")


def same_as_alone(torch, np, lm, cfg, params, decode, dev, prompt, alone, pooled,
                  what: str) -> None:
    """A completion through the pool must equal the same request run alone;
    where it does not, report the logits gap at the first token that differs,
    seen from the alone run's context."""
    if pooled == alone:
        print(f"[serve-main] {what} equals it run alone: {pooled[:8]}...")
        return
    j = next(i for i, (a, b) in enumerate(zip(alone, pooled)) if a != b)
    ctx = torch.as_tensor(np.concatenate([prompt, alone[:j]]), device=dev)[None]
    caches = lm.init_caches(cfg, 1, ctx.shape[1], device=dev)
    for i in range(ctx.shape[1]):
        logits, caches = decode(params, ctx[:, i : i + 1], caches, i)
    gap = (logits[0, -1, alone[j]] - logits[0, -1, pooled[j]]).item()
    print(f"[serve-main] {what} differs from it run alone at token {j}: logits gap "
          f"{gap:.4e} between tokens {alone[j]} and {pooled[j]}")
    need(False, f"{what}: pooled completion differs from the request run alone")


def quarter_speeds(p: int) -> list[float]:
    return [s for s in (24.0, 16.0, 4.0, 1.0) for _ in range(p // 4)]


def sched_states_equal(torch, a, b) -> str | None:
    """The first field in which two scheduler states differ (NaN equals
    NaN; queues compared on each worker's prefix [0, tail)), else None."""
    for name in a._fields:
        x, y = getattr(a, name).cpu(), getattr(b, name).cpu()
        if name == "queue":
            live = torch.arange(x.shape[1])[None, :] < a.tail.cpu()[:, None]
            x, y = torch.where(live, x, -2), torch.where(live, y, -2)
        same = (x == y) | (x.isnan() & y.isnan()) if x.is_floating_point() else x == y
        if not bool(same.all()):
            return name
    return None


def sched_first_split(torch, ds, cfg, packed: bool, dev) -> tuple[int, str] | None:
    """Rerun both devices round by round on one CPU generator's draws, as
    ``virtual_run`` draws them, and name the first round and field that split."""
    p, radius, max_steal, per = cfg
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(0)
    states = {d: ds.init_state(p, [per] * p, quarter_speeds(p), radius, p * per, device=d)
              for d in (cpu, dev)}
    fns = {d: ds.make_round_fn(p, radius, max_steal, packed=packed, device=d) for d in states}
    for rnd in range(1, SCHED_MAX_ROUNDS + 1):
        g = ds.gumbel_draws((p, 2 * radius + 1), gen, cpu)
        states = {d: fns[d](s, gumbel=g.to(d)) for d, s in states.items()}
        field = sched_states_equal(torch, states[dev], states[cpu])
        if field is not None:
            return rnd, field
        if int((states[cpu].tail - states[cpu].head).sum()) == 0:
            return None
    return None


def sched_check_conserved(torch, state, rounds: int, num_tasks: int, what: str) -> None:
    tail = state.tail.cpu()
    queue = state.queue.cpu()
    ids = torch.cat([queue[i, : tail[i]] for i in range(queue.shape[0])])
    need(torch.equal(ids.sort().values, torch.arange(num_tasks, dtype=torch.int32)),
         f"{what}: the queues do not hold every task id exactly once")
    need(torch.equal(state.head.cpu(), tail), f"{what}: head != tail at the end")
    need(int(state.executed.sum()) == num_tasks,
         f"{what}: executed {int(state.executed.sum())} of {num_tasks}")
    need(rounds < SCHED_MAX_ROUNDS, f"{what}: hit max_rounds {SCHED_MAX_ROUNDS}")


def sched_phase(torch, np, dev) -> None:
    """Phase 10: the device scheduler on ``dev`` against the CPU."""
    from repro_torch.core import device_sched as ds

    cpu = torch.device("cpu")
    radius = SCHED_CELL[1]
    w = 2 * radius + 1

    # (a) Eq. 5 and the γ-rounding on random windows ----------------------
    rng = np.random.default_rng(0)
    win_n = rng.integers(0, 40, (SCHED_WINDOWS, w)).astype(np.float32)
    win_t = rng.uniform(0.05, 4.0, (SCHED_WINDOWS, w)).astype(np.float32)
    win_t[rng.random((SCHED_WINDOWS, w)) < 0.3] = np.nan
    win_t[:, radius] = rng.uniform(0.05, 4.0, SCHED_WINDOWS)
    args = [torch.from_numpy(a) for a in (win_n, win_t)]
    rate = {d: ds.steal_rate_window(*(a.to(d) for a in args), radius).cpu() for d in (dev, cpu)}
    rel = ((rate[dev] - rate[cpu]).abs() / rate[cpu].abs().clamp_min(1e-30)).max().item()
    g_args = [torch.from_numpy(rng.uniform(0, 12, SCHED_WINDOWS).astype(np.float32))]
    g_args += [torch.from_numpy(a) for a in (win_n[:, 0], win_t[:, radius], win_n[:, 1],
                                             np.nan_to_num(win_t[:, 1], nan=np.inf))]
    gam = {d: ds.gamma_round(*(a.to(d) for a in g_args)).cpu() for d in (dev, cpu)}
    n_gamma = int((gam[dev] != gam[cpu]).sum())
    print(f"[sched] {SCHED_WINDOWS} windows of {w} cells (30% unknown): steal rate on the "
          f"card vs the CPU max relative gap {rel:.3e} (limit {SCHED_RTOL}); gamma_round "
          f"differs in {n_gamma} of {SCHED_WINDOWS}")
    need(bool(torch.isfinite(rate[cpu]).all()), "steal rates not finite")
    need(rel <= SCHED_RTOL, f"steal_rate_window: card vs CPU relative gap {rel}")
    need(n_gamma == 0, f"gamma_round: card and CPU differ in {n_gamma} cases")

    # (b), (c) scripts/sched_cell.py's configuration, card against CPU -----
    for packed in (True, False):
        sched_card_vs_cpu(torch, ds, SCHED_CELL, packed, dev)

    # (d) four times the workers, card against CPU, then timed -------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sched_card_vs_cpu(torch, ds, SCHED_BIG, True, dev)
    peak = torch.cuda.max_memory_allocated()
    p, radius, max_steal, per = SCHED_BIG
    round_fn = ds.make_round_fn(p, radius, max_steal, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = ds.init_state(p, [per] * p, quarter_speeds(p), radius, p * per, device=dev)
    ms = []
    while int((state.tail - state.head).sum()) > 0:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        state = round_fn(state, gen)
        stop.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(stop))
        need(len(ms) < SCHED_MAX_ROUNDS, f"P={p}: timed run hit max_rounds")
    print(f"[sched] P={p} R={radius} packed: {float(np.median(ms)):.4f} ms per round "
          f"(median of {len(ms)}, CUDA events, draws on the card); max_memory_allocated "
          f"{_gb(peak)} (card run of the comparison)")


def sched_card_vs_cpu(torch, ds, cfg, packed: bool, dev) -> None:
    """``virtual_run`` at ``cfg`` on the card and on the CPU with the same
    draws: integer state equal, makespan within SCHED_RTOL, every task id
    conserved.  Prints the rounds, the makespan beside its bounds, the tasks
    executed per speed quarter and the tasks run away from their first
    worker."""
    p, radius, max_steal, per = cfg
    cpu = torch.device("cpu")
    num_tasks = p * per
    speeds = quarter_speeds(p)
    what = f"P={p} R={radius} {'packed' if packed else 'baseline'}"
    runs = {d: ds.virtual_run(p, speeds, num_tasks, radius, max_steal, device=d,
                              packed=packed, generator=torch.Generator().manual_seed(0))
            for d in (cpu, dev)}
    (got, rounds, makespan), (want, want_rounds, want_ms) = runs[dev], runs[cpu]
    need(got.queue.device.type == dev.type, f"{what}: state left {dev}")
    field = sched_states_equal(torch, got, want)
    if rounds != want_rounds or field is not None:
        split = sched_first_split(torch, ds, cfg, packed, dev)
        need(False, f"{what}: card and CPU split (rounds {rounds} vs {want_rounds}, "
                    f"final field {field}); first split at (round, field) {split}")
    need(abs(makespan - want_ms) <= SCHED_RTOL * max(1.0, abs(want_ms)),
         f"{what}: makespan {makespan} vs {want_ms} on the CPU")
    sched_check_conserved(torch, got, rounds, num_tasks, what)
    queue, tail = got.queue.cpu(), got.tail.cpu()
    live = torch.arange(num_tasks)[None, :] < tail[:, None]
    home = torch.div(queue, per, rounding_mode="floor")  # block partition: per tasks each
    moved = int((live & (home != torch.arange(p)[:, None])).sum())
    print(f"[sched] {what}, max_steal {max_steal}, {num_tasks} tasks: {rounds} rounds, "
          f"makespan {makespan} (static partition {max(per / s for s in speeds)}, balanced "
          f"{num_tasks / sum(speeds):.4f}); card == CPU in rounds, executed, head, tail, "
          f"queues; executed per speed quarter {{24,16,4,1}} "
          f"{got.executed.cpu().view(4, -1).sum(1).tolist()}; {moved} tasks run by "
          f"another worker than their first")


def main() -> int:
    try:
        result = run()
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
