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
            run's bit for bit and the plain one within 1e-4 of its peak.

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
