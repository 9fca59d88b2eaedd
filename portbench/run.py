"""Run one cell of the port's benchmark once, on the card.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  The cell is the entry NAME of
``BENCHMARK.json``'s ``workloads``; its files are found by name:
``portbench/workloads/NAME.json`` (the configuration's and the traffic's
names, the correctness limits), ``portbench/configs/<config>.json`` (sizes
and the driver's name), ``portbench/traffic/<traffic>.json`` (the traffic's
parameters), ``portbench/drivers/<driver>.py`` (set-up, window, check) and,
under ``--trace 1``, ``portbench/metrics/<metric>.py`` for each per-layer
metric of the cell.  Adding a configuration, a traffic mix, a cell or a
metric adds files and entries; no file here needs an edit.

A run makes its inputs from ``--seed``, sets up and warms (``setup_s``,
from process start), measures for ``--seconds`` (no unit of work starts
after that), then frees the program's state, checks what the window
produced against the plain reference, and prints one JSON line last:
``correct``, ``attempted``, ``failed``, ``metrics`` (the end-to-end metrics
with ``--trace 0``, the per-layer ones with ``--trace 1``), ``device``,
``breakdown`` (``--trace 1``) and ``checks``, each compared number beside
its limit.  The checks are also the last lines on standard error.

Without a card it exits with 2 and prints no result; it never falls back
to the CPU.  If JAX or the JAX package was loaded, it exits with 3.
Build and kernel caches stay at fixed paths inside the checkout.
"""

from __future__ import annotations

import time

_T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CACHE_DIR = BENCH_DIR / ".cache"
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SPAN_WINDOW = "pb.window"


def set_cache_dirs() -> None:
    """Kernel and build caches at fixed paths inside the checkout (the port's
    own K1 library builds under ``src/repro_torch/kernels/fd3d/_build``)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE_DIR / sub)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(name: str) -> tuple[dict, dict, dict, dict, dict]:
    """(BENCHMARK.json, its workload entry, the cell's file, the
    configuration, the traffic) of cell ``name``."""
    bench = load_json(ROOT / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(entries)}")
    entry = entries[name]
    cell = load_json(BENCH_DIR / "workloads" / f"{name}.json")
    cfg = load_json(BENCH_DIR / "configs" / f"{entry['config']}.json")
    traffic = load_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json")
    return bench, entry, cell, cfg, traffic


def end_to_end_metrics(bench: dict, name: str) -> list[dict]:
    return [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]


def per_layer_metrics(bench: dict, name: str) -> list[dict]:
    """The per-layer metrics the cell reports: those that list it, and those
    without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_metrics(bench, name)}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def reader(metric: str):
    """``portbench/metrics/<metric>.py``'s ``read``."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot, whole) is
    JAX's or the JAX package's."""
    return sorted({k for k, v in sys.modules.items()
                   if v is not None and k.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else f"nvidia-smi failed: {smi.stderr.strip()}"


def make_driver(name: str, seed: int, device: str, patch: dict | None = None):
    """(BENCHMARK.json, the cell's entry, the driver's module, a driver of
    one run).  ``patch`` merges into the cell's files ({"config": {...},
    "traffic": {...}, "limits": {...}}): the tests' small sizes on the CPU."""
    import torch

    bench, entry, cell, cfg, traffic = cell_files(name)
    limits = dict(cell["limits"])
    for part, target in (("config", cfg), ("traffic", traffic), ("limits", limits)):
        target.update((patch or {}).get(part, {}))
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    mod = importlib.import_module(f"portbench.drivers.{cfg['driver']}")
    return bench, entry, mod, mod.Cell(cfg, traffic, limits, seed, torch.device(device))


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             patch: dict | None = None) -> dict:
    """Run cell ``name`` once and return the result (without printing)."""
    import torch
    from torch.profiler import record_function

    from portbench import devtrace

    bench, entry, _, drv = make_driver(name, seed, device, patch)
    dev = drv.device
    cuda = dev.type == "cuda"
    t_setup = time.perf_counter()
    drv.setup()
    if cuda:
        torch.cuda.synchronize(dev)
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - _T_PROCESS
    prof = devtrace.start_profiler() if trace else None
    t_window0 = time.perf_counter()
    with record_function(SPAN_WINDOW):
        e2e = drv.window(seconds)
        if cuda:
            torch.cuda.synchronize(dev)
    t_window = time.perf_counter()
    tr = None
    if prof is not None:
        prof.stop()
        tr = devtrace.collect(prof)
        del prof
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    metrics = {}
    if trace:
        ctx = SimpleNamespace(trace=tr, counters=drv.counters(), window_peak_bytes=window_peak)
        for m in per_layer_metrics(bench, name):
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        del ctx
    else:
        e2e["setup_s"] = setup_s
        for m in end_to_end_metrics(bench, name):
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    drv.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    attempted, failed, checks = drv.check()
    t_end = time.perf_counter()
    correct = attempted > 0 and failed == 0 and all(v <= lim for v, lim in checks.values())
    result = {
        "correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "count": int(entry["chips"]),
            "memory_peak_bytes": int(max(setup_peak, window_peak)) if cuda else 0,
        },
    }
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = devtrace.breakdown(tr)
    result["detail"] = drv.detail()
    result["phases_s"] = {"setup": t_window0 - t_setup, "window": t_window - t_window0,
                          "metrics": t_check - t_window, "check": t_end - t_check}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    sys.path.insert(0, str(ROOT))
    import torch

    _, entry, _, _, _ = cell_files(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"portbench: {args.workload} needs {entry['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"[portbench] {args.workload} seed {args.seed}: {card_line()}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
