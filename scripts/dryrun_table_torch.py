"""Print the port's dry-run records as a markdown table (one row a cell):
the memory one device holds, whether it fits 80 GB, the three roofline
terms on the H100's constants and the seconds the trace took.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b --shape train_4k
    python scripts/dryrun_table_torch.py [experiments/dryrun_torch]

``--with-reference`` sets each record beside the JAX reference's own cell
instead: per-device FLOPs, collective bytes and live bytes of both, with
the port's over the reference's.  Each reference cell is lowered and
compiled by ``scripts/dryrun_reference.py`` in a subprocess (it forces
512 host devices before JAX starts; this script imports no JAX), and its
records are kept under ``<records>/reference/``.

The numbers are analytic (fake tensors on a fake process group, XLA's
compiled HLO on the CPU), not measured on a card.  Live bytes are counted
differently in the two packages: compare each across meshes.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys

GB = 1e9
HERE = os.path.dirname(os.path.abspath(__file__))


def reference_record(arch: str, shape: str, multi_pod: bool, cache_dir: str) -> dict:
    """The reference's record of one cell, from ``scripts/dryrun_reference.py``
    in a subprocess, cached as JSON under ``cache_dir``."""
    tag = "2x16x16" if multi_pod else "16x16"
    path = os.path.join(cache_dir, f"{arch}__{shape}__{tag}.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    cmd = [sys.executable, os.path.join(HERE, "dryrun_reference.py"), arch, shape] + \
        (["--multi-pod"] if multi_pod else [])
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    if out.returncode != 0:
        raise RuntimeError(f"reference {arch} {shape} {tag}: {out.stderr[-3000:]}")
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    os.makedirs(cache_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _records(directory: str) -> list[dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


def roofline_table(directory: str) -> None:
    print("| arch | shape | mesh | params GB | opt GB | cache GB | live GB | fits 80 GB "
          "| compute s | memory s | collective s | dominant | trace s |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |")
    for r in _records(directory):
        if r.get("status") != "ok":
            print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['status']}: "
                  f"{r.get('reason') or r.get('error', '')[:80]} |")
            continue
        m = r["memory"]
        print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | {m['param_bytes'] / GB:.3f} "
              f"| {m.get('opt_bytes', 0) / GB:.3f} | {m.get('cache_bytes', 0) / GB:.3f} "
              f"| {r['live_bytes_per_device'] / GB:.2f} | {'yes' if r['fits_hbm80g'] else 'no'} "
              f"| {r['t_compute']:.4f} | {r['t_memory']:.4f} | {r['t_collective']:.4f} "
              f"| {r['dominant'][2:]} | {r['trace_s']} |")


def reference_table(directory: str) -> None:
    cache = os.path.join(directory, "reference")
    print("| arch | shape | mesh | FLOPs port | FLOPs ref | ratio | coll B port | coll B ref "
          "| ratio | live GB port | live GB ref |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |")
    for r in _records(directory):
        if r.get("status") != "ok":
            continue
        ref = reference_record(r["arch"], r["shape"], r["mesh"] == "2x16x16", cache_dir=cache)
        if ref.get("status") != "ok":
            print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | reference {ref['status']} |")
            continue
        fp, fr = r["flops_per_device"], ref["flops_per_device"]
        cp, cr = r["collective_bytes_per_device"], ref["collective_bytes_per_device"]
        print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | {fp:.4e} | {fr:.4e} "
              f"| {fp / fr:.3f} | {cp:.4e} | {cr:.4e} | {cp / cr if cr else float('nan'):.2f} "
              f"| {r['live_bytes_per_device'] / GB:.2f} "
              f"| {ref['live_bytes_per_device'] / GB:.2f} |", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("directory", nargs="?", default=os.path.join("experiments", "dryrun_torch"))
    ap.add_argument("--with-reference", action="store_true")
    args = ap.parse_args(argv)
    if args.with_reference:
        reference_table(args.directory)
    else:
        roofline_table(args.directory)


if __name__ == "__main__":
    main()
