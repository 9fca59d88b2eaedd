"""Print the port's dry-run records as a markdown table (one row a cell):
the memory one device holds, whether it fits 80 GB, the three roofline
terms on the H100's constants and the seconds the trace took.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b --shape train_4k
    python scripts/dryrun_table_torch.py [experiments/dryrun_torch]

The numbers are analytic (fake tensors on a fake process group), not
measured on a card.
"""

from __future__ import annotations

import glob
import json
import os
import sys

GB = 1e9


def main(directory: str) -> None:
    print("| arch | shape | mesh | params GB | opt GB | cache GB | live GB | fits 80 GB "
          "| compute s | memory s | collective s | dominant | trace s |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |")
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            r = json.load(f)
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


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun_torch")
