"""Multi-pod dry-run: trace every (arch x shape) cell on the production
meshes and record memory/cost/collective analysis, as
``repro/launch/dryrun.py`` does for the reference.

The reference forces 512 host devices before JAX starts; the port makes a
fake process group of 512 ranks (``torch.testing``'s ``FakeStore``, backend
``"fake"``: collectives return at once and move nothing) and traces each
cell as rank 0 under ``FakeTensorMode``, so nothing is allocated and the
671B config traces on a CPU.  The numbers are analytic, per H100 80 GB
(``repro_torch.launch.cells.HW``), not measured.

Usage:
    python -m repro_torch.launch.dryrun --arch mistral-nemo-12b --shape train_4k
    python -m repro_torch.launch.dryrun --all                  # single-pod 16x16
    python -m repro_torch.launch.dryrun --all --multi-pod      # 2x16x16
Records land in experiments/dryrun_torch/<arch>__<shape>__<mesh>.json.
"""

from __future__ import annotations

import argparse
import json
import os
import traceback

from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.launch.cells import analyze, trace_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.parallel.sharding import make_context

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


def init_fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks, this process rank 0."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    rec_path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_tag}.json")
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
               "status": "skipped", "reason": reason}
        _write(rec_path, rec)
        print(f"[skip] {arch} x {shape_name} ({mesh_tag}): {reason}")
        return rec

    mesh = make_production_mesh(multi_pod=multi_pod)
    ctx = make_context(mesh)
    chips = mesh.size()
    print(f"[cell] {arch} x {shape_name} on {mesh_tag} ({chips} ranks)", flush=True)
    try:
        costs, meta = trace_cell(cfg, shape, ctx)
        rec = analyze(costs, meta, cfg, shape, chips)
        rec.update({"mesh": mesh_tag, "status": "ok"})
        print({k: rec[k] for k in ("flops_per_device", "bytes_per_device",
                                   "collective_bytes_per_device", "live_bytes_per_device",
                                   "dominant", "trace_s")}, flush=True)
    except Exception as e:  # noqa: BLE001 -- record the failure, keep sweeping
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
               "status": "error", "error": f"{type(e).__name__}: {e}"[:2000],
               "traceback": traceback.format_exc()[-2000:]}
        print(f"[FAIL] {arch} x {shape_name}: {e}"[:2000])
    _write(rec_path, rec)
    return rec


def _write(path: str, rec: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=os.path.abspath(OUT_DIR))
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    init_fake_group(int(os.environ.get("REPRO_FAKE_RANKS", "512")))
    pods = [args.multi_pod] if not args.both_meshes else [False, True]
    cells_ = (
        [(a, s) for a in ARCH_IDS for s in SHAPES]
        if args.all
        else [(args.arch, args.shape)]
    )
    failures = 0
    for mp in pods:
        for arch, shape_name in cells_:
            tag = "2x16x16" if mp else "16x16"
            path = os.path.join(args.out, f"{arch}__{shape_name}__{tag}.json")
            if args.skip_existing and os.path.exists(path):
                with open(path) as f:
                    if json.load(f).get("status") in ("ok", "skipped"):
                        continue
            rec = run_cell(arch, shape_name, mp, args.out)
            failures += rec.get("status") == "error"
    print(f"done; failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
