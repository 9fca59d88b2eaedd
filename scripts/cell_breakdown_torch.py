"""Per-op breakdown of one of the port's dry-run cells, the counterpart of
``scripts/cell_breakdown.py``: the cell's step is traced once on fake
tensors on a fake group of 256 ranks (512 with ``--multi-pod``), as
``python -m repro_torch.launch.dryrun`` traces it, under
``launch/op_analysis.py::OpBreakdown``, and the top entries of each of its
three keys are printed, ranked by FLOPs, kernel bytes and collective bytes:

  op    -- (op, argument shapes): the local op or collective as it ran
  site  -- the ``repro_torch`` line that ran it, with its caller; backward
           ops under the forward line that made them ("[bwd]"), a
           checkpointed forward run again in backward as "[recompute]"
  coll  -- the collective kind

Every figure is per device and analytic (nothing runs on a card).  The
script checks that each key's sums equal the cell's record and prints the
record as JSON on its last line.

    PYTHONPATH=src python scripts/cell_breakdown_torch.py phi4-mini-3.8b decode_32k
    PYTHONPATH=src python scripts/cell_breakdown_torch.py phi4-mini-3.8b train_4k \\
        --multi-pod --layers 2 --top 15
    PYTHONPATH=src python scripts/cell_breakdown_torch.py deepseek-v3-671b decode_32k \\
        --layers 4 --world 512

``--world`` makes the fake group larger than the mesh, as the dry-run's
512-rank group holds the 16x16 mesh.  The JSON line also lists the
collectives and the FLOP-counting ops by (op, argument shapes), and the
collective bytes by line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch.distributed

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config, shape_applicable  # noqa: E402
from repro_torch.launch.cells import analyze, trace_cell  # noqa: E402
from repro_torch.launch.dryrun import init_fake_group  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.parallel.sharding import make_context  # noqa: E402


def _fmt(x: float) -> str:
    return f"{x:.4e}"


def _label(table: str, key) -> str:
    if table == "op":
        op, shapes = key
        return f"{op} {' '.join(str(s).replace(' ', '') for s in shapes)}"
    return str(key)


def print_tables(breakdown: dict, top: int) -> None:
    for table in ("op", "site", "coll"):
        rows = breakdown[table]
        for metric in ("flops", "bytes", "coll") if table != "coll" else ("coll",):
            ranked = sorted(rows.items(), key=lambda kv: -getattr(kv[1], metric))
            ranked = [(k, v) for k, v in ranked if getattr(v, metric)][:top]
            if not ranked:
                continue
            total = sum(getattr(v, metric) for v in rows.values())
            print(f"\n-- by {table}, top {len(ranked)} by {metric} (total {_fmt(total)})")
            print(f"{'flops':>11} {'bytes':>11} {'coll':>11} {'calls':>6} {'share':>6}  key")
            for k, v in ranked:
                share = getattr(v, metric) / total
                print(f"{_fmt(v.flops):>11} {_fmt(v.bytes):>11} {_fmt(v.coll):>11} "
                      f"{v.calls:>6} {share:>6.1%}  {_label(table, k)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arch", choices=ARCH_IDS)
    ap.add_argument("shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true", help="the 2x16x16 mesh")
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the decoder to this many layers (0: the config's depth)")
    ap.add_argument("--world", type=int, default=0,
                    help="ranks of the fake group (0: the mesh's, 256 or 512)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.layers:
        cfg = cfg.with_(n_layers=args.layers)
    shape = SHAPES[args.shape]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        print(f"{args.arch} x {args.shape} is skipped: {reason}")
        return 1
    init_fake_group(args.world or (512 if args.multi_pod else 256))
    mesh = make_production_mesh(multi_pod=args.multi_pod)
    costs, meta = trace_cell(cfg, shape, make_context(mesh), breakdown=True)
    rec = analyze(costs, meta, cfg, shape, mesh.size())
    tag = "2x16x16" if args.multi_pod else "16x16"
    print(f"=== {args.arch} {args.shape} on {tag} ({mesh.size()} of "
          f"{torch.distributed.get_world_size()} ranks), {cfg.n_layers} layers; "
          f"traced in {meta['trace_s']} s ===")
    print(f"flops {_fmt(costs.flops)}  bytes {_fmt(costs.bytes)}  collective bytes "
          f"{_fmt(costs.coll_bytes)} {rec['collectives']}  live bytes "
          f"{rec['live_bytes_per_device']}")
    bd = costs.breakdown
    sums_equal = all(
        sum(v.flops for v in bd[t].values()) == costs.flops
        and sum(v.bytes for v in bd[t].values()) == costs.bytes
        and sum(v.coll for v in bd[t].values()) == costs.coll_bytes
        for t in bd)
    print(f"each key's sums equal the record: {sums_equal}")
    print_tables(bd, args.top)
    def ops(metric):
        return [{"op": k[0], "shapes": [list(s) for s in k[1]], "calls": v.calls,
                 metric: getattr(v, metric)} for k, v in bd["op"].items() if getattr(v, metric)]

    coll_sites = [{"site": k, "calls": v.calls, "coll": v.coll}
                  for k, v in bd["site"].items() if v.coll]
    print()
    print(json.dumps({
        "arch": args.arch, "shape": args.shape, "mesh": tag, "layers": cfg.n_layers,
        "flops": costs.flops, "bytes": costs.bytes, "coll": costs.coll_bytes,
        "collectives": rec["collectives"], "live": rec["live_bytes_per_device"],
        "sums_equal": sums_equal, "collective_ops": ops("coll"), "flop_ops": ops("flops"),
        "collective_sites": coll_sites}))
    return 0 if sums_equal else 1


if __name__ == "__main__":
    raise SystemExit(main())
