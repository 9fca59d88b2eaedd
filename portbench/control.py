"""The readings that set each correctness limit, on the card at the cell's
own size (the benchmark's own runs never run this):

    python3 portbench/control.py --workload NAME --seeds 11 12 13

For each seed it sets the cell up, runs one unit of its window (a survey,
a training step) and prints one JSON line of readings:

- survey cells: ``program``, the sound run's ``seis_gap``; ``control``,
  the reference computed in bfloat16, one step below the configuration's
  float32, on the same sampled shots (the port's own bfloat16 path cannot
  hand a seismogram back: ``make_shot_task`` converts it with numpy);
- training cells: ``program``, the sound run's numbers (the first steps'
  and the late step's) against the float32 reference; ``control``, the
  reference with float8 products against the float32 reference, over the
  first steps and over the late step from the program's state; ``half``,
  the program with half of each step's microbatches left out (the mean over
  the rest).  A step that leaves the state unchanged reads 1 on
  ``change_norm_gap`` and ``late_change_norm_gap`` by their definition and
  needs no run.

The lower reading of a limit is the largest of the sound runs' (over a dozen
seeds or more), the upper the smallest of the control's and the faults'.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(_ROOT), str(_ROOT / "src")]

from portbench import run  # noqa: E402


def _once(drv) -> dict:
    drv.setup()
    drv.window(0.0)
    drv.release()
    gc.collect()
    _, failed, checks = drv.check()
    return {"failed": failed, **{k: v for k, (v, _) in checks.items()},
            **getattr(drv, "not_compared", {})}


def survey_readings(name: str, seeds, patch: dict | None = None, device: str = "cuda") -> dict:
    import torch

    out = {"program": [], "control": []}
    for seed in seeds:
        _, _, mod, drv = run.make_driver(name, seed, device, patch)
        out["program"].append(_once(drv))
        # the program's bfloat16 path cannot hand a seismogram back (numpy has
        # no bfloat16), so the reference takes the program's place in it
        low = [drv.reference(shot, nt, dtype=torch.bfloat16) for shot, nt, _ in drv.sample]
        out["control"].append({"seis_gap": max(mod.seis_gap(g, w) for g, w in zip(low, drv.want))})
    return out


def train_readings(name: str, seeds, patch: dict | None = None, device: str = "cuda",
                   faults: bool = False) -> dict:
    import torch

    from repro_torch.runtime import het_dp

    out = {"program": [], "control": [], "half": []}
    for seed in seeds:
        _, _, mod, drv = run.make_driver(name, seed, device, patch)
        out["program"].append(_once(drv))
        want, late, late_want = drv.want, drv.late, drv.late_want
        args = (drv.cfg, drv.traffic, seed, drv.limits["check_steps"], drv.device, drv.dtype,
                drv._opt())
        del drv
        gc.collect()
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            ctrl = mod.compare(mod.reference_readings(*args, matmul="fp8"), want)
            ctrl_late = mod.reference_late(args[0], args[1], seed, late, args[4], args[6],
                                           matmul="fp8")
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        del late
        ctrl.update({"late_" + k: v for k, v in mod.compare(ctrl_late, late_want).items()})
        out["control"].append(ctrl)
        if faults:
            gradient = het_dp.HetDPTrainer.gradient
            het_dp.HetDPTrainer.gradient = lambda self, mbs: gradient(self, mbs[: len(mbs) // 2])
            try:
                out["half"].append(_once(run.make_driver(name, seed, device, patch)[3]))
                gc.collect()
            finally:
                het_dp.HetDPTrainer.gradient = gradient
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    run.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("portbench control: needs a CUDA card", file=sys.stderr)
        return 2
    _, _, _, cfg, _ = run.cell_files(args.workload)
    for seed in args.seeds:
        if cfg["driver"] == "survey":
            got = survey_readings(args.workload, [seed])
        else:
            got = train_readings(args.workload, [seed], faults=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "card": run.card_line(),
                          **{k: v[0] for k, v in got.items() if v}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
