"""The paper's use case end-to-end on PyTorch: 3-D acoustic seismic shots
scheduled by A2WS across heterogeneous workers (paper §3-4, miniaturised).

Each task = one shot: inject a Ricker wavelet, propagate the 8th-order FDM
stencil (``repro_torch.kernels.fd3d``: the hand-written CUDA kernel on a
card, the plain PyTorch version on the CPU), record seismograms at the
receiver line.  Workers are threads sharing one device, each with its own
CUDA stream; a scripted slowdown (sleep-paced by the pool) makes worker 2 a
"1-core node".

    PYTHONPATH=src python examples/seismic_shots_torch.py            # on a card
    PYTHONPATH=src python examples/seismic_shots_torch.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.core import (
    A2WSRuntime,
    CTWSRuntime,
    SlowdownEvent,
    SlowdownSchedule,
)
from repro_torch.seismic import make_demo_model, make_shot_grid, run_shot
from repro_torch.seismic.tasks import make_shot_task

SLOWDOWN = {0: 1.0, 1: 1.0, 2: 4.0}  # worker 2 is a "1-core node"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=32, help="model cube size")
    ap.add_argument("--nt", type=int, default=60, help="time steps per shot")
    ap.add_argument("--shots", type=int, default=12)
    args = ap.parse_args(argv)

    model = make_demo_model(n=args.n, device=args.device)
    shots = make_shot_grid(model, args.shots)
    print(f"velocity model {tuple(model.velocity.shape)} on {model.velocity.device}, "
          f"{args.shots} shots x {args.nt} steps, CFL ok: {model.cfl_ok()}")
    # warm up (kernel build, allocator) so the first makespan excludes it
    run_shot(model, shots[0].src, shots[0].rec_array(), nt=2)
    if model.velocity.is_cuda:
        torch.cuda.synchronize()

    slowdown = SlowdownSchedule(
        [SlowdownEvent(w, 0.0, f) for w, f in SLOWDOWN.items() if f != 1.0]
    )
    seismograms = {}
    task_fn = make_shot_task(model, args.nt, len(SLOWDOWN), seismograms)
    for name, cls in (("a2ws", A2WSRuntime), ("ctws", CTWSRuntime)):
        seismograms.clear()
        rt = cls(shots, len(SLOWDOWN), task_fn, slowdown=slowdown)
        stats = rt.run()
        if rt.errors:
            raise RuntimeError(f"{name}: worker errors {rt.errors}")
        peak = max(float(np.abs(s).max()) for s in seismograms.values())
        print(f"{name:5s}: makespan {stats.makespan:6.2f}s  "
              f"tasks/worker {stats.per_worker_tasks}  "
              f"steals {len(stats.steals)}  "
              f"peak amplitude {peak:.3e}")
    print("slow worker (w2) should execute the fewest shots under a2ws.")


if __name__ == "__main__":
    main()
