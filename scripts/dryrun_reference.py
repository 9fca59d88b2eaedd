"""One dry-run cell of the JAX reference, printed as JSON: per-device FLOPs,
collective bytes (by kind) and live bytes, from ``repro.launch.cells``'
``lower_cell`` and ``analyze`` on the production mesh's shape (16x16, or
2x16x16 with ``--multi-pod``) of forced host devices.

    python scripts/dryrun_reference.py phi4-mini-3.8b decode_32k [--multi-pod] [--layers 2]

The mesh is an ``Auto``-axes ``jax.sharding.Mesh`` made here:
``repro.launch.mesh.make_production_mesh`` builds ``Explicit`` axes under
jax 0.9, on which the reference's ``constrain`` raises.  ``--layers`` cuts
the decoder's depth (``n_layers``); the widths stay the config's.  The
port's side of the comparison is ``scripts/dryrun_table_torch.py
--with-reference`` and ``scripts/cell_breakdown_torch.py``.
"""

import os

# before JAX starts: the device count is fixed at its first use
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import ARCH_IDS, SHAPES, get_config, shape_applicable  # noqa: E402
from repro.launch.cells import analyze, lower_cell  # noqa: E402
from repro.parallel.sharding import make_context  # noqa: E402


def lower_reference(arch: str, shape_name: str, multi_pod: bool, layers: int) -> dict:
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    shape = SHAPES[shape_name]
    tag = "2x16x16" if multi_pod else "16x16"
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": tag, "status": "skipped",
                "reason": reason}
    dims, axes = ((2, 16, 16), ("pod", "data", "model")) if multi_pod else \
        ((16, 16), ("data", "model"))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:int(np.prod(dims))]).reshape(dims), axes)
    with mesh:
        lowered, _ = lower_cell(cfg, shape, make_context(mesh))
        rec = analyze(lowered, lowered.compile(), cfg, shape, mesh.devices.size)
    keep = ("flops_per_device", "collective_bytes_per_device", "collectives",
            "live_bytes_per_device")
    return {"arch": arch, "shape": shape_name, "mesh": tag, "layers": cfg.n_layers,
            "status": "ok", **{k: rec[k] for k in keep}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arch", choices=ARCH_IDS)
    ap.add_argument("shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--layers", type=int, default=0)
    args = ap.parse_args(argv)
    print(json.dumps(lower_reference(args.arch, args.shape, args.multi_pod, args.layers)))


if __name__ == "__main__":
    main()
