"""One dry-run cell of the JAX reference, printed as JSON: per-device FLOPs,
collective bytes (by kind) and live bytes, from ``repro.launch.cells``'
``lower_cell`` and ``analyze`` on the production mesh's shape (16x16, or
2x16x16 with ``--multi-pod``) of forced host devices.

    python scripts/dryrun_reference.py phi4-mini-3.8b decode_32k [--multi-pod] [--layers 2]
    python scripts/dryrun_reference.py qwen2-vl-2b train_4k --layers 2 --dots 20

The mesh is an ``Auto``-axes ``jax.sharding.Mesh`` made here:
``repro.launch.mesh.make_production_mesh`` builds ``Explicit`` axes under
jax 0.9, on which the reference's ``constrain`` raises.  ``--layers`` cuts
the decoder's depth (``n_layers``); the widths stay the config's.
``--dots N`` also prints the N ``dot`` instructions of the compiled HLO
that carry the most FLOPs (and lists them all in the JSON line), as ``repro.launch.hlo_analysis`` counts them
(loop bodies times their trip counts), by operand shapes and by the
reference's source line, to set beside ``scripts/cell_breakdown_torch.py``.  The
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
import math  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import ARCH_IDS, SHAPES, get_config, shape_applicable  # noqa: E402
from repro.launch import hlo_analysis as H  # noqa: E402
from repro.launch.cells import analyze, lower_cell  # noqa: E402
from repro.parallel.sharding import make_context  # noqa: E402


_SOURCE_RE = re.compile(r'source_file="[^"]*?(repro/[^"]+)" source_line=(\d+)')


def dot_flops(text: str) -> dict:
    """``{(operand shapes, source line): [FLOPs, calls]}`` of the ``dot``
    instructions of compiled HLO ``text``, walked as
    ``hlo_analysis.analyze_hlo`` walks it: loop bodies and conditions times
    their trip counts, the computations that fusions and calls reach (not
    convert-only kernels, nor those whose root is a slice)."""
    comps = H._parse_computations(text)
    entry = re.search(r"^ENTRY\s+%([\w.\-]+)", text, re.M).group(1)
    shape_of = {c: {i.name: i.rtype for i in ins} for c, ins in comps.items()}
    table: dict = defaultdict(lambda: [0.0, 0])

    def walk(cname: str, mult: int) -> None:
        shapes = shape_of.get(cname, {})
        for ins in comps.get(cname, []):
            op = ins.opcode
            if op == "while":
                tm = H._TRIP_RE.search(ins.rest)
                trip = int(tm.group(1)) if tm else 1
                for pat in (H._CALL_RE, H._COND_RE):
                    m = pat.search(ins.rest)
                    if m:
                        walk(m.group(1), mult * trip)
            elif op in ("fusion", "call", "conditional", "map", "custom-call"):
                names = H._CALL_RE.findall(ins.rest)
                inner = comps.get(names[0], []) if names else []
                if inner and (H._is_convert_only(inner) or inner[-1].opcode in
                              ("dynamic-slice", "gather", "dynamic-update-slice", "scatter")):
                    continue
                for cn in names:
                    walk(cn, mult)
            elif op == "dot":
                ops = H._OPERAND_RE.findall(ins.rest)
                dims = [H._dims(shapes[o])[0][1] for o in ops[:2] if o in shapes]
                out = math.prod(H._dims(ins.rtype)[0][1])
                cm = H._DOT_LHS_C.search(ins.rest)
                k = math.prod(dims[0][int(c)] for c in cm.group(1).split(",") if c) \
                    if cm and dims else 1
                src = _SOURCE_RE.search(ins.rest)
                key = (tuple(tuple(d) for d in dims), f"{src.group(1)}:{src.group(2)}" if src
                       else "(no source line)")
                table[key][0] += 2.0 * out * k * mult
                table[key][1] += mult

    walk(entry, 1)
    return dict(table)


def lower_reference(arch: str, shape_name: str, multi_pod: bool, layers: int,
                    dots: int = 0) -> dict:
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
        compiled = lowered.compile()
        rec = analyze(lowered, compiled, cfg, shape, mesh.devices.size)
    keep = ("flops_per_device", "collective_bytes_per_device", "collectives",
            "live_bytes_per_device")
    out = {"arch": arch, "shape": shape_name, "mesh": tag, "layers": cfg.n_layers,
           "status": "ok", **{k: rec[k] for k in keep}}
    if dots:
        table = sorted(dot_flops(compiled.as_text()).items(), key=lambda kv: -kv[1][0])
        out["dots"] = [{"shapes": [list(d) for d in shapes], "source": src, "flops": f,
                        "calls": calls} for (shapes, src), (f, calls) in table]
        total = sum(f for f, _ in dict(table).values())
        print(f"-- dots, top {dots} by flops (total {total:.4e}; the record's "
              f"{rec['flops_per_device']:.4e})")
        for (shapes, src), (f, calls) in table[:dots]:
            ops = " ".join(str(list(d)).replace(" ", "") for d in shapes)
            print(f"{f:11.4e} {calls:6d} {f / total:6.1%}  dot {ops}  {src}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arch", choices=ARCH_IDS)
    ap.add_argument("shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--dots", type=int, default=0,
                    help="also print the top N dot instructions by FLOPs")
    args = ap.parse_args(argv)
    print(json.dumps(lower_reference(args.arch, args.shape, args.multi_pod, args.layers,
                                     args.dots)))


if __name__ == "__main__":
    main()
