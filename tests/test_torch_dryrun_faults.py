"""The port's sharded cells against the reference's own on the production
meshes: per-device collective bytes of decode and FLOPs and live bytes of
training, held to the reference's lowering, and the per-op breakdown
(``launch/op_analysis.py::OpBreakdown``) that finds the excess.

The cells keep their published widths with the depth cut to 2 layers in
both packages.  The port's side runs ``scripts/cell_breakdown_torch.py``
(fake tensors on a fake group of 256 or 512 ranks), the reference's
``scripts/dryrun_reference.py`` (XLA on 512 forced host devices, an
``Auto``-axes mesh), each in a subprocess with its own
timeout; every figure is analytic and per device.
"""

import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
LAYERS = 2
COLL_BOUND = 2.0    # the port's collective bytes a device over the reference's
FLOPS_BOUND = 1.10  # the port's FLOPs a device over the reference's


def _start(cmd):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               PYTHONWARNINGS="ignore", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, *cmd], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def _finish(proc, timeout):
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


def _last_json(cmd, timeout):
    return _finish(_start(cmd), timeout)


def _port_cmd(arch, shape, multi_pod, layers, world):
    return ([str(ROOT / "scripts" / "cell_breakdown_torch.py"), arch, shape, "--layers",
             str(layers)] + (["--multi-pod"] if multi_pod else [])
            + (["--world", str(world)] if world else []))


def _reference_cmd(arch, shape, multi_pod, layers, dots):
    return ([str(ROOT / "scripts" / "dryrun_reference.py"), arch, shape, "--layers", str(layers)]
            + (["--multi-pod"] if multi_pod else []) + (["--dots", "1"] if dots else []))


def _check_reference(rec, layers):
    assert rec["status"] == "ok" and rec["layers"] == layers, rec
    return rec


@functools.cache
def port(arch, shape, multi_pod=False, layers=LAYERS, world=0):
    return _last_json(_port_cmd(arch, shape, multi_pod, layers, world), 300)


@functools.cache
def reference(arch, shape, multi_pod=False, layers=LAYERS, dots=False):
    return _check_reference(
        _last_json(_reference_cmd(arch, shape, multi_pod, layers, dots), 300), layers)


@functools.cache
def both(arch, shape, layers=LAYERS, dots=False):
    """(the port's cell, the reference's), traced side by side."""
    procs = _start(_port_cmd(arch, shape, False, layers, 0)), \
        _start(_reference_cmd(arch, shape, False, layers, dots))
    return _finish(procs[0], 300), _check_reference(_finish(procs[1], 300), layers)


def _all_gathers(rec):
    """(bytes a call, argument shapes) of each all-gather the port ran."""
    return [(c["coll"] / c["calls"], c["shapes"]) for c in rec["collective_ops"]
            if "all_gather" in c["op"]]


def test_phi4_decode_moves_what_the_reference_moves():
    """phi4-mini-3.8b decode_32k on 16x16: the vocab-parallel lookup gathers
    no part of the table ([12504, 3072] a rank), so the collective bytes a
    device stay within COLL_BOUND of the reference's."""
    got, want = port("phi4-mini-3.8b", "decode_32k"), reference("phi4-mini-3.8b", "decode_32k")
    assert got["sums_equal"] and got["layers"] == LAYERS
    assert got["flops"] == want["flops_per_device"]
    assert got["coll"] <= COLL_BOUND * want["collective_bytes_per_device"], (got, want)
    assert all([12504, 3072] not in shapes for _, shapes in _all_gathers(got))


def test_mla_decode_gathers_no_scores():
    """deepseek-v3-671b decode_32k on 16x16: MLA decode's split softmax
    all-reduces [B, 1, H] and [B, 1, H, kvr] and gathers nothing larger
    than the [B, 1, H, kvr] query (B = 8 rows a device, 128 heads, kv rank
    512, f32); the collective bytes a device stay within COLL_BOUND of the
    reference's."""
    got = port("deepseek-v3-671b", "decode_32k")
    want = reference("deepseek-v3-671b", "decode_32k")
    assert got["sums_equal"]
    assert got["coll"] <= COLL_BOUND * want["collective_bytes_per_device"], (got, want)
    largest = max(_all_gathers(got))
    assert largest[0] <= 8 * 1 * 128 * 512 * 4, largest


def test_phi4_train_flops_match_reference():
    """phi4-mini-3.8b train_4k on 16x16: 24 query heads padded to 32 no
    longer make every rank compute ``wo``'s whole [3072, 3072] gradient;
    the FLOPs a device stay within FLOPS_BOUND of the reference's."""
    got, want = port("phi4-mini-3.8b", "train_4k"), reference("phi4-mini-3.8b", "train_4k")
    assert got["sums_equal"]
    assert got["flops"] <= FLOPS_BOUND * want["flops_per_device"], (got, want)


def test_phi4_train_multi_pod_holds_less_per_device():
    """phi4-mini-3.8b train_4k: on 2x16x16 each device holds half the batch
    of 16x16, and with the vocab-parallel cross-entropy its live bytes fall
    below 16x16's (the reference's halve)."""
    one, two = port("phi4-mini-3.8b", "train_4k"), port("phi4-mini-3.8b", "train_4k", True)
    assert two["live"] < one["live"], (two["live"], one["live"])
    assert not [c for c in two["collective_ops"] if "all_gather" in c["op"]
                and any(s[-1] == 12504 and len(s) == 3 for s in c["shapes"])]


_SMOKE = textwrap.dedent(
    """
    import json, sys
    sys.path.insert(0, {src!r})
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    from repro_torch.configs.base import Shape, get_smoke
    from repro_torch.launch.cells import trace_cell
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.parallel.sharding import make_context

    ctx = make_context(make_debug_mesh(2, 4))
    cfg, shape = get_smoke("phi4-mini-3.8b").with_(remat="full"), Shape("t", "train", 32, 4)
    plain, _ = trace_cell(cfg, shape, ctx)
    costs, _ = trace_cell(cfg, shape, ctx, breakdown=True)
    sums = {{t: [sum(getattr(v, f) for v in rows.values()) for f in ("flops", "bytes", "coll")]
             for t, rows in costs.breakdown.items()}}
    print(json.dumps({{"plain": [plain.flops, plain.bytes, plain.coll_bytes],
                       "costs": [costs.flops, costs.bytes, costs.coll_bytes], "sums": sums,
                       "sites": sorted(costs.breakdown["site"])}}))
    """
)


def test_breakdown_sums_equal_the_counts():
    """The breakdown of SMOKE phi4's train step (full remat) on a fake 2x4
    mesh: each of its three keys sums to the counter's FLOPs, bytes and
    collective bytes, which equal a plain count's; backward ops are filed
    under the forward lines that made them, and the checkpointed layers'
    recompute apart."""
    rec = _last_json(["-c", _SMOKE.format(src=str(ROOT / "src"))], 300)
    assert rec["costs"] == rec["plain"]
    assert set(rec["sums"]) == {"op", "site", "coll"}
    for table, sums in rec["sums"].items():
        assert sums == rec["costs"], table
    sites = rec["sites"]
    assert any(s.endswith("[bwd]") and "attention.py" in s for s in sites)
    assert any(s.endswith("[recompute]") for s in sites)
    assert any(s.startswith("models/lm.py") and "(_embed_tokens)" in s for s in sites)


def test_mamba2_train_moves_what_the_reference_moves():
    """mamba2-2.7b train_4k on 16x16 (F4): the mixer runs per rank with
    whole heads (``ssm._mixer``), so no activation of the width of d_in
    (5120), of the conv channels (5376) or of the packed projection
    (10576), nor any piece of one over 'model', is gathered: each rank
    projects its own columns, and the gated norm all-reduces its sum of
    squares, [16, 4096, 1].  B and C (one group of state 128) are
    gathered, [16, 4096, 16] a rank: every head reads them, and projecting
    them on every rank instead would add 240 columns to each rank's 661 of
    the input projection.  Collective bytes a device within COLL_BOUND and
    FLOPs within FLOPS_BOUND of the reference's."""
    got, want = both("mamba2-2.7b", "train_4k")
    assert got["sums_equal"] and got["layers"] == LAYERS
    assert got["coll"] <= COLL_BOUND * want["collective_bytes_per_device"], (got["coll"], want)
    assert got["flops"] <= FLOPS_BOUND * want["flops_per_device"], (got["flops"], want)
    b_loc, seq, tp = 16, 4096, 16
    bc = 2 * 128 // tp  # this rank's columns of B and of C
    gathered = [(per_call, shapes) for per_call, shapes in _all_gathers(got)
                if any(len(s) >= 3 and s[1] == seq for s in shapes)]
    assert all(s[:2] == [b_loc, seq] and s[2:] == [bc] for _, shapes in gathered
               for s in shapes), gathered
    # B and C whole in bf16, once in each layer's forward and once in its recompute
    assert sum(c["coll"] for c in got["collective_ops"] if "all_gather" in c["op"]
               and any(s[:2] == [b_loc, seq] for s in c["shapes"])) \
        <= 2 * LAYERS * b_loc * seq * 2 * 128 * 2
    norm = [s for s in got["collective_sites"] if "_gated_norm" in s["site"]]
    assert norm and sum(s["coll"] for s in norm) <= 8 * 4 * b_loc * seq * 2 * 2 * LAYERS


def test_collectives_over_two_axes_are_one_group():
    """deepseek-v3-671b decode_32k (F5): the full-EP MoE layer's all-reduce
    over ("data", "model") runs on one flattened group of the 16x16 mesh,
    so the fake 512-rank group, which holds the mesh in its first 256
    ranks, reads the 256-rank group's collective bytes.  Four layers: the
    first three are dense, the fourth routes."""
    one, two = port("deepseek-v3-671b", "decode_32k", layers=4), \
        port("deepseek-v3-671b", "decode_32k", layers=4, world=512)
    assert one["coll"] == two["coll"] and one["collectives"] == two["collectives"], (one, two)
    assert one["flops"] == two["flops"]


@pytest.mark.parametrize("arch,layers,heads", [("qwen2-vl-2b", 2, 3), ("recurrentgemma-2b", 3, 5)])
def test_low_flop_training_cells_are_the_references_repeated_heads(arch, layers, heads):
    """qwen2-vl-2b and recurrentgemma-2b train_4k read 0.67x and 0.74x the
    reference's FLOPs at full depth.  The port's weight products (``mm``)
    equal the reference's unbatched dots; its attention products (``bmm``)
    do one query head a device (12 or 10 heads, padded to 16 over
    'model'), and the reference's batched dots do ``heads`` a device: its
    GSPMD splits the 12 heads over 4 ranks and the 10 over 2, each group
    repeated over the rest of 'model'.  recurrentgemma's third layer is its
    first local-attention block; at 2 layers its FLOPs equal the
    reference's."""
    got, want = both(arch, "train_4k", layers=layers, dots=True)
    assert got["sums_equal"]
    mm = sum(o["flops"] for o in got["flop_ops"] if o["op"] in ("aten.mm", "aten.addmm"))
    bmm = sum(o["flops"] for o in got["flop_ops"] if o["op"] == "aten.bmm")
    assert mm + bmm == got["flops"]
    plain = sum(d["flops"] for d in want["dots"] if len(d["shapes"][0]) == 2)
    batched = sum(d["flops"] for d in want["dots"] if len(d["shapes"][0]) == 3)
    assert plain + batched == pytest.approx(want["flops_per_device"], rel=1e-12)
    assert mm == pytest.approx(plain, rel=1e-9), (mm, plain)
    assert heads * bmm == pytest.approx(batched, rel=1e-9), (bmm, batched)
