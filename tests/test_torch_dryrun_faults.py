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

ROOT = Path(__file__).resolve().parent.parent
LAYERS = 2
COLL_BOUND = 2.0    # the port's collective bytes a device over the reference's
FLOPS_BOUND = 1.10  # the port's FLOPs a device over the reference's


def _last_json(cmd, timeout):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               PYTHONWARNINGS="ignore", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, *cmd], capture_output=True, text=True,
                         timeout=timeout, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@functools.cache
def port(arch, shape, multi_pod=False):
    return _last_json([str(ROOT / "scripts" / "cell_breakdown_torch.py"), arch, shape,
                       "--layers", str(LAYERS)] + (["--multi-pod"] if multi_pod else []), 300)


@functools.cache
def reference(arch, shape, multi_pod=False):
    rec = _last_json([str(ROOT / "scripts" / "dryrun_reference.py"), arch, shape,
                      "--layers", str(LAYERS)]
                     + (["--multi-pod"] if multi_pod else []), 300)
    assert rec["status"] == "ok" and rec["layers"] == LAYERS, rec
    return rec


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
