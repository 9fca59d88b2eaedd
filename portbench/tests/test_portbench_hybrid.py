"""The hybrid training cell (``granite-hybrid-hetdp-train``, driver
``hetdp_train_hybrid``) end to end on the CPU at a small size: set-up,
window and check pass; each program fault fails a check; the counters and
the flops reach the readers; the fp8 control reads above the program.

The program runs in float32 at this size: in bfloat16 a router near-tie
flips between the two sides at random init and moves whole gradients of a
model this small (``tests/test_torch_granite.py``); the cell's limits come
from its bfloat16 runs on the card (``PERF.md`` §2)."""

import dataclasses

import pytest
import torch

from portbench import hybrid_counts, run
from portbench.drivers import hetdp_train_hybrid as hy

CELL = "granite-hybrid-hetdp-train"
SEED = 2**31 + 12_345
SMALL = {"config": {"hidden_size": 64, "mamba_n_heads": 8, "mamba_d_head": 16, "mamba_d_state": 16,
                    "mamba_chunk_size": 16, "num_attention_heads": 4, "num_key_value_heads": 2,
                    "intermediate_size": 32, "shared_intermediate_size": 48, "vocab_size": 256,
                    "router_experts": 12, "num_local_experts": 4, "num_experts_per_tok": 3,
                    "num_hidden_layers": 3, "layer_types": ["mamba", "attention", "mamba"],
                    "attention_multiplier": 0.0625, "torch_dtype": "float32"},
         "traffic": {"seq": 64}}


def _run(trace=False, seed=SEED):
    return run.run_cell(CELL, seed, 0.0, trace, device="cpu", patch=SMALL)


def test_cell_runs_correct_at_small_size():
    r = _run()
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"train_step_s", "setup_s"}
    assert r["checks"]["dropped_picks"] == {"value": 0.0, "limit": 0.0}
    w = r["detail"]["window_counters"]
    steps = r["attempted"]
    assert w["moe.calls"] == steps * 9 * 3 and w["moe.dropped"] == 0
    assert w["ssm.chunks"] == steps * 9 * 2 * 4  # 2 Mamba layers, 4 chunks of 16 a row
    assert w["moe.rows_max"] <= w["moe.rows_held"] <= 4 * w["moe.rows_max"]


def test_traced_run_reports_the_cells_per_layer_metrics():
    """Every per-layer metric that lists the cell and reads the counters or
    the steps (the CPU run has no device ops) is in the line."""
    r = _run(trace=True)
    m = r["metrics"]
    for name in ("train.steals", "train.makespan_over_floor", "train.step_mfu",
                 "train.idle_with_work_ms", "moe.rows_max_over_mean"):
        assert name in m, name
    assert m["moe.rows_max_over_mean"]["value"] >= 1.0


def _program_faults():
    from repro_torch.runtime import het_dp

    def unchanged_state(mp):
        update = het_dp.adamw_update

        def keep(grads, opt_state, params, cfg, lr_scale=1.0):
            copy = lambda t: het_dp.tree_map(torch.clone, t)  # noqa: E731
            _, state, om = update(grads, {**opt_state, "m": copy(opt_state["m"]),
                                          "v": copy(opt_state["v"])}, copy(params), cfg, lr_scale)
            return params, state, om
        mp.setattr(het_dp, "adamw_update", keep)

    def half_the_batch(mp):
        gradient = het_dp.HetDPTrainer.gradient
        mp.setattr(het_dp.HetDPTrainer, "gradient",
                   lambda self, mbs: gradient(self, mbs[: len(mbs) // 2]))

    def port(change):
        def fault(mp):
            orig = hy.port_config
            mp.setattr(hy, "port_config", lambda cfg: change(orig(cfg)))
        return fault

    capacity = port(lambda pc: dataclasses.replace(
        pc, moe=dataclasses.replace(pc.moe, dropless=False, capacity_factor=1.25)))
    rotary = port(lambda pc: dataclasses.replace(pc, nope=False))
    return {"unchanged_state": unchanged_state, "half_the_batch": half_the_batch,
            "capacity_1.25": capacity, "rotary": rotary}


@pytest.mark.parametrize("fault", ["unchanged_state", "half_the_batch", "capacity_1.25", "rotary"])
def test_check_catches_fault(fault, monkeypatch):
    _program_faults()[fault](monkeypatch)
    r = _run()
    assert not r["correct"], r["checks"]
    failing = {k for k, c in r["checks"].items() if c["value"] > c["limit"]}
    if fault == "capacity_1.25":
        assert "dropped_picks" in failing


def test_control_reads_above_the_program():
    """The reference with float8 products, in the program's place, reads
    above the program on the first step's gradient norms at this size; its
    readings at the cell's size set the limits (``portbench/control.py``)."""
    from portbench import control

    got = control.train_readings(CELL, [SEED], patch=SMALL, device="cpu")
    assert got["control"][0]["grad_norm_gap"] > 3 * got["program"][0]["grad_norm_gap"]


def test_same_seed_same_reference_readings():
    _, _, _, cfg, traffic = run.cell_files(CELL)
    cfg.update(SMALL["config"])
    traffic.update(SMALL["traffic"])
    opt = {k: traffic[k] for k in ("lr", "b1", "b2", "eps", "weight_decay", "clip_norm")}
    args = (cfg, traffic, SEED, 1, torch.device("cpu"), torch.bfloat16, opt)
    assert hy.reference_readings(*args) == hy.reference_readings(*args)


def test_parameter_count_and_flops_of_the_cut():
    """The cut's tree holds 2,320,321,152 parameters (9 Mamba-2 layers of
    196,961,920, one attention layer of 136,617,984, the embedding and the
    final norm); a step's flops grow with the held experts' rows."""
    _, _, _, cfg, traffic = run.cell_files(CELL)
    shapes = hy.leaf_shapes(cfg)
    total = sum(torch.Size(s).numel() for s, _ in shapes.values())
    assert total == 2_320_321_152
    from repro_torch.models import lm
    assert lm.param_count(hy.port_config(cfg)) == total
    dense = hybrid_counts.dense_matmul_params(cfg)
    mamba = 4096 * 16768 + 8192 * 4096
    attn = 4096 * 6144 + 4096 * 4096
    ffn = 4096 * 72 + 3 * 4096 * 1536
    assert dense == 9 * mamba + attn + 10 * ffn + 4096 * 100352
    a = hybrid_counts.train_step_flops(cfg, 9, 2048, 0)
    b = hybrid_counts.train_step_flops(cfg, 9, 2048, 1000)
    assert b - a == 6 * 3 * 4096 * 768 * 1000


def test_rows_reader_is_silent_without_the_counters():
    from types import SimpleNamespace

    read = run.reader("moe.rows_max_over_mean")
    assert read(SimpleNamespace(counters={"pool_stats": []})) is None
    assert read(SimpleNamespace(counters={"moe.rows_held": 300, "moe.rows_max": 60,
                                          "moe.experts_held": 8})) == 1.6


def test_reference_gives_an_unreached_leaf_a_zero_gradient():
    """A held expert no token picks (routing can leave a layer's held share
    idle after some steps) takes no part in the reference's graph: its
    gradient is 0, as the program's dropless product of no rows gives."""
    from portbench.reference import granite_hybrid as ref

    _, _, _, cfg, traffic = run.cell_files(CELL)
    cfg.update(SMALL["config"])
    traffic.update(SMALL["traffic"])
    opt = {k: traffic[k] for k in ("lr", "b1", "b2", "eps", "weight_decay", "clip_norm")}
    params = ref.flat_leaves(hy.make_params(cfg, SEED, "cpu", torch.float32))
    params["unreached"] = torch.ones(3, 4)
    batches = [hy.base.make_batches(cfg, traffic, SEED, 0, "cpu")[:1]]
    got = ref.train_steps(params, batches, cfg, opt)
    assert got["grad_norms"]["unreached"] == 0.0


def test_routed_reference_takes_the_programs_picks():
    """The late step's second reading: the reference on the program's expert
    picks.  In float32 at this size the two sides pick alike (no flips, the
    same gaps as the reference's own routing); picks moved to other experts
    are counted as flips and move the reference's gradients."""
    r = _run()
    nc = r["detail"]["not_compared"]
    assert nc["late_route_flips"] == 0.0
    for k in ("grad_norm_gap", "change_norm_gap", "grad_norm_gap_median"):
        assert nc["late_routed_" + k] == pytest.approx(
            r["checks"].get("late_" + k, {}).get("value", nc.get("late_" + k)), rel=1e-6, abs=1e-9)

    from portbench.reference import granite_hybrid as ref

    _, _, _, cfg, traffic = run.cell_files(CELL)
    cfg.update(SMALL["config"])
    traffic.update(SMALL["traffic"])
    opt = {k: traffic[k] for k in ("lr", "b1", "b2", "eps", "weight_decay", "clip_norm")}
    tree = hy.make_params(cfg, SEED, "cpu", torch.float32)
    batches = hy.base.make_batches(cfg, traffic, SEED, 0, "cpu")[:2]
    own = hy.program_routes(tree, batches, hy.port_config(cfg))
    assert [len(mb) for mb in own] == [3, 3]
    assert all(tuple(r.top_i.shape) == (1, 64, 3) for mb in own for r in mb)
    params = ref.flat_leaves(tree)
    same = ref.train_steps({k: v.clone() for k, v in params.items()}, [batches], cfg, opt,
                           routes=[own])
    free = ref.train_steps({k: v.clone() for k, v in params.items()}, [batches], cfg, opt)
    assert same["route_flips"] == 0
    assert same["grad_norms"] == pytest.approx(free["grad_norms"], rel=1e-5)
    moved = [[ref.Routed((r.top_i + 1) % cfg["router_experts"]) for r in mb] for mb in own]
    other = ref.train_steps({k: v.clone() for k, v in params.items()}, [batches], cfg, opt,
                            routes=[moved])
    # the first layer's input does not hang on the picks: every token flips
    assert [mb[0].flips for mb in moved] == [64, 64]
    assert other["route_flips"] == sum(r.flips for mb in moved for r in mb) > 2 * 64
    assert other["grad_norms"] != pytest.approx(free["grad_norms"], rel=1e-3)
