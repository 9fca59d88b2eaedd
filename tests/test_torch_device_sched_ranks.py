"""The port's multi-rank device scheduler (``repro_torch.core.device_sched``
with ``mesh=``) against the reference's ``shard_map`` round and against the
port's one-process round, on the CPU.

The ranks are ``gloo`` processes (``tests/_torch_dist.py::run_group``,
``sched_worker``), each holding a block of workers on a 1-D ("workers",)
mesh.  The reference's round runs in a subprocess with 8 forced host
devices, one worker a device, and records its state after every round with
the Gumbel draws it made from its keys; the ranks replay those draws.  The
dry-run counts run in subprocesses: the port's on a fake process group, the
reference's lowered on forced host devices.
"""

import functools
import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dist import run_group
from repro.core import device_sched as jds
from repro_torch.core import device_sched as tds

ROOT = Path(__file__).resolve().parent.parent
FLOAT_RTOL = 1e-6
P8 = dict(p=8, speeds=[24, 16, 8, 8, 4, 2, 1, 1], tasks=192, radius=2, max_steal=8)
P8_ROUNDS = 7
P256 = dict(p=256, speeds=[s for s in (24.0, 16.0, 4.0, 1.0) for _ in range(64)],
            tasks=7680, radius=51, max_steal=16)  # scripts/sched_cell.py
P16 = dict(p=16, speeds=[24, 24, 16, 16, 8, 8, 4, 4, 2, 2, 1, 1, 1, 1, 1, 1], tasks=480,
           radius=3, max_steal=4)
VARIANTS = {"packed": True, "baseline": False}

_REFERENCE = textwrap.dedent(
    r"""
    import os, pickle, re, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, {src!r})
    import jax, jax.numpy as jnp, numpy as np
    from repro.core import device_sched as ds
    from repro.launch.cells import collective_bytes
    cfg = {cfg!r}
    p, w = cfg["p"], 2 * cfg["radius"] + 1
    mesh = jax.make_mesh((p,), ("workers",))
    counts = [cfg["tasks"] // p + (1 if i < cfg["tasks"] % p else 0) for i in range(p)]

    def draw(key):
        _, sub = jax.random.split(jax.random.wrap_key_data(key))
        return jax.random.gumbel(sub, (w,), jnp.float32)

    draws = jax.jit(jax.vmap(draw))
    out = {{}}
    for variant, packed in {variants!r}.items():
        state = ds.init_state(p, jnp.asarray(counts, jnp.int32),
                              jnp.asarray(cfg["speeds"], jnp.float32), cfg["radius"],
                              capacity=cfg["tasks"])
        step = ds.make_round_fn(mesh, "workers", cfg["radius"], cfg["max_steal"], packed=packed)
        # XLA's CPU backend lowers each all_to_all at P=8 to a tuple of 8
        # results, whose "/*index=5*/" comment collective_bytes' pattern
        # does not cross: without the comments it counts them
        hlo = re.sub(r"/\*index=\d+\*/", "", step.lower(state).compile().as_text())
        coll = collective_bytes(hlo)
        states, gumbel = [state._asdict()], []
        for _ in range({rounds}):
            gumbel.append(np.asarray(draws(jnp.asarray(np.asarray(state.key)))))
            state = step(state)
            states.append(state._asdict())
        out[variant] = {{"coll": coll, "gumbel": np.asarray(gumbel),
                         "states": [{{k: np.asarray(v) for k, v in s.items()}} for s in states]}}
    with open({out!r}, "wb") as f:
        pickle.dump(out, f)
    """
)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's shard_map round at p8 on 8 forced host devices, both
    variants: every state, the draws of every round, the collective bytes."""
    out = tmp_path_factory.mktemp("ref") / "p8.pkl"
    code = _REFERENCE.format(src=str(ROOT / "src"), cfg=P8, variants=VARIANTS,
                             rounds=P8_ROUNDS, out=str(out))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


@functools.lru_cache(maxsize=None)
def _reference_draws(p: int, radius: int, rounds: int) -> np.ndarray:
    """``[rounds, P, 2R+1]``: the Gumbel draws of the reference's rounds
    from ``init_state``'s keys (seed 0), as ``jax.random.categorical``
    makes them.  The keys advance without reading the state, so no round
    needs to run."""
    w = 2 * radius + 1
    keys = jds.init_state(p, jnp.zeros(p, jnp.int32), jnp.ones(p, jnp.float32), radius,
                          capacity=1).key

    def one(key):
        key, sub = jax.random.split(jax.random.wrap_key_data(key))
        return jax.random.key_data(key), jax.random.gumbel(sub, (w,), jnp.float32)

    step = jax.jit(jax.vmap(one))
    out = []
    for _ in range(rounds):
        keys, g = step(keys)
        out.append(np.asarray(g))
    return np.stack(out)


def _group(world, jobs, tmp_path_factory):
    return run_group(world, "_torch_dist:sched_worker", jobs, tmp_path_factory.mktemp("ranks"))


@pytest.fixture(scope="module")
def eight_ranks(reference, tmp_path_factory):
    """p8 on 8 ranks, one worker a rank, replaying the reference's draws."""
    jobs = [dict(kind="replay", packed=packed, gumbel=reference[v]["gumbel"], **P8)
            for v, packed in VARIANTS.items()]
    return dict(zip(VARIANTS, _group(8, jobs, tmp_path_factory)))


@pytest.fixture(scope="module")
def four_ranks(reference, tmp_path_factory):
    """On 4 ranks: p8 (two workers a rank) replaying the reference's draws;
    P=256 beside the one-process round on the reference's draws; a seeded
    run; R=0; and a worker count the ranks do not divide."""
    jobs = [dict(kind="replay", packed=packed, gumbel=reference[v]["gumbel"], **P8)
            for v, packed in VARIANTS.items()]
    draws = _reference_draws(P256["p"], P256["radius"], 32)
    jobs += [dict(kind="ranks_vs_one", packed=packed, gumbel=draws, **P256)
             for packed in VARIANTS.values()]
    jobs += [dict(kind="seed", seed=5, **P16), dict(kind="seed", seed=3, **{**P16, "radius": 0}),
             dict(kind="split", **{**P16, "p": 10, "speeds": [1.0] * 10, "tasks": 40})]
    out = _group(4, jobs, tmp_path_factory)
    return {"p8": dict(zip(VARIANTS, out[:2])), "p256": dict(zip(VARIANTS, out[2:4])),
            "seed": out[4], "r0": out[5], "split": out[6]}


def _assert_same_state(want: dict, got: dict, rnd: int) -> None:
    for name in tds.SchedState._fields:
        w, g = np.asarray(want[name]), got[name]
        assert g.dtype == w.dtype, (rnd, name, g.dtype, w.dtype)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL, atol=0, equal_nan=True,
                                       err_msg=f"round {rnd}, field {name}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"round {rnd}, field {name}")


def _assert_conserved(state: dict, num_tasks: int) -> None:
    ids = np.concatenate([q[:t] for q, t in zip(state["queue"], state["tail"])])
    np.testing.assert_array_equal(np.sort(ids), np.arange(num_tasks, dtype=np.int32))
    np.testing.assert_array_equal(state["head"], state["tail"])
    assert int(state["executed"].sum()) == num_tasks


# ------------------------------------------------- the reference's round
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("world", [8, 4])
def test_ranks_match_reference_shard_map_round(reference, eight_ranks, four_ranks, world,
                                               variant):
    """p8: the port on 8 gloo ranks (one worker a rank, the reference's own
    layout) and on 4 (two a rank) against the reference's ``make_round_fn``
    on 8 devices, round by round on its draws: integer fields equal, floats
    within 1e-6 relative; the run ends in 7 rounds."""
    got = (eight_ranks if world == 8 else four_ranks["p8"])[variant]
    want = reference[variant]["states"]
    assert len(got) == len(want) == P8_ROUNDS + 1
    for rnd, (w, g) in enumerate(zip(want, got)):
        _assert_same_state(w, g, rnd)
    assert int((got[-1]["tail"] - got[-1]["head"]).sum()) == 0
    _assert_conserved(got[-1], P8["tasks"])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_p256_on_four_ranks_matches_one_process(four_ranks, variant):
    """scripts/sched_cell.py's configuration on 4 ranks of 64 workers,
    beside the one-process round on the reference's draws (each rank's block
    equal to its rows bit for bit after every round, checked in the ranks):
    25 rounds, makespan 24.0, every task id conserved."""
    out = four_ranks["p256"][variant]
    assert out["rounds"] == 25
    assert out["makespan"] == 24.0
    _assert_conserved(out["state"], P256["tasks"])


# ------------------------------------------------ seeds and edge cases
@pytest.mark.parametrize("world", [1, 2, 4])
def test_seeded_run_on_ranks_equals_one_process(four_ranks, tmp_path_factory, world):
    """``virtual_run(mesh=..., seed=5)`` equals ``virtual_run(seed=5)``:
    every rank draws all P rows from the seed's generator and keeps its own.
    At 2 ranks both ring neighbours are the same rank; at 1 the ring wraps
    inside the block and the exchanges still cross the group."""
    out = (four_ranks["seed"] if world == 4 else
           _group(world, [dict(kind="seed", seed=5, **P16)], tmp_path_factory)[0])
    assert out["field"] is None, out
    assert out["rounds"][0] == out["rounds"][1] and out["rounds"][0] < 4096
    assert out["makespan"][0] == out["makespan"][1]


def test_radius_zero_on_ranks(four_ranks):
    """R=0: no ring, so no steals; the ranks still equal one process."""
    out = four_ranks["r0"]
    assert out["field"] is None, out
    assert out["rounds"] == (30, 30)  # 30 tasks at speed 1: the static partition


def test_workers_the_ranks_do_not_divide_raise(four_ranks):
    for err in four_ranks["split"]:
        assert err == "10 workers do not split over 4 ranks of 'workers'"


# ------------------------------------------------------------ dry-run
_DRYRUN = textwrap.dedent(
    """
    import json, sys
    sys.path[:0] = [{src!r}, {scripts!r}]
    import sched_cell_torch as cell
    print(json.dumps({{v: cell.dryrun_record(v, *{cfg!r}) for v in ("baseline", "packed")}}))
    """
)


def _dryrun(cfg: tuple) -> dict:
    code = _DRYRUN.format(src=str(ROOT / "src"), scripts=str(ROOT / "scripts"), cfg=cfg)
    env = dict(os.environ, PYTHONWARNINGS="ignore")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_dryrun_p8_collective_bytes_match_reference_lowering(reference):
    """One round on a fake group of 8 ranks: the collective bytes by kind
    equal ``repro.launch.cells.collective_bytes`` of the reference's round
    lowered on 8 forced host devices, packed and baseline: a pmax of one
    f32, two permutes of f32[3, 2], and the request and payload all-to-alls
    (i32, or u16 when packed)."""
    recs = _dryrun((8, P8["radius"], P8["max_steal"], P8["tasks"]))
    for variant, a2a in (("baseline", 4 * (8 + 8 * 8)), ("packed", 2 * (8 + 8 * 8))):
        want = {"all-reduce": 8, "collective-permute": 2 * 3 * 2 * 4, "all-to-all": a2a}
        assert reference[variant]["coll"] == want, variant
        assert recs[variant]["collectives"] == want, variant


def test_dryrun_p256_record():
    """scripts/sched_cell_torch.py --dryrun's cell: P=256 ranks, R=51,
    max_steal 16, 7680 tasks; all-reduce 8, collective-permute 1224 and
    all-to-all 17408 (baseline) or 8704 (packed) bytes a device, as the
    reference's scripts/sched_cell.py records."""
    recs = _dryrun((256, 51, 16, 7680))
    for variant, a2a in (("baseline", 17408), ("packed", 8704)):
        rec = recs[variant]
        assert rec["collectives"] == {"all-reduce": 8, "collective-permute": 1224,
                                      "all-to-all": a2a}
        assert rec["collectives"] == rec["reference"]["collectives"]
        assert rec["chips"] == 256 and rec["status"] == "ok"
        assert rec["bytes_per_device"] > 0 and rec["live_bytes_per_device"] > 0
