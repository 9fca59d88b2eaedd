"""The harness end to end on the CPU at small sizes: each cell's set-up,
window and check; the faults that each check must catch; the refusal
without a card; and that nothing a run loads is JAX or the JAX package."""

import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from portbench import run
from portbench.tests import small

SEED = 2**31 + 12_345  # above 32 signed bits, as the check's seeds are


@pytest.mark.parametrize("cell", sorted(small.CELLS))
def test_cell_runs_correct_at_small_size(cell):
    r = run.run_cell(cell, SEED, 0.3, False, device="cpu", patch=small.CELLS[cell])
    assert r["correct"], r
    assert r["attempted"] > 0 and r["failed"] == 0
    e2e = {m["name"] for m in run.end_to_end_metrics(run.load_json(run.ROOT / "BENCHMARK.json"), cell)}
    assert set(r["metrics"]) == e2e
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", ["overthrust-uniform", "overthrust-bimodal"])
def test_same_seed_same_check(cell):
    """A survey's check reads the same on the same seed: the inputs, the
    sample and the seismograms come from the seed alone."""
    a = run.run_cell(cell, 7, 0.0, False, device="cpu", patch=small.CELLS[cell])
    b = run.run_cell(cell, 7, 0.0, False, device="cpu", patch=small.CELLS[cell])
    assert a["checks"] == b["checks"]


def test_same_seed_same_reference_readings():
    """The training check's reference side comes from the seed alone (the
    program's side varies with which worker ran which microbatch)."""
    from portbench.drivers import hetdp_train as ht

    _, _, cfile, cfg, traffic = run.cell_files("phi4-hetdp-train")
    cfg.update(small.TRAIN["config"])
    traffic.update(small.TRAIN["traffic"])
    opt = {k: traffic[k] for k in ("lr", "b1", "b2", "eps", "weight_decay", "clip_norm")}
    args = (cfg, traffic, SEED, 2, torch.device("cpu"), torch.bfloat16, opt)
    assert ht.reference_readings(*args) == ht.reference_readings(*args)


def _alter_where(mp, pick):
    """Alter the seismogram of each shot task for which ``pick(wid, task,
    tasks)`` holds, inside the pool's call of the task."""
    import threading

    import repro_torch.seismic.tasks as tasks
    from repro_torch.core import a2ws

    flag = threading.local()
    init, shot = a2ws.WorkerPool.__init__, tasks.run_shot

    def pool_init(self, ts, nw, task_fn, *a, **kw):
        ts = list(ts)

        def wrapped(wid, task):
            flag.on = pick(wid, task, ts, nw)
            try:
                return task_fn(wid, task)
            finally:
                flag.on = False
        init(self, ts, nw, wrapped, *a, **kw)

    def altered(*a, **kw):
        seis = shot(*a, **kw)
        if getattr(flag, "on", False):
            seis[seis.shape[0] // 2] += 1.0
        return seis
    mp.setattr(a2ws.WorkerPool, "__init__", pool_init)
    mp.setattr(tasks, "run_shot", altered)


def _survey_faults():
    import repro_torch.seismic.model as model
    import repro_torch.seismic.tasks as tasks
    from repro_torch.core import a2ws
    from portbench.drivers.survey import block_owners

    def unchanged_state(mp):
        mp.setattr(model, "fd3d_step", lambda u, u_prev, c2dt2, **kw: u.clone())

    def half_the_batch(mp):
        init = a2ws.WorkerPool.__init__
        mp.setattr(a2ws.WorkerPool, "__init__",
                   lambda self, t, *a, **kw: init(self, list(t)[::2], *a, **kw))

    def answer_altered(mp):
        shot = tasks.run_shot

        def altered(*a, **kw):
            seis = shot(*a, **kw)
            seis[seis.shape[0] // 2] += 1.0
            return seis
        mp.setattr(tasks, "run_shot", altered)

    def stolen_altered(mp):
        _alter_where(mp, lambda wid, task, ts, nw: block_owners(len(ts), nw)[ts.index(task)] != wid)

    def slow_worker_altered(mp):
        _alter_where(mp, lambda wid, task, ts, nw: wid == nw - 1)

    return [unchanged_state, half_the_batch, answer_altered, stolen_altered, slow_worker_altered]


def _train_faults():
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

    def unchanged_after_set_up(mp):
        """Only the steps after the checked first three leave the state as
        it was: the late step's check must see it."""
        update = het_dp.adamw_update

        def keep_late(grads, opt_state, params, cfg, lr_scale=1.0):
            if int(opt_state["count"]) < 3:
                return update(grads, opt_state, params, cfg, lr_scale)
            copy = lambda t: het_dp.tree_map(torch.clone, t)  # noqa: E731
            _, state, om = update(grads, {**opt_state, "m": copy(opt_state["m"]),
                                          "v": copy(opt_state["v"])}, copy(params), cfg, lr_scale)
            return params, state, om
        mp.setattr(het_dp, "adamw_update", keep_late)

    return [unchanged_state, half_the_batch, unchanged_after_set_up]


@pytest.mark.parametrize("cell,fault", [
    *[(c, i) for c in ("overthrust-uniform", "overthrust-bimodal") for i in range(5)],
    *[("phi4-hetdp-train", i) for i in range(3)],
])
def test_check_catches_fault(cell, fault, monkeypatch):
    faults = _train_faults() if cell == "phi4-hetdp-train" else _survey_faults()
    faults[fault](monkeypatch)
    r = run.run_cell(cell, SEED, 0.0, False, device="cpu", patch=small.CELLS[cell])
    assert not r["correct"], r
    if cell != "phi4-hetdp-train" and fault == 3:  # the fault needs a steal to show
        assert any(r["detail"]["steals"]), r["detail"]


def test_late_step_is_checked_alone(monkeypatch):
    """A fault from the fourth step on passes the first steps' numbers and
    fails the late step's."""
    _train_faults()[2](monkeypatch)
    r = run.run_cell("phi4-hetdp-train", SEED, 0.0, False, device="cpu", patch=small.TRAIN)
    c = r["checks"]
    assert c["grad_norm_gap"]["value"] <= c["grad_norm_gap"]["limit"]
    assert c["change_norm_gap"]["value"] <= c["change_norm_gap"]["limit"]
    assert c["late_change_norm_gap"]["value"] > c["late_change_norm_gap"]["limit"]


@pytest.mark.parametrize("cell", ["overthrust-uniform", "overthrust-bimodal"])
def test_survey_sample_covers_each_worker_a_steal_and_each_length(cell):
    r = run.run_cell(cell, SEED, 0.0, False, device="cpu", patch=small.CELLS[cell])
    checked = r["detail"]["checked"]
    ran = {w for per in r["detail"]["tasks_per_worker"] for w, n in enumerate(per) if n}
    assert {c["worker"] for c in checked} == ran
    assert any(c["stolen"] for c in checked) == any(r["detail"]["steals"])
    nts = {g["nt"] for g in small.CELLS[cell]["traffic"]["shots"]}
    assert {c["nt"] for c in checked} == nts


def test_survey_control_fails():
    """The reference in bfloat16, one precision below the configuration's
    float32, in the program's place, fails the seismogram limit."""
    from portbench import control

    got = control.survey_readings("overthrust-uniform", [SEED], patch=small.UNIFORM, device="cpu")
    limit = run.cell_files("overthrust-uniform")[2]["limits"]["seis_gap"]
    assert got["program"][0]["seis_gap"] <= limit
    assert got["control"][0]["seis_gap"] > 10 * limit


def test_train_control_reads_above_the_program():
    """The reference with float8 products, in the program's place, reads
    above the program on the loss and on the gradient norms at this size;
    its readings at the cell's size set the limits (``portbench/control.py``)."""
    from portbench import control

    got = control.train_readings("phi4-hetdp-train", [SEED], patch=small.TRAIN, device="cpu")
    prog, ctrl = got["program"][0], got["control"][0]
    assert ctrl["loss_gap"] > 2 * prog["loss_gap"]
    assert ctrl["grad_norm_gap"] > 3 * prog["grad_norm_gap"]


def test_refuses_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "overthrust-uniform",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=run.ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode == 2 and p.stdout.strip() == "", (p.returncode, p.stdout, p.stderr)
    assert "CUDA card" in p.stderr


def test_fails_without_the_program(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's files
    has no program to run: the run raises and prints no result."""
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(run.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(tmp_path)!r})
        from portbench import run
        run.run_cell("overthrust-uniform", 1, 0.0, False, device="cpu")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and "{" not in p.stdout


def test_nothing_loaded_is_jax_or_the_jax_package():
    """Both drivers and every reader run in a process where ``jax`` and
    ``repro`` cannot be imported; then no loaded module's top-level name
    (before the first dot, compared whole) is theirs."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "flax", "repro"):
            sys.modules[name] = None
        sys.path[:0] = [{str(run.ROOT)!r}, {str(run.ROOT / "src")!r}]
        from portbench import run
        from portbench.tests import small
        for cell, patch in small.CELLS.items():
            assert run.run_cell(cell, 3, 0.0, False, device="cpu", patch=patch)["correct"]
        bench = run.load_json(run.ROOT / "BENCHMARK.json")
        for m in bench["per_layer"]:
            run.reader(m["name"])
        import portbench.control
        print(run.forbidden_modules())
        print(sorted({{k.split(".")[0] for k, v in sys.modules.items() if v is not None}}))
    """)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    bad, tops = p.stdout.strip().splitlines()[-2:]
    assert bad == "[]"
    assert "repro_torch" in tops and "'repro'" not in tops and "'jax'" not in tops
