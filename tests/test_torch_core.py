"""The port's copy of the A2WS core (``repro_torch.core``): byte-identical to
the reference's modules (``a2ws.py`` but for a committed diff), exporting
what they define, simulating as the reference does, and scheduling real
torch shots whose seismograms equal the JAX set."""

import dataclasses
import difflib
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as jcore
import repro_torch.core as tcore
from repro.seismic import model as jm
from repro_torch.core import A2WSRuntime
from repro_torch.seismic import make_demo_model
from repro_torch.seismic.tasks import make_shot_task

ROOT = Path(__file__).resolve().parent.parent
COPIED = ["deque", "steal", "info_ring", "policy", "limp", "topology",
          "netfault", "a2ws", "baselines", "simulator", "trace"]
# the port's own lines in a copied module: the unified diff from the
# reference's file to the port's (a2ws: the spans and the idle counter)
PATCHES = {"a2ws": ROOT / "tests" / "torch_core_a2ws.diff"}


@pytest.mark.parametrize("module", COPIED)
def test_copied_module_is_byte_identical(module):
    """Each copied module is the reference's byte for byte, or the
    reference's with exactly the port's committed diff applied."""
    ours = ROOT / "src" / "repro_torch" / "core" / f"{module}.py"
    theirs = ROOT / "src" / "repro" / "core" / f"{module}.py"
    if module not in PATCHES:
        assert ours.read_bytes() == theirs.read_bytes()
        return
    diff = difflib.unified_diff(
        theirs.read_bytes().decode().splitlines(True), ours.read_bytes().decode().splitlines(True),
        f"src/repro/core/{module}.py", f"src/repro_torch/core/{module}.py")
    assert "".join(diff) == PATCHES[module].read_bytes().decode()


def test_exports_are_the_references_minus_the_simulator():
    """Every name the reference's core exports, in its order, from the port:
    the simulator, once held out, is ported, so nothing is subtracted now."""
    assert tcore.__all__ == jcore.__all__
    for name in tcore.__all__:
        obj = getattr(tcore, name)
        if callable(obj):
            assert obj.__module__.startswith("repro_torch.core.")
    assert tcore.A2WSRuntime is tcore.WorkerPool


@pytest.mark.parametrize("policy", ["a2ws", "ctws", "lw"])
def test_simulate_equals_reference(policy):
    """The copied simulator gives the reference's SimResult, field for field."""
    def run(core):
        cfg = core.SimConfig(speeds=core.table2_speeds("C1"), num_tasks=240, seed=3)
        return dataclasses.asdict(core.simulate(policy, cfg))

    got, want = run(tcore), run(jcore)
    assert got == want
    assert sum(got["per_node_tasks"]) == 240


def test_a2ws_schedules_torch_shots_equal_to_jax():
    """Mirror of test_seismic.py::test_a2ws_schedules_real_shots through the
    copied core: 2 workers, n=16, nt=40, 6 shots; the seismograms keyed by
    source equal the JAX set, whichever worker ran each shot."""
    nt = 40
    jmod = jm.make_demo_model(n=16)
    shots = jm.make_shot_grid(jmod, 6)
    want = {
        s.src: np.asarray(jm.run_shot(jmod, jnp.asarray(s.src),
                                      jnp.asarray(s.rec_array()), nt=nt))
        for s in shots
    }
    tmod = make_demo_model(n=16, device="cpu")
    results = {}
    rt = A2WSRuntime(shots, 2, make_shot_task(tmod, nt, 2, results), seed=0)
    stats = rt.run()
    assert not rt.errors
    assert sum(stats.per_worker_tasks) == 6
    assert set(results) == set(want)
    for src, seis in results.items():
        peak = np.abs(want[src]).max()
        np.testing.assert_allclose(seis, want[src], rtol=1e-5, atol=1e-5 * peak)


def test_example_runs_on_cpu():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "seismic_shots_torch.py"),
         "--device", "cpu", "--n", "16", "--nt", "20", "--shots", "6"],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
    )
    assert proc.returncode == 0, proc.stderr
    assert "a2ws" in proc.stdout and "ctws" in proc.stdout
