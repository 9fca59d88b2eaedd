"""The port's seismic substrate (``repro_torch.seismic``) against the JAX
reference, and the physics checks of ``tests/test_seismic.py`` on the torch
side.  Everything runs on the CPU, through the FD3D step's plain version."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.seismic import model as jm
from repro_torch.seismic import (
    SeismicModel,
    make_demo_model,
    make_shot_grid,
    ricker,
    run_shot,
    seismic_model_from_numpy,
)
from repro_torch.seismic import model as tm

ROOT = Path(__file__).resolve().parent.parent


def _bridge(m, device="cpu") -> SeismicModel:
    return seismic_model_from_numpy(
        np.asarray(m.velocity), m.dx, m.dt, m.f_peak, m.sponge, m.sponge_decay,
        device=device,
    )


def _jax_seis(m, shot, nt):
    return np.asarray(jm.run_shot(m, jnp.asarray(shot.src),
                                  jnp.asarray(shot.rec_array()), nt=nt))


@pytest.mark.parametrize("f_peak,dt,nt", [(12.0, 1e-3, 120), (10.0, 1e-3, 400), (25.0, 5e-4, 64)])
def test_ricker_matches_jax(f_peak, dt, nt):
    got = ricker(f_peak, dt, nt, device="cpu")
    assert got.dtype == torch.float32
    want = np.asarray(jm.ricker(f_peak, dt, nt))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape,width,decay", [
    ((24, 24, 24), 8, 0.012), ((13, 20, 9), 4, 0.05), ((16, 16, 16), 8, 0.012),
])
def test_sponge_mask_matches_jax(shape, width, decay):
    got = tm._sponge_mask(shape, width, decay, device="cpu")
    assert got.dtype == torch.float32
    want = np.asarray(jm._sponge_mask(shape, width, decay))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_demo_model_and_shot_grid_match_jax():
    jmod = jm.make_demo_model(n=24)
    tmod = make_demo_model(n=24, device="cpu")
    np.testing.assert_array_equal(tmod.velocity.numpy(), np.asarray(jmod.velocity))
    got = [(s.src, s.receivers) for s in make_shot_grid(tmod, 5)]
    assert got == [(s.src, s.receivers) for s in jm.make_shot_grid(jmod, 5)]


def test_run_shot_matches_jax():
    """n=24, nt=120: the torch seismogram equals the JAX one (4e-7 relative
    observed; summation order in the step is the same, the mask multiplies
    and the source add are the same float32 operations)."""
    jmod = jm.make_demo_model(n=24)
    shot = jm.make_shot_grid(jmod, 1)[0]
    want = _jax_seis(jmod, shot, 120)
    got = run_shot(_bridge(jmod), shot.src, shot.rec_array(), nt=120).numpy()
    assert got.shape == want.shape == (120, 8)
    peak = np.abs(want).max()
    assert peak > 1.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * peak)


def test_bridge_round_trips_jax_model():
    jmod = jm.SeismicModel(
        velocity=jnp.asarray(np.random.default_rng(0).uniform(1500, 3000, (6, 7, 8)),
                             jnp.float32),
        dx=7.5, dt=4e-4, f_peak=15.0, sponge=3, sponge_decay=0.02,
    )
    tmod = _bridge(jmod)
    assert tmod.velocity.device.type == "cpu"
    np.testing.assert_array_equal(tmod.velocity.numpy(), np.asarray(jmod.velocity))
    for f in ("dx", "dt", "f_peak", "sponge", "sponge_decay"):
        assert getattr(tmod, f) == getattr(jmod, f)
    back = jm.SeismicModel(jnp.asarray(tmod.velocity.numpy()), tmod.dx, tmod.dt,
                           tmod.f_peak, tmod.sponge, tmod.sponge_decay)
    np.testing.assert_array_equal(np.asarray(back.velocity), np.asarray(jmod.velocity))
    assert back.cfl_ok() == jmod.cfl_ok() == tmod.cfl_ok()


def test_bridge_copies_read_only_velocity():
    vel = np.broadcast_to(np.float32(1500.0), (4, 4, 4))  # read-only, as in make_demo_model
    m = seismic_model_from_numpy(vel, 10.0, 1e-3, 12.0, 2, 0.01, device="cpu")
    m.velocity.mul_(2.0)  # owns its memory
    assert float(vel.max()) == 1500.0


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: a CUDA request is served")
    with pytest.raises(RuntimeError, match="cuda"):
        make_demo_model(n=8)  # default device is cuda; no CPU fallback
    with pytest.raises(RuntimeError, match="cuda"):
        ricker(12.0, 1e-3, 8, device="cuda")


# ---- physics checks of tests/test_seismic.py, on the torch side ----------

def test_ricker_wavelet_properties():
    w = ricker(10.0, 1e-3, 400, device="cpu").numpy()
    assert w.max() == pytest.approx(1.0, abs=1e-3)  # unit peak at t=1/f
    assert abs(w[0]) < 1e-2 and abs(w[-1]) < 1e-2  # compact support


def test_demo_model_cfl():
    assert make_demo_model(n=24, device="cpu").cfl_ok()


def test_shot_produces_signal_and_stays_finite():
    m = make_demo_model(n=24, device="cpu")
    shots = make_shot_grid(m, 1)
    s = run_shot(m, shots[0].src, shots[0].rec_array(), nt=120).numpy()
    assert s.shape == (120, 8)
    assert np.isfinite(s).all()
    assert np.abs(s).max() > 1e-8  # the wave reached the receivers
    # energy arrives later at farther receivers (finite propagation speed)
    src_x = shots[0].src[2]
    rec_x = shots[0].rec_array()[:, 2]
    arrival = np.argmax(np.abs(s) > 1e-4 * np.abs(s).max(), axis=0)
    near = arrival[np.argmin(np.abs(rec_x - src_x))]
    far = arrival[np.argmax(np.abs(rec_x - src_x))]
    assert near <= far


def test_sponge_damps_boundary_energy():
    m = make_demo_model(n=24, device="cpu")
    shots = make_shot_grid(m, 1)
    s = run_shot(m, shots[0].src, shots[0].rec_array(), nt=400).numpy()
    # late-time energy must not exceed the first-arrival energy (no
    # reflection blow-up from the absorbing boundaries)
    assert np.abs(s[350:]).max() < np.abs(s[:200]).max()


# Scripts that hold the port against the reference, as the parity tests
# do, and so import both packages; they are not part of the port.
MEETS_REFERENCE = {"scripts/bf16_gap_torch.py"}


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*ROOT.glob("src/repro_torch/**/*.py"),
                                       ROOT / "chip_smoke.py",
                                       *ROOT.glob("examples/*_torch.py"),
                                       *ROOT.glob("scripts/*_torch.py")]
    if str(p.relative_to(ROOT)) not in MEETS_REFERENCE
))
def test_port_source_imports_no_jax_nor_reference(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), (path, name)


def test_port_runs_with_jax_and_reference_blocked():
    """The port imports neither ``jax`` nor anything of ``repro``: with both
    blocked in ``sys.modules`` it imports, runs one CPU shot, serves a SMOKE
    model (one greedy generation and a 2-replica CPU ServePool), the MoE
    SMOKE models (moonshot, deepseek with MLA) and the recurrent ones
    (mamba2, recurrentgemma), prefills and decodes the enc-dec and VLM
    SMOKE models (seamless, qwen2-vl), runs the device scheduler at
    P=8 on the CPU, in one process and on a one-rank ``gloo`` mesh, and one
    simulation, and trains a SMOKE model: one
    ``make_train_step`` step and one ``HetDPTrainer`` step over 2 workers."""
    code = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import numpy as np
        import torch
        import repro_torch, repro_torch.core, repro_torch.kernels.fd3d
        import repro_torch.configs, repro_torch.models, repro_torch.serve
        from repro_torch.launch.serve import generate, make_replica_generate
        from repro_torch.models import lm
        from repro_torch.serve import Replica, ServePool
        from repro_torch.seismic import make_demo_model, make_shot_grid, run_shot
        from repro_torch.seismic.tasks import make_shot_task
        m = make_demo_model(n=12, device="cpu")
        shot = make_shot_grid(m, 1)[0]
        s = run_shot(m, shot.src, shot.rec_array(), nt=10)
        assert s.shape == (10, 8) and bool(s.isfinite().all())
        cfg = repro_torch.configs.get_smoke("minitron-4b")
        params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
        out = generate(cfg, params, torch.zeros((1, 4), dtype=torch.long), 3)
        assert out.shape == (1, 3)
        pool = ServePool([Replica(f"r{i}", make_replica_generate(cfg, params, 2))
                          for i in range(2)])
        futs = pool.submit_wave([{"tokens": np.arange(4) + k} for k in range(4)])
        assert all(len(f.result(timeout=60)["completion"]) == 2 for f in futs)
        assert sum(pool.shutdown().per_worker_tasks) == 4
        for arch in ("moonshot-v1-16b-a3b", "deepseek-v3-671b", "mamba2-2.7b",
                     "recurrentgemma-2b"):
            cfg = repro_torch.configs.get_smoke(arch)
            params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
            out = generate(cfg, params, torch.zeros((2, 4), dtype=torch.long), 2)
            assert out.shape == (2, 2)
        for arch, batch in (
                ("seamless-m4t-medium", {"tokens": torch.zeros((2, 4), dtype=torch.long),
                                         "enc_embeds": torch.ones((2, 6, 64))}),
                ("qwen2-vl-2b", {"embeds": torch.ones((2, 4, 64)),
                                 "positions": torch.zeros((3, 2, 4), dtype=torch.long)})):
            cfg = repro_torch.configs.get_smoke(arch)
            params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
            logits, caches = lm.prefill(params, batch, cfg)
            caches = lm.pad_caches(caches, cfg, 6)
            for i in (4, 5):
                logits, caches = lm.decode_step(params, logits[:, -1].argmax(-1)[:, None],
                                                caches, i, cfg)
            assert logits.shape == (2, 1, cfg.vocab_padded) and bool(logits.isfinite().all())
        from repro_torch.core import simulator, device_sched
        state, rounds, makespan = device_sched.virtual_run(
            8, [24, 16, 8, 8, 4, 2, 1, 1], 192, 2, device="cpu")
        assert int(state.executed.sum()) == 192 and 0 < rounds < 4096
        import torch.distributed as dist
        from repro_torch.launch.mesh import make_workers_mesh
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
        ranked = device_sched.virtual_run(8, [24, 16, 8, 8, 4, 2, 1, 1], 192, 2, device="cpu",
                                          mesh=make_workers_mesh(1))
        dist.destroy_process_group()
        assert ranked[1:] == (rounds, makespan)
        assert all(torch.equal(getattr(ranked[0], k), getattr(state, k))
                   for k in ("queue", "head", "tail", "executed"))
        res = simulator.simulate("a2ws", simulator.SimConfig(
            speeds=simulator.table2_speeds("C1"), num_tasks=48))
        assert sum(res.per_node_tasks) == 48
        import repro_torch.checkpoint, repro_torch.data, repro_torch.runtime
        from repro_torch.optim.adamw import AdamWConfig, adamw_init
        from repro_torch.runtime import HetDPTrainer, WorkerSpec
        from repro_torch.train.step import make_train_step
        cfg = repro_torch.configs.get_smoke("phi4-mini-3.8b")
        params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
        toks = torch.randint(0, cfg.vocab, (2, 9), generator=torch.Generator().manual_seed(1))
        mb = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        opt = AdamWConfig(lr=1e-3)
        _, _, m = make_train_step(cfg, opt)(params, adamw_init(params, opt), mb)
        assert bool(m["loss"].isfinite()) and float(m["grad_norm"]) > 0
        tr = HetDPTrainer(lambda p, b: lm.loss_fn(p, b, cfg), params,
                          [WorkerSpec("a"), WorkerSpec("b")], opt)
        assert sum(tr.step([mb, mb])["tasks_per_worker"]) == 2
        bad = [k for k, v in sys.modules.items() if v is not None
               and (k in ("jax", "repro") or k.startswith(("jax.", "repro.")))]
        assert not bad, bad
        print("ok")
        """
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
