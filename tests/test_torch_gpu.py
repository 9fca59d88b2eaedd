"""The port on the card: its CUDA kernel against its plain PyTorch version,
the serving path's SMOKE model against the same model on the CPU, and the
device scheduler's run on the card against its run on the CPU.

Every test here carries the ``gpu`` marker and skips, with a reason, where
``torch.cuda.is_available()`` is false; the decision is taken inside the
``cuda`` fixture, never at import.  This file imports no JAX, so it also runs
where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.core import A2WSRuntime
from repro_torch.core.device_sched import virtual_run
from repro_torch.launch.serve import make_replica_generate
from repro_torch.models import lm
from repro_torch.serve import Replica, ServePool
from repro_torch.kernels.fd3d import fd3d as tkernel
from repro_torch.kernels.fd3d import fd3d_step, ref
from repro_torch.seismic import make_demo_model, make_shot_grid, run_shot
from repro_torch.seismic.tasks import make_shot_task

pytestmark = pytest.mark.gpu

SHAPES = [(8, 16, 16), (16, 24, 16), (32, 16, 32), (8, 8, 8),
          (13, 17, 29), (1, 9, 130), (1, 1, 1), (5, 1, 3), (40, 33, 65)]
TOL = {torch.float32: 2e-5, torch.bfloat16: 0.15}  # the reference's own


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _fields(shape, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    u = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    up = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    c2 = torch.full(shape, 0.1)
    return tuple(t.to(device=device, dtype=dtype) for t in (u, up, c2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain(cuda, shape, dtype):
    u, up, c2 = _fields(shape, dtype, cuda)
    before = tkernel.launches
    got = fd3d_step(u, up, c2, dx=10.0)
    torch.cuda.synchronize()
    assert tkernel.launches == before + 1
    assert got.dtype == dtype and got.shape == u.shape
    want = ref.fd3d_step(u, up, c2, 10.0)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_run_shot_kernel_matches_plain(cuda):
    m = make_demo_model(n=40, device=cuda)
    shot = make_shot_grid(m, 1)[0]
    before = tkernel.launches
    got = run_shot(m, shot.src, shot.rec_array(), nt=200)
    torch.cuda.synchronize()
    assert tkernel.launches == before + 200
    want = run_shot(m, shot.src, shot.rec_array(), nt=200, backend="ref")
    peak = want.abs().max().item()
    assert peak > 0
    assert (got - want).abs().max().item() <= 1e-4 * peak


def test_a2ws_on_streams_matches_cpu(cuda):
    m = make_demo_model(n=24, device=cuda)
    cpu = make_demo_model(n=24, device="cpu")
    shots = make_shot_grid(m, 6)
    results = {}
    rt = A2WSRuntime(shots, 3, make_shot_task(m, 60, 3, results), seed=0)
    stats = rt.run()
    assert not rt.errors
    assert sum(stats.per_worker_tasks) == 6
    for shot in shots:
        want = run_shot(cpu, shot.src, shot.rec_array(), nt=60).numpy()
        peak = np.abs(want).max()
        np.testing.assert_allclose(results[shot.src], want, rtol=1e-4, atol=1e-4 * peak)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device)


def test_smoke_model_on_card_matches_cpu(cuda):
    """phi4 SMOKE in f32, the same weights on the card and on the CPU:
    forward, prefill and the decode steps continuing it agree within 1e-4
    (f32 products in full f32 on both; only the summation order differs)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke("phi4-mini-3.8b").with_(dtype="float32")
    cpu = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    card = _to(cpu, cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 12)))
    want, _ = lm.forward(cpu, {"tokens": toks}, cfg)
    got, _ = lm.forward(card, {"tokens": toks.to(cuda)}, cfg)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    (wl, wc), (gl, gc) = (lm.prefill(p, {"tokens": t[:, :8]}, cfg)
                          for p, t in ((cpu, toks), (card, toks.to(cuda))))
    torch.testing.assert_close(gl.cpu(), wl, atol=1e-4, rtol=1e-4)
    wc, gc = lm.pad_caches(wc, cfg, 12), lm.pad_caches(gc, cfg, 12)
    for i in range(8, 12):
        wl, wc = lm.decode_step(cpu, toks[:, i : i + 1], wc, i, cfg)
        gl, gc = lm.decode_step(card, toks[:, i : i + 1].to(cuda), gc, i, cfg)
        torch.testing.assert_close(gl.cpu(), wl, atol=1e-4, rtol=1e-4)


def test_servepool_on_card_streams(cuda):
    """Two replicas on their own streams serve bf16 SMOKE requests; each
    completion equals the request generated alone on the card."""
    cfg = get_smoke("phi4-mini-3.8b")
    params = lm.init(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    torch.cuda.synchronize()
    alone = make_replica_generate(cfg, params, 4)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (8, 6))
    want = [alone({"tokens": p})["completion"] for p in prompts]
    pool = ServePool([Replica(f"r{i}", make_replica_generate(cfg, params, 4),
                              slow_factor=1.0 + 3 * i) for i in range(2)])
    futs = pool.submit_wave([{"tokens": p} for p in prompts])
    assert [f.result(timeout=120)["completion"] for f in futs] == want
    assert sum(pool.shutdown().per_worker_tasks) == 8


def test_serve_launcher_device_cpu_on_card_machine(cuda):
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "phi4-mini-3.8b",
         "--device", "cpu", "--requests", "2", "--prompt-len", "6", "--new-tokens", "3",
         "--open-arrival", "--rate", "40"],
        capture_output=True, text=True, timeout=300, cwd=root,
        env=dict(os.environ, PYTHONPATH=str(root / "src")),
    )
    assert proc.returncode == 0, proc.stderr
    assert "on cpu" in proc.stdout


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "baseline"])
def test_device_sched_on_card_matches_cpu(cuda, packed):
    """P=64, R=12: the same CPU generator's draws feed both runs, so every
    integer field, the round count and the makespan must be equal."""
    speeds = [s for s in (24.0, 16.0, 4.0, 1.0) for _ in range(16)]
    runs = [virtual_run(64, speeds, 64 * 30, 12, max_steal=16, device=dev, packed=packed,
                        generator=torch.Generator().manual_seed(0))
            for dev in ("cpu", cuda)]
    (want, want_rounds, want_ms), (got, got_rounds, got_ms) = runs
    assert got.queue.device.type == "cuda"
    assert got_rounds == want_rounds and got_ms == want_ms
    for name in ("queue", "head", "tail", "executed"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name
    assert int(got.executed.sum()) == 64 * 30
