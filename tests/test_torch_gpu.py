"""The port's CUDA kernel on the card, against its plain PyTorch version.

Every test here carries the ``gpu`` marker and skips, with a reason, where
``torch.cuda.is_available()`` is false; the decision is taken inside the
``cuda`` fixture, never at import.  This file imports no JAX, so it also runs
where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import A2WSRuntime
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
