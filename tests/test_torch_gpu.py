"""The port on the card: its CUDA kernel against its plain PyTorch version,
the serving path's SMOKE models (dense, MoE, MLA, Mamba-2, RG-LRU with local
attention, enc-dec, VLM) against the same models on the CPU, a SMOKE
training step and a HetDPTrainer gradient on the card against the CPU's,
the device scheduler's run on the card against its run on the CPU, and the
sharded step makers and the multi-rank scheduler on a one-rank ``nccl`` mesh
against the unsharded and one-process ones.

Every test here carries the ``gpu`` marker and skips, with a reason, where
``torch.cuda.is_available()`` is false; the decision is taken inside the
``cuda`` fixture, never at import.  This file imports no JAX, so it also runs
where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import dataclasses
import os
import subprocess
from collections import deque
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.autodiff import tree_leaves, tree_map, value_and_grad
from repro_torch.configs import get_smoke
from repro_torch.core import A2WSRuntime
from repro_torch.core.device_sched import virtual_run
from repro_torch.launch.serve import make_replica_generate
from repro_torch.models import lm
from repro_torch.models import moe as moe_mod
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.runtime.het_dp import HetDPTrainer, WorkerSpec
from repro_torch.train.step import make_train_step
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "deepseek-v3-671b"])
def test_moe_smoke_model_on_card_matches_cpu(cuda, arch, dtype, monkeypatch):
    """The MoE SMOKE models (deepseek's with MLA), the same weights on the
    card and on the CPU, capacity raised so that no token drops: forward,
    prefill and the decode steps continuing it.  f32 within 1e-4.  bf16
    within 0.02 (``tests/test_torch_models.py``'s BF16_TOL), with the CPU's
    routing replayed on the card: a bf16 ulp apart, a router near-tie may
    pick another expert, which is not rounding."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke(arch).with_(dtype=str(dtype).removeprefix("torch."))
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    cpu = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=dtype)
    card = _to(cpu, cuda)
    assert card["groups"][-1]["b0"]["moe"]["router"].dtype == torch.float32
    route, decisions = moe_mod.route, deque()

    def pinned(router_w, x, m):
        top_i, top_w, probs = route(router_w, x, m)
        if dtype == torch.float32:
            return top_i, top_w, probs
        if x.is_cuda:
            top_i, top_w = (t.to(x.device) for t in decisions.popleft())
        else:
            decisions.append((top_i, top_w))
        return top_i, top_w, probs

    monkeypatch.setattr(moe_mod, "route", pinned)
    tol = 1e-4 if dtype == torch.float32 else 0.02

    def close(got, want):
        torch.testing.assert_close(got.cpu(), want, atol=tol, rtol=tol)

    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 12)))
    want, want_aux = lm.forward(cpu, {"tokens": toks}, cfg)
    got, got_aux = lm.forward(card, {"tokens": toks.to(cuda)}, cfg)
    close(got, want)
    assert float(got_aux) == pytest.approx(float(want_aux), rel=1e-3)
    wl, wc = lm.prefill(cpu, {"tokens": toks[:, :8]}, cfg)
    gl, gc = lm.prefill(card, {"tokens": toks[:, :8].to(cuda)}, cfg)
    close(gl, wl)
    wc, gc = lm.pad_caches(wc, cfg, 12), lm.pad_caches(gc, cfg, 12)
    for i in range(8, 12):
        wl, wc = lm.decode_step(cpu, toks[:, i : i + 1], wc, i, cfg)
        gl, gc = lm.decode_step(card, toks[:, i : i + 1].to(cuda), gc, i, cfg)
        close(gl, wl)
    assert not decisions


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-2b"])
def test_recurrent_smoke_model_on_card_matches_cpu(cuda, arch, dtype):
    """The recurrent SMOKE models, the same weights on the card and on the
    CPU: forward over 48 tokens (whole SSM chunks), prefill (past
    recurrentgemma's window of 32, so its ring wraps) and the decode steps
    continuing it.  f32 within 1e-4; bf16 within 0.02
    (``tests/test_torch_models.py``'s BF16_TOL)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke(arch).with_(dtype=str(dtype).removeprefix("torch."))
    cpu = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=dtype)
    card = _to(cpu, cuda)
    tol = 1e-4 if dtype == torch.float32 else 0.02

    def close(got, want):
        torch.testing.assert_close(got.cpu(), want, atol=tol, rtol=tol)

    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 48)))
    want, _ = lm.forward(cpu, {"tokens": toks}, cfg)
    got, _ = lm.forward(card, {"tokens": toks.to(cuda)}, cfg)
    close(got, want)
    s0 = 32 if cfg.ssm is not None else 36
    wl, wc = lm.prefill(cpu, {"tokens": toks[:, :s0]}, cfg)
    gl, gc = lm.prefill(card, {"tokens": toks[:, :s0].to(cuda)}, cfg)
    close(gl, wl)
    wc, gc = lm.pad_caches(wc, cfg, s0 + 4), lm.pad_caches(gc, cfg, s0 + 4)
    for i in range(s0, s0 + 4):
        wl, wc = lm.decode_step(cpu, toks[:, i : i + 1], wc, i, cfg)
        gl, gc = lm.decode_step(card, toks[:, i : i + 1].to(cuda), gc, i, cfg)
        close(gl, wl)


def _frontend_batch(cfg, params, s, seed=0):
    """A SMOKE batch of ``s`` positions: seamless's decoder tokens and 24
    encoder frames (std 0.2), or qwen2-vl's embeds (16 patches on a 4x4
    grid at (0, i, j), then text embedding rows at t = h = w = 4 + k) and
    their [3, B, s] positions; with the continuation's tokens."""
    r = np.random.default_rng(seed)
    toks = torch.from_numpy(r.integers(0, cfg.vocab, (2, s)))
    if cfg.enc_layers:
        enc = torch.from_numpy((r.standard_normal((2, 24, cfg.d_model)) * 0.2).astype(np.float32))
        return {"tokens": toks, "enc_embeds": enc}, toks
    patches = torch.from_numpy(r.standard_normal((2, 16, cfg.d_model)).astype(np.float32))
    emb = torch.cat([patches.to(params["embed"].dtype), params["embed"][toks[:, 16:]]], 1)
    i, j = np.divmod(np.arange(16), 4)
    grid = np.stack([np.zeros(16, int), i, j])
    pos = np.concatenate([grid, np.broadcast_to(4 + np.arange(s - 16), (3, s - 16))], 1)
    return ({"embeds": emb, "positions": torch.from_numpy(np.broadcast_to(pos[:, None], (3, 2, s))
                                                          .copy())}, toks)


def _prefix(batch, n):
    """The first ``n`` decoder positions of a batch (the encoder frames whole)."""
    out = dict(batch)
    for k in ("tokens", "embeds"):
        if k in out:
            out[k] = out[k][:, :n]
    if "positions" in out:
        out["positions"] = out["positions"][..., :n]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "qwen2-vl-2b"])
def test_frontend_smoke_model_on_card_matches_cpu(cuda, arch, dtype):
    """The enc-dec and VLM SMOKE models, the same weights on the card and on
    the CPU: forward, prefill of 20 positions (seamless against 24 encoder
    frames; qwen2-vl's image and text embeds on grid positions) and 4
    decode steps continuing it; the memory K/V unchanged by decode.  f32
    within 1e-4; bf16 within 0.02 (``tests/test_torch_models.py``'s
    BF16_TOL)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke(arch).with_(dtype=str(dtype).removeprefix("torch."))
    cpu = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=dtype)
    card = _to(cpu, cuda)
    tol = 1e-4 if dtype == torch.float32 else 0.02

    def close(got, want):
        torch.testing.assert_close(got.cpu(), want, atol=tol, rtol=tol)

    batch, toks = _frontend_batch(cfg, cpu, 24)
    want, _ = lm.forward(cpu, batch, cfg)
    got, _ = lm.forward(card, _to(batch, cuda), cfg)
    close(got, want)
    wl, wc = lm.prefill(cpu, _prefix(batch, 20), cfg)
    gl, gc = lm.prefill(card, _to(_prefix(batch, 20), cuda), cfg)
    close(gl, wl)
    memory = [t.clone() for t in gc[0][0][1]] if cfg.enc_layers else []
    wc, gc = lm.pad_caches(wc, cfg, 24), lm.pad_caches(gc, cfg, 24)
    for i in range(20, 24):
        wl, wc = lm.decode_step(cpu, toks[:, i : i + 1], wc, i, cfg)
        gl, gc = lm.decode_step(card, toks[:, i : i + 1].to(cuda), gc, i, cfg)
        close(gl, wl)
    assert all(torch.equal(a, b) for a, b in zip(gc[0][0][1] if memory else [], memory))


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-2b"])
def test_recurrent_servepool_on_card_repeats(cuda, arch):
    """Two replicas of a recurrent SMOKE model in bf16 on their own
    streams: every pooled completion equals the request generated alone."""
    cfg = get_smoke(arch)
    params = lm.init(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    torch.cuda.synchronize()
    alone = make_replica_generate(cfg, params, 4)
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (6, 9))
    want = [alone({"tokens": p})["completion"] for p in prompts]
    pool = ServePool([Replica(f"r{i}", make_replica_generate(cfg, params, 4),
                              slow_factor=1.0 + 3 * i) for i in range(2)])
    futs = pool.submit_wave([{"tokens": p} for p in prompts])
    assert [f.result(timeout=120)["completion"] for f in futs] == want
    assert sum(pool.shutdown().per_worker_tasks) == 6


def test_moe_servepool_on_card_repeats(cuda):
    """Two replicas of moonshot SMOKE in bf16 on their own streams, at the
    published capacity factor (tokens drop): every pooled completion equals
    the request generated alone, so the MoE combine gives the same bits on
    every stream."""
    cfg = get_smoke("moonshot-v1-16b-a3b")
    params = lm.init(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    torch.cuda.synchronize()
    alone = make_replica_generate(cfg, params, 4)
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (6, 9))
    want = [alone({"tokens": p})["completion"] for p in prompts]
    pool = ServePool([Replica(f"r{i}", make_replica_generate(cfg, params, 4),
                              slow_factor=1.0 + 3 * i) for i in range(2)])
    futs = pool.submit_wave([{"tokens": p} for p in prompts])
    assert [f.result(timeout=120)["completion"] for f in futs] == want
    assert sum(pool.shutdown().per_worker_tasks) == 6


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


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "baseline"])
def test_device_sched_on_one_nccl_rank_matches_one_process(one_rank_mesh, packed):
    """P=64, R=12 on a 1-D ("workers",) mesh of the one-rank ``nccl`` group
    (the all-reduces and all-to-alls cross NCCL; the ring wraps inside the
    block) against the one-process card run on the same CPU generator's
    draws: every field, the round count and the makespan equal."""
    from repro_torch.launch.mesh import make_workers_mesh

    speeds = [s for s in (24.0, 16.0, 4.0, 1.0) for _ in range(16)]
    runs = [virtual_run(64, speeds, 64 * 30, 12, max_steal=16, device="cuda", packed=packed,
                        generator=torch.Generator().manual_seed(0), mesh=mesh)
            for mesh in (None, make_workers_mesh(1))]
    (want, want_rounds, want_ms), (got, got_rounds, got_ms) = runs
    assert got_rounds == want_rounds and got_ms == want_ms
    for name in got._fields:
        a, b = getattr(got, name), getattr(want, name)
        same = (a == b) | (a.isnan() & b.isnan()) if a.is_floating_point() else a == b
        assert a.shape == b.shape and bool(same.all()), name
    assert int(got.executed.sum()) == 64 * 30


def _rel_l2(got, want) -> float:
    """Relative L2 distance between two gradient trees (leaves in f32)."""
    num = sum(float(((g.float().cpu() - w.float().cpu()) ** 2).sum())
              for g, w in zip(tree_leaves(got), tree_leaves(want)))
    den = sum(float((w.float().cpu() ** 2).sum()) for w in tree_leaves(want))
    return (num / den) ** 0.5


def _train_batch(cfg, b=2, s=12, seed=0):
    toks = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab, (b, s + 1)))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def test_train_step_on_card_matches_cpu(cuda):
    """phi4 SMOKE in f32 under full remat, the same weights on the card and
    on the CPU: the loss and every gradient leaf within 1e-4, and the
    parameters after one make_train_step within 1e-5 (f32 products in full
    f32 on both; only the summation order differs)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke("phi4-mini-3.8b").with_(dtype="float32", remat="full")
    cpu = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    card = _to(cpu, cuda)
    batch = _train_batch(cfg)
    grad = value_and_grad(lambda p, b: lm.loss_fn(p, b, cfg))
    (wl, _), wg = grad(cpu, batch)
    (gl, _), gg = grad(card, _to(batch, cuda))
    torch.testing.assert_close(gl.cpu(), wl, atol=1e-4, rtol=1e-4)
    for g, w in zip(tree_leaves(gg), tree_leaves(wg)):
        torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=1e-4)
    opt = AdamWConfig(lr=1e-3)
    step = make_train_step(cfg, opt)  # updates in place: give each step a copy
    cpu, card = tree_map(torch.clone, cpu), tree_map(torch.clone, card)
    wp, _, wm = step(cpu, adamw_init(cpu, opt), batch)
    gp, _, gm = step(card, adamw_init(card, opt), _to(batch, cuda))
    torch.testing.assert_close(gm["grad_norm"].cpu(), wm["grad_norm"], atol=1e-4, rtol=1e-4)
    for g, w in zip(tree_leaves(gp), tree_leaves(wp)):
        torch.testing.assert_close(g.cpu(), w, atol=1e-5, rtol=1e-5)


def test_het_dp_on_card_streams_matches_cpu(cuda):
    """HetDPTrainer on the card, 3 workers (one 4x slow) each on its own
    stream: the combined gradient of 6 microbatches equals the mean of the
    CPU's per-microbatch gradients within a relative L2 of 1e-5, and a step
    runs every microbatch once."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke("phi4-mini-3.8b").with_(dtype="float32", remat="full")
    cpu = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    mbs = [_train_batch(cfg, seed=i) for i in range(6)]
    loss = lambda p, b: lm.loss_fn(p, b, cfg)  # noqa: E731
    grad = value_and_grad(loss)
    want = tree_map(lambda *gs: sum(gs[1:], gs[0]) / 6, *[grad(cpu, mb)[1] for mb in mbs])
    tr = HetDPTrainer(loss, _to(cpu, cuda),
                      [WorkerSpec("a"), WorkerSpec("b"), WorkerSpec("slow", slow_factor=4.0)],
                      base_task_time=0.01)
    got, m = tr.gradient([_to(mb, cuda) for mb in mbs])
    assert sum(m["tasks_per_worker"]) == 6
    assert _rel_l2(got, want) <= 1e-5
    out = tr.step([_to(mb, cuda) for mb in mbs])
    assert sum(out["tasks_per_worker"]) == 6 and out["grad_norm"] > 0


# ------------------------------------------------------------ sharded steps
@pytest.fixture
def one_rank_mesh(cuda):
    """A (1, 1) ("data", "model") mesh over a one-rank ``nccl`` group of its
    own store, torn down after the test."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    torch.cuda.set_device(0)  # the rank's card, before NCCL starts
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_debug_mesh(1, 1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "deepseek-v3-671b"])
def test_sharded_steps_on_card_match_unsharded(one_rank_mesh, arch):
    """Phases 19-20 at SMOKE size: ``jit_prefill_step`` then
    ``jit_decode_step`` (serving layout; deepseek's experts full-EP under
    ``local_map``) on a one-rank ``nccl`` mesh, the parameters wrapped as
    DTensors without a copy, against the unsharded steps on the card: the
    same logits, bit for bit."""
    from repro_torch.models.bridge import flatten
    from repro_torch.parallel import sharding as sh
    from repro_torch.serve import engine

    dev = torch.device("cuda")
    cfg = get_smoke(arch)
    if cfg.moe is not None:
        cfg = cfg.with_(mtp=False, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    ctx = sh.serve_context(one_rank_mesh, cfg.moe.num_experts if cfg.moe else 0)
    dparams = sh.distribute_tree(params, engine._param_shardings(cfg, ctx))
    plain, wrapped = flatten(params), flatten(dparams)
    assert all(wrapped[k].to_local().data_ptr() == t.data_ptr() for k, t in plain.items())
    toks = torch.randint(0, cfg.vocab, (2, 20), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    prompt = {"tokens": toks[:, :16]}
    wl, wc = lm.prefill(params, prompt, cfg)
    gl, gc = engine.jit_prefill_step(cfg, ctx, prompt)(dparams, prompt)
    assert torch.equal(gl.full_tensor(), wl)
    wc, gc = lm.pad_caches(wc, cfg, 20), lm.pad_caches(gc, cfg, 20)
    decode = engine.jit_decode_step(cfg, ctx, 2, 20)
    for i in range(16, 20):
        wl, wc = lm.decode_step(params, toks[:, i:i + 1], wc, i, cfg)
        gl, gc = decode(dparams, toks[:, i:i + 1], gc, i)
        assert torch.equal(gl.full_tensor(), wl), i
