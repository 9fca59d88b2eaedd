"""The port's A2WS-scheduled heterogeneous data parallelism
(``repro_torch.runtime``): the reference's six trainer tests
(``tests/test_het_dp.py``) on a torch toy, the combined gradient against the
full-batch one, and the port's trainer against the reference's on a SMOKE
model over the same microbatches.

Parameters cross from JAX through ``repro_torch.models.bridge`` in the
reference's checkpoint format; microbatches are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.checkpoint.store import _flatten
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.models import lm as jlm
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.runtime.het_dp import HetDPTrainer as JHetDPTrainer
from repro.runtime.het_dp import WorkerSpec as JWorkerSpec
import repro_torch.configs as tconfigs
from repro_torch.autodiff import tree_map, value_and_grad
from repro_torch.models import lm as tlm
from repro_torch.models.bridge import flatten, params_from_flat
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import ResilientDriver
from repro_torch.runtime.het_dp import HetDPTrainer, WorkerSpec

torch.set_num_threads(1)

W_TRUE = np.asarray([1.0, -2.0, 0.5], np.float32)


def _toy():
    """Tiny least-squares problem; loss_fn(params, batch) -> (loss, aux)."""

    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"]
        err = pred - batch["y"]
        return torch.mean(err**2), {"n": err.shape[0]}

    def make_microbatches(step, t=8, n=4):
        rng = np.random.default_rng(step)
        out = []
        for _ in range(t):
            x = rng.normal(size=(n, 3)).astype(np.float32)
            out.append({"x": torch.from_numpy(x), "y": torch.from_numpy(x @ W_TRUE)})
        return out

    return loss_fn, {"w": torch.zeros(3)}, make_microbatches


def _full_batch_grad(loss_fn, params, mbs):
    grad = value_and_grad(loss_fn)
    g_total = None
    for mb in mbs:
        _, g = grad(params, mb)
        g_total = g if g_total is None else tree_map(torch.add, g_total, g)
    return tree_map(lambda x: x / len(mbs), g_total)


# ------------------------------------------------- the reference's six tests
def test_gradient_exact_regardless_of_stealing():
    """The combined A2WS gradient == the single-worker full-batch gradient,
    no matter who computed which microbatch; so are the updates."""
    loss_fn, params, make_mbs = _toy()
    mbs = make_mbs(0)
    want = _full_batch_grad(loss_fn, params, mbs)

    ref = HetDPTrainer(loss_fn, params, [WorkerSpec("solo")],
                       AdamWConfig(lr=0.1, weight_decay=0.0))
    het = HetDPTrainer(
        loss_fn, {"w": torch.zeros(3)},
        [WorkerSpec("fast"), WorkerSpec("slow", slow_factor=6.0)],
        AdamWConfig(lr=0.1, weight_decay=0.0), base_task_time=0.003,
    )
    got, m = het.gradient(mbs)
    np.testing.assert_allclose(got["w"].numpy(), want["w"].numpy(), rtol=1e-6, atol=1e-6)
    assert sum(m["tasks_per_worker"]) == 8
    ref.step(mbs)
    het.step(make_mbs(0))
    np.testing.assert_allclose(ref.params["w"].numpy(), het.params["w"].numpy(), atol=1e-5)


def test_straggler_mitigation_fast_does_more():
    loss_fn, params, make_mbs = _toy()
    tr = HetDPTrainer(
        loss_fn, params,
        [WorkerSpec("fast"), WorkerSpec("slow", slow_factor=8.0)],
        base_task_time=0.004,
    )
    m = tr.step(make_mbs(0, t=12))
    assert sum(m["tasks_per_worker"]) == 12
    assert m["tasks_per_worker"][0] > m["tasks_per_worker"][1]


def test_worker_failure_step_still_completes():
    loss_fn, params, make_mbs = _toy()
    tr = HetDPTrainer(
        loss_fn, params,
        [WorkerSpec("ok"), WorkerSpec("dies", fail_at_step=0)],
    )
    m = tr.step(make_mbs(0))
    assert m["failed_workers"] == [1]
    assert sum(m["tasks_per_worker"]) == 8  # survivors finished everything


def test_elastic_add_remove():
    loss_fn, params, make_mbs = _toy()
    tr = HetDPTrainer(loss_fn, params, [WorkerSpec("a"), WorkerSpec("b")])
    tr.step(make_mbs(0))
    tr.remove_worker(1)
    m = tr.step(make_mbs(1))
    assert len(m["tasks_per_worker"]) == 1
    tr.add_worker(WorkerSpec("c"))
    m = tr.step(make_mbs(2))
    assert len(m["tasks_per_worker"]) == 2
    assert sum(m["tasks_per_worker"]) == 8


def test_compression_path_still_converges():
    """int8+EF compression adds quantisation noise but must keep converging
    (error feedback prevents bias accumulation)."""
    loss_fn, params, make_mbs = _toy()
    tr = HetDPTrainer(
        loss_fn, params, [WorkerSpec("a"), WorkerSpec("b")],
        AdamWConfig(lr=0.05, weight_decay=0.0), compress=True,
    )
    first = None
    for step in range(60):
        m = tr.step(make_mbs(step))
        if first is None:
            first = m["loss"]
    assert m["loss"] < min(1.0, first / 4), (first, m["loss"])


def test_resilient_driver_restart(tmp_path):
    loss_fn, params, make_mbs = _toy()
    tr = HetDPTrainer(
        loss_fn, params,
        [WorkerSpec("a"), WorkerSpec("dies", fail_at_step=3)],
        AdamWConfig(lr=0.05, weight_decay=0.0),
    )
    drv = ResilientDriver(tr, make_mbs, str(tmp_path), ckpt_every=2)
    report = drv.run(8)
    assert report.steps_run == 8
    assert "dies" in report.removed_workers
    assert len(tr.workers) == 1
    assert np.isfinite(report.final_loss)
    # a new trainer on the same directory resumes from the last checkpoint
    fresh = HetDPTrainer(loss_fn, {"w": torch.zeros(3)}, [WorkerSpec("b")],
                         AdamWConfig(lr=0.05, weight_decay=0.0))
    again = ResilientDriver(fresh, make_mbs, str(tmp_path), ckpt_every=2)
    assert again._maybe_restore() == 8
    assert torch.equal(fresh.params["w"], tr.params["w"])
    assert int(fresh.opt_state["count"]) == 8
    assert again.run(10).steps_run == 2


def test_all_workers_failing_raises():
    loss_fn, params, make_mbs = _toy()
    tr = HetDPTrainer(loss_fn, params, [WorkerSpec("dies", fail_at_step=0)])
    with pytest.raises(Exception) as err:
        tr.step(make_mbs(0))
    assert "worker 0 failed" in str(err.value)


def test_bf16_mean_is_taken_in_f32_as_the_reference_takes_it():
    """bf16 parameters: the workers' bf16 sums are divided into an f32 mean,
    as the reference's host combine divides a bf16 numpy array by an int."""
    import ml_dtypes

    cs = [[1.0, 2.0, 5.0], [2.0, 7.0, 1.0], [4.0, -3.0, 2.0]]
    mbs = [{"c": torch.tensor(c)} for c in cs]

    def loss_fn(p, b):
        return (p["w"].float() * b["c"]).sum(), {}

    tr = HetDPTrainer(loss_fn, {"w": torch.ones(3, dtype=torch.bfloat16)},
                      [WorkerSpec("a"), WorkerSpec("b")])
    got, _ = tr.gradient(mbs)
    want = np.asarray(np.sum(cs, axis=0), ml_dtypes.bfloat16) / len(cs)
    assert want.dtype == np.float32 and got["w"].dtype == torch.float32
    assert np.array_equal(got["w"].numpy(), want)
    assert not np.array_equal(want, want.astype(ml_dtypes.bfloat16).astype(np.float32))


# ------------------------------------------------------ against the reference
def _smoke_trainers(arch, workers, base_task_time):
    jcfg = jconfigs.get_smoke(arch).with_(dtype="float32")
    tcfg = tconfigs.get_smoke(arch).with_(dtype="float32")
    jp, _ = jlm.init(jcfg, jax.random.key(0))
    jp = jax.tree.map(lambda x: x.astype(jnp.float32), jp)
    tp = params_from_flat(_flatten(jp), device="cpu", dtype=torch.float32)
    opt = dict(lr=1e-3, weight_decay=0.1)
    jtr = JHetDPTrainer(lambda p, b: jlm.loss_fn(p, b, jcfg), jp,
                        [JWorkerSpec(*w) for w in workers], JAdamWConfig(**opt),
                        base_task_time=base_task_time)
    ttr = HetDPTrainer(lambda p, b: tlm.loss_fn(p, b, tcfg), tp,
                       [WorkerSpec(*w) for w in workers], AdamWConfig(**opt),
                       base_task_time=base_task_time)
    return jcfg, jtr, ttr


def test_trainer_matches_reference():
    """Three optimizer steps of 6 microbatches each, a fast and a 4x slow
    worker in both packages: parameters, moments and losses within 1e-5 in
    f32, whichever worker ran which microbatch in either."""
    workers = [("fast", 1.0), ("slow", 4.0)]
    jcfg, jtr, ttr = _smoke_trainers("phi4-mini-3.8b", workers, base_task_time=0.002)
    data = SyntheticLM(DataConfig(vocab=jcfg.vocab, seq_len=16, global_batch=12, seed=0))
    for step in range(3):
        b = data.batch_at(step)
        mbs = [{k: v[i::6] for k, v in b.items()} for i in range(6)]
        jm = jtr.step([{k: jnp.asarray(v) for k, v in mb.items()} for mb in mbs])
        tm = ttr.step([{k: torch.from_numpy(v.copy()) for k, v in mb.items()} for mb in mbs])
        assert sum(tm["tasks_per_worker"]) == 6
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], rtol=1e-5, atol=1e-5)
    for got, want in ((ttr.params, jtr.params), (ttr.opt_state["m"], jtr.opt_state["m"]),
                      (ttr.opt_state["v"], jtr.opt_state["v"])):
        g, w = flatten(got), _flatten(want)
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k].numpy(), w[k], rtol=1e-5, atol=1e-5, err_msg=k)
    assert int(ttr.opt_state["count"]) == int(jtr.opt_state["count"]) == 3

