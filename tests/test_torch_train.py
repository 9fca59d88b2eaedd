"""The port's training path against the JAX reference on the CPU:
``lm.loss_fn`` and its gradients for every SMOKE arch and every
rematerialisation, the streamed cross-entropy, AdamW and its schedule, the
train step, checkpoints crossing between the packages, the int8
compression, the copied modules, and the entry points.

Inputs are made with numpy from a seed; parameters come from
``repro.models.lm.init`` and cross through ``repro_torch.models.bridge`` in
the reference's checkpoint format, widened to f32.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.checkpoint import store as jstore
from repro.checkpoint.store import _flatten
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.runtime import compression as jcomp
from repro.train.step import make_train_step as jmake_train_step
import repro_torch.configs as tconfigs
from repro_torch.autodiff import tree_leaves, tree_map, value_and_grad
from repro_torch.checkpoint import store as tstore
from repro_torch.launch import train as tlaunch
from repro_torch.models import lm as tlm
from repro_torch.models.bridge import flatten, params_from_flat
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel import sharding as tsh
from repro_torch.runtime import compression as tcomp
from repro_torch.train import step as tstep

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-4  # loss and gradients, f32: CPU summation orders differ
B, S = 2, 16


def _f32(tree):
    return jax.tree.map(lambda x: x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x, tree)


def _models(arch, **overrides):
    """(reference cfg, port cfg, JAX params, port params), f32 SMOKE."""
    jcfg = jconfigs.get_smoke(arch).with_(dtype="float32", **overrides)
    tcfg = tconfigs.get_smoke(arch).with_(dtype="float32", **overrides)
    jp = _f32(jlm.init(jcfg, jax.random.key(0))[0])
    return jcfg, tcfg, jp, params_from_flat(_flatten(jp), device="cpu", dtype=torch.float32)


def _batch(cfg, seed=1):
    """A numpy training batch: tokens (or embeds with M-RoPE positions, or
    tokens and encoder frames), labels and a loss mask with zeros."""
    r = np.random.default_rng(seed)
    out = {"labels": r.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "loss_mask": (r.random((B, S)) > 0.25).astype(np.float32)}
    if cfg.frontend == "vision":
        out["embeds"] = (r.standard_normal((B, S, cfg.d_model)) * 0.2).astype(np.float32)
        t = np.arange(S)
        out["positions"] = np.ascontiguousarray(
            np.broadcast_to(np.stack([t, t // 4, t % 4])[:, None], (3, B, S))).astype(np.int32)
    else:
        out["tokens"] = r.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.enc_layers:
        out["enc_embeds"] = (r.standard_normal((B, 24, cfg.d_model)) * 0.2).astype(np.float32)
    return out


def _jax_value_and_grad(jcfg, jp, batch):
    fn = jax.jit(jax.value_and_grad(lambda p, b: jlm.loss_fn(p, b, jcfg), has_aux=True))
    return fn(jp, {k: jnp.asarray(v) for k, v in batch.items()})


def _port_value_and_grad(tcfg, tp, batch):
    fn = value_and_grad(lambda p, b: tlm.loss_fn(p, b, tcfg))
    return fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()})


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got.float() if torch.is_tensor(got) else got),
                               np.asarray(want, np.float32), atol=tol, rtol=tol, err_msg=what)


def _check_loss(arch, **overrides):
    jcfg, tcfg, jp, tp = _models(arch, **overrides)
    batch = _batch(jcfg)
    (jl, jm), jg = _jax_value_and_grad(jcfg, jp, batch)
    (tl, tm), tg = _port_value_and_grad(tcfg, tp, batch)
    _close(tl, jl, TOL, "loss")
    assert set(tm) == set(jm)
    for k in jm:
        _close(tm[k], jm[k], TOL, k)
    g, w = flatten(tg), _flatten(jg)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == torch.float32 and tuple(g[k].shape) == w[k].shape, k
        _close(g[k], w[k], TOL, k)
    return jm


# ------------------------------------------------------------------- loss_fn
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_loss_and_grads_match_reference(arch):
    """loss, ce, aux, ce_mtp, tokens and every gradient leaf within 1e-4."""
    jm = _check_loss(arch)
    if jconfigs.get_smoke(arch).mtp:
        assert "ce_mtp" in jm
    if jconfigs.get_smoke(arch).moe is not None:
        assert float(jm["aux"]) > 0


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "moonshot-v1-16b-a3b"])
def test_loss_and_grads_under_remat(arch, remat):
    _check_loss(arch, remat=remat)


def test_remat_keeps_values_and_gradients():
    """The three remat settings give the port the same loss and gradients
    (recomputation runs the same ops on the same inputs)."""
    _, tcfg, _, tp = _models("deepseek-v3-671b")
    batch = _batch(tcfg)
    outs = [_port_value_and_grad(tcfg.with_(remat=r), tp, batch) for r in ("none", "full", "dots")]
    for (loss, _), grads in outs[1:]:
        assert torch.equal(loss, outs[0][0][0])
        for a, b in zip(tree_leaves(grads), tree_leaves(outs[0][1])):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_remat_dots_saves_the_weight_products():
    assert {torch.ops.aten.mm.default, torch.ops.aten.addmm.default} <= tlm._DOTS
    assert torch.ops.aten.bmm.default not in tlm._DOTS  # batched, as in the reference


def test_ce_stream_chunks():
    """ce_chunks 4 (sequence slabs of 4 under a checkpoint each) against 1
    (the whole logits at once): the same loss and gradients in the port,
    and the reference's at 4 chunks."""
    _check_loss("phi4-mini-3.8b", ce_chunks=4)
    assert tlm._num_ce_chunks(tconfigs.get_smoke("phi4-mini-3.8b").with_(ce_chunks=4), S) == 4
    assert tlm._num_ce_chunks(tconfigs.get_smoke("phi4-mini-3.8b").with_(ce_chunks=5), S) == 4
    _, tcfg, _, tp = _models("phi4-mini-3.8b")
    batch = _batch(tcfg)
    (l4, _), g4 = _port_value_and_grad(tcfg.with_(ce_chunks=4), tp, batch)
    (l1, _), g1 = _port_value_and_grad(tcfg.with_(ce_chunks=1), tp, batch)
    torch.testing.assert_close(l4, l1, rtol=1e-6, atol=1e-6)
    for a, b in zip(tree_leaves(g4), tree_leaves(g1)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "deepseek-v3-671b", "mamba2-2.7b"])
def test_num_ce_chunks_matches(arch):
    for seq in (1, 16, 96, 1024, 4096):
        for chunks in (0, 1, 3, 8):
            jcfg = jconfigs.get_config(arch).with_(ce_chunks=chunks)
            tcfg = tconfigs.get_config(arch).with_(ce_chunks=chunks)
            assert tlm._num_ce_chunks(tcfg, seq) == jlm._num_ce_chunks(jcfg, seq)


def test_padded_vocab_mask_is_differentiable():
    """The padded vocabulary columns are masked to -2e38 out of place, so
    autograd differentiates the logits through the mask."""
    _, tcfg, _, tp = _models("mamba2-2.7b")
    if tcfg.vocab_padded == tcfg.vocab:
        tcfg = tcfg.with_(vocab=tcfg.vocab - 3)
    x = torch.randn(1, 2, tcfg.d_model, requires_grad=True)
    logits = tlm._logits(tp, x, tcfg)
    assert bool((logits[..., tcfg.vocab:] == -2.0e38).all())
    (g,) = torch.autograd.grad(logits[..., : tcfg.vocab].sum(), x)
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0


# --------------------------------------------------------------------- AdamW
def _adamw_inputs(seed=0, layers=3, d=16):
    """Stacked [L, d] norm scales and [L, d, 2d] matrices, an embedding, a
    final norm, and three steps' gradients with a norm far above clip."""
    r = np.random.default_rng(seed)
    shapes = {"embed": (40, d), "final_norm": (d,),
              "groups": [{"b0": {"norm1": (layers, d), "w": (layers, d, 2 * d)}}]}

    def tree(fn):
        return {"embed": fn(shapes["embed"]), "final_norm": fn(shapes["final_norm"]),
                "groups": [{"b0": {k: fn(v) for k, v in shapes["groups"][0]["b0"].items()}}]}

    params = tree(lambda s: (r.standard_normal(s) * 0.5).astype(np.float32))
    grads = [tree(lambda s: (r.standard_normal(s) * 3.0).astype(np.float32)) for _ in range(3)]
    return params, grads


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("clip_norm", [1.0, 1e3])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference(moment_dtype, clip_norm):
    """Three steps with clipping active (global norms ~50 against 1.0) or
    not (against 1e3), decay on every leaf with ndim >= 2 (the stacked [L, d] norm scales
    included, as the reference decays them) and a cosine schedule: the
    parameters and moments within 1e-6 (absolute and relative), the bf16
    moments within one bf16 ulp (at most 2^-7 relative): the global norm's
    f32 sum runs in another order, so the clip scale differs in its last
    places, and a bf16 moment can round the other way."""
    params, grads = _adamw_inputs()
    jcfg = jadamw.AdamWConfig(lr=1e-4, moment_dtype=moment_dtype, clip_norm=clip_norm)
    tcfg = tadamw.AdamWConfig(lr=1e-4, moment_dtype=moment_dtype, clip_norm=clip_norm)
    jp, tp = _to_jax(params), _to_torch(params)
    jo, to = jadamw.adamw_init(jp, jcfg), tadamw.adamw_init(tp, tcfg)
    for i, g in enumerate(grads):
        sched = dict(warmup=1, total=4)
        jp, jo, jm = jadamw.adamw_update(_to_jax(g), jo, jp, jcfg,
                                         jadamw.cosine_lr(jo["count"], **sched))
        tp, to, tm = tadamw.adamw_update(_to_torch(g), to, tp, tcfg,
                                         tadamw.cosine_lr(to["count"], **sched))
        _close(tm["grad_norm"], jm["grad_norm"], 1e-6 * float(jm["grad_norm"]), "grad_norm")
        assert float(jm["clip_scale"]) < 0.1 if clip_norm == 1.0 else float(jm["clip_scale"]) == 1.0
        _close(tm["clip_scale"], jm["clip_scale"], 1e-6, "clip_scale")
        assert int(to["count"]) == int(jo["count"]) == i + 1
    mtol = 1e-6 if moment_dtype == "float32" else 2.0**-7
    for got, want, tol in ((tp, jp, 1e-6), (to["m"], jo["m"], mtol), (to["v"], jo["v"], mtol)):
        g, w = flatten(got), _flatten(want)
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k].float().numpy(), w[k], rtol=tol, atol=1e-6,
                                       err_msg=k)
    assert to["m"]["embed"].dtype == getattr(torch, moment_dtype)
    # decayed: the stacked norm scale moved by more than its Adam step alone
    norm = tp["groups"][0]["b0"]["norm1"]
    assert norm.ndim == 2 and not torch.equal(norm, torch.from_numpy(params["groups"][0]["b0"]["norm1"]))


def test_adamw_update_writes_in_place():
    """The new parameters and moments are the tensors that were passed in,
    overwritten; the returned trees hold no other storage."""
    params, grads = _adamw_inputs()
    tp = _to_torch(params)
    cfg = tadamw.AdamWConfig(lr=1e-2)
    opt = tadamw.adamw_init(tp, cfg)
    before = {k: (t.data_ptr(), t.clone()) for k, t in flatten({"p": tp, "m": opt["m"],
                                                                 "v": opt["v"]}).items()}
    new_p, new_opt, _ = tadamw.adamw_update(_to_torch(grads[0]), opt, tp, cfg)
    after = flatten({"p": new_p, "m": new_opt["m"], "v": new_opt["v"]})
    assert after.keys() == before.keys()
    for k, t in after.items():
        ptr, old = before[k]
        assert t.data_ptr() == ptr and not torch.equal(t, old), k
    assert int(new_opt["count"]) == 1 and int(opt["count"]) == 0


def test_adamw_decays_stacked_norms_but_not_vectors():
    """With zero gradients only weight decay moves a leaf: every leaf with
    ndim >= 2 shrinks by lr * wd, the [d] final norm stays."""
    params, _ = _adamw_inputs()
    tp = _to_torch(params)
    cfg = tadamw.AdamWConfig(lr=0.1, weight_decay=0.5)
    zeros = tree_map(torch.zeros_like, tp)
    new, _, _ = tadamw.adamw_update(zeros, tadamw.adamw_init(tp, cfg), tree_map(torch.clone, tp),
                                    cfg)
    for k, v in flatten(new).items():
        old = flatten(tp)[k]
        want = old if old.ndim < 2 else old - 0.1 * 0.5 * old
        torch.testing.assert_close(v, want, rtol=1e-6, atol=1e-7, msg=k)


def test_cosine_lr_matches_reference():
    """Within 1.2e-7 (one f32 ulp of 1): XLA's f32 cos and torch's differ in
    their last place, and 0.5 * (1 + cos) keeps that absolute error."""
    for warmup, total, floor in ((10, 20, 0.1), (0, 5, 0.0), (3, 3, 0.2)):
        for step in range(0, 30):
            want = float(jadamw.cosine_lr(step, warmup=warmup, total=total, floor=floor))
            got = float(tadamw.cosine_lr(step, warmup=warmup, total=total, floor=floor))
            assert got == pytest.approx(want, rel=0, abs=1.2e-7), (warmup, total, step)


def test_global_norm_matches_reference():
    params, grads = _adamw_inputs(seed=3)
    want = float(jadamw.global_norm(_to_jax(grads[0])))
    got = float(tadamw.global_norm(_to_torch(grads[0])))
    assert got == pytest.approx(want, rel=1e-6)


def test_train_step_matches_reference():
    """make_train_step (no mesh) with the cosine schedule, two steps: the
    metrics and parameters within 1e-5 of the reference's step."""
    jcfg, tcfg, jp, tp = _models("phi4-mini-3.8b")
    sched = {"warmup": 1, "total": 4}
    jstep = jmake_train_step(jcfg, None, jadamw.AdamWConfig(lr=1e-3), schedule=sched)
    tstep_fn = tstep.make_train_step(tcfg, tadamw.AdamWConfig(lr=1e-3), schedule=sched)
    jo = jadamw.adamw_init(jp, jadamw.AdamWConfig())
    to = tadamw.adamw_init(tp, tadamw.AdamWConfig())
    for seed in (1, 2):
        batch = _batch(tcfg, seed)
        jp, jo, jm = jax.jit(jstep)(jp, jo, {k: jnp.asarray(v) for k, v in batch.items()})
        tp, to, tm = tstep_fn(tp, to, {k: torch.from_numpy(v) for k, v in batch.items()})
        for k in ("loss", "ce", "grad_norm"):
            _close(tm[k], jm[k], 1e-5, k)
    g, w = flatten(tp), _flatten(jp)
    for k in w:
        _close(g[k], w[k], 1e-5, k)


def test_sharded_training_is_not_ported():
    """``abstract_train_state`` builds ``meta`` trees and the parameters'
    logical axes; without a mesh ``train_shardings`` has none and
    ``jit_train_step`` is the plain step (the sharded step on meshes:
    ``tests/test_torch_sharded_steps.py``)."""
    cfg = tconfigs.get_smoke("phi4-mini-3.8b")
    ctx = tsh.make_context(None)
    assert tstep.train_shardings(cfg, ctx, tadamw.AdamWConfig()) == (None, None)
    assert tstep.batch_shardings({"tokens": torch.zeros(2, 3)}, ctx) == {"tokens": None}
    assert callable(tstep.jit_train_step(cfg, ctx, tadamw.AdamWConfig(), {}))
    params, opt, axes = tstep.abstract_train_state(cfg, tadamw.AdamWConfig())
    assert all(t.device.type == "meta" for t in tree_leaves(params) + tree_leaves(opt["m"]))
    assert sum(t.numel() for t in tree_leaves(params)) == cfg.param_count()
    assert axes["embed"] == ("vocab", "embed")


# --------------------------------------------------------------- checkpoints
def _bf16_state(arch="phi4-mini-3.8b"):
    """The reference's bf16 SMOKE params and optimizer state after a step."""
    jcfg = jconfigs.get_smoke(arch)
    jp, _ = jlm.init(jcfg, jax.random.key(0))
    ocfg = jadamw.AdamWConfig(lr=1e-2)
    jo = jadamw.adamw_init(jp, ocfg)
    g = jax.tree.map(lambda p: jnp.full(p.shape, 0.5, p.dtype), jp)
    jp, jo, _ = jadamw.adamw_update(g, jo, jp, ocfg)
    return jcfg, jp, jo


def _jax_loss(jcfg, jp, batch):
    return float(jlm.loss_fn(_f32(jp), {k: jnp.asarray(v) for k, v in batch.items()},
                             jcfg.with_(dtype="float32"))[0])


def _port_loss(tcfg, tp, batch):
    tp32 = tree_map(lambda t: t.float(), tp)
    return float(tlm.loss_fn(tp32, {k: torch.from_numpy(v) for k, v in batch.items()},
                             tcfg.with_(dtype="float32"))[0])


def test_checkpoint_from_reference_restores_in_port(tmp_path):
    """The reference saves bf16 params + f32 moments + the int32 count; the
    port restores them into its own template (other values, the same
    structure): bit-equal leaves in the template's dtypes, and the same loss."""
    jcfg, jp, jo = _bf16_state()
    jstore.save(str(tmp_path), 7, {"params": jp, "opt": jo}, metadata={"who": "jax"})
    tcfg = tconfigs.get_smoke("phi4-mini-3.8b")
    tp = tlm.init(tcfg, torch.Generator().manual_seed(5), device="cpu")
    template = {"params": tp, "opt": tadamw.adamw_init(tp, tadamw.AdamWConfig())}
    assert tstore.latest_step(str(tmp_path)) == 7
    got, step = tstore.restore(str(tmp_path), template)
    assert step == 7
    want = _flatten({"params": jp, "opt": jo})
    flat = flatten(got)
    assert flat.keys() == want.keys()
    for k, t in flat.items():
        assert t.dtype == flatten(template)[k].dtype, k
        assert np.array_equal(t.float().numpy() if t.is_floating_point() else t.numpy(),
                              want[k]), k
    assert got["params"]["embed"].dtype == torch.bfloat16 and got["opt"]["count"].dtype == torch.int32
    batch = _batch(tcfg)
    assert _port_loss(tcfg, got["params"], batch) == pytest.approx(
        _jax_loss(jcfg, jp, batch), rel=1e-5)


def test_checkpoint_from_port_restores_in_reference(tmp_path):
    tcfg = tconfigs.get_smoke("moonshot-v1-16b-a3b")
    tp = tlm.init(tcfg, torch.Generator().manual_seed(3), device="cpu")
    ocfg = tadamw.AdamWConfig(lr=1e-2)
    to = tadamw.adamw_init(tp, ocfg)
    tp, to, _ = tadamw.adamw_update(tree_map(lambda p: torch.full_like(p, 0.5), tp), to, tp, ocfg)
    tstore.save(str(tmp_path), 3, {"params": tp, "opt": to})
    manifest = json.loads((tmp_path / "ckpt_00000003.npz.json").read_text())
    assert manifest["step"] == 3 and manifest["keys"] == sorted(flatten({"params": tp, "opt": to}))
    jcfg = jconfigs.get_smoke("moonshot-v1-16b-a3b")
    jp, _ = jlm.init(jcfg, jax.random.key(9))
    template = {"params": jp, "opt": jadamw.adamw_init(jp, jadamw.AdamWConfig())}
    got, step = jstore.restore(str(tmp_path), template)
    assert step == 3
    want = {k: (t.float() if t.dtype == torch.bfloat16 else t).numpy()
            for k, t in flatten({"params": tp, "opt": to}).items()}
    for k, a in _flatten(got).items():
        assert np.array_equal(a, want[k]), k
    assert got["params"]["embed"].dtype == jnp.bfloat16
    batch = _batch(tcfg)
    assert _jax_loss(jcfg, got["params"], batch) == pytest.approx(
        _port_loss(tcfg, tp, batch), rel=1e-5)


def test_async_checkpointer_snapshots_and_latest_step(tmp_path):
    d = str(tmp_path / "ck")
    assert tstore.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        tstore.restore(d, {"w": torch.zeros(2)})
    ck = tstore.AsyncCheckpointer(d)
    tree = {"w": torch.arange(4, dtype=torch.bfloat16), "n": [torch.tensor(3, dtype=torch.int32)]}
    ck.save(2, tree)
    tree["w"].add_(100)  # after save() returns: the checkpoint holds the snapshot
    ck.save(5, tree, metadata={"note": "x"})
    ck.wait()
    assert ck.last_saved == 5 and tstore.latest_step(d) == 5
    two, step = tstore.restore(d, tree, step=2)
    assert step == 2 and torch.equal(two["w"], torch.arange(4, dtype=torch.bfloat16))
    assert two["n"][0].dtype == torch.int32 and int(two["n"][0]) == 3
    five, _ = tstore.restore(d, tree)
    assert torch.equal(five["w"], tree["w"])
    assert json.loads(Path(d, "ckpt_00000005.npz.json").read_text())["note"] == "x"
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]


# --------------------------------------------------------------- compression
def _arrays(seed=0):
    r = np.random.default_rng(seed)
    return [
        (r.standard_normal((7, 9)) * 3).astype(np.float32),
        np.zeros((4,), np.float32),
        (r.standard_normal((50,)) * 1e-4).astype(np.float32),
        np.asarray([0.5, -0.5, 1.5, 127.0, -127.0, 63.5], np.float32),  # ties at .5
        np.asarray(2.0, np.float32),
    ]


def test_quantize_bit_equal():
    for a in _arrays():
        jq, js = jcomp.quantize(jnp.asarray(a))
        tq, ts = tcomp.quantize(torch.from_numpy(a.copy()))
        assert ts == js and type(ts) is float
        assert tq.dtype == torch.int8 and np.array_equal(tq.numpy(), jq)
        assert np.array_equal(tcomp.dequantize(tq, ts).numpy(), jcomp.dequantize(jq, js))
    bf = jnp.asarray(_arrays()[0], jnp.bfloat16)
    jq, js = jcomp.quantize(bf)
    tq, ts = tcomp.quantize(torch.from_numpy(np.asarray(bf, np.float32)).to(torch.bfloat16))
    assert ts == js and np.array_equal(tq.numpy(), jq)


def test_error_feedback_matches_reference():
    """Three rounds over a tree: the packed pairs, the decompressed values
    and the residual carried between rounds, equal to the reference's."""
    jef, tef = jcomp.ErrorFeedback(), tcomp.ErrorFeedback()
    for rnd in range(3):
        arrs = _arrays(rnd)
        tree = {"a": arrs[0], "b": [arrs[2], arrs[3]]}
        jp = jef.compress(jax.tree.map(jnp.asarray, tree))
        tp = tef.compress(_to_torch(tree))
        for (jq, js), (tq, ts) in zip([jp["a"], *jp["b"]], [tp["a"], *tp["b"]]):
            assert ts == js and np.array_equal(tq.numpy(), jq)
        jd, td = jcomp.ErrorFeedback.decompress(jp), tcomp.ErrorFeedback.decompress(tp)
        for a, b in zip(jax.tree.leaves(jd), tree_leaves(td)):
            assert np.array_equal(b.numpy(), a)
        for a, b in zip(jax.tree.leaves(jef._residual), tree_leaves(tef._residual)):
            assert np.array_equal(b.numpy(), a)
    tree = {"a": np.zeros((3, 5), np.float32), "b": [np.zeros(2, np.float32)]}
    assert tcomp.compressed_bytes(_to_torch(tree)) == jcomp.compressed_bytes(tree) == 25


# ------------------------------------------------------------ copied modules
@pytest.mark.parametrize("path", ["data/pipeline.py", "data/__init__.py", "optim/__init__.py",
                                  "checkpoint/__init__.py", "runtime/__init__.py",
                                  "train/__init__.py"])
def test_copied_module_is_byte_identical(path):
    ours = ROOT / "src" / "repro_torch" / path
    assert ours.read_bytes() == (ROOT / "src" / "repro" / path).read_bytes()


def test_fault_tolerance_differs_in_its_store_import_only():
    ours = (ROOT / "src" / "repro_torch" / "runtime" / "fault_tolerance.py").read_text().splitlines()
    theirs = (ROOT / "src" / "repro" / "runtime" / "fault_tolerance.py").read_text().splitlines()
    diff = [(a, b) for a, b in zip(ours, theirs) if a != b]
    assert len(ours) == len(theirs)
    assert [a for a, _ in diff] == [b.replace("from repro.", "from repro_torch.") for _, b in diff]
    assert diff == [("from repro_torch.checkpoint import store", "from repro.checkpoint import store")]


def test_training_modules_import_no_jax():
    for mod in ("autodiff.py", "optim/adamw.py", "checkpoint/store.py", "runtime/compression.py",
                "runtime/het_dp.py", "runtime/fault_tolerance.py", "train/step.py",
                "launch/train.py"):
        text = (ROOT / "src" / "repro_torch" / mod).read_text()
        assert "import jax" not in text and "from repro." not in text and "from jax" not in text, mod


# --------------------------------------------------------------- entry points
def test_launch_train_cpu_smoke_resumes(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    argv = ["--arch", "phi4-mini-3.8b", "--device", "cpu", "--smoke", "--batch", "2",
            "--seq", "16", "--ckpt", ck, "--ckpt-every", "2"]
    tlaunch.main(argv + ["--steps", "2"])
    out = capsys.readouterr().out
    assert out.count("loss") == 2 and "done" in out
    assert tstore.latest_step(ck) == 2
    tlaunch.main(argv + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and out.count("loss") == 1
    losses = [float(line.split()[3]) for line in out.splitlines() if line.startswith("step")]
    assert all(np.isfinite(losses))


def test_launch_train_refuses_mesh_and_frontends():
    """Frontend archs exit as the reference's driver does (``--mesh`` runs:
    ``tests/test_torch_sharding.py::test_launch_train_mesh_on_gloo``)."""
    for arch in ("seamless-m4t-medium", "qwen2-vl-2b"):
        with pytest.raises(SystemExit, match="feeds token batches"):
            tlaunch.main(["--arch", arch, "--device", "cpu", "--smoke"])


def test_het_train_example_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "het_train_torch.py"), "--device", "cpu",
         "--steps", "6", "--fail-step", "3", "--microbatches", "4"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "steps run:        6" in proc.stdout
    assert "removed workers:  ['flaky-pod']" in proc.stdout
