"""The port's sharded steps on ``gloo`` process groups against the JAX
reference's mesh-free ones, in f32: forward, prefill and decode of the ten
SMOKE archs on a 2x2 mesh (on 2x2x2: ``tests/test_torch_sharded_pod.py``),
and ``jit_train_step`` of phi4 and moonshot on 2x2 and on the 2x2x2 pod
mesh.

Weights come from ``repro.models.lm.init`` and cross through the
reference's checkpoint format; each group runs in subprocesses
(``tests/_torch_dist.py``) with its own timeout.  MoE configs run at the
capacity factor num_experts / top_k: under a mesh each data shard fills
its own expert capacity, as the reference's ``shard_map`` does, so with
drops a sharded step routes otherwise than a mesh-free one by design
(``tests/test_torch_sharding.py`` holds the drops themselves).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.checkpoint.store import _flatten
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.train.step import make_train_step as jmake_train_step

from _torch_dist import run_group

torch.set_num_threads(1)

ARCHS = list(jconfigs.ARCH_IDS)
B, S0, N = 4, 16, 3  # batch (splits over 'data'), prompt, decode steps
PORT_TOL = 1e-5  # sharded port vs unsharded port
REF_TOL = 1e-4  # either vs the reference (CPU summation orders differ)


def _cfg(arch):
    cfg = jconfigs.get_smoke(arch).with_(dtype="float32")
    if cfg.moe is not None:
        cfg = cfg.with_(moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    return cfg


def _params(cfg):
    jp, _ = jlm.init(cfg, jax.random.key(0))
    return jax.tree.map(lambda x: x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x, jp)


def _prompt(cfg, r):
    if cfg.frontend == "vision":
        t = np.arange(S0)
        pos = np.broadcast_to(np.stack([t, t // 4, t % 4])[:, None], (3, B, S0))
        return {"embeds": (r.standard_normal((B, S0, cfg.d_model)) * 0.2).astype(np.float32),
                "positions": np.ascontiguousarray(pos).astype(np.int64)}
    batch = {"tokens": r.integers(0, cfg.vocab, (B, S0)).astype(np.int64)}
    if cfg.enc_layers:
        batch["enc_embeds"] = (r.standard_normal((B, 24, cfg.d_model)) * 0.2).astype(np.float32)
    return batch


def _close(got, want, tol, what, vocab):
    np.testing.assert_allclose(np.asarray(got)[..., :vocab], np.asarray(want)[..., :vocab],
                               atol=tol, rtol=tol, err_msg=what)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serving_matches(arch, tmp_path):
    """On 2x2: ``lm.forward`` on DTensors, ``jit_prefill_step`` and
    ``jit_decode_step`` (serving layout, full-EP experts) against the
    port's unsharded logits (1e-5) and the reference's mesh-free ones
    (1e-4)."""
    check_sharded_serving(arch, (2, 2, 0), tmp_path)


def test_split_mla_decode_matches(tmp_path):
    """deepseek on 2x2 with a cache of S0 + 4 = 20 slots, which 'model'
    divides: the compressed MLA cache is split over its slots, and
    decode's split softmax (``attention._mla_attend_split``) holds the
    serving check's bounds."""
    out = check_sharded_serving("deepseek-v3-671b", (2, 2, 0), tmp_path, steps=4)
    assert out["split_caches"] > 0


def check_sharded_serving(arch, mesh, tmp_path, steps=N):
    """The serving check on ``mesh`` (data, model, pod), ``steps`` decode
    steps; returns the ranks' output."""
    cfg = _cfg(arch)
    jp = _params(cfg)
    r = np.random.default_rng(1)
    batch = _prompt(cfg, r)
    nxt = r.integers(0, cfg.vocab, (B, steps)).astype(np.int64)
    out = run_group(8 if mesh[2] else 4, "_torch_dist:serve_worker",
                    {"arch": arch, "cf": cfg.moe and cfg.moe.capacity_factor, "mesh": mesh,
                     "params": _flatten(jp), "batch": batch, "next": nxt, "s0": S0}, tmp_path)

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = {"forward": jlm.forward(jp, jb, cfg)[0]}
    want["prefill"], caches = jlm.prefill(jp, jb, cfg)
    caches = jlm.pad_caches(caches, cfg, S0 + steps)
    want["decode"] = []
    for i in range(steps):
        logits, caches = jlm.decode_step(jp, jnp.asarray(nxt[:, i:i + 1], jnp.int32), caches,
                                         jnp.int32(S0 + i), cfg)
        want["decode"].append(logits)
    for k in ("forward", "prefill", "decode"):
        pairs = zip(out["sharded"][k], out["plain"][k], want[k]) if k == "decode" else \
            [(out["sharded"][k], out["plain"][k], want[k])]
        for i, (sharded, plain, ref) in enumerate(pairs):
            _close(sharded, plain, PORT_TOL, f"{k} {i}: sharded vs unsharded", cfg.vocab)
            _close(plain, ref, REF_TOL, f"{k} {i}: unsharded vs reference", cfg.vocab)
            _close(sharded, ref, REF_TOL, f"{k} {i}: sharded vs reference", cfg.vocab)
    return out


@pytest.mark.parametrize("mesh", [(2, 2, 0), (2, 2, 2)], ids=["2x2", "2x2x2"])
@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "moonshot-v1-16b-a3b", "mamba2-2.7b"])
def test_sharded_train_step_matches_reference(arch, mesh, tmp_path):
    """``jit_train_step`` (FSDP over 'data', TP over 'model', the pod axis
    data-parallel; the vocab-parallel lookup and cross-entropy) over two
    steps with the cosine schedule: loss, ``grad_norm`` and every parameter
    leaf within 1e-4 of the reference's mesh-free step.  SMOKE mamba2 (8
    heads, one group of state 16) splits its heads and its B and C columns
    over 'model' of 2, so its mixer runs per rank (``ssm._mixer``): the
    gated norm's squares summed over 'model', B and C gathered."""
    check_sharded_train_step(arch, mesh, tmp_path)


def test_tied_table_train_step_matches_reference(tmp_path):
    """recurrentgemma ties its head to the embedding table: on 2x2 the
    vocab-parallel lookup's gradient and the head product's meet in the
    table's layout (rows over 'model'), and the step holds the bounds of
    ``test_sharded_train_step_matches_reference``."""
    check_sharded_train_step("recurrentgemma-2b", (2, 2, 0), tmp_path)


def check_sharded_train_step(arch, mesh, tmp_path):
    cfg = _cfg(arch)
    jp = _params(cfg)
    sched = {"warmup": 1, "total": 4}
    r = np.random.default_rng(2)
    batches = []
    for _ in range(2):
        toks = r.integers(0, cfg.vocab, (8, 16)).astype(np.int32)
        batches.append({"tokens": toks, "labels": np.roll(toks, -1, 1)})
    out = run_group(8 if mesh[2] else 4, "_torch_dist:train_worker",
                    {"arch": arch, "cf": cfg.moe and cfg.moe.capacity_factor, "mesh": mesh,
                     "params": _flatten(jp), "lr": 1e-3, "schedule": sched,
                     "batches": batches}, tmp_path)
    step = jax.jit(jmake_train_step(cfg, None, jadamw.AdamWConfig(lr=1e-3), schedule=sched))
    jo = jadamw.adamw_init(jp, jadamw.AdamWConfig(lr=1e-3))
    for b, got in zip(batches, out["metrics"]):
        jp, jo, jm = step(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(got[k], float(jm[k]), atol=REF_TOL, rtol=REF_TOL, err_msg=k)
    want = _flatten(jp)
    assert out["params"].keys() == want.keys()
    assert any("Shard" in p for p in out["placements"].values())
    for k in want:
        np.testing.assert_allclose(out["params"][k], want[k], atol=REF_TOL, rtol=REF_TOL,
                                   err_msg=k)
