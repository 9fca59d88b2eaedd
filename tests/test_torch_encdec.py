"""The port's encoder-decoder family (seamless-m4t-medium: block kinds
``enc`` and ``xdec``, the plain ReLU MLP, cross-attention over the encoder
memory, the ``(self K/V, memory K/V)`` cache pairs) against the JAX
reference on the CPU.

Inputs are made with numpy from a seed; parameters come from
``repro.models.lm.init`` and cross through ``repro_torch.models.bridge`` in
the reference's checkpoint format, widened to f32.  The encoder's length
(24) differs from the decoder's (16), so that no mix-up of the two passes.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.checkpoint.store import _flatten
from repro.models import blocks as jblocks
from repro.models import lm as jlm
import repro_torch.configs as tconfigs
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm
from repro_torch.models.bridge import flatten, params_from_flat
from repro_torch.serve import Replica, ServePool

# SMOKE-size tensors: one intra-op thread is as fast, and leaves the other
# test workers' cores (and their timing-sensitive threads) alone.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
ARCH = "seamless-m4t-medium"
S = 16       # decoder tokens
S_ENC = 24   # encoder frames
MOD_TOL = 1e-5
F32_TOL = 1e-4
CONSISTENCY_TOL = 2e-3  # the reference's own (tests/test_decode_consistency.py)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _close_trees(got, want, tol):
    g, w = flatten(got), _flatten(want)
    assert g.keys() == w.keys()
    for k in w:
        assert tuple(g[k].shape) == w[k].shape, k
        _close(g[k], w[k], tol)


@pytest.fixture(scope="module")
def models():
    """(reference cfg, port cfg, JAX params, port params), f32 SMOKE."""
    jcfg = jconfigs.get_smoke(ARCH).with_(dtype="float32")
    tcfg = tconfigs.get_smoke(ARCH).with_(dtype="float32")
    jp, _ = jlm.init(jcfg, jax.random.key(0))
    jp = jax.tree.map(lambda x: x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x, jp)
    return jcfg, tcfg, jp, params_from_flat(_flatten(jp), device="cpu", dtype=torch.float32)


def _layer(jp, tp, tree, i=0):
    """Layer ``i`` of a stacked block: the reference's and the port's."""
    j, t = jp[tree][0]["b0"], tp[tree][0]["b0"]
    return jax.tree.map(lambda a: a[i], j), jax.tree.map(lambda a: a[i], t)


def _batch(cfg, s=S, s_enc=S_ENC, seed=1):
    r = _rng(seed)
    toks = r.integers(0, cfg.vocab, (2, s)).astype(np.int32)
    enc = (r.standard_normal((2, s_enc, cfg.d_model)) * 0.2).astype(np.float32)
    return toks, enc


def _jbatch(toks, enc):
    return {"tokens": jnp.asarray(toks), "enc_embeds": jnp.asarray(enc)}


def _tbatch(toks, enc):
    return {"tokens": _t(toks).long(), "enc_embeds": _t(enc)}


# ------------------------------------------------------------------ modules
def test_plain_mlp_matches(models):
    jcfg, tcfg, _, _ = models
    r = _rng(2)
    p = {"w_in": r.standard_normal((64, 128)).astype(np.float32) / 8,
         "w_out": r.standard_normal((128, 64)).astype(np.float32) / 11}
    x = r.standard_normal((2, 5, 64)).astype(np.float32)
    want = jblocks._mlp_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg)
    got = tblocks._mlp_apply({k: _t(v) for k, v in p.items()}, _t(x), tcfg)
    _close(got, want, MOD_TOL)
    assert (np.asarray(want) != 0).all()  # the ReLU left some units on in every row


def test_memory_kv_matches(models):
    jcfg, tcfg, jp, tp = models
    jl, tl = _layer(jp, tp, "groups", 1)
    mem = (_rng(3).standard_normal((2, S_ENC, tcfg.d_model))).astype(np.float32)
    (wk, wv), (gk, gv) = (jblocks.memory_kv(jl["xattn"], jnp.asarray(mem), jcfg),
                          tblocks.memory_kv(tl["xattn"], _t(mem), tcfg))
    assert tuple(gk.shape) == (2, S_ENC, tcfg.n_kv_heads, tcfg.head_dim_)
    _close(gk, wk, MOD_TOL)
    _close(gv, wv, MOD_TOL)


@pytest.mark.parametrize("s_enc", [S_ENC, 1030])  # 1030: two key chunks of 1024
def test_cross_attn_matches(models, s_enc):
    jcfg, tcfg, jp, tp = models
    jl, tl = _layer(jp, tp, "groups")
    r = _rng(4)
    x = r.standard_normal((2, S, tcfg.d_model)).astype(np.float32)
    shape = (2, s_enc, tcfg.n_kv_heads, tcfg.head_dim_)
    k, v = (r.standard_normal(shape).astype(np.float32) for _ in range(2))
    want = jblocks._cross_attn(jl["xattn"], jnp.asarray(x), jcfg, (jnp.asarray(k), jnp.asarray(v)))
    got = tblocks._cross_attn(tl["xattn"], _t(x), tcfg, (_t(k), _t(v)))
    _close(got, want, MOD_TOL)


@pytest.mark.parametrize("want_cache", [False, True], ids=["nocache", "cache"])
@pytest.mark.parametrize("kind", ["enc", "xdec"])
def test_block_apply_matches(models, kind, want_cache):
    """One ``enc`` block over the encoder's 24 frames, or one ``xdec`` block
    over 16 decoder rows attending a 24-frame memory, chunk 8; with the
    cache, the block's K/V (and an ``xdec`` block's memory K/V)."""
    jcfg, tcfg, jp, tp = models
    jl, tl = _layer(jp, tp, "enc_groups" if kind == "enc" else "groups")
    r = _rng(5)
    s = S_ENC if kind == "enc" else S
    x = r.standard_normal((2, s, tcfg.d_model)).astype(np.float32)
    mem = r.standard_normal((2, S_ENC, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (2, s)).copy()
    jaux = {"positions": jnp.asarray(pos), "ctx": None, "chunk": 8, "memory": jnp.asarray(mem)}
    taux = {"positions": _t(pos), "chunk": 8, "memory": _t(mem)}
    want, _, wc = jblocks.block_apply(jl, jnp.asarray(x), kind=kind, cfg=jcfg, aux=jaux,
                                      want_cache=want_cache)
    got, aux_l, gc = tblocks.block_apply(tl, _t(x), kind=kind, cfg=tcfg, aux=taux,
                                         want_cache=want_cache)
    assert aux_l == 0.0
    _close(got, want, MOD_TOL)
    if want_cache:
        _close_trees(gc, wc, MOD_TOL)
        if kind == "xdec":
            assert tuple(gc[1][0].shape) == (2, S_ENC, tcfg.n_kv_heads, tcfg.head_dim_)
    else:
        assert gc is None and wc is None


def test_block_decode_xdec_matches(models):
    """One decode step of an ``xdec`` block at position 17 of a 20-slot
    cache: the output and the written self-attention row as the
    reference's; the memory K/V read and left as they were (the same
    tensors, the same bits)."""
    jcfg, tcfg, jp, tp = models
    jl, tl = _layer(jp, tp, "groups")
    r = _rng(6)
    pos = 17
    x = r.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    shape = (2, 20, tcfg.n_kv_heads, tcfg.head_dim_)
    mshape = (2, S_ENC, tcfg.n_kv_heads, tcfg.head_dim_)
    ck, cv = (r.standard_normal(shape).astype(np.float32) for _ in range(2))
    mk, mv = (r.standard_normal(mshape).astype(np.float32) for _ in range(2))
    positions = np.full((2, 1), pos)
    want, (wsa, wm) = jblocks.block_decode(
        jl, jnp.asarray(x), kind="xdec", cfg=jcfg,
        aux={"positions": jnp.asarray(positions), "ctx": None},
        cache=((jnp.asarray(ck), jnp.asarray(cv)), (jnp.asarray(mk), jnp.asarray(mv))),
        pos=jnp.int32(pos))
    tk, tv, tmk, tmv = (_t(a.copy()) for a in (ck, cv, mk, mv))
    got, (gsa, gm) = tblocks.block_decode(
        tl, _t(x), kind="xdec", cfg=tcfg, aux={"positions": _t(positions)},
        cache=((tk, tv), (tmk, tmv)), pos=pos)
    _close(got, want, MOD_TOL)
    _close(gsa[0], wsa[0], MOD_TOL)
    _close(gsa[1], wsa[1], MOD_TOL)
    assert gsa[0] is tk and gm[0] is tmk and gm[1] is tmv  # in place; memory only read
    assert np.array_equal(tmk.numpy(), mk) and np.array_equal(tmv.numpy(), mv)
    with pytest.raises(ValueError, match="memory K/V is None"):
        tblocks.block_decode(tl, _t(x), kind="xdec", cfg=tcfg, aux={"positions": _t(positions)},
                             cache=((tk, tv), None), pos=pos)


def test_enc_and_xdec_keep_no_block_cache(models):
    """As in the reference, ``block_init_cache`` has no cache for ``enc``
    or ``xdec``: an ``xdec`` pair comes from ``lm.init_caches``."""
    _, tcfg, _, _ = models
    for kind in ("enc", "xdec"):
        with pytest.raises(ValueError, match="no cache"):
            tblocks.block_init_cache(tcfg, kind, 1, 4, torch.float32, layers=2,
                                     device=torch.device("meta"))


# -------------------------------------------------------------------- model
@pytest.mark.parametrize("chunk", [1024, 8])  # 8: the encoder runs 3 key chunks
def test_forward_matches(models, chunk):
    jcfg, tcfg, jp, tp = models
    toks, enc = _batch(tcfg)
    want, want_aux = jlm.forward(jp, _jbatch(toks, enc), jcfg, chunk=chunk)
    got, aux = tlm.forward(tp, _tbatch(toks, enc), tcfg, chunk=chunk)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, S, 256)
    assert float(aux) == float(want_aux) == 0.0
    _close(got, want, F32_TOL)


def test_encoder_positions_are_read(models):
    """``enc_positions`` reach the encoder's rotary, as in the reference."""
    jcfg, tcfg, jp, tp = models
    toks, enc = _batch(tcfg)
    epos = np.broadcast_to(np.arange(S_ENC) * 3 + 5, (2, S_ENC)).astype(np.int32)
    want, _ = jlm.forward(jp, {**_jbatch(toks, enc), "enc_positions": jnp.asarray(epos)}, jcfg)
    got, _ = tlm.forward(tp, {**_tbatch(toks, enc), "enc_positions": _t(epos)}, tcfg)
    _close(got, want, F32_TOL)
    plain, _ = tlm.forward(tp, _tbatch(toks, enc), tcfg)
    assert (got - plain).abs().max() > 1e-3


def test_prefill_pad_and_decode_match(models):
    """prefill of 12 tokens against a 24-frame memory: logits and every
    cache leaf (the memory K/V included); pad_caches grows only the
    self-attention K/V; then 4 decode steps, each against the reference's
    and against the port's forward; the memory K/V come out bit-equal."""
    jcfg, tcfg, jp, tp = models
    toks, enc = _batch(tcfg)
    s0 = 12
    jl, jc = jlm.prefill(jp, _jbatch(toks[:, :s0], enc), jcfg)
    tl, tc = tlm.prefill(tp, _tbatch(toks[:, :s0], enc), tcfg)
    _close(tl, jl, F32_TOL)
    _close_trees(tc, jc, F32_TOL)
    memory = [t.clone() for t in tc[0][0][1]]
    jc, tc = jlm.pad_caches(jc, jcfg, S), tlm.pad_caches(tc, tcfg, S)
    L, hkv, hd = tcfg.n_layers, tcfg.n_kv_heads, tcfg.head_dim_
    (((sk, sv), (mk, mv)),) = tc[0]
    assert tuple(sk.shape) == tuple(sv.shape) == (L, 2, S, hkv, hd)
    assert tuple(mk.shape) == tuple(mv.shape) == (L, 2, S_ENC, hkv, hd)
    assert not sk[:, :, s0:].any() and not sv[:, :, s0:].any()
    _close_trees(tc, jc, F32_TOL)
    full, _ = tlm.forward(tp, _tbatch(toks, enc), tcfg)
    jstep = jax.jit(lambda p, t, c, i: jlm.decode_step(p, t, c, i, jcfg))
    for i in range(s0, S):
        jl, jc = jstep(jp, jnp.asarray(toks[:, i : i + 1]), jc, jnp.int32(i))
        tl, tc = tlm.decode_step(tp, _t(toks[:, i : i + 1]).long(), tc, i, tcfg)
        _close(tl, jl, F32_TOL)
        torch.testing.assert_close(tl, full[:, i : i + 1], atol=CONSISTENCY_TOL,
                                   rtol=CONSISTENCY_TOL)
    _close_trees(tc, jc, F32_TOL)
    assert all(torch.equal(a, b) for a, b in zip(tc[0][0][1], memory))


def test_pad_lengths_give_the_same_decode(models):
    """pad_caches to 16 and to 40 slots: the same decode logits (zero
    slots past the position are masked)."""
    _, tcfg, _, tp = models
    toks, enc = _batch(tcfg)
    outs = []
    for cache_len in (S, 40):
        _, tc = tlm.prefill(tp, _tbatch(toks[:, :12], enc), tcfg)
        tc = tlm.pad_caches(tc, tcfg, cache_len)
        outs.append(torch.cat([tlm.decode_step(tp, _t(toks[:, i : i + 1]).long(), tc, i, tcfg)[0]
                               for i in range(12, S)], 1))
    torch.testing.assert_close(outs[0], outs[1], atol=1e-5, rtol=1e-5)


def test_init_caches_leave_the_memory_slot_empty(models):
    """``init_caches`` gives ``(self K/V, None)`` as the reference's does,
    and a decode step on it raises: an enc-dec model decodes after a
    prefill."""
    jcfg, tcfg, _, tp = models
    tc = tlm.init_caches(tcfg, 2, 8, device="cpu")
    jc = jlm.init_caches(jcfg, 2, 8)
    (((sk, sv), memory),) = tc[0]
    assert memory is None and jc[0][0][1] is None
    assert tuple(sk.shape) == jc[0][0][0][0].shape
    with pytest.raises(ValueError, match="after a prefill"):
        tlm.decode_step(tp, torch.zeros((2, 1), dtype=torch.long), tc, 0, tcfg)


# ------------------------------------------------------------- the pool
def test_servepool_request_equals_its_run_alone(models):
    """Two replicas of seamless SMOKE in f32 on the CPU, each generating by
    prefill, pad_caches and greedy decode steps (``chip_smoke.py``'s
    enc-dec replica): every pooled completion, and its logits bit for bit,
    equal the request run alone; the first equals the reference's own
    prefill and decode loop."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    jcfg, tcfg, jp, tp = models
    new = 4
    r = _rng(7)
    requests = [{"tokens": r.integers(0, tcfg.vocab, 6),
                 "enc_embeds": (r.standard_normal((S_ENC, tcfg.d_model)) * 0.2).astype(np.float32)}
                for _ in range(6)]
    alone = chip_smoke.encdec_generate(torch, np, tcfg, tp, new)
    want = [alone(req) for req in requests]
    pool = ServePool([Replica(f"r{i}", chip_smoke.encdec_generate(torch, np, tcfg, tp, new),
                              slow_factor=1.0 + 5 * i) for i in range(2)], seed=1)
    futs = pool.submit_wave(requests, replica=1)
    got = [f.result(timeout=60) for f in futs]
    stats = pool.shutdown()
    assert sum(stats.per_worker_tasks) == 6
    for g, w in zip(got, want):
        assert g["completion"] == w["completion"] and len(g["completion"]) == new
        assert torch.equal(g["logits"], w["logits"])
    # the reference's greedy prefill + pad + decode over request 0
    req = requests[0]
    jl, jc = jlm.prefill(jp, {"tokens": jnp.asarray(req["tokens"][None]),
                              "enc_embeds": jnp.asarray(req["enc_embeds"][None])}, jcfg)
    jc = jlm.pad_caches(jc, jcfg, 6 + new - 1)
    ref = [int(jnp.argmax(jl[0, -1]))]
    for i in range(new - 1):
        jl, jc = jlm.decode_step(jp, jnp.asarray([[ref[-1]]]), jc, jnp.int32(6 + i), jcfg)
        ref.append(int(jnp.argmax(jl[0, -1])))
    assert want[0]["completion"] == ref
