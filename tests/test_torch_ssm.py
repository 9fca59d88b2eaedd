"""The port's recurrent mixers (``repro_torch.models.ssm``, ``rglru``) and
the ``local`` block against the JAX reference on the CPU, at SMOKE size.

Inputs are made with numpy from a seed; parameters come from the
reference's ``ssm_params``/``rglru_params``/``block_params`` and cross
through ``repro_torch.models.bridge``, widened to f32 as the reference's own
``tests/test_ssm_rglru.py`` widens them.  The SSM runs with ``chunk=8``, as
the reference's tests do.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.checkpoint.store import _flatten
from repro.models import blocks as jblocks
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro.models.layers import split
import repro_torch.configs as tconfigs
from repro_torch.models import blocks as tblocks
from repro_torch.models import rglru as trglru
from repro_torch.models import ssm as tssm
from repro_torch.models.bridge import params_from_flat

# SMOKE-size tensors: one intra-op thread is as fast, and leaves the other
# test workers' cores (and their timing-sensitive threads) alone.
torch.set_num_threads(1)

TOL = 1e-5  # f32, module against module: only summation order differs
ORACLE = dict(atol=2e-4, rtol=2e-3)  # chunked scan vs step oracle: the reference's own


def _cfgs(arch, **overrides):
    jcfg = jconfigs.get_smoke(arch).with_(dtype="float32", **overrides)
    tcfg = tconfigs.get_smoke(arch).with_(dtype="float32", **overrides)
    if jcfg.ssm is not None:
        jcfg = jcfg.with_(ssm=dataclasses.replace(jcfg.ssm, chunk=8))
        tcfg = tcfg.with_(ssm=dataclasses.replace(tcfg.ssm, chunk=8))
    return jcfg, tcfg


def _params(make, jcfg, *args):
    """(JAX params widened to f32, the same on the port's side)."""
    jp, _ = split(make(jax.random.key(0), jcfg, *args))
    jp = jax.tree.map(lambda x: x.astype(jnp.float32), jp)
    return jp, params_from_flat(_flatten(jp), device="cpu", dtype=torch.float32)


def _x(shape, seed, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=TOL, **kw):
    kw = kw or dict(atol=tol, rtol=tol)
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **kw)


# ----------------------------------------------------------------------- SSM
def test_ssm_params_fixed_leaves_match_reference():
    """a_log and dt_bias are not drawn: the port's equal the reference's
    (a_log within one f32 ulp: XLA's log and torch's round differently),
    f32 whatever the model's dtype."""
    jcfg = jconfigs.get_smoke("mamba2-2.7b")
    jp, _ = split(jssm.ssm_params(jax.random.key(0), jcfg))
    tp = tssm.ssm_params(torch.Generator().manual_seed(0), tconfigs.get_smoke("mamba2-2.7b"),
                         dtype=torch.bfloat16, device=torch.device("cpu"))
    assert tp.keys() == jp.keys()
    assert tp["a_log"].dtype == tp["dt_bias"].dtype == torch.float32
    np.testing.assert_array_max_ulp(tp["a_log"].numpy(), np.asarray(jp["a_log"]), maxulp=1)
    np.testing.assert_array_equal(tp["dt_bias"].numpy(), np.asarray(jp["dt_bias"]))
    assert tp["d_skip"].dtype == torch.bfloat16 and bool((tp["d_skip"] == 1).all())
    for k, v in jp.items():
        assert tuple(tp[k].shape) == v.shape, k


def test_ssm_apply_matches_reference_and_naive():
    jcfg, tcfg = _cfgs("mamba2-2.7b")
    jp, tp = _params(jssm.ssm_params, jcfg)
    x = _x((2, 32, tcfg.d_model), 1)  # chunk 8: 4 chunks
    got = tssm.ssm_apply(tp, _t(x), tcfg)
    _close(got, jssm.ssm_apply(jp, jnp.asarray(x), jcfg))
    _close(got, tssm.ssd_naive(tp, _t(x), tcfg).numpy(), **ORACLE)


def _ssd_steps(x, bmat, cmat, dt, a, d_skip, *, q):
    """``ssm._ssd`` as the token-by-token recurrence, under autograd."""
    bsz, slen, h, pdim = x.shape
    rep = h // bmat.shape[2]
    xf = x.float()
    bf, cf = (m.float().repeat_interleave(rep, 2) for m in (bmat, cmat))
    state = torch.zeros(bsz, h, pdim, bmat.shape[3])
    ys = []
    for t in range(slen):
        state = state * torch.exp(dt[:, t] * a)[..., None, None] + \
            (dt[:, t, :, None] * xf[:, t])[..., None] * bf[:, t, :, None, :]
        ys.append((state * cf[:, t, :, None, :]).sum(-1) + xf[:, t] * d_skip[None, :, None])
    return torch.stack(ys, 1), state


def test_ssm_gradient_finite_at_full_width(monkeypatch):
    """mamba2-2.7b's own widths (80 heads, state 128), one chunk of 128
    tokens: the forward equals the reference's, and the gradient is finite
    and the step recurrence's (the mixer with its scan run token by token).
    The reference's is NaN: its
    ``where(tri, exp(seg), 0)`` overflows in the masked triangle (heads
    decay at up to 80 a unit of dt), and ``where``'s gradient there is
    0 * inf; the port takes exp of the causal triangle only."""
    jcfg = jconfigs.get_config("mamba2-2.7b").with_(dtype="float32")
    tcfg = tconfigs.get_config("mamba2-2.7b").with_(dtype="float32")
    jp, tp = _params(jssm.ssm_params, jcfg)
    x = _x((1, 128, tcfg.d_model), 2)
    w = _x((1, 128, tcfg.d_model), 3)
    tx = _t(x).requires_grad_()
    leaves = [tx] + [v.requires_grad_() for v in tp.values()]
    got = tssm.ssm_apply(tp, tx, tcfg)
    _close(got, jssm.ssm_apply(jp, jnp.asarray(x), jcfg))
    grads = torch.autograd.grad((got * _t(w)).sum(), leaves)
    assert all(bool(g.isfinite().all()) for g in grads)
    monkeypatch.setattr(tssm, "_ssd", _ssd_steps)
    oracle = torch.autograd.grad((tssm.ssm_apply(tp, tx, tcfg) * _t(w)).sum(), leaves)
    for name, g, o in zip(["x", *tp], grads, oracle):
        scale = float(o.abs().max())
        _close(g, o.numpy(), atol=ORACLE["atol"] * scale, rtol=ORACLE["rtol"], err_msg=name)
    jgrad = jax.grad(lambda p: jnp.sum(jssm.ssm_apply(p, jnp.asarray(x), jcfg) * w))(jp)
    assert np.isnan(np.asarray(jgrad["in_proj"])).any()


def test_ssm_apply_asserts_whole_chunks():
    _, tcfg = _cfgs("mamba2-2.7b")
    _, tp = _params(jssm.ssm_params, _cfgs("mamba2-2.7b")[0])
    with pytest.raises(AssertionError):
        tssm.ssm_apply(tp, _t(_x((1, 12, tcfg.d_model), 1)), tcfg)


def test_ssm_cache_continuation():
    """apply's cache equals the reference's, and the state after decoding
    every token of the same input."""
    jcfg, tcfg = _cfgs("mamba2-2.7b")
    jp, tp = _params(jssm.ssm_params, jcfg)
    x = _x((1, 16, tcfg.d_model), 2)
    _, (state, conv) = tssm.ssm_apply(tp, _t(x), tcfg, return_cache=True)
    _, (jstate, jconv) = jssm.ssm_apply(jp, jnp.asarray(x), jcfg, return_cache=True)
    _close(state, jstate)
    _close(conv, jconv)
    cache = tssm.ssm_init_cache(tcfg, 1, dtype=torch.float32, device="cpu")
    for t in range(16):
        tssm.ssm_decode(tp, _t(x[:, t : t + 1]), tcfg, cache)
    _close(state, cache[0].numpy(), **ORACLE)
    _close(conv, cache[1].numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("steps", [1, 12])
def test_ssm_decode_matches_reference(steps):
    """From a random state and conv tail: each step's output and the final
    cache, which the port updates in place."""
    jcfg, tcfg = _cfgs("mamba2-2.7b")
    jp, tp = _params(jssm.ssm_params, jcfg)
    shapes = [tuple(c.shape) for c in tssm.ssm_init_cache(tcfg, 2, device="meta")]
    state, conv = _x(shapes[0], 3, 0.5), _x(shapes[1], 4)
    jc = (jnp.asarray(state), jnp.asarray(conv))
    tc = (_t(state.copy()), _t(conv.copy()))
    x = _x((2, steps, tcfg.d_model), 5)
    for t in range(steps):
        jy, jc = jssm.ssm_decode(jp, jnp.asarray(x[:, t : t + 1]), jcfg, jc)
        ty, out = tssm.ssm_decode(tp, _t(x[:, t : t + 1]), tcfg, tc)
        assert out[0] is tc[0] and out[1] is tc[1]
        _close(ty, jy)
    _close(tc[0], jc[0])
    _close(tc[1], jc[1])


# -------------------------------------------------------------------- RG-LRU
def test_rglru_params_layout():
    jcfg = jconfigs.get_smoke("recurrentgemma-2b")
    jp, _ = split(jrglru.rglru_params(jax.random.key(0), jcfg))
    tp = trglru.rglru_params(torch.Generator().manual_seed(0),
                             tconfigs.get_smoke("recurrentgemma-2b"),
                             dtype=torch.bfloat16, device=torch.device("cpu"))
    assert tp.keys() == jp.keys()
    for k, v in jp.items():
        assert tuple(tp[k].shape) == v.shape, k
        assert str(tp[k].dtype).removeprefix("torch.") == str(v.dtype), k
    np.testing.assert_array_equal(tp["lam"].numpy(), np.asarray(jp["lam"]))


@pytest.mark.parametrize("slen", [12, 13])
def test_rglru_apply_matches_reference_and_naive(slen):
    """12 and 13 steps: the doubling scan on a power-of-two-free length."""
    jcfg, tcfg = _cfgs("recurrentgemma-2b")
    jp, tp = _params(jrglru.rglru_params, jcfg)
    x = _x((2, slen, tcfg.d_model), 1)
    got = trglru.rglru_apply(tp, _t(x), tcfg)
    _close(got, jrglru.rglru_apply(jp, jnp.asarray(x), jcfg))
    _close(got, trglru.rglru_naive(tp, _t(x), tcfg).numpy(), **ORACLE)


def test_rglru_cache_continuation():
    jcfg, tcfg = _cfgs("recurrentgemma-2b")
    jp, tp = _params(jrglru.rglru_params, jcfg)
    x = _x((1, 9, tcfg.d_model), 2)
    _, (h, conv) = trglru.rglru_apply(tp, _t(x), tcfg, return_cache=True)
    _, (jh, jconv) = jrglru.rglru_apply(jp, jnp.asarray(x), jcfg, return_cache=True)
    _close(h, jh)
    _close(conv, jconv)
    cache = trglru.rglru_init_cache(tcfg, 1, dtype=torch.float32, device="cpu")
    for t in range(9):
        trglru.rglru_decode(tp, _t(x[:, t : t + 1]), tcfg, cache)
    _close(h, cache[0].numpy(), **ORACLE)
    _close(conv, cache[1].numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("steps", [1, 12])
def test_rglru_decode_matches_reference(steps):
    jcfg, tcfg = _cfgs("recurrentgemma-2b")
    jp, tp = _params(jrglru.rglru_params, jcfg)
    shapes = [tuple(c.shape) for c in trglru.rglru_init_cache(tcfg, 2, device="meta")]
    h, conv = _x(shapes[0], 3, 0.5), _x(shapes[1], 4)
    jc = (jnp.asarray(h), jnp.asarray(conv))
    tc = (_t(h.copy()), _t(conv.copy()))
    x = _x((2, steps, tcfg.d_model), 5)
    for t in range(steps):
        jy, jc = jrglru.rglru_decode(jp, jnp.asarray(x[:, t : t + 1]), jcfg, jc)
        ty, out = trglru.rglru_decode(tp, _t(x[:, t : t + 1]), tcfg, tc)
        assert out[0] is tc[0] and out[1] is tc[1]
        _close(ty, jy)
    _close(tc[0], jc[0])
    _close(tc[1], jc[1])


def test_rglru_decay_bounded():
    """a_t in (0, 1), as the reference's test holds it: the recurrence can
    never blow up; and the gates equal the reference's."""
    jcfg, tcfg = _cfgs("recurrentgemma-2b")
    jp, tp = _params(jrglru.rglru_params, jcfg)
    x = _x((1, 8, tcfg.d_model), 3, 5.0)
    a, b = trglru._gates(tp, _t(x), tcfg.rglru.c_exponent)
    assert float(a.min()) > 0.0 and float(a.max()) < 1.0
    ja, jb = jrglru._gates(jp, jnp.asarray(x), jcfg.rglru.c_exponent)
    _close(a, ja)
    _close(b, jb)


def test_scan_matches_sequential():
    r = np.random.default_rng(6)
    a = r.uniform(0.1, 0.99, (2, 21, 5)).astype(np.float32)
    b = r.standard_normal((2, 21, 5)).astype(np.float32)
    h, want = np.zeros((2, 5), np.float32), []
    for t in range(21):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    _close(trglru._scan(_t(a), _t(b)), np.stack(want, 1), 1e-6)


# --------------------------------------------------------------------- local
def _local_aux(positions, j):
    return {"positions": jnp.asarray(positions) if j else _t(positions), "chunk": 8}


def test_local_block_past_its_window():
    """S = 40 at SMOKE's window of 32: forward attends within the window;
    prefill of 36 tokens wraps the ring; 4 decode steps continue it.  Each
    against the reference's block, and decode against forward."""
    jcfg, tcfg = _cfgs("recurrentgemma-2b")
    w = tcfg.window
    assert w == 32
    jp, tp = _params(jblocks.block_params, jcfg, "local")
    x = _x((2, 40, tcfg.d_model), 7, 1.0)
    pos = np.broadcast_to(np.arange(40), (2, 40)).copy()
    kw = dict(kind="local", want_cache=False)
    want, _, _ = jblocks.block_apply(jp, jnp.asarray(x), cfg=jcfg, aux=_local_aux(pos, 1), **kw)
    got, _, _ = tblocks.block_apply(tp, _t(x), cfg=tcfg, aux=_local_aux(pos, 0), **kw)
    _close(got, want)
    full, _, _ = tblocks.block_apply(tp, _t(x), cfg=tcfg.with_(window=0), aux=_local_aux(pos, 0),
                                     kind="attn", want_cache=False)
    assert float((got - full).abs().max()) > 1e-3  # the window changed the result

    s0 = 36
    kw = dict(kind="local", want_cache=True)
    _, _, jc = jblocks.block_apply(jp, jnp.asarray(x[:, :s0]), cfg=jcfg,
                                   aux=_local_aux(pos[:, :s0], 1), **kw)
    _, _, tc = tblocks.block_apply(tp, _t(x[:, :s0]), cfg=tcfg,
                                   aux=_local_aux(pos[:, :s0], 0), **kw)
    assert tuple(tc[0].shape) == (2, w, tcfg.n_kv_heads, tcfg.head_dim_)
    _close(tc[0], jc[0])
    _close(tc[1], jc[1])
    for i in range(s0, 40):
        step = pos[:, i : i + 1]
        jy, jc = jblocks.block_decode(jp, jnp.asarray(x[:, i : i + 1]), kind="local", cfg=jcfg,
                                      aux=_local_aux(step, 1), cache=jc, pos=jnp.int32(i))
        ty, tc = tblocks.block_decode(tp, _t(x[:, i : i + 1]), kind="local", cfg=tcfg,
                                      aux=_local_aux(step, 0), cache=tc, pos=i)
        _close(ty, jy)
        _close(ty, got[:, i : i + 1].numpy(), 1e-4)
    _close(tc[0], jc[0])


def test_gated_norm_matches():
    r = np.random.default_rng(8)
    y, z = (r.standard_normal((2, 3, 32)).astype(np.float32) for _ in range(2))
    g = r.standard_normal(32).astype(np.float32) * 0.1
    _close(tssm._gated_norm(_t(y), _t(z), _t(g), 1e-6),
           jssm._gated_norm(jnp.asarray(y), jnp.asarray(z), jnp.asarray(g), 1e-6))
    # rounded back to the input's dtype, as the reference does
    assert tssm._gated_norm(_t(y).bfloat16(), _t(z), _t(g), 1e-6).dtype == torch.bfloat16
