"""The port's MoE layer (``repro_torch.models.moe``) and MLA attention
(``repro_torch.models.attention``) against the JAX reference on the CPU.

Inputs are made with numpy from a seed; parameters come from the
reference's ``moe_params``/``lm.init`` and cross through
``repro_torch.models.bridge``.  The dispatch is held apart from routing:
both ``moe_apply``s get the reference's ``top_i``/``top_w``, since the two
frameworks' matmuls sum in other orders and a near-tie in the router could
flip one expert.  ``route`` is held on inputs whose logits are exact in both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.checkpoint.store import _flatten
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models.config import MoEConfig as JMoEConfig
from repro.models.layers import split
import repro_torch.configs as tconfigs
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models.bridge import params_from_flat
from repro_torch.models.config import MoEConfig as TMoEConfig

torch.set_num_threads(1)

MOE = ["moonshot-v1-16b-a3b", "deepseek-v3-671b"]
TOL = 2e-5  # f32, the reference's own MoE tolerance (tests/test_moe.py)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _cfgs(arch, cf=None):
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    if cf is not None:
        jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
        tcfg = tcfg.with_(moe=dataclasses.replace(tcfg.moe, capacity_factor=cf))
    return jcfg, tcfg


def _moe_setup(arch, cf, dtype=jnp.float32, shape=(2, 16)):
    """(cfgs, reference params, port params, x as numpy), as
    ``tests/test_moe.py::_setup`` builds them."""
    jcfg, tcfg = _cfgs(arch, cf)
    jp, _ = split(jmoe.moe_params(jax.random.key(0), jcfg))
    jp = jax.tree.map(lambda a: a.astype(dtype) if a.dtype == jnp.bfloat16 else a, jp)
    tp = params_from_flat(_flatten(jp), device="cpu", dtype=getattr(torch, jnp.dtype(dtype).name))
    x = (np.random.default_rng(1).standard_normal((*shape, jcfg.d_model)) * 0.5).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


# -------------------------------------------------------------------- route
@pytest.mark.parametrize("e,k", [(8, 2), (64, 6), (256, 8)])
def test_route_matches_on_the_same_logits(e, k):
    """An identity router makes the logits the input itself in both
    frameworks; the input has many exact ties (multiples of 0.5), which
    both break towards the lower expert id."""
    x = (np.random.default_rng(e).integers(-4, 5, (2, 12, e)) * 0.5).astype(np.float32)
    w = np.eye(e, dtype=np.float32)
    ji, jw, jp = jmoe.route(jnp.asarray(w), jnp.asarray(x),
                            JMoEConfig(num_experts=e, top_k=k, d_expert=8))
    ti, tw, tp = tmoe.route(_t(w), _t(x), TMoEConfig(num_experts=e, top_k=k, d_expert=8))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tw, jw, 1e-6)
    _close(tp, jp, 1e-6)
    assert tw.dtype == torch.float32 and tp.dtype == torch.float32


def test_route_weights_take_the_activation_dtype():
    jcfg, tcfg, jp, tp, x = _moe_setup("moonshot-v1-16b-a3b", 8.0)
    ti, tw, probs = tmoe.route(tp["router"], _t(x).bfloat16(), tcfg.moe)
    assert tw.dtype == torch.bfloat16 and probs.dtype == torch.float32
    assert tuple(ti.shape) == (2, 16, tcfg.moe.top_k)


def test_aux_loss_balanced_and_collapsed_match():
    """The cases of ``tests/test_moe.py::test_aux_loss_balanced_vs_collapsed``."""
    jcfg, tcfg = _cfgs("moonshot-v1-16b-a3b", 8.0)
    e, k = tcfg.moe.num_experts, tcfg.moe.top_k
    probs = np.full((2, 16, e), 1.0 / e, np.float32)
    top_i = np.tile(np.arange(k)[None, None], (2, 16, 1))
    probs_c = np.zeros((2, 16, e), np.float32)
    probs_c[..., 0] = 1.0
    top_c = np.zeros_like(top_i)
    got = [float(tmoe.aux_load_balance_loss(_t(p), _t(i), tcfg.moe))
           for p, i in ((probs, top_i), (probs_c, top_c))]
    want = [float(jmoe.aux_load_balance_loss(jnp.asarray(p), jnp.asarray(i), jcfg.moe))
            for p, i in ((probs, top_i), (probs_c, top_c))]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[1] > got[0]


# ----------------------------------------------------------------- dispatch
def _kept(apply, top_i, top_w):
    """[B, S, k] bool: pick j of a token is kept iff routing the token to
    that pick alone (weight 1) gives a non-zero row."""
    k = top_i.shape[-1]
    kept = []
    for j in range(k):
        one = np.zeros(top_w.shape, np.float32)
        one[..., j] = 1.0
        kept.append(np.abs(np.asarray(apply(one), np.float32)).max(-1) > 0)
    return np.stack(kept, -1)


@pytest.mark.parametrize("cf", [8.0, 1.0, 1e-6])
def test_moe_apply_matches_given_routing(cf):
    """The reference's routing into both dispatches: the same pairs are
    dropped at capacity factor 8 (none), 1.0 (some) and 1e-6 (one slot an
    expert), and every row agrees within 2e-5."""
    jcfg, tcfg, jp, tp, x = _moe_setup("moonshot-v1-16b-a3b", cf)
    ji, jw, _ = jmoe.route(jp["router"], jnp.asarray(x), jcfg.moe)
    top_i, top_w = np.asarray(ji), np.asarray(jw)
    want = jmoe.moe_apply(jp, jnp.asarray(x), ji, jw, jcfg, ctx=None)
    got = tmoe.moe_apply(tp, _t(x), _t(top_i).long(), _t(top_w), tcfg)
    _close(got, want, TOL)
    kept_j = _kept(lambda w: jmoe.moe_apply(jp, jnp.asarray(x), ji, jnp.asarray(w), jcfg), top_i, top_w)
    kept_t = _kept(lambda w: tmoe.moe_apply(tp, _t(x), _t(top_i).long(), _t(w), tcfg), top_i, top_w)
    np.testing.assert_array_equal(kept_t, kept_j)
    t = x.shape[0] * x.shape[1]
    cap = int(np.ceil(t * tcfg.moe.top_k / tcfg.moe.num_experts * cf))
    assert kept_t.sum() == np.minimum(np.bincount(top_i.reshape(-1), minlength=8), cap).sum()
    if cf == 8.0:
        assert kept_t.all()
    else:
        assert not kept_t.all()


def test_moe_apply_bf16_matches_and_repeats():
    """bf16 with the reference's routing: within a bf16 ulp of the
    reference's rows, and the same bits on a second run."""
    jcfg, tcfg, jp, tp, x = _moe_setup("moonshot-v1-16b-a3b", 1.0, dtype=jnp.bfloat16)
    assert tp["router"].dtype == torch.float32 and tp["w1"].dtype == torch.bfloat16
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    ji, jw, _ = jmoe.route(jp["router"], jx, jcfg.moe)
    want = jmoe.moe_apply(jp, jx, ji, jw, jcfg)
    tx, ti, tw = _t(x).bfloat16(), _t(np.asarray(ji)).long(), _t(np.asarray(jw.astype(jnp.float32))).bfloat16()
    got = tmoe.moe_apply(tp, tx, ti, tw, tcfg)
    assert got.dtype == torch.bfloat16
    w = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), w, atol=2 ** -7 * np.abs(w).max(), rtol=2 ** -7)
    assert torch.equal(got, tmoe.moe_apply(tp, tx, ti, tw, tcfg))


@pytest.mark.parametrize("arch", MOE)
def test_shared_expert_and_dense_oracle_match(arch):
    """moe_apply (with deepseek's shared expert) and the all-experts oracle
    against the reference's, and against each other with no drops."""
    jcfg, tcfg, jp, tp, x = _moe_setup(arch, 8.0, shape=(1, 8))
    assert ("ws1" in tp) == (arch == "deepseek-v3-671b")
    ji, jw, _ = jmoe.route(jp["router"], jnp.asarray(x), jcfg.moe)
    got = tmoe.moe_apply(tp, _t(x), _t(np.asarray(ji)).long(), _t(np.asarray(jw)), tcfg)
    _close(got, jmoe.moe_apply(jp, jnp.asarray(x), ji, jw, jcfg), TOL)
    oracle = tmoe.moe_dense_ref(tp, _t(x), tcfg)
    _close(oracle, jmoe.moe_dense_ref(jp, jnp.asarray(x), jcfg), TOL)
    _close(got, oracle.numpy(), TOL)


def test_moe_apply_takes_a_mesh_free_context():
    """A context without a mesh is the one-device dispatch, bit for bit
    (the expert-parallel layouts on a mesh: ``tests/test_torch_sharding.py``)."""
    class Ctx:
        mesh = None

    jcfg, tcfg, jp, tp, x = _moe_setup("moonshot-v1-16b-a3b", 1.0)
    top_i, top_w, _ = tmoe.route(tp["router"], _t(x), tcfg.moe)
    want = tmoe.moe_apply(tp, _t(x), top_i, top_w, tcfg)
    assert torch.equal(tmoe.moe_apply(tp, _t(x), top_i, top_w, tcfg, ctx=Ctx()), want)


# ---------------------------------------------------------------------- MLA
def _mla_layer():
    """deepseek SMOKE in f32: (cfgs, reference params, port params) of the
    first layer's attention."""
    jcfg = jconfigs.get_smoke("deepseek-v3-671b").with_(dtype="float32")
    tcfg = tconfigs.get_smoke("deepseek-v3-671b").with_(dtype="float32")
    jp, _ = jlm.init(jcfg, jax.random.key(0))
    jpa = jax.tree.map(lambda a: a[0].astype(jnp.float32), jp["groups"][0]["b0"]["attn"])
    # the reference's norms start at zero; give them values so they count
    r = np.random.default_rng(3)
    jpa = {k: (jnp.asarray(r.standard_normal(v.shape).astype(np.float32) * 0.1)
               if "norm" in k else v) for k, v in jpa.items()}
    tpa = params_from_flat(_flatten(jpa), device="cpu", dtype=torch.float32)
    return jcfg, tcfg, jpa, tpa


@pytest.mark.parametrize("chunk", [4, 16])
def test_mla_attend_matches(chunk):
    jcfg, tcfg, jpa, tpa = _mla_layer()
    r = np.random.default_rng(4)
    x = r.standard_normal((2, 12, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12)[None], (2, 12)).copy()
    want, (wc, wk) = jattn.mla_attend(jpa, jnp.asarray(x), jcfg, jnp.asarray(pos),
                                      chunk=chunk, return_cache=True)
    got, (gc, gk) = tattn.mla_attend(tpa, _t(x), tcfg, _t(pos), chunk=chunk, return_cache=True)
    _close(got, want, TOL)
    _close(gc, wc, TOL)
    _close(gk, wk, TOL)
    assert tuple(gc.shape) == (2, 12, tcfg.mla.kv_lora_rank)
    assert tuple(gk.shape) == (2, 12, tcfg.mla.qk_rope_dim)


@pytest.mark.parametrize("pos", [0, 5, 9])
def test_mla_decode_matches(pos):
    """Absorbed decode against a random compressed cache of 10 rows, the new
    row written in place at ``pos`` (9 is the last slot); one past the
    cache raises instead of the reference's silent clamp."""
    jcfg, tcfg, jpa, tpa = _mla_layer()
    m = tcfg.mla
    r = np.random.default_rng(5)
    x = r.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    cc = r.standard_normal((2, 10, m.kv_lora_rank)).astype(np.float32)
    ck = r.standard_normal((2, 10, m.qk_rope_dim)).astype(np.float32)
    want, (wc, wk) = jattn.mla_decode(jpa, jnp.asarray(x), jcfg,
                                      (jnp.asarray(cc), jnp.asarray(ck)), jnp.int32(pos))
    tc, tk = _t(cc.copy()), _t(ck.copy())
    got, (gc, gk) = tattn.mla_decode(tpa, _t(x), tcfg, (tc, tk), pos)
    _close(got, want, TOL)
    _close(gc, wc, TOL)
    _close(gk, wk, TOL)
    assert gc is tc and gk is tk
    with pytest.raises(IndexError):
        tattn.mla_decode(tpa, _t(x), tcfg, (tc, tk), 10)


def test_mla_decode_equals_attend_at_the_last_position():
    """The absorbed form against the expanded one on the port alone: the
    cache prefill returns, then one decode step at the next position."""
    _, tcfg, _, tpa = _mla_layer()
    x = _t(np.random.default_rng(6).standard_normal((1, 9, tcfg.d_model)).astype(np.float32))
    pos = torch.arange(9)[None]
    full = tattn.mla_attend(tpa, x, tcfg, pos, chunk=4)
    _, (c, k) = tattn.mla_attend(tpa, x[:, :8], tcfg, pos[:, :8], chunk=4, return_cache=True)
    cache = tuple(torch.nn.functional.pad(a, (0, 0, 0, 1)) for a in (c, k))
    y, _ = tattn.mla_decode(tpa, x[:, 8:], tcfg, cache, 8)
    torch.testing.assert_close(y, full[:, 8:], atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------- init and bridge
def test_bridged_router_stays_f32():
    jp, _ = jlm.init(jconfigs.get_smoke("deepseek-v3-671b"), jax.random.key(0))
    tp = params_from_flat(_flatten(jp), device="cpu", dtype=torch.bfloat16)
    moe = tp["groups"][1]["b0"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert tp["mtp"]["block"]["moe"]["router"].dtype == torch.float32
    assert moe["w1"].dtype == torch.bfloat16
    np.testing.assert_array_equal(moe["router"].numpy(),
                                  np.asarray(jp["groups"][1]["b0"]["moe"]["router"]))


def test_stacked_draw_is_bounded_by_one_layer(monkeypatch):
    """A [layers, ...] bf16 stack is drawn through f32 temporaries of at
    most one layer each (and at most ``_DRAW_CHUNK`` elements), never as
    one f32 stack; the result is bf16, seeded and in the truncated range."""
    sizes = []
    draw = torch.nn.init.trunc_normal_

    def spy(t, *a, **kw):
        assert t.dtype == torch.float32
        sizes.append(t.numel())
        return draw(t, *a, **kw)

    monkeypatch.setattr(torch.nn.init, "trunc_normal_", spy)
    shape = (8, 64, 96)  # moonshot SMOKE's w1, per layer
    cpu = torch.device("cpu")
    w = tlayers.param(torch.Generator().manual_seed(0), shape, layers=3, device=cpu)
    assert w.dtype == torch.bfloat16 and tuple(w.shape) == (3, *shape)
    assert sizes == [8 * 64 * 96] * 3
    again = tlayers.param(torch.Generator().manual_seed(0), shape, layers=3, device=cpu)
    assert torch.equal(w, again)
    assert w.float().abs().max() <= 3 / np.sqrt(8) + 1e-2
    monkeypatch.setattr(tlayers, "_DRAW_CHUNK", 1000)
    sizes.clear()
    tlayers.param(torch.Generator(), (10, 300), layers=2, device=cpu)
    assert max(sizes) == 1000 and sum(sizes) == 2 * 10 * 300
