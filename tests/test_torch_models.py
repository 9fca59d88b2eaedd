"""The port's model stack (``repro_torch.models``, ``repro_torch.configs``):
the dense family, the MoE/MLA family and the recurrent families (Mamba-2
SSD; RG-LRU with local attention), against the JAX reference on the CPU;
the init trees and counts of the enc-dec and VLM families (their parity is
in ``tests/test_torch_encdec.py`` and ``tests/test_torch_vlm.py``).

Inputs are made with numpy from a seed; parameters come from
``repro.models.lm.init`` and cross through ``repro_torch.models.bridge`` in
the reference's checkpoint format (``repro.checkpoint.store._flatten``), so
the two frameworks' random generators are never compared.  f32 cases widen
the reference's bf16 parameters as ``tests/test_decode_consistency.py`` does.
"""

import dataclasses
from collections import deque
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.checkpoint.store import _flatten
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import moe as jmoe
import repro_torch.configs as tconfigs
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models.bridge import flatten, params_from_flat

# SMOKE-size tensors: one intra-op thread is as fast, and leaves the other
# test workers' cores (and their timing-sensitive threads) alone.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
DENSE = ["phi4-mini-3.8b", "minitron-4b", "mistral-nemo-12b", "qwen1.5-32b"]
MOE = ["moonshot-v1-16b-a3b", "deepseek-v3-671b"]
RECURRENT = ["mamba2-2.7b", "recurrentgemma-2b"]
FRONTEND = ["seamless-m4t-medium", "qwen2-vl-2b"]  # enc-dec (audio stub), VLM (vision stub)
S = 16  # sequence length of the model comparisons
F32_TOL = 1e-4  # logits, f32: summation order of CPU matmuls differs
BF16_TOL = 0.02  # logits, bf16: a few bf16 ulps (2^-8 at 0.5); observed max 0.0056


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _f32(tree):
    return jax.tree.map(
        lambda x: x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x, tree
    )


def _models(arch, dtype="float32", **overrides):
    """(cfg for the reference, same cfg for the port, JAX params, port params)."""
    jcfg = jconfigs.get_smoke(arch).with_(dtype=dtype, **overrides)
    tcfg = tconfigs.get_smoke(arch).with_(dtype=dtype, **overrides)
    jp, _ = jlm.init(jcfg, jax.random.key(0))
    if dtype == "float32":
        jp = _f32(jp)
    tp = params_from_flat(_flatten(jp), device="cpu", dtype=getattr(torch, dtype))
    return jcfg, tcfg, jp, tp


def _tokens(cfg, b=2, s=S, seed=1):
    return _rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _close_trees(got, want, tol):
    g, w = flatten(got), _flatten(want)
    assert g.keys() == w.keys()
    for k in w:
        assert tuple(g[k].shape) == w[k].shape, k
        _close(g[k], w[k], tol)


# ----------------------------------------------------------------- registry
def test_config_module_is_a_copy():
    ours = ROOT / "src" / "repro_torch" / "models" / "config.py"
    assert ours.read_bytes() == (ROOT / "src" / "repro" / "models" / "config.py").read_bytes()


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_modules_match(arch):
    mod = arch.replace("-", "_").replace(".", "_") + ".py"
    ours = (ROOT / "src" / "repro_torch" / "configs" / mod).read_text().splitlines()
    theirs = (ROOT / "src" / "repro" / "configs" / mod).read_text().splitlines()
    diff = [(a, b) for a, b in zip(ours, theirs) if a != b]
    assert len(ours) == len(theirs)
    assert [a for a, _ in diff] == [b.replace("from repro.", "from repro_torch.") for _, b in diff]
    assert len(diff) == 1 and diff[0][0].startswith("from repro_torch.models.config import")
    for get in ("get_config", "get_smoke"):
        assert dataclasses.asdict(getattr(tconfigs, get)(arch)) == \
            dataclasses.asdict(getattr(jconfigs, get)(arch))


def test_registry_matches():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert tconfigs.cells(include_skipped=True) == jconfigs.cells(include_skipped=True)
    assert set(tconfigs.__all__) == set(jconfigs.__all__) - {"input_specs"}


@pytest.mark.parametrize("arch", DENSE + MOE + RECURRENT + FRONTEND)
def test_param_count_matches(arch):
    full = jconfigs.get_config(arch)
    assert tlm.param_count(tconfigs.get_config(arch)) == jlm.param_count(full)
    assert tconfigs.get_smoke(arch).param_count() == jconfigs.get_smoke(arch).param_count()
    for get in (jconfigs.get_config, jconfigs.get_smoke):
        want = jlm.param_count(get(arch), active_only=True)
        assert tlm.param_count(getattr(tconfigs, get.__name__)(arch), active_only=True) == want


def test_moe_full_counts():
    """moonshot-v1-16b-a3b whole: 28,057,995,264 parameters (56.12 GB in
    bf16), 3,974,301,696 active; deepseek-v3-671b at 4 layers without MTP
    (the card's cut): 15,111,101,440."""
    moon = tconfigs.get_config("moonshot-v1-16b-a3b")
    assert moon.param_count() == 28_057_995_264
    assert moon.active_param_count() == 3_974_301_696
    ds4 = tconfigs.get_config("deepseek-v3-671b").with_(n_layers=4, mtp=False)
    assert ds4.param_count() == 15_111_101_440 == jlm.param_count(
        jconfigs.get_config("deepseek-v3-671b").with_(n_layers=4, mtp=False))


def test_recurrent_full_counts():
    """At full width and depth, on the ``meta`` device: mamba2-2.7b
    2,702,599,680 parameters (5.41 GB in bf16), recurrentgemma-2b
    2,894,574,080 (5.79 GB)."""
    assert tconfigs.get_config("mamba2-2.7b").param_count() == 2_702_599_680
    assert tconfigs.get_config("recurrentgemma-2b").param_count() == 2_894_574_080


def test_frontend_full_counts():
    """At full width and depth: seamless-m4t-medium 877,099,008 parameters
    (12 encoder and 12 decoder layers; 1.75 GB in bf16), qwen2-vl-2b
    1,777,088,000 (28 layers; 3.55 GB); every one of them active."""
    for arch, n in (("seamless-m4t-medium", 877_099_008), ("qwen2-vl-2b", 1_777_088_000)):
        cfg = tconfigs.get_config(arch)
        assert cfg.param_count() == cfg.active_param_count() == n
        assert n == jlm.param_count(jconfigs.get_config(arch), active_only=True)


def test_phi4_full_width_count():
    """4,450,618,368 parameters: 8.90 GB in bf16."""
    assert tconfigs.get_config("phi4-mini-3.8b").param_count() == 4_450_618_368


@pytest.mark.parametrize("arch", DENSE)
def test_init_tree_matches_reference_layout(arch):
    cfg = tconfigs.get_smoke(arch)
    ours = flatten(tlm.init(cfg, torch.Generator().manual_seed(0), device="cpu"))
    theirs = _flatten(jlm.init(jconfigs.get_smoke(arch), jax.random.key(0))[0])
    assert ours.keys() == theirs.keys()
    for k, t in ours.items():
        assert tuple(t.shape) == theirs[k].shape, k
        assert t.dtype == torch.bfloat16
        if "norm" in k or k.endswith(("/bq", "/bk", "/bv")):
            assert not t.any(), k  # zero-initialised, as in the reference
    # fan-in std, truncated at 3 std: the reference's distribution, not its bits
    w = ours["groups/0/b0/mlp/w_gate"].float()
    std = 1.0 / np.sqrt(cfg.d_model)
    assert w.abs().max() <= 3 * std + 1e-3
    assert abs(w.std().item() - std * 0.986) < 0.15 * std


def _ref_dtypes(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): leaf.dtype
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", MOE)
def test_moe_init_tree_matches_reference_layout(arch):
    """The MoE/MLA tree, deepseek's ``mtp`` module included: the reference's
    paths and shapes, the router in f32 and the rest in bf16, as the
    reference stores them."""
    cfg = tconfigs.get_smoke(arch)
    ours = flatten(tlm.init(cfg, torch.Generator().manual_seed(0), device="cpu"))
    jp = jlm.init(jconfigs.get_smoke(arch), jax.random.key(0))[0]
    theirs, dtypes = _flatten(jp), _ref_dtypes(jp)
    assert ours.keys() == theirs.keys()
    assert any(k.startswith("mtp/") for k in ours) == cfg.mtp
    for k, t in ours.items():
        assert tuple(t.shape) == theirs[k].shape, k
        assert str(t.dtype).removeprefix("torch.") == str(dtypes[k]), k
        if "norm" in k:
            assert not t.any(), k
    assert ours["groups/0/b0/norm1"].dtype == torch.bfloat16
    routers = [k for k in ours if k.endswith("/router")]
    assert routers and all(ours[k].dtype == torch.float32 for k in routers)
    # the experts' fan-in is shape[0] of one layer's [E, d, f]: num_experts
    w1 = ours[next(k for k in ours if k.endswith("moe/w1"))].float()
    assert w1.abs().max() <= 3 / np.sqrt(cfg.moe.num_experts) + 1e-2


def test_init_is_seeded():
    cfg = tconfigs.get_smoke("phi4-mini-3.8b")
    a = flatten(tlm.init(cfg, torch.Generator().manual_seed(3), device="cpu"))
    b = flatten(tlm.init(cfg, torch.Generator().manual_seed(3), device="cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("arch", FRONTEND)
def test_other_families_name_their_roadmap_item(arch):
    """The enc-dec and VLM trees, at SMOKE size and, on the ``meta``
    device, at full width: the reference's paths and shapes (seamless's
    ``enc_groups``, ``enc_norm`` and the ``xdec`` blocks' ``normx`` and
    ``xattn``, its plain ``w_in``/``w_out`` MLP; qwen2-vl's q/k/v biases),
    all in bf16, norms and biases zero."""
    cfg = tconfigs.get_smoke(arch)
    ours = flatten(tlm.init(cfg, torch.Generator().manual_seed(0), device="cpu"))
    theirs = _flatten(jlm.init(jconfigs.get_smoke(arch), jax.random.key(0))[0])
    assert ours.keys() == theirs.keys()
    for k, t in ours.items():
        assert tuple(t.shape) == theirs[k].shape, k
        assert t.dtype == torch.bfloat16, k
        if "norm" in k or k.endswith(("/bq", "/bk", "/bv")):
            assert not t.any(), k
    full = tconfigs.get_config(arch)
    meta = flatten(tlm.init(full, None, device="meta"))
    shapes, _ = jlm.init_shapes(jconfigs.get_config(arch))
    want = {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert {k: tuple(t.shape) for k, t in meta.items()} == want
    if cfg.enc_layers:
        assert ours["groups/0/b0/mlp/w_in"].shape == (cfg.n_layers, cfg.d_model, cfg.d_ff)
        assert ours["enc_groups/0/b0/attn/wq"].shape[0] == cfg.enc_layers
    else:
        assert any(k.endswith("/attn/bq") for k in ours)


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: a CUDA request is served")
    cfg = tconfigs.get_smoke("phi4-mini-3.8b")
    with pytest.raises(RuntimeError, match="cuda"):
        tlm.init(cfg, torch.Generator())  # default device is cuda
    with pytest.raises(RuntimeError, match="cuda"):
        tlm.init_caches(cfg, 1, 8)


# ------------------------------------------------------------------- layers
def test_rms_norm_matches():
    x = _rng(0).standard_normal((2, 5, 48)).astype(np.float32) * 3
    g = _rng(1).standard_normal(48).astype(np.float32) * 0.1
    _close(tlayers.rms_norm(_t(x), _t(g), 1e-6),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-6), 1e-5)


def test_dense_and_softcap_match():
    r = _rng(2)
    x = r.standard_normal((2, 3, 16)).astype(np.float32)
    w = r.standard_normal((16, 24)).astype(np.float32) / 4
    b = r.standard_normal(24).astype(np.float32)
    _close(tlayers.dense(_t(x), _t(w), _t(b)),
           jlayers.dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)), 1e-5)
    _close(tlayers.dense(_t(x), _t(w)), jlayers.dense(jnp.asarray(x), jnp.asarray(w)), 1e-5)
    y = r.standard_normal((4, 7)).astype(np.float32) * 40
    for cap in (0.0, 30.0):
        _close(tlayers.softcap(_t(y), cap), jlayers.softcap(jnp.asarray(y), cap), 1e-5)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_gated_mlps_match(act):
    r = _rng(3)
    x = r.standard_normal((2, 3, 16)).astype(np.float32)
    wg, wu = (r.standard_normal((16, 32)).astype(np.float32) / 4 for _ in range(2))
    wd = r.standard_normal((32, 16)).astype(np.float32) / 6
    _close(tlayers.swiglu(_t(x), _t(wg), _t(wu), _t(wd), act),
           jlayers.swiglu(*map(jnp.asarray, (x, wg, wu, wd)), act), 1e-5)
    win = np.concatenate([wg, wu], 1)
    _close(tlayers.geglu_mlp(_t(x), _t(win), _t(wd), act),
           jlayers.geglu_mlp(*map(jnp.asarray, (x, win, wd)), act), 1e-5)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches(theta):
    r = _rng(4)
    x = r.standard_normal((2, 6, 3, 16)).astype(np.float32)
    pos = r.integers(0, 200, (2, 6))
    _close(tlayers.rope(_t(x), _t(pos), theta),
           jlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta), 1e-5)


def test_mrope_matches():
    r = _rng(5)
    x = r.standard_normal((2, 6, 3, 16)).astype(np.float32)
    pos = r.integers(0, 50, (3, 2, 6))
    _close(tlayers.mrope(_t(x), _t(pos), 1e6, (2, 3, 3)),
           jlayers.mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, (2, 3, 3)), 1e-5)


# ---------------------------------------------------------------- attention
@pytest.mark.parametrize("sq,sk,h,hkv,d,causal,window,chunk", [
    (8, 8, 4, 4, 16, True, 0, 4),       # MHA causal
    (8, 8, 4, 1, 16, True, 0, 8),       # MQA
    (16, 16, 8, 2, 8, True, 0, 4),      # GQA, several chunks
    (8, 8, 4, 2, 16, False, 0, 4),      # bidirectional (encoder)
    (16, 16, 4, 2, 8, True, 6, 4),      # sliding window
    (12, 12, 2, 2, 8, True, 0, 5),      # chunk doesn't divide seq
    (1, 16, 4, 2, 8, True, 0, 16),      # single query vs long keys
])
def test_flash_attention_matches(sq, sk, h, hkv, d, causal, window, chunk):
    r = _rng(6)
    q = r.standard_normal((2, sq, h, d)).astype(np.float32)
    k = r.standard_normal((2, sk, hkv, d)).astype(np.float32)
    v = r.standard_normal((2, sk, hkv, d)).astype(np.float32)
    got = tattn.flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window, chunk=chunk)
    want = jattn.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                 window=window, chunk=chunk)
    _close(got, want, 2e-5)


def test_flash_attention_q_offset_matches():
    r = _rng(7)
    q = r.standard_normal((1, 4, 2, 8)).astype(np.float32)
    k = r.standard_normal((1, 12, 2, 8)).astype(np.float32)
    v = r.standard_normal((1, 12, 2, 8)).astype(np.float32)
    got = tattn.flash_attention(_t(q), _t(k), _t(v), causal=True, chunk=4, q_offset=8)
    want = jattn.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True, chunk=4, q_offset=8)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("arch,window,pos", [
    ("phi4-mini-3.8b", 0, 9), ("qwen1.5-32b", 0, 9),
    ("phi4-mini-3.8b", 10, 23),  # ring buffer: slot 23 % 10, the last one
])
def test_gqa_decode_at_last_slot_matches(arch, window, pos):
    """pos lands in slot cache_len - 1, the last one; without a window one
    past it raises instead of the reference's silent clamp."""
    jcfg, tcfg, jp, tp = _models(arch)
    jpa = jax.tree.map(lambda a: a[0], jp["groups"][0]["b0"]["attn"])
    tpa = {k: v[0] for k, v in tp["groups"][0]["b0"]["attn"].items()}
    r = _rng(8)
    cache_len = 10
    x = r.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    shape = (2, cache_len, tcfg.n_kv_heads, tcfg.head_dim_)
    ck, cv = (r.standard_normal(shape).astype(np.float32) for _ in range(2))
    positions = np.full((2, 1), pos)
    want, (wk, wv) = jattn.gqa_decode(
        jpa, jnp.asarray(x), jcfg,
        lambda a: jlayers.rope(a, jnp.asarray(positions), jcfg.rope_theta),
        (jnp.asarray(ck), jnp.asarray(cv)), jnp.int32(pos), window=window)
    tk, tv = _t(ck.copy()), _t(cv.copy())
    rope_fn = lambda a: tlayers.rope(a, _t(positions), tcfg.rope_theta)  # noqa: E731
    got, (gk, gv) = tattn.gqa_decode(tpa, _t(x), tcfg, rope_fn, (tk, tv), pos, window=window)
    _close(got, want, 2e-5)
    _close(gk, wk, 2e-5)
    _close(gv, wv, 2e-5)
    assert gk is tk  # written in place
    if not window:
        with pytest.raises(IndexError):
            tattn.gqa_decode(tpa, _t(x), tcfg, rope_fn, (tk, tv), cache_len)


# -------------------------------------------------------------------- model
@pytest.mark.parametrize("arch", DENSE + MOE)
def test_forward_matches(arch):
    """Logits and the aux loss (the MoE load-balance loss summed over
    layers; 0 for dense models)."""
    jcfg, tcfg, jp, tp = _models(arch)
    toks = _tokens(tcfg)
    want, want_aux = jlm.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg, chunk=8)
    got, aux = tlm.forward(tp, {"tokens": _t(toks).long()}, tcfg, chunk=8)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-6, abs=0.0)
    assert (float(aux) > 0) == (arch in MOE)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_prefill_caches_and_continuation_match(arch):
    """prefill logits and caches, pad_caches, then decode steps continuing
    from the prompt, each against the reference."""
    jcfg, tcfg, jp, tp = _models(arch)
    toks = _tokens(tcfg)
    s0 = 10
    jl, jc = jlm.prefill(jp, {"tokens": jnp.asarray(toks[:, :s0])}, jcfg, chunk=4)
    tl, tc = tlm.prefill(tp, {"tokens": _t(toks[:, :s0]).long()}, tcfg, chunk=4)
    _close(tl, jl, F32_TOL)
    _close_trees(tc, jc, F32_TOL)
    jc, tc = jlm.pad_caches(jc, jcfg, S), tlm.pad_caches(tc, tcfg, S)
    _close_trees(tc, jc, F32_TOL)
    jstep = jax.jit(lambda p, t, c, i: jlm.decode_step(p, t, c, i, jcfg))
    for i in range(s0, S):
        jl, jc = jstep(jp, jnp.asarray(toks[:, i : i + 1]), jc, jnp.int32(i))
        tl, tc = tlm.decode_step(tp, _t(toks[:, i : i + 1]).long(), tc, i, tcfg)
        _close(tl, jl, F32_TOL)
    _close_trees(tc, jc, F32_TOL)


def test_decode_matches_forward_token_by_token():
    """The reference's serving contract on the port alone: feeding tokens one
    by one through decode_step reproduces forward (atol = rtol = 2e-3, the
    reference's own tolerance)."""
    _, tcfg, _, tp = _models("phi4-mini-3.8b")
    toks = _t(_tokens(tcfg)).long()
    full, _ = tlm.forward(tp, {"tokens": toks}, tcfg)
    caches = tlm.init_caches(tcfg, 2, S, device="cpu")
    outs = [tlm.decode_step(tp, toks[:, i : i + 1], caches, i, tcfg)[0] for i in range(S)]
    torch.testing.assert_close(torch.cat(outs, 1), full, atol=2e-3, rtol=2e-3)


def test_bf16_forward_and_decode_match():
    """bf16 weights and activations (the card's dtype) on phi4 SMOKE: the
    reference and the port round to bf16 at the same places but their CPU
    matmuls sum in other orders, so logits agree within BF16_TOL."""
    jcfg, tcfg, jp, tp = _models("phi4-mini-3.8b", dtype="bfloat16")
    assert tp["embed"].dtype == torch.bfloat16
    toks = _tokens(tcfg)
    want, _ = jlm.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    got, _ = tlm.forward(tp, {"tokens": _t(toks).long()}, tcfg)
    _close(got, want, BF16_TOL)
    jc = jlm.init_caches(jcfg, 2, 4)
    tc = tlm.init_caches(tcfg, 2, 4, device="cpu")
    for i in range(4):
        jl, jc = jlm.decode_step(jp, jnp.asarray(toks[:, i : i + 1]), jc, jnp.int32(i), jcfg)
        tl, tc = tlm.decode_step(tp, _t(toks[:, i : i + 1]).long(), tc, i, tcfg)
        _close(tl, jl, BF16_TOL)
    assert tc[0][0][0].dtype == torch.bfloat16


def test_padded_vocab_is_masked():
    """vocab=250 pads to 256: the padded columns are masked to -2e38 in the
    port as in the reference."""
    jcfg, tcfg, jp, tp = _models("phi4-mini-3.8b", vocab=250)
    assert tcfg.vocab_padded == 256
    toks = _tokens(tcfg, s=6)
    want, _ = jlm.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    got, _ = tlm.forward(tp, {"tokens": _t(toks).long()}, tcfg)
    assert bool((got[..., 250:] == -2.0e38).all())
    _close(got[..., :250], np.asarray(want)[..., :250], F32_TOL)
    np.testing.assert_array_equal(got[..., 250:].numpy(), np.asarray(want)[..., 250:])


def test_window_is_honoured_in_forward():
    jcfg, tcfg, jp, tp = _models("mistral-nemo-12b", window=5)
    toks = _tokens(tcfg)
    want, _ = jlm.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg, chunk=4)
    got, _ = tlm.forward(tp, {"tokens": _t(toks).long()}, tcfg, chunk=4)
    _close(got, want, F32_TOL)
    full, _ = tlm.forward(tp, {"tokens": _t(toks).long()}, tcfg.with_(window=0))
    assert (got - full).abs().max() > 1e-3  # the window changed the result


def test_mrope_through_the_model_matches():
    """A dense config with M-RoPE (text positions t, h, w given apart): the
    rotary path the VLM slice builds on, forward and one decode step."""
    jcfg, tcfg, jp, tp = _models("phi4-mini-3.8b", mrope=True, mrope_sections=(1, 1, 2))
    toks = _tokens(tcfg, s=8)
    pos = np.stack([np.broadcast_to(np.arange(8) * k, (2, 8)) for k in (1, 2, 3)])
    want, _ = jlm.forward(jp, {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)}, jcfg)
    got, _ = tlm.forward(tp, {"tokens": _t(toks).long(), "positions": _t(pos.copy())}, tcfg)
    _close(got, want, F32_TOL)
    jl, _ = jlm.decode_step(jp, jnp.asarray(toks[:, :1]), jlm.init_caches(jcfg, 2, 4),
                            jnp.int32(0), jcfg)
    tl, _ = tlm.decode_step(tp, _t(toks[:, :1]).long(), tlm.init_caches(tcfg, 2, 4, device="cpu"),
                            0, tcfg)
    _close(tl, jl, F32_TOL)


def test_not_ported_error_names_item():
    """Every part of the reference is ported, so no error names a roadmap
    item any more: a block kind the registry does not know is refused with
    a ValueError that names it, on the CPU and on ``meta`` alike."""
    cfg = tconfigs.get_smoke("phi4-mini-3.8b")
    for kind, device in (("conv", "meta"), ("xattn", "cpu")):
        with pytest.raises(ValueError, match=f"unknown block kind {kind!r}"):
            tblocks.block_params(None, cfg, kind, dtype=torch.float32,
                                 device=torch.device(device))


# ------------------------------------------------------- recurrent families
# Prefill lengths: whole SSM chunks of 8, and past recurrentgemma SMOKE's
# window of 32, so that its prefill wraps the local blocks' ring.
S0 = {"mamba2-2.7b": 32, "recurrentgemma-2b": 36}
S_REC = 40


def _recurrent_models(arch, dtype="float32"):
    """``_models`` with the SSM's chunk at 8, as the reference's tests run it."""
    jcfg, tcfg, jp, tp = _models(arch, dtype)
    if tcfg.ssm is not None:
        jcfg = jcfg.with_(ssm=dataclasses.replace(jcfg.ssm, chunk=8))
        tcfg = tcfg.with_(ssm=dataclasses.replace(tcfg.ssm, chunk=8))
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_init_tree_matches_reference_layout(arch):
    """The reference's paths, shapes and dtypes: ``a_log``, ``dt_bias`` and
    ``lam`` in f32, the rest in bf16; an ``ssm`` block has no norm2 and no
    MLP."""
    cfg = tconfigs.get_smoke(arch)
    ours = flatten(tlm.init(cfg, torch.Generator().manual_seed(0), device="cpu"))
    jp = jlm.init(jconfigs.get_smoke(arch), jax.random.key(0))[0]
    theirs, dtypes = _flatten(jp), _ref_dtypes(jp)
    assert ours.keys() == theirs.keys()
    f32 = {k for k in ours if k.split("/")[-1] in ("a_log", "dt_bias", "lam")}
    assert f32
    for k, t in ours.items():
        assert tuple(t.shape) == theirs[k].shape, k
        assert str(t.dtype).removeprefix("torch.") == str(dtypes[k]), k
        assert (t.dtype == torch.float32) == (k in f32), k
        if "norm" in k:
            assert not t.any(), k
    if arch == "mamba2-2.7b":  # an ssm block is norm1 and the mixer alone
        assert {k.split("/")[3] for k in ours if k.startswith("groups/")} == {"norm1", "ssm"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_forward_prefill_decode_match(arch, dtype):
    """forward over 40 tokens; prefill of S0 tokens, its caches (f32), and
    pad_caches, which leaves the ring and the recurrent states as they are;
    then decode steps continuing the prompt; each against the reference, at
    F32_TOL or BF16_TOL.  In f32 the decode steps also reproduce forward
    (the reference's own 2e-3)."""
    jcfg, tcfg, jp, tp = _recurrent_models(arch, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    toks = _tokens(tcfg, s=S_REC)
    want, _ = jlm.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    full, aux = tlm.forward(tp, {"tokens": _t(toks).long()}, tcfg)
    assert full.dtype == torch.float32 and float(aux) == 0.0
    _close(full, want, tol)
    s0 = S0[arch]
    jl, jc = jlm.prefill(jp, {"tokens": jnp.asarray(toks[:, :s0])}, jcfg)
    tl, tc = tlm.prefill(tp, {"tokens": _t(toks[:, :s0]).long()}, tcfg)
    _close(tl, jl, tol)
    if dtype == "float32":
        _close_trees(tc, jc, F32_TOL)
    padded = tlm.pad_caches(tc, tcfg, S_REC)
    assert all(a is b for a, b in zip(flatten(padded).values(), flatten(tc).values()))
    jc = jlm.pad_caches(jc, jcfg, S_REC)
    jstep = jax.jit(lambda p, t, c, i: jlm.decode_step(p, t, c, i, jcfg))
    for i in range(s0, S_REC):
        jl, jc = jstep(jp, jnp.asarray(toks[:, i : i + 1]), jc, jnp.int32(i))
        tl, tc = tlm.decode_step(tp, _t(toks[:, i : i + 1]).long(), tc, i, tcfg)
        _close(tl, jl, tol)
        if dtype == "float32":
            torch.testing.assert_close(tl, full[:, i : i + 1], atol=2e-3, rtol=2e-3)
    if dtype == "float32":
        _close_trees(tc, jc, F32_TOL)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_decode_from_empty_matches_forward(arch):
    """Every token through decode_step from zero caches reproduces forward
    (the reference's serving contract, atol = rtol = 2e-3), and the
    reference's decode within F32_TOL."""
    jcfg, tcfg, jp, tp = _recurrent_models(arch)
    toks = _tokens(tcfg, s=24)
    full, _ = tlm.forward(tp, {"tokens": _t(toks).long()}, tcfg)
    caches = tlm.init_caches(tcfg, 2, 24, device="cpu")
    jc = jlm.init_caches(jcfg, 2, 24)
    jstep = jax.jit(lambda p, t, c, i: jlm.decode_step(p, t, c, i, jcfg))
    outs = []
    for i in range(24):
        jl, jc = jstep(jp, jnp.asarray(toks[:, i : i + 1]), jc, jnp.int32(i))
        outs.append(tlm.decode_step(tp, _t(toks[:, i : i + 1]).long(), caches, i, tcfg)[0])
        _close(outs[-1], jl, F32_TOL)
    torch.testing.assert_close(torch.cat(outs, 1), full, atol=2e-3, rtol=2e-3)


# ----------------------------------------------------------- MoE/MLA in bf16
class _PinnedRouting:
    """The reference's routing decisions, replayed in call order by the
    port's ``route``.  In bf16 the two frameworks' hidden states part by a
    bf16 ulp here and there, and a router near-tie can then pick another
    expert (deepseek SMOKE: probabilities 0.1808 and 0.1756 at one token of
    its last layer), which moves that token's logits by far more than
    rounding; pinned, the comparison holds the arithmetic alone.  The
    reference runs eagerly (``jax.disable_jit``) so that its scan over
    layers calls ``route`` once a layer."""

    def __init__(self, monkeypatch):
        self.queue = deque()
        j_route, t_route = jmoe.route, tmoe.route

        def record(router_w, x, m):
            out = j_route(router_w, x, m)
            self.queue.append(out[:2])
            return out

        def replay(router_w, x, m):
            top_i, top_w = self.queue.popleft()
            _, _, probs = t_route(router_w, x, m)
            return (_t(np.array(top_i)).long(),
                    _t(np.array(top_w.astype(jnp.float32))).to(x.dtype), probs)

        monkeypatch.setattr(jmoe, "route", record)
        monkeypatch.setattr(tmoe, "route", replay)


@pytest.mark.parametrize("arch", MOE)
def test_moe_bf16_forward_and_decode_match(arch, monkeypatch):
    """bf16 weights and activations with the router f32, the reference's
    routing pinned: forward, then prefill and decode steps continuing it,
    within BF16_TOL."""
    jcfg, tcfg, jp, tp = _models(arch, dtype="bfloat16")
    pinned = _PinnedRouting(monkeypatch)
    toks = _tokens(tcfg)
    with jax.disable_jit():
        want, _ = jlm.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg, chunk=8)
        got, _ = tlm.forward(tp, {"tokens": _t(toks).long()}, tcfg, chunk=8)
        _close(got, want, BF16_TOL)
        s0 = 10
        jl, jc = jlm.prefill(jp, {"tokens": jnp.asarray(toks[:, :s0])}, jcfg, chunk=4)
        tl, tc = tlm.prefill(tp, {"tokens": _t(toks[:, :s0]).long()}, tcfg, chunk=4)
        _close(tl, jl, BF16_TOL)
        jc, tc = jlm.pad_caches(jc, jcfg, S), tlm.pad_caches(tc, tcfg, S)
        for i in range(s0, S):
            jl, jc = jlm.decode_step(jp, jnp.asarray(toks[:, i : i + 1]), jc, jnp.int32(i), jcfg)
            tl, tc = tlm.decode_step(tp, _t(toks[:, i : i + 1]).long(), tc, i, tcfg)
            _close(tl, jl, BF16_TOL)
    assert not pinned.queue
    assert tc[0][0][0].dtype == torch.bfloat16


def test_mla_caches_are_rank4_and_pad():
    """MLA's caches ``[L, B, S, r]``: prefill's against the reference's,
    then padded along S only."""
    jcfg, tcfg, jp, tp = _models("deepseek-v3-671b")
    toks = _tokens(tcfg, s=6)
    _, jc = jlm.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    _, tc = tlm.prefill(tp, {"tokens": _t(toks).long()}, tcfg)
    padded = tlm.pad_caches(tc, tcfg, 9)
    m = tcfg.mla
    for (kind, count), group, jgroup in zip(tcfg.scan_groups(), padded, jlm.pad_caches(jc, jcfg, 9)):
        c, k = group[0]
        assert tuple(c.shape) == (count, 2, 9, m.kv_lora_rank), kind
        assert tuple(k.shape) == (count, 2, 9, m.qk_rope_dim), kind
        _close(c, jgroup[0][0], F32_TOL)
        assert not c[:, :, 6:].any() and not k[:, :, 6:].any()
