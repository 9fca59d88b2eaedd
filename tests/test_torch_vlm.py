"""The port's vision-frontend family (qwen2-vl-2b: patch embeddings in
place of token ids, [3, B, S] M-RoPE grid positions, ``qkv_bias``) against
the JAX reference on the CPU.

The prompt is a 4x4 grid of stub patch embeddings, the image tokens at
(t, h, w) = (0, i, j), then text at t = h = w = 4 + k.  Decode continues it
at the cache index in all three sections, as the reference's decode_step
does; so forward's positions for the continuation are that index, and its
embeds the tokens' embedding rows.  Parameters come from the reference's
``lm.init`` bridged in f32; inputs from numpy with a seed.
"""

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

# SMOKE-size tensors: one intra-op thread is as fast, and leaves the other
# test workers' cores (and their timing-sensitive threads) alone.
torch.set_num_threads(1)

ARCH = "qwen2-vl-2b"
GRID = 4      # image patches per side (after the 2x2 merge)
TEXT = 8      # text tokens after the image
STEPS = 4     # decode steps continuing the prompt
MOD_TOL = 1e-5
F32_TOL = 1e-4
CONSISTENCY_TOL = 2e-3  # the reference's own (tests/test_decode_consistency.py)


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
    """(reference cfg, port cfg, JAX params, port params), f32 SMOKE; the
    zero-initialised q/k/v biases drawn, so that they matter."""
    jcfg = jconfigs.get_smoke(ARCH).with_(dtype="float32")
    tcfg = tconfigs.get_smoke(ARCH).with_(dtype="float32")
    jp, _ = jlm.init(jcfg, jax.random.key(0))
    flat = {k: v.astype(np.float32) for k, v in _flatten(jp).items()}
    r = np.random.default_rng(9)
    for k in flat:
        if k.endswith(("/bq", "/bk", "/bv")):
            flat[k] = (r.standard_normal(flat[k].shape) * 0.1).astype(np.float32)
    jp = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jp),
                                      [jnp.asarray(flat[k]) for k in _flatten(jp)])
    return jcfg, tcfg, jp, params_from_flat(flat, device="cpu", dtype=torch.float32)


def _grid_positions(b=2):
    """[3, B, GRID^2 + TEXT]: the image at (0, i, j), the text after it at
    t = h = w = GRID + k."""
    i, j = np.divmod(np.arange(GRID * GRID), GRID)
    img = np.stack([np.zeros_like(i), i, j])
    txt = np.broadcast_to(GRID + np.arange(TEXT), (3, TEXT))
    return np.ascontiguousarray(np.broadcast_to(np.concatenate([img, txt], 1)[:, None],
                                                (3, b, GRID * GRID + TEXT)))


def _inputs(cfg, seed=1):
    """Stub patch embeddings, text and continuation token ids."""
    r = np.random.default_rng(seed)
    patches = r.standard_normal((2, GRID * GRID, cfg.d_model)).astype(np.float32)
    toks = r.integers(0, cfg.vocab, (2, TEXT + STEPS)).astype(np.int32)
    return patches, toks


def _prompt(params_embed, patches, toks):
    """The prompt's embeds: patches, then the text's embedding rows."""
    text = np.asarray(params_embed)[toks[:, :TEXT]]
    return np.concatenate([patches, text], 1).astype(np.float32)


def test_mrope_attention_block_with_bias_matches(models):
    """One ``attn`` block of the VLM (biased q/k/v, M-RoPE over grid
    positions) within 1e-5, with its K/V cache."""
    jcfg, tcfg, jp, tp = models
    jl = jax.tree.map(lambda a: a[0], jp["groups"][0]["b0"])
    tl = jax.tree.map(lambda a: a[0], tp["groups"][0]["b0"])
    x = np.random.default_rng(2).standard_normal((2, GRID * GRID + TEXT, tcfg.d_model))
    x = x.astype(np.float32)
    pos = _grid_positions()
    want, _, wc = jblocks.block_apply(jl, jnp.asarray(x), kind="attn", cfg=jcfg, want_cache=True,
                                      aux={"positions": jnp.asarray(pos), "ctx": None, "chunk": 8})
    got, _, gc = tblocks.block_apply(tl, _t(x), kind="attn", cfg=tcfg, want_cache=True,
                                     aux={"positions": _t(pos), "chunk": 8})
    _close(got, want, MOD_TOL)
    _close_trees(gc, wc, MOD_TOL)


@pytest.mark.parametrize("chunk", [1024, 8])
def test_forward_on_embeds_matches(models, chunk):
    jcfg, tcfg, jp, tp = models
    patches, toks = _inputs(tcfg)
    emb = _prompt(tp["embed"], patches, toks)
    pos = _grid_positions()
    want, _ = jlm.forward(jp, {"embeds": jnp.asarray(emb), "positions": jnp.asarray(pos)},
                          jcfg, chunk=chunk)
    got, aux = tlm.forward(tp, {"embeds": _t(emb), "positions": _t(pos)}, tcfg, chunk=chunk)
    assert tuple(got.shape) == want.shape == (2, GRID * GRID + TEXT, tcfg.vocab_padded)
    assert float(aux) == 0.0
    _close(got, want, F32_TOL)
    flat, _ = tlm.forward(tp, {"embeds": _t(emb), "positions": _t(pos[:1].repeat(3, 0))}, tcfg)
    assert (got - flat).abs().max() > 1e-3  # the h and w sections are read


def test_prefill_then_decode_match(models):
    """prefill of the image-and-text prompt (logits and K/V caches),
    pad_caches, then STEPS decode steps: each against the reference's, and
    against the port's forward over the prompt and the continuation at its
    cache index."""
    jcfg, tcfg, jp, tp = models
    patches, toks = _inputs(tcfg)
    emb = _prompt(tp["embed"], patches, toks)
    pos = _grid_positions()
    p0 = emb.shape[1]
    jl, jc = jlm.prefill(jp, {"embeds": jnp.asarray(emb), "positions": jnp.asarray(pos)}, jcfg)
    tl, tc = tlm.prefill(tp, {"embeds": _t(emb), "positions": _t(pos)}, tcfg)
    _close(tl, jl, F32_TOL)
    _close_trees(tc, jc, F32_TOL)
    jc, tc = jlm.pad_caches(jc, jcfg, p0 + STEPS), tlm.pad_caches(tc, tcfg, p0 + STEPS)
    assert tuple(tc[0][0][0].shape)[2] == p0 + STEPS
    cont = toks[:, TEXT:]
    full_emb = np.concatenate([emb, np.asarray(tp["embed"])[cont]], 1)
    idx = np.broadcast_to(p0 + np.arange(STEPS), (3, 2, STEPS))
    full_pos = np.ascontiguousarray(np.concatenate([pos, idx], 2))
    full, _ = tlm.forward(tp, {"embeds": _t(full_emb), "positions": _t(full_pos)}, tcfg)
    jstep = jax.jit(lambda p, t, c, i: jlm.decode_step(p, t, c, i, jcfg))
    for s in range(STEPS):
        jl, jc = jstep(jp, jnp.asarray(cont[:, s : s + 1]), jc, jnp.int32(p0 + s))
        tl, tc = tlm.decode_step(tp, _t(cont[:, s : s + 1]).long(), tc, p0 + s, tcfg)
        _close(tl, jl, F32_TOL)
        torch.testing.assert_close(tl, full[:, p0 + s : p0 + s + 1], atol=CONSISTENCY_TOL,
                                   rtol=CONSISTENCY_TOL)
    _close_trees(tc, jc, F32_TOL)


def test_bf16_forward_on_embeds_matches():
    """bf16 weights and activations (the card's dtype): the embeds cast to
    bf16 as the reference casts them; logits within 0.02
    (``tests/test_torch_models.py``'s BF16_TOL)."""
    jcfg, tcfg = jconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH)
    jp, _ = jlm.init(jcfg, jax.random.key(0))
    tp = params_from_flat(_flatten(jp), device="cpu", dtype=torch.bfloat16)
    patches, toks = _inputs(tcfg)
    emb = _prompt(tp["embed"].float(), patches, toks)
    pos = _grid_positions()
    want, _ = jlm.forward(jp, {"embeds": jnp.asarray(emb), "positions": jnp.asarray(pos)}, jcfg)
    got, _ = tlm.forward(tp, {"embeds": _t(emb), "positions": _t(pos)}, tcfg)
    _close(got, want, 0.02)


def test_positions_default_from_embeds_without_mrope(models):
    """A model without M-RoPE given ``embeds`` and no positions counts them
    0..S-1 from the embeds, as the reference does."""
    jcfg, tcfg, jp, tp = models
    jcfg, tcfg = jcfg.with_(mrope=False), tcfg.with_(mrope=False)
    patches, toks = _inputs(tcfg)
    emb = _prompt(tp["embed"], patches, toks)
    want, _ = jlm.forward(jp, {"embeds": jnp.asarray(emb)}, jcfg)
    got, _ = tlm.forward(tp, {"embeds": _t(emb)}, tcfg)
    _close(got, want, F32_TOL)
