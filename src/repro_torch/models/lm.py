"""Model assembly for decoder-only LMs and encoder-decoders, as in
``repro/models/lm.py``.

The layer stack is grouped into runs of identical block kinds (see
``ModelConfig.scan_groups``).  As in the reference, each run's parameters
are stacked ``[L, ...]``, and so are its caches (a list of groups, a tuple
per block kind, leaves ``[L, B, S, Hkv, hd]``, or ``[L, B, S, r]`` for
MLA's compressed cache, or an SSM or RG-LRU block's fixed-size state, or
an ``xdec`` block's pair of self-attention K/V and encoder-memory K/V); the
reference's ``lax.scan`` over a run, a ``cycle:`` group's included, becomes
a Python loop over views of the stack.

Public entry points (functions over plain nested dicts of tensors):
  init(cfg, generator)          -> params
  forward(params, batch, cfg)   -> (logits [B, S, vocab_padded] f32, aux loss)
  loss_fn(params, batch, cfg)   -> (scalar loss, metrics), differentiable
  prefill(params, batch, cfg)   -> (last-position logits, caches)
  decode_step(params, tok, caches, pos, cfg) -> (logits, caches)
  init_caches / pad_caches / param_count

``decode_step`` writes each new K/V row, and each new recurrent state, into
``caches`` in place; the caller owns them (one set per request).  The
training path (``forward`` and ``loss_fn``) writes nothing in place, so that
``torch.autograd`` differentiates it; each layer's body runs under the
rematerialisation ``cfg.remat`` names (:func:`_remat`), as the reference's
scan body does.  ``init`` builds the multi-token-prediction module's
parameters (``tree["mtp"]``, DeepSeek-V3), which ``loss_fn`` trains.

A batch holds ``tokens`` [B, S], or ``embeds`` [B, S, d] for a model with a
frontend stub (qwen2-vl's patch embeddings), and ``positions``: [B, S], or
[3, B, S] (t, h, w) under M-RoPE, where they are required.  An
encoder-decoder (seamless) takes ``enc_embeds`` [B, S_enc, d] (the audio
frame stub) and optional ``enc_positions`` for its encoder beside the
decoder's ``tokens``.  Its caches start at ``prefill``, which fills each
layer's memory K/V: :func:`init_caches` leaves that slot ``None``.
"""

from __future__ import annotations

import functools
import operator
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.device import resolve_device
from repro_torch.parallel.sharding import (
    compute_layout,
    constrain,
    mesh_region,
    vocab_log_prob,
    vocab_lookup,
)

from . import blocks as blk
from .bridge import flatten
from .config import ModelConfig
from .layers import param, rms_norm, softcap

__all__ = [
    "init",
    "init_shapes",
    "logical_axes",
    "forward",
    "loss_fn",
    "prefill",
    "decode_step",
    "init_caches",
    "pad_caches",
    "param_count",
]


# Block kinds whose cache grows with the sequence (see pad_caches).
_GROWS = ("attn", "attn_dense", "attn_moe")


def _torch_dtype(name: str) -> torch.dtype:
    """``cfg.dtype`` ("bfloat16", "float32", ...) as a torch dtype."""
    return getattr(torch, name)


def _group_kinds(group_kind: str) -> list[str]:
    if group_kind.startswith("cycle:"):
        return group_kind[len("cycle:") :].split("|")
    return [group_kind]


def _decoder_groups(cfg: ModelConfig):
    if cfg.enc_layers:
        return (("xdec", cfg.n_layers),)
    return cfg.scan_groups()


def _embed_scale(cfg: ModelConfig) -> float:
    return float(cfg.d_model) ** 0.5 if cfg.family == "hybrid" else 1.0


def _unstack(tree, count: int) -> list:
    """Per-layer views ``[tree[0], ..., tree[count-1]]`` of a stacked tree
    (a ``None`` leaf, an ``xdec`` cache's memory slot before prefill, stays
    ``None``)."""
    if tree is None:
        return [None] * count
    if isinstance(tree, dict):
        subs = {k: _unstack(v, count) for k, v in tree.items()}
        return [{k: subs[k][i] for k in subs} for i in range(count)]
    if isinstance(tree, tuple):
        subs = [_unstack(v, count) for v in tree]
        return [tuple(s[i] for s in subs) for i in range(count)]
    return list(tree.unbind(0))


def _stack(trees: list):
    """Inverse of :func:`_unstack` for per-layer tuples of tensors."""
    if isinstance(trees[0], tuple):
        return tuple(_stack([t[i] for t in trees]) for i in range(len(trees[0])))
    return torch.stack(trees)


def init(
    cfg: ModelConfig,
    generator: torch.Generator | None,
    *,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.bfloat16,
) -> dict[str, Any]:
    """The reference's parameter tree, drawn from ``generator`` on ``device``.

    Leaves are stored in ``dtype`` (bf16, as the reference stores them);
    norms start at zero.  ``device="meta"`` builds shapes only (no
    generator needed), which is how :func:`param_count` counts.
    """
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        raise ValueError("init draws from an explicit torch.Generator")
    kw = dict(dtype=dtype, device=dev)
    groups = _decoder_groups(cfg)
    tree: dict[str, Any] = {
        "embed": param(generator, (cfg.vocab_padded, cfg.d_model), scale=0.02, **kw),
        "groups": [
            {
                f"b{i}": blk.block_params(generator, cfg, k, layers=count, **kw)
                for i, k in enumerate(_group_kinds(kind))
            }
            for kind, count in groups
        ],
        "final_norm": param(generator, (cfg.d_model,), init="zeros", **kw),
    }
    if not cfg.tie_embeddings:
        tree["head"] = param(generator, (cfg.d_model, cfg.vocab_padded), scale=0.02, **kw)
    if cfg.enc_layers:
        tree["enc_groups"] = [
            {"b0": blk.block_params(generator, cfg, "enc", layers=cfg.enc_layers, **kw)}
        ]
        tree["enc_norm"] = param(generator, (cfg.d_model,), init="zeros", **kw)
    if cfg.mtp:  # DeepSeek-V3 multi-token prediction module (depth 1)
        tree["mtp"] = {
            "norm_h": param(generator, (cfg.d_model,), init="zeros", **kw),
            "norm_e": param(generator, (cfg.d_model,), init="zeros", **kw),
            "proj": param(generator, (2 * cfg.d_model, cfg.d_model), **kw),
            "block": blk.block_params(generator, cfg, cfg.block_types()[-1], **kw),
        }
    return tree


# Each leaf's logical axes by its name, as the reference's ``param`` calls
# give them (``repro/models/{lm,blocks,attention,moe,ssm,rglru}.py``); a
# leaf stacked over a group's layers gains a leading "layers".
_AXES: dict[str, tuple] = {
    "embed": ("vocab", "embed"), "head": ("embed", "vocab"),
    "final_norm": ("embed",), "enc_norm": ("embed",), "norm1": ("embed",),
    "norm2": ("embed",), "normx": ("embed",), "norm_h": ("embed",), "norm_e": ("embed",),
    "proj": (None, "embed"),
    # GQA
    "wq": ("embed", "heads"), "wk": ("embed", "kv"), "wv": ("embed", "kv"),
    "wo": ("heads", "embed"), "bq": ("heads",), "bk": ("kv",), "bv": ("kv",),
    # MLA
    "w_dq": ("embed", "lora"), "q_norm": ("lora",), "w_uq": ("lora", "heads"),
    "w_dkv": ("embed", "lora"), "kv_norm": ("lora",), "w_uk": ("lora", "heads"),
    "w_uv": ("lora", "heads"),
    # MLPs
    "w_gate": ("embed", "ffn"), "w_up": ("embed", "ffn"), "w_down": ("ffn", "embed"),
    "w_in": ("embed", "ffn"), "w_out": ("ffn", "embed"),
    # MoE
    "router": ("embed", None), "w1": ("experts", "embed", "ffn"),
    "w3": ("experts", "embed", "ffn"), "w2": ("experts", "ffn", "embed"),
    "ws1": ("embed", "ffn"), "ws3": ("embed", "ffn"), "ws2": ("ffn", "embed"),
    # Mamba-2 SSD
    "in_proj": ("embed", "ffn"), "conv_w": (None, "ffn"), "conv_b": ("ffn",),
    "a_log": ("heads",), "dt_bias": ("heads",), "d_skip": ("heads",), "norm": ("ffn",),
    "out_proj": ("ffn", "embed"),
    # RG-LRU
    "in_x": ("embed", "ffn"), "in_gate": ("embed", "ffn"), "w_a": ("ffn", "ffn"),
    "b_a": ("ffn",), "w_i": ("ffn", "ffn"), "b_i": ("ffn",), "lam": ("ffn",),
    "out": ("ffn", "embed"),
}


def logical_axes(tree, stacked: bool = False):
    """The logical-axes tree of a parameter tree (tensors, ``meta`` or not):
    each leaf's axes tuple, as the reference's ``init`` returns beside its
    parameters.  Leaves under ``groups``/``enc_groups`` are stacked over
    layers."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = logical_axes(v, stacked)
        elif isinstance(v, list):  # groups / enc_groups: stacked layers
            out[k] = [logical_axes(g, True) for g in v]
        else:
            axes = _AXES[k]
            out[k] = ("layers", *axes) if stacked else axes
    return out


def init_shapes(cfg: ModelConfig):
    """(``meta`` parameter tree in ``cfg.dtype``, logical-axes tree): the
    dry-run's stand-ins, nothing allocated."""
    params = init(cfg, None, device="meta", dtype=_torch_dtype(cfg.dtype))
    return params, logical_axes(params)


# Products without batch dimensions, the weight matmuls: what the reference's
# ``dots_with_no_batch_dims_saveable`` policy keeps under ``remat="dots"``.
# Attention's and the experts' batched products (``bmm``) are recomputed.
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    """``fn`` under ``cfg.remat``: ``"none"`` keeps every activation,
    ``"full"`` keeps the inputs and recomputes the rest in backward,
    ``"dots"`` keeps the weight matmuls' outputs too (the reference's
    ``jax.checkpoint`` policies)."""
    if cfg.remat == "none":
        return fn
    kw: dict[str, Any] = {"use_reentrant": False, "preserve_rng_state": False}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    elif cfg.remat != "full":
        raise ValueError(f"unknown remat {cfg.remat!r}")
    return lambda *args: checkpoint(fn, *args, **kw)


def _layer(x, layer_p, *, kinds, cfg: ModelConfig, aux, want_cache: bool):
    """One layer of a group: its blocks in order.  Returns (x, aux loss, caches)."""
    cs = []
    a_sum = 0.0
    for i, k in enumerate(kinds):
        x, a, c = blk.block_apply(
            layer_p[f"b{i}"], x, kind=k, cfg=cfg, aux=aux, want_cache=want_cache,
        )
        a_sum = a_sum + a
        cs.append(c)
    return x, a_sum, tuple(cs)


def _run_groups(params_groups, x, cfg: ModelConfig, aux, groups, want_cache=False):
    """Apply every layer group; returns (x, aux_loss_sum, caches|None).

    The aux loss is summed as the reference sums it: over a layer's blocks,
    then over the group's layers, then over the groups.  Without caches each
    layer runs under :func:`_remat`; a serving call (``want_cache``) keeps
    its activations, which no backward reads."""
    aux_total = 0.0
    caches = []
    for gp, (kind, count) in zip(params_groups, groups):
        # bound now: backward may recompute a layer after the loop moved on
        body = functools.partial(_layer, kinds=_group_kinds(kind), cfg=cfg, aux=aux,
                                 want_cache=want_cache)
        if not want_cache:
            body = _remat(body, cfg)
        per_layer = []
        layer_aux = []
        for layer_p in _unstack(gp, count):
            x = constrain(x, aux.get("ctx"), ("dp", None, None))
            x, a_sum, cs = body(x, compute_layout(layer_p, aux.get("ctx")))
            per_layer.append(cs)
            layer_aux.append(a_sum)
        if torch.is_tensor(layer_aux[0]):  # a group of MoE blocks
            aux_total = aux_total + torch.stack(layer_aux).sum()
        if want_cache:
            caches.append(_stack(per_layer))
    return x, aux_total, (caches if want_cache else None)


def _gather_top(params, ctx):
    """The parameters outside the layer groups in their compute layout
    (``compute_layout``); the groups follow one layer at a time."""
    if ctx is None or ctx.mesh is None:
        return params
    top = {k: v for k, v in params.items() if k not in ("groups", "enc_groups")}
    return {**params, **compute_layout(top, ctx)}


def _embed_tokens(params, tokens, cfg: ModelConfig):
    x = vocab_lookup(params["embed"], tokens)
    scale = _embed_scale(cfg)
    if scale != 1.0:
        x = x * scale
    return x.to(_torch_dtype(cfg.dtype))


def _logits(params, x, cfg: ModelConfig, ctx=None):
    """f32 logits; the head product runs in the activation dtype and padded
    vocab columns are masked."""
    x = constrain(x, ctx, ("dp", None, None))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    logits = constrain(x @ head.to(x.dtype), ctx, ("dp", None, "tp"))
    logits = softcap(logits.float(), cfg.logits_softcap)
    if cfg.vocab_padded != cfg.vocab:  # out of place: autograd reads the product
        keep = torch.arange(cfg.vocab_padded, device=logits.device) < cfg.vocab
        logits = torch.where(keep, logits, -2.0e38)
    return logits


def _arange_positions(ref: torch.Tensor) -> torch.Tensor:
    """[B, S] positions 0..S-1 for ``ref`` [B, S, ...]."""
    b, s = ref.shape[:2]
    return torch.arange(s, device=ref.device)[None].expand(b, s)


def _make_aux(batch, cfg: ModelConfig, ctx=None, chunk=1024):
    if cfg.mrope:
        positions = batch["positions"]  # [3, B, S]
    else:
        tokens = batch.get("tokens")
        positions = batch.get("positions")
        if positions is None:
            positions = _arange_positions(tokens if tokens is not None else batch["embeds"])
    return {"positions": positions, "ctx": ctx, "chunk": chunk}


def _encode(params, batch, cfg: ModelConfig, aux):
    """The encoder stack of an enc-dec model (bidirectional), then its norm."""
    ctx = aux.get("ctx")
    x = batch["enc_embeds"].to(_torch_dtype(cfg.dtype))
    positions = batch.get("enc_positions")
    enc_aux = dict(aux, positions=_arange_positions(x) if positions is None else positions)
    x = constrain(x, ctx, ("dp", None, None))
    x, _, _ = _run_groups(params["enc_groups"], x, cfg, enc_aux, (("enc", cfg.enc_layers),))
    return constrain(rms_norm(x, params["enc_norm"], cfg.norm_eps), ctx, ("dp", None, None))


def _decoder_input(params, batch, cfg: ModelConfig, ctx=None):
    """The decoder's input rows: ``embeds`` where the batch has them, except
    in an enc-dec model, whose decoder reads ``tokens``."""
    if "embeds" in batch and not cfg.enc_layers:
        x = batch["embeds"].to(_torch_dtype(cfg.dtype))
    else:
        x = _embed_tokens(params, batch["tokens"], cfg)
    return constrain(x, ctx, ("dp", None, None))


@mesh_region
def forward(params, batch, cfg: ModelConfig, ctx=None, chunk: int = 1024):
    """Full-sequence forward over a batch (see the module docstring).
    Returns (logits [B, S, vocab_padded] f32, aux loss).  With a ``ctx``
    that holds a mesh the tensors are DTensors (see ``repro_torch.parallel``)."""
    params = _gather_top(params, ctx)
    aux = _make_aux(batch, cfg, ctx, chunk)
    if cfg.enc_layers:
        aux["memory"] = _encode(params, batch, cfg, aux)
    x = _decoder_input(params, batch, cfg, ctx)
    x, aux_loss, _ = _run_groups(params["groups"], x, cfg, aux, _decoder_groups(cfg))
    return _logits(params, x, cfg, ctx), aux_loss


def _mtp_trunk(params, h, batch, cfg: ModelConfig, aux):
    """DeepSeek-V3 MTP (depth 1): predict token t+2 from (h_t, emb_{t+1}).

    ``h`` is the trunk output BEFORE the final norm, [B, S, d].  Returns the
    MTP hidden states [B, S-1, d] (logits via the shared streamed CE head);
    the block's own aux loss is dropped, as the reference drops it.
    """
    p = params["mtp"]
    emb = _embed_tokens(params, batch["tokens"], cfg)
    hh = rms_norm(h[:, :-1], p["norm_h"], cfg.norm_eps)
    ee = rms_norm(emb[:, 1:], p["norm_e"], cfg.norm_eps)
    x = torch.cat([hh, ee], dim=-1) @ p["proj"].to(hh.dtype)
    x = constrain(x, aux.get("ctx"), ("dp", None, None))
    aux_m = dict(aux, positions=aux["positions"][..., :-1])
    x, _, _ = blk.block_apply(p["block"], x, kind=cfg.block_types()[-1], cfg=cfg, aux=aux_m)
    return x


def _check_labels(labels, vocab: int) -> None:
    """Raise on a label outside ``[0, vocab)`` in this rank's piece of a
    DTensor ``labels`` (one look a step; fake tensors carry no values)."""
    from torch._subclasses.fake_tensor import is_fake
    from torch.distributed.tensor import DTensor

    if not isinstance(labels, DTensor):
        return
    local = labels.to_local()
    if not is_fake(local) and bool(((local < 0) | (local >= vocab)).any()):
        raise ValueError(f"a label outside the vocabulary [0, {vocab})")


def _ce(logits, labels, mask):
    """Mean next-token cross-entropy over the ``mask``ed positions."""
    ll = vocab_log_prob(logits, labels)
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _num_ce_chunks(cfg: ModelConfig, seq: int) -> int:
    """Resolved chunk count: a divisor of ``seq`` near the target."""
    want = cfg.ce_chunks
    if want == 0:  # auto: ~16M logits elements per chunk
        want = max(1, (seq * cfg.vocab_padded) // (1 << 24))
    want = min(want, seq)
    for nc in range(want, 0, -1):
        if seq % nc == 0:
            return nc
    return 1


def _ce_chunk(params, h_c, l_c, m_c, cfg: ModelConfig, ctx=None):
    """(masked negative log-likelihood sum, mask sum) of one sequence chunk."""
    ll = vocab_log_prob(_logits(params, h_c, cfg, ctx), l_c)
    return (ll * m_c).sum(), m_c.sum()


def _ce_stream(params, h, labels, mask, cfg: ModelConfig, ctx=None):
    """Streaming cross-entropy over sequence chunks, as the reference's.

    The head matmul + log-softmax + gather run one [B, S/nc] slab at a time,
    each under a checkpoint that keeps only its inputs, so the [B, S, vocab]
    f32 logits never exist: backward recomputes one slab's at a time.  The
    chunks' sums are taken in the reference's scan order.  On a mesh the
    log-softmax is vocab-parallel (``vocab_log_prob``), where a label no
    rank's columns hold would read as 0: such labels raise.
    """
    _check_labels(labels, cfg.vocab)
    nc = _num_ce_chunks(cfg, h.shape[1])
    if nc <= 1:
        return _ce(_logits(params, h, cfg, ctx), labels, mask)
    sc = h.shape[1] // nc
    nll = msum = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(nc):
        part = slice(c * sc, (c + 1) * sc)
        ll, m = checkpoint(_ce_chunk, params, h[:, part], labels[:, part], mask[:, part], cfg,
                           ctx, use_reentrant=False, preserve_rng_state=False)
        nll, msum = nll - ll, msum + m
    return nll / torch.clamp(msum, min=1.0)


@mesh_region
def loss_fn(params, batch, cfg: ModelConfig, ctx=None, chunk: int = 1024):
    """(loss, metrics) of a training batch: ``tokens`` (or ``embeds``, or an
    enc-dec model's ``enc_embeds`` beside its ``tokens``), ``labels`` [B, S]
    and an optional f32 ``loss_mask``.  The loss is the streamed
    cross-entropy plus the MoE aux loss, plus ``cfg.mtp_weight`` times the
    MTP cross-entropy where the model has the module; ``metrics`` holds
    ``ce``, ``aux``, ``tokens`` (the mask's sum) and ``ce_mtp``."""
    params = _gather_top(params, ctx)
    aux = _make_aux(batch, cfg, ctx, chunk)
    if cfg.enc_layers:
        aux["memory"] = _encode(params, batch, cfg, aux)
    x = _decoder_input(params, batch, cfg, ctx)
    h, aux_loss, _ = _run_groups(params["groups"], x, cfg, aux, _decoder_groups(cfg))
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    aux_loss = torch.as_tensor(aux_loss, dtype=torch.float32, device=h.device)
    ce = _ce_stream(params, h, labels, mask, cfg, ctx)
    loss = ce + aux_loss
    metrics = {"ce": ce, "aux": aux_loss, "tokens": mask.sum()}
    if cfg.mtp and "tokens" in batch:
        h_mtp = _mtp_trunk(params, h, batch, cfg, aux)
        ce_mtp = _ce_stream(params, h_mtp, labels[:, 1:], mask[:, 1:], cfg, ctx)
        loss = loss + cfg.mtp_weight * ce_mtp
        metrics["ce_mtp"] = ce_mtp
    return loss, metrics


# ------------------------------------------------------------------- serving
def init_caches(
    cfg: ModelConfig,
    bsz: int,
    cache_len: int,
    dtype: torch.dtype | None = None,
    *,
    device: str | torch.device = "cuda",
):
    """Zero caches in the layout ``prefill`` returns; an ``xdec`` block's
    memory K/V is ``None`` until a prefill computes it, as in the reference."""
    dtype = dtype or _torch_dtype(cfg.dtype)
    dev = resolve_device(device)

    def one(kind: str, count: int):
        if kind == "xdec":  # (self-attention K/V, memory K/V)
            return (one("attn", count), None)
        return blk.block_init_cache(cfg, kind, bsz, cache_len, dtype, layers=count, device=dev)

    return [tuple(one(k, count) for k in _group_kinds(kind))
            for kind, count in _decoder_groups(cfg)]


@mesh_region
def prefill(params, batch, cfg: ModelConfig, ctx=None, chunk: int = 1024):
    """Run the prompt; returns (last-position logits [B, 1, vocab], caches)."""
    params = _gather_top(params, ctx)
    aux = _make_aux(batch, cfg, ctx, chunk)
    if cfg.enc_layers:
        aux["memory"] = _encode(params, batch, cfg, aux)
    x = _decoder_input(params, batch, cfg, ctx)
    x, _, caches = _run_groups(params["groups"], x, cfg, aux, _decoder_groups(cfg),
                               want_cache=True)
    return _logits(params, x[:, -1:, :], cfg, ctx), caches


def pad_caches(caches, cfg: ModelConfig, cache_len: int):
    """Grow prefill caches to ``cache_len`` along the sequence so decoding
    can continue (zeros after the prompt): GQA's ``[L, B, S, Hkv, hd]`` and
    MLA's ``[L, B, S, r]`` alike.  A ``local`` block's ring and the SSM and
    RG-LRU states have a fixed size and stay as they are, as in the
    reference.  Of an ``xdec`` pair only the self-attention K/V grow: zero
    keys padded onto the memory would enter the unmasked cross-attention."""

    def pad(kv):
        return tuple(_pad_seq(x, cache_len) for x in kv)

    out = []
    for cache, (kind, _count) in zip(caches, _decoder_groups(cfg)):
        new = []
        for c, k in zip(cache, _group_kinds(kind)):
            if k in _GROWS:
                c = pad(c)
            elif k == "xdec":
                c = (pad(c[0]), c[1])
            new.append(c)
        out.append(tuple(new))
    return out


def _pad_seq(x: torch.Tensor, cache_len: int) -> torch.Tensor:
    cur = x.shape[2]  # [L, B, S, ...]
    if cur >= cache_len:
        return x
    pad = [0, 0] * (x.ndim - 3) + [0, cache_len - cur]  # F.pad lists the last dim first
    return F.pad(x, pad)


@mesh_region
def decode_step(params, tokens, caches, pos: int, cfg: ModelConfig, ctx=None):
    """One decode step.  tokens [B, 1]; ``pos`` a Python int, the number of
    tokens already in the caches, which are updated in place.  Under M-RoPE
    the token's position is ``pos`` in all three sections, as in the
    reference."""
    pos = operator.index(pos)
    params = _gather_top(params, ctx)
    bsz = tokens.shape[0]
    shape = (3, bsz, 1) if cfg.mrope else (bsz, 1)
    aux = {"positions": torch.full(shape, pos, device=tokens.device), "ctx": ctx, "chunk": 1024}
    x = constrain(_embed_tokens(params, tokens, cfg), ctx, ("dp", None, None))
    for gp, cache, (kind, count) in zip(params["groups"], caches, _decoder_groups(cfg)):
        kinds = _group_kinds(kind)
        for layer_p, layer_c in zip(_unstack(gp, count), _unstack(cache, count)):
            layer_p = compute_layout(layer_p, ctx)
            for i, k in enumerate(kinds):
                x, _ = blk.block_decode(
                    layer_p[f"b{i}"], x, kind=k, cfg=cfg, aux=aux, cache=layer_c[i], pos=pos,
                )
    return _logits(params, x, cfg, ctx), caches


# ------------------------------------------------------------------ counting
def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact parameter count from the tree's shapes on the ``meta`` device;
    ``active_only`` scales each expert stack (``moe/w1``, ``w2``, ``w3``) by
    top_k/num_experts, as the reference does."""
    total = 0
    for key, leaf in flatten(init(cfg, None, device="meta")).items():
        n = leaf.numel()
        parts = key.split("/")
        expert = "moe" in parts and parts[-1] in ("w1", "w2", "w3")
        if active_only and cfg.moe is not None and expert:
            n = int(n * cfg.moe.top_k / cfg.moe.num_experts)
        total += n
    return total
