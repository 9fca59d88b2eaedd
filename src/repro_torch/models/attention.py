"""Attention variants: GQA (full / sliding-window / cached) and MLA, as in
``repro/models/attention.py``.

Train/prefill paths use a blocked softmax (a loop over KV chunks with a
running max and denominator), the reference's ``lax.scan`` written out, so
the [S, S] score matrix is never materialised.  Decode attends a query of
length 1 against the cache directly.  The reference reaches no Pallas kernel
here; these are plain PyTorch ops.

Dots accumulate in f32 as the reference's ``preferred_element_type`` does:
the operands are widened to f32 before each score and value product, so a
bf16 model keeps f32 scores and accumulators.  The masking constant
``-2e38`` is safe only in f32, which is where it is used.

MLA (DeepSeek-V3) has both the *naive* expanded form (train/prefill) and the
*absorbed* form for decode, where the cache holds only the compressed
``c_kv`` (kv_lora_rank) plus the shared rope key and the up-projections are
folded into the query/output products.
"""

from __future__ import annotations

import math
import operator

import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import (
    merge_heads,
    over_batch_and_heads,
    set_index,
    split_heads,
    split_over_sequence,
)

from .config import MLAConfig, ModelConfig
from .layers import dense, param, rms_norm, rope

__all__ = [
    "gqa_params",
    "gqa_attend",
    "gqa_decode",
    "mla_params",
    "mla_attend",
    "mla_decode",
    "flash_attention",
]

_NEG = -2.0e38


def flash_attention(q, k, v, **kwargs) -> torch.Tensor:
    """:func:`_flash` (see there); on DTensors, per rank on its batch rows
    and heads (``over_batch_and_heads``)."""
    return over_batch_and_heads(_flash, q, k, v, **kwargs)


def _flash(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,  # [B, Sk, Hkv, Dv]
    *,
    causal: bool,
    window: int = 0,
    q_offset: int = 0,
    chunk: int = 1024,
    scale: float | None = None,
) -> torch.Tensor:
    """Blocked softmax attention.  GQA via head grouping.

    ``q_offset`` is the absolute position of q[0] (for cached prefill);
    ``window`` > 0 restricts attention to the last ``window`` keys.  K and V
    are padded to a multiple of ``chunk`` and the padding masked, as in the
    reference.
    """
    b, sq, h, d = q.shape
    _, sk, hkv, dv = v.shape
    g = h // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    # The scaled query is rounded to its storage dtype before the dot.
    qf = (q * scale).to(q.dtype).reshape(b, sq, hkv, g, d).float()
    nchunk = -(-sk // chunk)
    pad = nchunk * chunk - sk
    kc = F.pad(k, (0, 0, 0, 0, 0, pad)).reshape(b, nchunk, chunk, hkv, d)
    vc = F.pad(v, (0, 0, 0, 0, 0, pad)).reshape(b, nchunk, chunk, hkv, dv)
    dev = q.device
    qpos = torch.arange(sq, device=dev) + q_offset  # [Sq]
    m = torch.full((b, sq, hkv, g), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, sq, hkv, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, sq, hkv, g, dv), dtype=torch.float32, device=dev)
    for c in range(nchunk):
        kb, vb = kc[:, c], vc[:, c]
        kpos = c * chunk + torch.arange(chunk, device=dev)
        s = torch.einsum("bqkgd,bckd->bqkgc", qf, kb.float())  # [B,Sq,Hkv,G,C]
        if causal:
            mask = kpos[None, :] <= qpos[:, None]
        else:
            mask = (kpos[None, :] >= 0) & (qpos[:, None] >= 0)
        if window:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        mask = mask & (kpos[None, :] < sk)
        s = s.masked_fill(~mask[None, :, None, None, :], _NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqkgc,bckv->bqkgv", p.to(vb.dtype).float(), vb.float()
        )
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-37)
    return out.reshape(b, sq, h, dv).to(q.dtype)


# ------------------------------------------------------------------------ GQA
def gqa_params(generator, cfg: ModelConfig, *, layers: int = 0, dtype, device) -> dict:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    kw = dict(layers=layers, dtype=dtype, device=device)
    p = {
        "wq": param(generator, (d, h * hd), **kw),
        "wk": param(generator, (d, hkv * hd), **kw),
        "wv": param(generator, (d, hkv * hd), **kw),
        "wo": param(generator, (h * hd, d), **kw),
    }
    if cfg.qkv_bias:
        p["bq"] = param(generator, (h * hd,), init="zeros", **kw)
        p["bk"] = param(generator, (hkv * hd,), init="zeros", **kw)
        p["bv"] = param(generator, (hkv * hd,), init="zeros", **kw)
    return p


def _qkv(p, x, cfg: ModelConfig, rope_fn):
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = split_heads(dense(x, p["wq"], p.get("bq")), h, hd)
    k = split_heads(dense(x, p["wk"], p.get("bk")), hkv, hd)
    v = split_heads(dense(x, p["wv"], p.get("bv")), hkv, hd)
    q = rope_fn(q)
    k = rope_fn(k)
    return q, k, v


def gqa_attend(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    rope_fn,
    *,
    window: int = 0,
    chunk: int = 1024,
    return_cache: bool = False,
):
    """Full/windowed causal self-attention for train & prefill."""
    q, k, v = _qkv(p, x, cfg, rope_fn)
    o = flash_attention(q, k, v, causal=True, window=window, chunk=chunk)
    y = dense(merge_heads(o), p["wo"])
    if return_cache:
        return y, (k, v)
    return y


def gqa_decode(
    p: dict,
    x: torch.Tensor,  # [B, 1, d]
    cfg: ModelConfig,
    rope_fn,
    cache: tuple[torch.Tensor, torch.Tensor],  # k/v [B, S_cache, Hkv, hd]
    pos: int,  # number of tokens already in cache
    *,
    window: int = 0,
):
    """Single-token decode.  ``window``>0 => ring-buffer cache of that size.

    The new K/V row is written into ``cache`` in place (the reference
    returns fresh, donated buffers): callers own their caches, one set per
    request.  A slot outside the cache raises, where the reference's
    ``dynamic_update_slice`` would clamp it silently.
    """
    pos = operator.index(pos)
    b = x.shape[0]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = split_heads(dense(x, p["wq"], p.get("bq")), h, hd)
    k = split_heads(dense(x, p["wk"], p.get("bk")), hkv, hd)
    v = split_heads(dense(x, p["wv"], p.get("bv")), hkv, hd)
    q = rope_fn(q)
    k = rope_fn(k)
    ck, cv = cache
    s_cache = ck.shape[1]
    slot = pos % s_cache if window else pos
    if not 0 <= slot < s_cache:
        raise IndexError(f"decode position {pos} outside a cache of {s_cache}")
    set_index(ck, 1, slot, k[:, 0].to(ck.dtype))
    set_index(cv, 1, slot, v[:, 0].to(cv.dtype))
    kpos = torch.arange(s_cache, device=x.device)
    if window:
        # ring buffer: entry at slot j holds absolute position
        # pos - ((slot - j) mod S_cache)
        abs_pos = pos - torch.remainder(slot - kpos, s_cache)
        valid = (abs_pos >= 0) & (abs_pos > pos - window)
    else:
        valid = kpos <= pos
    if split_over_sequence(ck):
        o = _decode_attend_split(q, ck, cv, valid)
    else:
        o = over_batch_and_heads(_decode_attend, q, ck, cv, valid=valid)
    y = dense(o.reshape(b, 1, h * hd).to(x.dtype), p["wo"])
    return y, (ck, cv)


def _decode_attend_split(q, ck, cv, valid):
    """:func:`_decode_attend` against a cache whose slots are split over
    mesh axes (the layout ``cache_pspecs`` gives when the kv heads do not
    divide 'model'): each rank attends its own slots with every head, and
    the pieces' running max, denominator and weighted values are combined
    across the split (a split softmax), so no rank gathers the cache."""
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import axis_names, shard_map_compat, spec_of

    mesh = ck.device_mesh
    names = axis_names(mesh)
    split = tuple(names[i] for i, pl in enumerate(ck.placements) if pl.is_shard(1))
    q_spec = (spec_of(ck)[0], None, None, None)

    def local(q_l, k_l, v_l):
        s_loc = k_l.shape[1]
        first = coll.linear_index(mesh, split) * s_loc
        b, _, h, hd = q_l.shape
        hkv = k_l.shape[2]
        qf = (q_l * (1.0 / math.sqrt(hd))).to(k_l.dtype).reshape(b, 1, hkv, h // hkv, hd)
        s = torch.einsum("bqkgd,bckd->bqkgc", qf.float(), k_l.float())
        s = s.masked_fill(~valid[first:first + s_loc][None, None, None, None, :], _NEG)
        m = coll.all_reduce(s.amax(-1), mesh, split, op="max")
        pr = torch.exp(s - m[..., None])
        den = coll.all_reduce(pr.sum(-1), mesh, split)
        acc = coll.all_reduce(
            torch.einsum("bqkgc,bckv->bqkgv", pr.to(v_l.dtype).float(), v_l.float()), mesh, split)
        return (acc / den[..., None]).reshape(b, 1, h, hd)

    return shard_map_compat(local, mesh=mesh, in_specs=(q_spec, spec_of(ck), spec_of(cv)),
                            out_specs=q_spec)(q, ck, cv)


def _decode_attend(q, ck, cv, *, valid):
    """One query row ``q`` [B, 1, H, hd] against the cache's K/V [B, S,
    Hkv, hd] at the ``valid`` slots; f32 [B, 1, H, hd]."""
    b, _, h, hd = q.shape
    hkv = ck.shape[2]
    g = h // hkv
    qf = (q * (1.0 / math.sqrt(hd))).to(ck.dtype).reshape(b, 1, hkv, g, hd)
    s = torch.einsum("bqkgd,bckd->bqkgc", qf.float(), ck.float())
    s = s.masked_fill(~valid[None, None, None, None, :], _NEG)
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bqkgc,bckv->bqkgv", a.to(cv.dtype).float(), cv.float())
    return o.reshape(b, 1, h, hd)


# ------------------------------------------------------------------------ MLA
def mla_params(generator, cfg: ModelConfig, *, layers: int = 0, dtype, device) -> dict:
    m: MLAConfig = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    kw = dict(layers=layers, dtype=dtype, device=device)
    return {
        "w_dq": param(generator, (d, m.q_lora_rank), **kw),
        "q_norm": param(generator, (m.q_lora_rank,), init="zeros", **kw),
        "w_uq": param(generator, (m.q_lora_rank, h * qk), **kw),
        "w_dkv": param(generator, (d, m.kv_lora_rank + m.qk_rope_dim), **kw),
        "kv_norm": param(generator, (m.kv_lora_rank,), init="zeros", **kw),
        "w_uk": param(generator, (m.kv_lora_rank, h * m.qk_nope_dim), **kw),
        "w_uv": param(generator, (m.kv_lora_rank, h * m.v_dim), **kw),
        "wo": param(generator, (h * m.v_dim, d), **kw),
    }


def _mla_q(p, x, cfg: ModelConfig, positions):
    m: MLAConfig = cfg.mla
    b, s, _ = x.shape
    qk = m.qk_nope_dim + m.qk_rope_dim
    q = dense(rms_norm(dense(x, p["w_dq"]), p["q_norm"], cfg.norm_eps), p["w_uq"])
    q = split_heads(q, cfg.n_heads, qk)
    q_nope, q_rope = q[..., : m.qk_nope_dim], q[..., m.qk_nope_dim :]
    return q_nope, rope(q_rope, positions, cfg.rope_theta)


def _mla_ckv(p, x, cfg: ModelConfig, positions):
    m: MLAConfig = cfg.mla
    ckv = dense(x, p["w_dkv"])
    c, k_rope = ckv[..., : m.kv_lora_rank], ckv[..., m.kv_lora_rank :]
    c = rms_norm(c, p["kv_norm"], cfg.norm_eps)
    k_rope = rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c, k_rope  # [B,S,kvr], [B,S,rope_d]


def mla_attend(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    positions: torch.Tensor,
    *,
    chunk: int = 1024,
    return_cache: bool = False,
):
    """Naive (expanded) MLA for train/prefill: q/k heads of nope + rope
    dims, v heads of ``v_dim``, through :func:`flash_attention`."""
    m: MLAConfig = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    c, k_rope = _mla_ckv(p, x, cfg, positions)
    k_nope = split_heads(dense(c, p["w_uk"]), h, m.qk_nope_dim)
    v = split_heads(dense(c, p["w_uv"]), h, m.v_dim)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, m.qk_rope_dim)], -1)
    o = flash_attention(q, k, v, causal=True, chunk=chunk)
    y = dense(merge_heads(o), p["wo"])
    if return_cache:
        return y, (c, k_rope)
    return y


def mla_decode(
    p: dict,
    x: torch.Tensor,  # [B, 1, d]
    cfg: ModelConfig,
    cache: tuple[torch.Tensor, torch.Tensor],  # c [B,S,kvr], k_rope [B,S,rope_d]
    pos: int,
):
    """Absorbed-matrix MLA decode against the compressed cache.

    The new row is written into ``cache`` in place at ``pos``, as
    :func:`gqa_decode` does; a position outside the cache raises.  Every
    product reads its operands in their storage dtype and accumulates in
    f32, as the reference's ``preferred_element_type`` does.
    """
    pos = operator.index(pos)
    m: MLAConfig = cfg.mla
    b = x.shape[0]
    h = cfg.n_heads
    positions = torch.full((b, 1), pos, device=x.device)
    q_nope, q_rope = _mla_q(p, x, cfg, positions)  # [B,1,H,*]
    c_new, kr_new = _mla_ckv(p, x, cfg, positions)
    cc, ckr = cache
    if not 0 <= pos < cc.shape[1]:
        raise IndexError(f"decode position {pos} outside a cache of {cc.shape[1]}")
    set_index(cc, 1, pos, c_new[:, 0].to(cc.dtype))
    set_index(ckr, 1, pos, kr_new[:, 0].to(ckr.dtype))
    # Absorb W_uk into q: q_eff[b,h,r] = q_nope . W_uk[., h, .]
    w_uk = split_heads(p["w_uk"], h, m.qk_nope_dim)
    q_eff = torch.einsum("bqhd,rhd->bqhr", q_nope.float(), w_uk.float())  # [B,1,H,kvr]
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    valid = torch.arange(cc.shape[1], device=x.device) <= pos
    split = split_over_sequence(cc) or split_over_sequence(ckr)
    o_c = (_mla_attend_split if split else _mla_attend)(q_eff, q_rope, cc, ckr, valid, scale)
    w_uv = split_heads(p["w_uv"], h, m.v_dim)
    o = torch.einsum("bqhr,rhv->bqhv", o_c.to(w_uv.dtype).float(), w_uv.float())
    y = dense(o.reshape(b, 1, h * m.v_dim).to(x.dtype), p["wo"])
    return y, (cc, ckr)


def _mla_attend(q_eff, q_rope, cc, ckr, valid, scale):
    """The absorbed scores of :func:`mla_decode`'s query row (``q_eff`` [B,
    1, H, kvr], ``q_rope`` [B, 1, H, rope_d]) against the compressed cache
    (``cc`` [B, S, kvr], ``ckr`` [B, S, rope_d]) at the ``valid`` slots,
    their softmax and the weighted ``c``: f32 ``o_c`` [B, 1, H, kvr]."""
    s = (
        torch.einsum("bqhr,bsr->bqhs", q_eff.to(cc.dtype).float(), cc.float())
        + torch.einsum("bqhd,bsd->bqhs", q_rope.to(ckr.dtype).float(), ckr.float())
    ) * scale
    s = s.masked_fill(~valid[None, None, None, :], _NEG)
    a = torch.softmax(s, dim=-1)
    return torch.einsum("bqhs,bsr->bqhr", a.to(cc.dtype).float(), cc.float())


def _mla_attend_split(q_eff, q_rope, cc, ckr, valid, scale):
    """:func:`_mla_attend` against a compressed cache whose slots are split
    over mesh axes (the layout ``cache_pspecs`` gives MLA's cache): each
    rank scores its own slots with every head, and the pieces' max,
    denominator and weighted ``c`` are combined across the split (a split
    softmax, as :func:`_decode_attend_split` does for GQA), so no rank
    gathers the scores or the cache.  f32 ``o_c`` [B, 1, H, kvr]."""
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import axis_names, shard_map_compat, spec_of

    mesh = cc.device_mesh
    c_spec, r_spec = spec_of(cc), spec_of(ckr)
    if c_spec[:2] != r_spec[:2] or c_spec[2] is not None or r_spec[2] is not None:
        raise ValueError(f"MLA caches split as {c_spec} and {r_spec}: the split softmax "
                         "takes both split alike over batch and slots only")
    names = axis_names(mesh)
    split = tuple(names[i] for i, pl in enumerate(cc.placements) if pl.is_shard(1))
    q_spec = (c_spec[0], None, None, None)

    def local(qe, qr, c_l, r_l):
        s_loc = c_l.shape[1]
        first = coll.linear_index(mesh, split) * s_loc
        s = (
            torch.einsum("bqhr,bsr->bqhs", qe.to(c_l.dtype).float(), c_l.float())
            + torch.einsum("bqhd,bsd->bqhs", qr.to(r_l.dtype).float(), r_l.float())
        ) * scale
        s = s.masked_fill(~valid[first:first + s_loc][None, None, None, :], _NEG)
        m = coll.all_reduce(s.amax(-1), mesh, split, op="max")
        pr = torch.exp(s - m[..., None])
        den = coll.all_reduce(pr.sum(-1), mesh, split)
        acc = coll.all_reduce(
            torch.einsum("bqhs,bsr->bqhr", pr.to(c_l.dtype).float(), c_l.float()), mesh, split)
        return acc / den[..., None]

    return shard_map_compat(local, mesh=mesh, in_specs=(q_spec, q_spec, c_spec, r_spec),
                            out_specs=q_spec)(q_eff, q_rope, cc, ckr)
