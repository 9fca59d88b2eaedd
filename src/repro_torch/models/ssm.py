"""Mamba-2 (SSD, state-space duality) mixing layer, as in
``repro/models/ssm.py``.

Chunked SSD for train/prefill: the sequence is split into chunks of Q
tokens; within a chunk the quadratic "attention-like" form runs directly,
and across chunks a linear recurrence carries the [H, P, N] state (the
reference's ``lax.scan`` over chunks, here a loop).  It equals the token-by-
token recurrence (``ssd_naive``); decode keeps the state, O(1) per token.

Every dtype change is the reference's, in its order: the input projection,
the causal conv and its SiLU run in the activation dtype (the decode conv
sums its window in f32 and rounds once, as ``jnp.sum`` does); ``dt`` is a
softplus in f32; x, B and C are widened to f32 for the scan, whose state
stays f32; the output is rounded to the activation dtype *before* the gated
norm, which computes in f32 and rounds back; the output projection runs in
the activation dtype.  ``a_log`` and ``dt_bias`` are stored in f32.  Heads
share their group's B and C by a view over ``[groups, heads per group]``,
the reference's ``jnp.repeat`` without the copy.  The reference reaches no
Pallas kernel here; these are plain PyTorch ops.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import (
    axis_sizes,
    gather_last,
    make_context,
    partial_sums,
    shard_map_compat,
)

from .config import ModelConfig, SSMConfig
from .layers import param

__all__ = [
    "ssm_params",
    "ssm_apply",
    "ssm_decode",
    "ssd_naive",
    "ssm_init_cache",
]


def _dims(cfg: ModelConfig):
    """(d_in, heads, groups, state size, head dim, conv channels)."""
    s: SSMConfig = cfg.ssm
    d_in = s.expand * cfg.d_model
    return d_in, d_in // s.head_dim, s.n_groups, s.d_state, s.head_dim, \
        d_in + 2 * s.n_groups * s.d_state


def _f32_leaf(values: torch.Tensor, layers: int, device) -> torch.Tensor:
    """A fixed f32 leaf (not drawn), stacked ``[layers, ...]`` when
    ``layers`` > 0."""
    values = values.to(device=device, dtype=torch.float32)
    return values.expand(layers, *values.shape).clone() if layers else values


def ssm_params(generator, cfg: ModelConfig, *, layers: int = 0, dtype, device) -> dict:
    s: SSMConfig = cfg.ssm
    d = cfg.d_model
    d_in, h, g, n, _, conv_ch = _dims(cfg)
    kw = dict(layers=layers, dtype=dtype, device=device)
    # dt drawn log-uniform in [dt_min, dt_max] from numpy's seed 0, as the
    # reference draws it, and stored as its inverse softplus.
    dt = np.exp(np.random.RandomState(0).uniform(np.log(s.dt_min), np.log(s.dt_max), size=(h,)))
    dt_bias = dt + np.log(-np.expm1(-dt))
    return {
        # packed: [z (d_in), x (d_in), B (g*n), C (g*n), dt (h)]
        "in_proj": param(generator, (d, 2 * d_in + 2 * g * n + h), **kw),
        "conv_w": param(generator, (s.d_conv, conv_ch), scale=0.5, **kw),
        "conv_b": param(generator, (conv_ch,), init="zeros", **kw),
        "a_log": _f32_leaf(torch.log(torch.arange(1, h + 1, dtype=torch.float32)), layers, device),
        "dt_bias": _f32_leaf(torch.from_numpy(dt_bias), layers, device),
        "d_skip": param(generator, (h,), init="ones", **kw),
        "norm": param(generator, (d_in,), init="zeros", **kw),
        "out_proj": param(generator, (d_in, d), **kw),
    }


def _conv1d(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv along S.  u [B, S, C], w [K, C]; the taps are
    added one at a time in u's dtype, as the reference's ``sum`` does."""
    k, s = w.shape[0], u.shape[1]
    up = F.pad(u, (0, 0, k - 1, 0))
    out = up[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + up[:, i : i + s] * w[i]
    return out + b


def _split_proj(zxbcdt, d_in, g, n, h):
    z = zxbcdt[..., :d_in]
    x = zxbcdt[..., d_in : 2 * d_in]
    b = zxbcdt[..., 2 * d_in : 2 * d_in + g * n]
    c = zxbcdt[..., 2 * d_in + g * n : 2 * d_in + 2 * g * n]
    dt = zxbcdt[..., 2 * d_in + 2 * g * n :]
    return z, x, b, c, dt


def _gated_norm(y, z, gamma, eps, mesh=None):
    """``y * silu(z)`` normalized by its RMS over the last dim.  With
    ``mesh`` (inside the mixer's region), the last dim is this rank's share
    of it over 'model': the squares are summed over the ranks."""
    dt = y.dtype
    y = y.float() * F.silu(z.float())
    if mesh is None:
        var = (y * y).mean(-1, keepdim=True)
    else:
        total = coll.sum_shares((y * y).sum(-1, keepdim=True), mesh, ("model",))
        var = total / (y.shape[-1] * coll.axis_size(mesh, "model"))
    return (y * torch.rsqrt(var + eps) * (1.0 + gamma.float())).to(dt)


def _ssd(x, bmat, cmat, dt, a, d_skip, *, q: int):
    """The chunked SSD scan.  x [B, S, H, P], bmat/cmat [B, S, G, N] (each
    group shared by H/G heads), dt [B, S, H] f32, a and d_skip [H].
    Returns (y [B, S, H, P] f32, the state after the last token [B, H, P,
    N] f32)."""
    bsz, slen, h, pdim = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    nc, hpg = slen // q, h // g
    xh = x.reshape(bsz, nc, q, g, hpg, pdim).float()
    bh = bmat.reshape(bsz, nc, q, g, n).float()
    ch = cmat.reshape(bsz, nc, q, g, n).float()
    dtc = dt.reshape(bsz, nc, q, h)

    cum = torch.cumsum(dtc * a, dim=2)  # [B, NC, Q, H]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B, NC, Q(t), Q(s), H]
    # exp of the causal triangle only: the reference's where(tri, exp(seg),
    # 0) has the same values, but with 80 heads the other triangle's sums
    # overflow, and its gradient there is 0 * inf, NaN
    upper = torch.ones(q, q, dtype=torch.bool, device=x.device).triu(1)
    ldecay = torch.exp(seg.masked_fill(upper[None, None, :, :, None], -math.inf))

    cb = torch.einsum("bcqgn,bcsgn->bcqsg", ch, bh)  # [B, NC, Q, Q, G]
    m = cb[..., None] * ldecay.reshape(bsz, nc, q, q, g, hpg) * \
        dtc.reshape(bsz, nc, 1, q, g, hpg)  # weight on x_s
    y_intra = torch.einsum("bcqsgj,bcsgjp->bcqgjp", m, xh)

    # chunk summary state: sum_s exp(cum_end - cum_s) dt_s B_s x_s^T
    wgt = (torch.exp(cum[:, :, -1:, :] - cum) * dtc).reshape(bsz, nc, q, g, hpg)
    bx = torch.einsum("bcsgn,bcsgjp->bcgjpn", bh, xh * wgt[..., None])
    chunk_decay = torch.exp(cum[:, :, -1, :]).reshape(bsz, nc, g, hpg)

    hstate = torch.zeros(bsz, g, hpg, pdim, n, dtype=torch.float32, device=x.device)
    h_prev = []  # the state BEFORE each chunk
    for c in range(nc):
        h_prev.append(hstate)
        hstate = hstate * chunk_decay[:, c, :, :, None, None] + bx[:, c]
    h_prev = torch.stack(h_prev, 1)  # [B, NC, G, J, P, N]

    y_inter = torch.einsum("bcqgn,bcgjpn->bcqgjp", ch, h_prev) * \
        torch.exp(cum).reshape(bsz, nc, q, g, hpg)[..., None]
    y = (y_intra + y_inter).reshape(bsz, slen, h, pdim)
    y = y + xh.reshape(bsz, slen, h, pdim) * d_skip[None, None, :, None]
    return y, hstate.reshape(bsz, h, pdim, n)


def _ssd_region(x, bmat, cmat, dt, a, d_skip, *, q: int):
    """:func:`_ssd`; on DTensors per rank (``shard_map_compat``): batch over
    the DP axes, heads over 'model' when they divide it and the groups do
    too or there is one group (each rank then reads it whole)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return _ssd(x, bmat, cmat, dt, a, d_skip, q=q)
    mesh = x.device_mesh
    tpn = axis_sizes(mesh).get("model", 1)
    h, g = x.shape[2], bmat.shape[2]
    hsplit = "model" if h % tpn == 0 and (g == 1 or g % tpn == 0) else None
    b = make_context(mesh).dp_spec(x.shape[0])
    x_spec = (b, None, hsplit)
    g_spec = (b, None, hsplit if g % tpn == 0 else None)
    return shard_map_compat(
        functools.partial(_ssd, q=q), mesh=mesh,
        in_specs=(x_spec, g_spec, g_spec, x_spec, (hsplit,), (hsplit,)),
        out_specs=[x_spec, (b, hsplit)],
    )(x, bmat, cmat, dt, a, d_skip)


_WEIGHTS = ("in_proj", "conv_w", "conv_b", "dt_bias", "a_log", "d_skip", "norm", "out_proj")


def _take(w: torch.Tensor, widths: tuple, tp: int, r: int) -> torch.Tensor:
    """Rank ``r``'s columns of ``w``'s packed last dim (pieces of
    ``widths``, in order): the ``r``-th of ``tp`` equal slices of each."""
    if tp == 1:
        return w
    idx = [torch.arange(k // tp, device=w.device) + start + r * (k // tp)
           for start, k in zip(np.cumsum((0,) + widths[:-1]).tolist(), widths)]
    return w.index_select(-1, torch.cat(idx))


def _gather_bc(bc: torch.Tensor, mesh) -> torch.Tensor:
    """``bc`` [B, S, 2 * k], this rank's k columns of B then of C, as [B,
    S, 2 * k * tp]: all of B, then all of C (one all-gather over
    'model')."""
    tp = coll.axis_size(mesh, "model")
    got = coll.all_gather(bc, mesh, ("model",))  # [tp * B, S, 2k], rank-major
    got = got.view(tp, *bc.shape[:-1], 2, bc.shape[-1] // 2).movedim(0, -2)
    return got.reshape(*bc.shape[:-1], bc.shape[-1] * tp)


def _mixer(xin, in_proj, conv_w, conv_b, dt_bias, a_log, d_skip, norm, out_proj, *,
           cfg: ModelConfig, mesh=None, return_cache: bool = False):
    """The mixer.  With ``mesh`` it runs inside ``shard_map_compat`` on one
    rank's pieces: ``xin`` its batch rows, ``in_proj``, ``conv_w`` and
    ``conv_b`` whole, the rest its heads' (``norm``, ``out_proj``'s rows:
    its share of d_in).  It projects its columns only -- its heads of z, x
    and dt and its 1/tp of B and of C -- runs the conv on its channels,
    gathers B and C whole (one group: every head reads them) or keeps its
    groups' (groups split over 'model'), scans its heads, sums the gated
    norm's squares over the ranks and returns the output product's partial
    sums over 'model'.  Returns [out], and with the cache [out, state, the
    x, B and C rows of the conv tail]."""
    s: SSMConfig = cfg.ssm
    bsz, slen, _ = xin.shape
    d_in, h, g, n, pdim, _ = _dims(cfg)
    assert slen % s.chunk == 0, (slen, s.chunk)
    tp = 1 if mesh is None else coll.axis_size(mesh, "model")
    r = 0 if mesh is None else coll.axis_rank(mesh, "model")
    dl, gnl = d_in // tp, g * n // tp
    gather = tp > 1 and g % tp != 0

    zxbcdt = gather_last(xin @ _take(in_proj, (d_in, d_in, g * n, g * n, h), tp, r))
    z, xbc_pre, dt = zxbcdt[..., :dl], zxbcdt[..., dl : 2 * dl + 2 * gnl], \
        zxbcdt[..., 2 * dl + 2 * gnl :]
    widths = (d_in, g * n, g * n)
    xbc = F.silu(_conv1d(xbc_pre, _take(conv_w, widths, tp, r), _take(conv_b, widths, tp, r)))
    x, bc = xbc[..., :dl], xbc[..., dl:]
    if gather:
        bc = _gather_bc(bc, mesh)
    bmat, cmat = bc.chunk(2, -1)
    dt = F.softplus(dt.float() + dt_bias)  # [B, S, heads]
    a = -torch.exp(a_log)  # [heads]

    gl = bmat.shape[-1] // n
    y, hstate = _ssd_region(x.reshape(bsz, slen, -1, pdim), bmat.reshape(bsz, slen, gl, n),
                            cmat.reshape(bsz, slen, gl, n), dt, a, d_skip, q=s.chunk)
    y = y.reshape(bsz, slen, dl).to(xin.dtype)
    y = _gated_norm(y, z, norm, cfg.norm_eps, mesh)
    out = y @ out_proj
    if not return_cache:
        return [out]
    tail = xbc_pre[:, -(s.d_conv - 1) :]
    x_tail, bc_tail = tail[..., :dl], tail[..., dl:]
    if gather:
        bc_tail = _gather_bc(bc_tail, mesh)
    return [out, hstate, x_tail, *bc_tail.chunk(2, -1)]


def _region_mesh(xin, cfg: ModelConfig):
    """The mesh the mixer runs on per rank, or ``None``: a plain ``xin``,
    a mesh without 'model', or heads that do not split over it whole (with
    one group, its B and C columns must split too) run op by op."""
    from torch.distributed.tensor import DTensor

    if not isinstance(xin, DTensor) or "model" not in axis_sizes(xin.device_mesh):
        return None
    tp = axis_sizes(xin.device_mesh)["model"]
    _, h, g, n, _, _ = _dims(cfg)
    ok = h % tp == 0 and (g % tp == 0 or (g == 1 and n % tp == 0))
    return xin.device_mesh if ok else None


def ssm_apply(p: dict, xin: torch.Tensor, cfg: ModelConfig, return_cache: bool = False):
    """Chunked SSD over the full sequence.  xin [B, S, d]; S a multiple of
    the chunk.  With ``return_cache`` also the decode cache: the f32 state
    after the last token and the last ``d_conv - 1`` pre-conv rows.

    On a mesh whose 'model' axis splits the heads whole, the mixer runs per
    rank (:func:`_mixer` under ``shard_map_compat``): no activation is
    gathered but B and C, ``[B, S, 2 * groups * state]``.  Elsewhere it
    runs op by op, the packed projection gathered whole and the scan in its
    own region (:func:`_ssd_region`)."""
    weights = [p[k] for k in _WEIGHTS]
    mesh = _region_mesh(xin, cfg)
    if mesh is None:
        outs = _mixer(xin, *weights, cfg=cfg, return_cache=return_cache)
    else:
        _, _, g, _, _, _ = _dims(cfg)
        b = make_context(mesh).dp_spec(xin.shape[0])
        heads = ("model",)
        rows = (b, None, None)
        bc = (b, None, "model" if g % axis_sizes(mesh)["model"] == 0 else None)
        outs = list(shard_map_compat(
            functools.partial(_mixer, cfg=cfg, mesh=mesh, return_cache=return_cache),
            mesh=mesh, in_specs=(rows, (None, None), (None, None), (None,), heads, heads,
                                 heads, heads, ("model", None)),
            out_specs=[rows, (b, "model"), (b, None, "model"), bc, bc][:5 if return_cache else 1],
        )(xin, *weights))
        outs[0] = partial_sums(outs[0], "model")  # reduced where next used whole
    if not return_cache:
        return outs[0]
    out, hstate, *tails = outs
    return out, (hstate, torch.cat(tails, -1).to(xin.dtype))


def ssd_naive(p: dict, xin: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Token-by-token recurrence oracle (slow; tests only)."""
    cache = ssm_init_cache(cfg, xin.shape[0], dtype=xin.dtype, device=xin.device)
    outs = [ssm_decode(p, xin[:, t : t + 1], cfg, cache)[0] for t in range(xin.shape[1])]
    return torch.cat(outs, dim=1)


def ssm_init_cache(cfg: ModelConfig, bsz: int, dtype=torch.bfloat16, *, layers: int = 0,
                   device):
    """Zero cache ``(state f32 [B, H, P, N], conv tail [B, d_conv - 1, C])``,
    stacked ``[layers, ...]`` when ``layers`` > 0."""
    s: SSMConfig = cfg.ssm
    _, h, _, n, pdim, conv_ch = _dims(cfg)
    lead = (layers,) if layers else ()
    return (
        torch.zeros((*lead, bsz, h, pdim, n), dtype=torch.float32, device=device),
        torch.zeros((*lead, bsz, s.d_conv - 1, conv_ch), dtype=dtype, device=device),
    )


def ssm_decode(p: dict, xin: torch.Tensor, cfg: ModelConfig, cache):
    """One-token step.  xin [B, 1, d]; cache = (state, conv_tail), both
    updated in place (the reference returns new ones) and returned."""
    bsz = xin.shape[0]
    d_in, h, g, n, pdim, conv_ch = _dims(cfg)
    state, conv_tail = cache

    zxbcdt = gather_last(xin @ p["in_proj"])
    z, _, _, _, dt = _split_proj(zxbcdt, d_in, g, n, h)
    window = torch.cat([conv_tail, zxbcdt[..., d_in : d_in + conv_ch]], dim=1)  # [B, K, C]
    xbc = F.silu((window * p["conv_w"]).sum(1, keepdim=True) + p["conv_b"])
    x, bmat, cmat = xbc[..., :d_in], xbc[..., d_in : d_in + g * n], xbc[..., d_in + g * n :]
    dt = F.softplus(dt.float() + p["dt_bias"])[:, 0]  # [B, H]
    new, y = _step_region(state, x.reshape(bsz, h, pdim), dt, -torch.exp(p["a_log"]),
                          bmat.reshape(bsz, g, n), cmat.reshape(bsz, g, n), p["d_skip"])
    y = y.reshape(bsz, 1, d_in).to(xin.dtype)
    y = _gated_norm(y, z, p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    state.copy_(new)
    conv_tail.copy_(window[:, 1:])
    return out, (state, conv_tail)


def _step(state, x, dt, a, bmat, cmat, d_skip):
    """One recurrence step: state [B, H, P, N] f32, x [B, H, P], dt [B, H]
    f32, a and d_skip [H], bmat/cmat [B, G, N].  Returns (new state, y [B,
    H, P] f32)."""
    bsz, h, pdim, n = state.shape
    g = bmat.shape[1]
    dec = torch.exp(dt * a)
    xh = x.float()
    bh = bmat.reshape(bsz, g, 1, 1, n).float()
    ch = cmat.reshape(bsz, g, 1, n, 1).float()
    new = (state * dec[:, :, None, None]).view(bsz, g, h // g, pdim, n) + \
        (xh * dt[:, :, None]).view(bsz, g, h // g, pdim, 1) * bh
    y = (new @ ch).view(bsz, h, pdim)
    return new.view(bsz, h, pdim, n), y + xh * d_skip[None, :, None]


def _step_region(state, x, dt, a, bmat, cmat, d_skip):
    """:func:`_step`; on DTensors per rank (``shard_map_compat``), split as
    :func:`_ssd_region` splits the scan (decode takes no gradient)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(state, DTensor):
        return _step(state, x, dt, a, bmat, cmat, d_skip)
    mesh = state.device_mesh
    tpn = axis_sizes(mesh).get("model", 1)
    h, g = state.shape[1], bmat.shape[1]
    hsplit = "model" if h % tpn == 0 and (g == 1 or g % tpn == 0) else None
    rows = (make_context(mesh).dp_spec(state.shape[0]), hsplit)
    groups = (rows[0], hsplit if g % tpn == 0 else None)
    specs = [rows, rows, rows, (hsplit,), groups, groups, (hsplit,)]
    return shard_map_compat(_step, mesh=mesh, in_specs=specs, out_specs=[rows, rows])(
        state, x, dt, a, bmat, cmat, d_skip)
