"""Plain PyTorch reference of a Granite-4.0-H training step (IBM's
granitemoehybrid layer), written from the model's equations and
independent of the port: its mean next-token cross-entropy plus the MoE's
balance term, gradients and AdamW.

Every layer is ``x + r * mixer(rms(x))`` then ``x + r * ffn(rms(x))``, r the
residual multiplier; the mixer is Mamba-2 or grouped-query attention, the
FFN a routed MoE beside a shared SwiGLU expert:

- Mamba-2: one input projection to (z, x, B, C, dt); a causal depthwise
  conv of width ``mamba_d_conv`` with bias over (x, B, C), then SiLU;
  dt = softplus(dt + dt_bias), A = -exp(A_log); the state-space recurrence
  h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t + D x_t, per
  head (one group: B and C shared by every head), computed as the SSD:
  within each chunk of ``mamba_chunk_size`` tokens the quadratic form, and
  across chunks the state carried (:func:`ssd`; :func:`ssd_recurrent` is
  the token-by-token recurrence); then RMSNorm of y * silu(z) over the
  whole inner width, and the output projection;
- attention: q, k, v projections, no positional embedding, each query head
  reading key head i // (heads / KV heads), softmax of the causal scores
  times ``attention_multiplier``, the output projection;
- MoE: router logits over all ``num_experts`` (the published 72), softmax,
  the top ``num_experts_per_tok`` (ties to the lower id) renormalised; the
  held experts (ids 0 to ``num_local_experts`` - 1, this chip's share)
  each compute SwiGLU for the tokens routed to them, weighted; the share
  of the absent experts is left out, as the program leaves it out; plus
  the shared SwiGLU expert.  The balance term, at ``router_aux_loss_coef``
  a layer: num_experts * sum_e (the share of picks of e) * (e's mean
  probability), over all experts.

The embedding is multiplied by ``embedding_multiplier`` and tied to the
head; the logits are divided by ``logits_scaling``; every norm scales by
1 + gamma and uses ``rms_norm_eps``.

Weights arrive as the benchmark made them, leaves by path in the stacked
layout both sides read: ``embed`` [V, d], ``final_norm`` [d], and per run
of one layer kind ``groups/<g>/b0/...`` stacked over the run's layers
(:func:`runs`): ``norm1``, ``norm2``, ``ssm/{in_proj, conv_w, conv_b,
a_log, dt_bias, d_skip, norm, out_proj}`` or ``attn/{wq, wk, wv, wo}``, and
``moe/{router, w1, w3, w2, ws1, ws3, ws2}``.  The forward and gradients run
in float32 with TF32 off (the caller sets the flags), each layer recomputed
in backward; the parameters keep their stored dtypes, each update rounded
to them.  ``matmul="fp8"`` is the control of ``reference/lm.py``: every
weight product takes float8 operands.

``routes`` (:class:`Routed`, one a MoE layer) makes the MoE take another
run's expert picks (the program's) in place of its own top-k: the weights
are still this reference's probabilities at those experts, renormalised,
so everything but the choice of experts is computed here; each
:class:`Routed` notes how many tokens' own picks differ from the ones it
takes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.lm import _mm, flat_leaves

__all__ = ["runs", "ssd", "ssd_recurrent", "layer", "loss", "AdamW", "train_steps", "flat_leaves",
           "Routed"]

KINDS = {"mamba": "ssm", "attention": "attn"}


class Routed:
    """One MoE layer's expert picks taken from elsewhere: ``top_i`` [T, k];
    ``flips``, set by the layer, the tokens whose own top-k set differs."""

    def __init__(self, top_i: torch.Tensor):
        self.top_i = top_i
        self.flips = 0


def runs(layer_types: list[str]) -> list[tuple[str, int]]:
    """Consecutive runs of one kind, (kind, count): the layout's groups."""
    out: list[list] = []
    for t in layer_types:
        if out and out[-1][0] == t:
            out[-1][1] += 1
        else:
            out.append([t, 1])
    return [(t, n) for t, n in out]


def _rms(x, gamma, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + gamma)


def _swiglu(x, w_gate, w_up, w_down, matmul: str):
    return _mm(F.silu(_mm(x, w_gate, matmul)) * _mm(x, w_up, matmul), w_down, matmul)


def ssd(x, dt, a, bmat, cmat, q: int):
    """The SSD over chunks of ``q`` tokens.  x [B, S, H, P], dt [B, S, H],
    a [H], bmat and cmat [B, S, N].  Returns y [B, S, H, P] without the
    skip term."""
    bsz, s, h, p = x.shape
    nc = s // q
    xc = x.reshape(bsz, nc, q, h, p)
    dtc = dt.reshape(bsz, nc, q, h)
    bc = bmat.reshape(bsz, nc, q, -1)
    cc = cmat.reshape(bsz, nc, q, -1)
    lam = torch.cumsum(dtc * a, dim=2)  # [B, C, Q, H]: sum of dt_u A over u <= t
    # within a chunk: y_t += sum_{s <= t} (C_t . B_s) exp(lam_t - lam_s) dt_s x_s
    diff = lam[:, :, :, None, :] - lam[:, :, None, :, :]  # [B, C, Qt, Qs, H]
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(causal[None, None, :, :, None], diff, -math.inf))
    scores = torch.einsum("bctn,bcsn->bcts", cc, bc)
    weight = scores[..., None] * decay * dtc[:, :, None, :, :]  # [B, C, Qt, Qs, H]
    y = torch.einsum("bctsh,bcshp->bcthp", weight, xc)
    # each chunk's own contribution to the state at its end
    tail = torch.exp(lam[:, :, -1:, :] - lam) * dtc  # [B, C, Q, H]
    own = torch.einsum("bcsn,bcshp->bchpn", bc, xc * tail[..., None])
    # the state entering each chunk, carried across chunks
    states, h_in = [], torch.zeros_like(own[:, 0])
    for c in range(nc):
        states.append(h_in)
        h_in = h_in * torch.exp(lam[:, c, -1, :])[:, :, None, None] + own[:, c]
    h_prev = torch.stack(states, 1)  # [B, C, H, P, N]
    y = y + torch.einsum("bctn,bchpn->bcthp", cc, h_prev) * torch.exp(lam)[..., None]
    return y.reshape(bsz, s, h, p)


def ssd_recurrent(x, dt, a, bmat, cmat):
    """The same recurrence token by token (the oracle of :func:`ssd`)."""
    bsz, s, h, p = x.shape
    state = torch.zeros(bsz, h, p, bmat.shape[-1], dtype=x.dtype, device=x.device)
    ys = []
    for t in range(s):
        state = state * torch.exp(dt[:, t] * a)[:, :, None, None] + \
            (dt[:, t, :, None] * x[:, t])[..., None] * bmat[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", state, cmat[:, t]))
    return torch.stack(ys, 1)


def _mamba(x, p: dict, cfg: dict, matmul: str):
    bsz, s, _ = x.shape
    h, hd, n = cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"]
    d_in, k = h * hd, cfg["mamba_d_conv"]
    zxbcdt = _mm(x, p["in_proj"], matmul)
    z, xbc, dt = zxbcdt.split([d_in, d_in + 2 * n, h], dim=-1)
    xbc = F.conv1d(F.pad(xbc.transpose(1, 2), (k - 1, 0)), p["conv_w"].t()[:, None, :],
                   p["conv_b"], groups=xbc.shape[-1]).transpose(1, 2)
    xs, bmat, cmat = F.silu(xbc).split([d_in, n, n], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    xs = xs.reshape(bsz, s, h, hd)
    y = ssd(xs, dt, a, bmat, cmat, cfg["mamba_chunk_size"]) + p["d_skip"][:, None] * xs
    y = _rms(y.reshape(bsz, s, d_in) * F.silu(z), p["norm"], cfg["rms_norm_eps"])
    return _mm(y, p["out_proj"], matmul)


def _attention(x, p: dict, cfg: dict, matmul: str):
    bsz, s, _ = x.shape
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["hidden_size"] // h
    q = _mm(x, p["wq"], matmul).view(bsz, s, h, hd)
    k = _mm(x, p["wk"], matmul).view(bsz, s, hkv, hd).repeat_interleave(h // hkv, dim=2)
    v = _mm(x, p["wv"], matmul).view(bsz, s, hkv, hd).repeat_interleave(h // hkv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * cfg["attention_multiplier"]
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(bsz, s, h * hd)
    return _mm(o, p["wo"], matmul)


def _moe(x, p: dict, cfg: dict, matmul: str, routed: Routed | None = None):
    """(the held experts' share plus the shared expert, the balance term)."""
    e_all, top_k = cfg["router_experts"], cfg["num_experts_per_tok"]
    xt = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(xt @ p["router"], dim=-1)  # the router stays f32 in both runs
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :top_k], top_i[:, :top_k]
    if routed is not None:
        theirs = routed.top_i.reshape(-1, top_k).to(top_i.device)
        routed.flips = int((top_i.sort(-1).values != theirs.sort(-1).values).any(-1).sum())
        top_i, top_w = theirs, probs.gather(1, theirs)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    picks = torch.zeros(e_all, device=x.device).index_add_(
        0, top_i.reshape(-1), torch.ones(top_i.numel(), device=x.device))
    balance = e_all * torch.sum(picks / picks.sum() * probs.mean(0)) * cfg["router_aux_loss_coef"]
    out = _swiglu(xt, p["ws1"], p["ws3"], p["ws2"], matmul)
    for e in range(p["w1"].shape[0]):  # held expert e is expert id e
        weight = (top_w * (top_i == e)).sum(-1)
        rows = weight.nonzero()[:, 0]
        if rows.numel() == 0:  # no token picked expert e
            continue
        y = _swiglu(xt[rows], p["w1"][e], p["w3"][e], p["w2"][e], matmul)
        out = out.index_add(0, rows, y * weight[rows, None])
    return out.reshape(x.shape), balance


def layer(x, p: dict, kind: str, cfg: dict, matmul: str = "f32", routed: Routed | None = None):
    """One layer: (its output, its balance term)."""
    eps, r = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    mixer = _mamba if kind == "mamba" else _attention
    x = x + r * mixer(_rms(x, p["norm1"], eps), p, cfg, matmul)
    y, balance = _moe(_rms(x, p["norm2"], eps), p, cfg, matmul, routed)
    return x + r * y, balance


def _layer_leaves(leaves: dict, g: int, i: int, kind: str) -> dict:
    """Layer ``i`` of run ``g``'s leaves, by their last name."""
    pre = f"groups/{g}/b0/"
    mixer = KINDS[kind]
    return {k.rsplit("/", 1)[-1]: v[i] for k, v in leaves.items()
            if k.startswith(pre) and k[len(pre):].split("/")[0] in ("norm1", "norm2", mixer, "moe")}


def loss(leaves: dict[str, torch.Tensor], tokens, labels, cfg: dict, matmul: str = "f32",
         routes: list[Routed] | None = None):
    """Mean next-token cross-entropy of one microbatch plus the layers'
    balance terms; ``leaves`` are the float32 parameters by path;
    ``routes``, one a layer, the picks the MoE layers take."""
    x = leaves["embed"][tokens] * cfg["embedding_multiplier"]
    total = 0.0
    routes = iter(routes or [])
    for g, (kind, count) in enumerate(runs(cfg["layer_types"])):
        for i in range(count):
            p = _layer_leaves(leaves, g, i, kind)
            x, balance = checkpoint(layer, x, p, kind, cfg, matmul, next(routes, None),
                                    use_reentrant=False)
            total = total + balance
    x = _rms(x, leaves["final_norm"], cfg["rms_norm_eps"])
    logits = _mm(x, leaves["embed"].t(), matmul) / cfg["logits_scaling"]
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))
    return ce + total


class AdamW:
    """AdamW with the global-norm clip, bias correction and decoupled weight
    decay on every leaf of two or more dimensions in the stacked layout
    (the layer runs' norms and per-head vectors too, as the program decays
    them), float32 moments, each parameter rounded to its own stored dtype
    after each update.  ``state`` is (first moments, second moments, steps
    taken) to start from; zeros and 0 by default."""

    def __init__(self, leaves, *, lr, b1, b2, eps, weight_decay, clip_norm, state=None):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.wd, self.clip = weight_decay, clip_norm
        if state is None:
            zeros = lambda: {k: torch.zeros_like(v, dtype=torch.float32) for k, v in leaves.items()}  # noqa: E731
            state = (zeros(), zeros(), 0)
        self.m = {k: t.float() for k, t in state[0].items()}
        self.v = {k: t.float() for k, t in state[1].items()}
        self.t = int(state[2])

    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        gnorm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values()))
        scale = min(1.0, self.clip / max(gnorm, 1e-9))
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k] * scale
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            upd = (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + self.eps)
            if p.ndim >= 2:
                upd = upd + self.wd * p.float()
            p.copy_(p.float() - self.lr * upd)


def train_steps(params: dict, batches: list[list[dict]], cfg: dict, opt: dict,
                matmul: str = "f32", state=None, routes=None) -> dict:
    """Follow ``len(batches)`` optimizer steps from ``params`` (leaves by
    path, in their stored dtypes; updated in place) and AdamW's ``state``.
    Each step's gradient is the mean over its microbatches.  Returns each
    step's mean loss, the first step's gradient norm of each leaf, and each
    leaf's change after the last step (the norm of new minus initial).
    ``routes[step][microbatch]``, where given, are the MoE layers' picks
    (:class:`Routed`, one a layer); then ``route_flips`` counts the
    token-layer picks this reference would have made otherwise."""
    first = {k: p.clone() for k, p in params.items()}
    adam = AdamW(params, state=state, **opt)
    losses, first_grad = [], {}
    for step, mbs in enumerate(batches):
        w = {k: p.float().detach().requires_grad_() for k, p in params.items()}
        total = 0.0
        for i, mb in enumerate(mbs):
            val = loss(w, mb["tokens"], mb["labels"], cfg, matmul,
                       routes[step][i] if routes else None)
            val.backward()  # summed into each leaf's .grad in place
            total += float(val.detach())
            del val
        # a leaf no pair reached (a held expert no token picked) has no .grad: 0
        grads = {k: (torch.zeros_like(t) if t.grad is None else t.grad).div_(len(mbs))
                 for k, t in w.items()}
        del w
        if step == 0:
            first_grad = {k: float(g.double().norm()) for k, g in grads.items()}
        adam.step(params, grads)
        losses.append(total / len(mbs))
        del grads
    change = {k: float((params[k].double() - first[k].double()).norm()) for k in params}
    out = {"losses": losses, "grad_norms": first_grad, "change_norms": change}
    if routes:
        out["route_flips"] = sum(r.flips for step in routes for mb in step for r in mb)
    return out
