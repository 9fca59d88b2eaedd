"""Plain PyTorch reference of a dense decoder-only LM's training step (the
phi4-mini layer: RMSNorm scaled by 1 + gamma, grouped-query attention with
rotary embeddings on the whole head, a SiLU-gated MLP, an output head
tied to the embedding or of its own), its mean next-token cross-entropy,
gradients and AdamW, written from the equations and independent of the
port.

Weights arrive as the benchmark made them, in the stacked tree layout both
sides read: ``embed`` [V, d], ``head`` [d, V] (untied only), ``final_norm``
[d], and
``groups[0]["b0"]`` with ``norm1``/``norm2`` [L, d], ``attn`` {``wq``
[L, d, H*D], ``wk``/``wv`` [L, d, Hkv*D], ``wo`` [L, H*D, d]} and ``mlp``
{``w_gate``/``w_up`` [L, d, F], ``w_down`` [L, F, d]}.  The forward and the
gradients run in float32 with TF32 off (the caller sets the flags); the
parameters are kept as the configuration stores them (bfloat16), each
update rounded to it.  ``matmul="fp8"`` is the control: every weight product
takes float8 operands (e4m3 forward, e5m2 gradients, one scale a tensor)
and accumulates in float32, the step a later change might take.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


def _quantize(x: torch.Tensor, dtype, limit: float) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under one scale for the whole tensor, back
    in float32."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = limit / amax
    return (x * scale).to(dtype).float() / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        xq = _quantize(x, torch.float8_e4m3fn, _E4M3_MAX)
        wq = _quantize(w, torch.float8_e4m3fn, _E4M3_MAX)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _quantize(g, torch.float8_e5m2, _E5M2_MAX)
        gx = gq @ wq.transpose(-1, -2)
        gw = xq.reshape(-1, xq.shape[-1]).transpose(0, 1) @ gq.reshape(-1, gq.shape[-1])
        return gx, gw


def _mm(x, w, matmul: str):
    if matmul == "fp8":
        return _Fp8Matmul.apply(x, w)
    return x @ w


def _rms_norm(x, gamma, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + gamma)


def _rotate(x, positions, theta: float):
    """Rotary embedding over the whole head: the pairs (x[i], x[i + D/2])
    turn by position * theta^(-2i/D)."""
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = positions[:, None].float() * inv[None, :]  # [S, D/2]
    c, s = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _layer(x, p: dict, cfg: dict, matmul: str):
    b, s, d = x.shape
    h, hkv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    pos = torch.arange(s, device=x.device)
    xn = _rms_norm(x, p["norm1"], eps)
    q = _rotate(_mm(xn, p["wq"], matmul).view(b, s, h, hd), pos, theta)
    k = _rotate(_mm(xn, p["wk"], matmul).view(b, s, hkv, hd), pos, theta)
    v = _mm(xn, p["wv"], matmul).view(b, s, hkv, hd)
    k = k.repeat_interleave(h // hkv, dim=2)  # query head i reads key head i // (H / Hkv)
    v = v.repeat_interleave(h // hkv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, h * hd)
    x = x + _mm(o, p["wo"], matmul)
    xn = _rms_norm(x, p["norm2"], eps)
    return x + _mm(F.silu(_mm(xn, p["w_gate"], matmul)) * _mm(xn, p["w_up"], matmul),
                   p["w_down"], matmul)


def flat_leaves(params: dict) -> dict[str, torch.Tensor]:
    """The tree's leaves by "/"-joined path."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}/{k}" if path else k)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}" if path else str(i))
        else:
            out[path] = node

    walk(params, "")
    return out


def loss(leaves: dict[str, torch.Tensor], tokens, labels, cfg: dict, matmul: str = "f32"):
    """Mean next-token cross-entropy of one microbatch; ``leaves`` are the
    float32 parameters by path.  Each layer is recomputed in backward."""
    g = "groups/0/b0/"
    x = leaves["embed"][tokens]
    for i in range(cfg["num_hidden_layers"]):
        p = {k: leaves[g + path][i] for k, path in (
            ("norm1", "norm1"), ("norm2", "norm2"), ("wq", "attn/wq"), ("wk", "attn/wk"),
            ("wv", "attn/wv"), ("wo", "attn/wo"), ("w_gate", "mlp/w_gate"),
            ("w_up", "mlp/w_up"), ("w_down", "mlp/w_down"))}
        x = checkpoint(_layer, x, p, cfg, matmul, use_reentrant=False)
    x = _rms_norm(x, leaves["final_norm"], cfg["rms_norm_eps"])
    head = leaves["embed"].transpose(0, 1) if cfg["tie_word_embeddings"] else leaves["head"]
    logits = _mm(x, head, matmul)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))


class AdamW:
    """AdamW with the global-norm clip, bias correction and decoupled weight
    decay on matrices (embedding, head and each layer's projections; not
    the norms), float32 moments, the parameters rounded to ``store`` after
    each update.  ``state`` is (first moments, second moments, steps taken)
    to start from; zeros and 0 by default."""

    def __init__(self, leaves, *, lr, b1, b2, eps, weight_decay, clip_norm, store, state=None):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.wd, self.clip, self.store = weight_decay, clip_norm, store
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
            decays = not k.endswith("norm1") and not k.endswith("norm2") and k != "final_norm"
            if decays:
                upd = upd + self.wd * p.float()
            p.copy_((p.float() - self.lr * upd).to(self.store))


def train_steps(params: dict, batches: list[list[dict]], cfg: dict, opt: dict,
                matmul: str = "f32", state=None) -> dict:
    """Follow ``len(batches)`` optimizer steps from ``params`` (leaves by
    path, in the stored dtype; updated in place) and AdamW's ``state`` (see
    :class:`AdamW`).  Each step's gradient is
    the mean over its microbatches.  Returns each step's mean loss, the
    first step's gradient norm of each leaf, and each leaf's parameter
    change after the last step (the norm of new minus initial)."""
    first = {k: p.clone() for k, p in params.items()}
    adam = AdamW(params, store=next(iter(params.values())).dtype, state=state, **opt)
    losses, first_grad = [], {}
    for step, mbs in enumerate(batches):
        w = {k: p.float().detach().requires_grad_() for k, p in params.items()}
        total = 0.0
        for mb in mbs:
            val = loss(w, mb["tokens"], mb["labels"], cfg, matmul)
            val.backward()  # summed into each leaf's .grad in place
            total += float(val.detach())
            del val  # its graph's leaf nodes would keep w and the gradients alive
        grads = {k: t.grad.div_(len(mbs)) for k, t in w.items()}
        del w
        if step == 0:
            first_grad = {k: float(g.double().norm()) for k, g in grads.items()}
        adam.step(params, grads)
        losses.append(total / len(mbs))
        del grads
    change = {k: float((params[k].double() - first[k].double()).norm()) for k in params}
    return {"losses": losses, "grad_norms": first_grad, "change_norms": change}
